"""Device time per training step of the attention mixers (``attn``:
projections, RoPE, the core and the output projection, in the forward and
in the layer recompute; ``attn.bwd``: their backward), from the program's
span recorder, in ms.  A span's device time runs from its first to its
last event on the stream, idle included."""

from perfbench import spans_join


def read(run):
    return spans_join.device_ms(run, ("attn", "attn.bwd"))
