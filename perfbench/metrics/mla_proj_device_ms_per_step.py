"""Device time per training step of MLA's four low-rank projections and
their norms (``mla.proj``, in the forward and the layer recompute;
``mla.proj.bwd``: their backward), from the program's span recorder, in
ms.  None where the model has no latent attention."""

from perfbench import spans_join


def read(run):
    return spans_join.device_ms(run, ("mla.proj", "mla.proj.bwd"))
