"""Device time per training step of the backward's recomputes: each layer
checkpoint's (``remat.layer``) and each FCDA chunk checkpoint's
(``remat.chunk``), from the program's span recorder, in ms.  The layer
recompute's attention is also in ``attention_device_ms_per_step``."""

from perfbench import spans_join


def read(run):
    return spans_join.device_ms(run, ("remat.layer", "remat.chunk"))
