"""Device time per training step of the optimizer (``train.optimizer``: the
global norm, clipping, AdamW and the router-bias steps), from the program's
span recorder, in ms."""

from perfbench import spans_join


def read(run):
    return spans_join.device_ms(run, ("train.optimizer",))
