"""Device time per training step of the MoE layers' routers (``moe.route``:
scores, the choice of experts, weights, load and the balance loss's terms,
each FCDA chunk, in the forward and both recomputes), from the program's
span recorder, in ms."""

from perfbench import spans_join


def read(run):
    return spans_join.device_ms(run, ("moe.route",))
