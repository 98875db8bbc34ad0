"""The expert leg's share of its roofline over the window: the least time
at the chip's peaks of every MoE layer's expert FFN, forward and backward,
over the step's routed token-slots (batch x sequence x top-k under dropless
routing, counted once; ``work.expert_leg_least_s``), over the device time
of the leg's kernels (``kernel_names.EXPERT_LEG``), in %."""

from perfbench import work
from perfbench.kernel_names import EXPERT_LEG, matches


def read(run):
    r = run.record
    steps = r.get("steps")
    dev = run.window.device_s_where(matches(EXPERT_LEG))
    if not steps or dev <= 0:
        return None
    n_moe = sum(1 for lay in run.spec["layers"] if lay["ffn"] == "moe")
    slots = r["batch"] * r["seq"] * run.spec["top_k"]
    return 100.0 * len(steps) * n_moe * work.expert_leg_least_s(run.spec, slots) / dev
