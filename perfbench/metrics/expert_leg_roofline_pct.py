"""The expert leg's share of its roofline over the window: the least time
at the chip's peaks of every MoE layer's expert FFN, forward and backward,
over the routed token-slots of the experts this chip holds (batch x
sequence x top-k x experts held / experts, under dropless routing, counted
once; the architecture file's ``expert_leg_least_s``), over the device
time of the leg's kernels (``kernel_names.EXPERT_LEG``), in %."""

from perfbench.kernel_names import EXPERT_LEG, matches


def read(run):
    r, spec = run.record, run.spec
    steps = r.get("steps")
    dev = run.window.device_s_where(matches(EXPERT_LEG))
    if not steps or dev <= 0:
        return None
    n_moe = sum(1 for lay in spec["layers"] if lay["ffn"] == "moe")
    slots = r["batch"] * r["seq"] * spec["top_k"] * spec["experts_held"] / spec["n_experts"]
    return 100.0 * len(steps) * n_moe * run.arch.expert_leg_least_s(spec, slots) / dev
