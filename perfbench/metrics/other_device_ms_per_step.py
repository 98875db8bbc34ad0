"""Device time per training step of every kernel outside the expert leg
(attention, AdamW, norms, the LM head, elementwise), in ms."""

from perfbench.kernel_names import EXPERT_LEG, matches


def read(run):
    steps = run.record.get("steps")
    if not steps or not run.window.device:
        return None
    leg = matches(EXPERT_LEG)
    return 1e3 * run.window.device_s_where(lambda n: not leg(n)) / len(steps)
