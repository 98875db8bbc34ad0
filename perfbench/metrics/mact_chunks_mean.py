"""The mean FCDA chunk count MACT chose over the window's steps
(``Trainer.log[i]["chunks"]``)."""


def read(run):
    steps = run.record.get("steps")
    if not steps:
        return None
    return sum(s["chunks"] for s in steps) / len(steps)
