"""MACT's modeled bytes at the last step's schedule
(``memory_report(...)["total_gb"]``) over the window's measured peak
(``Trainer.max_memory_allocated``)."""


def read(run):
    r = run.record
    if not r.get("steps") or not r.get("peak_bytes"):
        return None
    return r["modeled_bytes"] / r["peak_bytes"]
