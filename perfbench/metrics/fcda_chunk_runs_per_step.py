"""Runs of an FCDA chunk body per training step, in the forward, the layer
recompute and the chunk recompute (the program's counter
``fcda.chunk_runs``)."""

from perfbench import spans_join


def read(run):
    got = spans_join.recorded(run)
    if got is None or "fcda.chunk_runs" not in got[1]:
        return None
    return spans_join.per_step(run, got[1]["fcda.chunk_runs"])
