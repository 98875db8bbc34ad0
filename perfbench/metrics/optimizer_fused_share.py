"""The share of the parameter elements AdamW updated in the window that the
card's one-pass kernel updated (the program's counters
``adamw.fused_elems`` over ``adamw.elems``); 1.0 when the main path takes
the kernel.  A program without the counters reads None."""

from perfbench import spans_join


def read(run):
    got = spans_join.recorded(run)
    if got is None or not got[1].get("adamw.elems"):
        return None
    return got[1].get("adamw.fused_elems", 0) / got[1]["adamw.elems"]
