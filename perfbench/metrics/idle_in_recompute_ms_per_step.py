"""Device idle time per training step inside the backward's recomputes:
the window's idle gaps whose midpoint falls inside a ``remat.layer`` or
``remat.chunk`` span of the program's recorder, in ms."""

from perfbench import spans_join


def read(run):
    return spans_join.idle_ms(
        run, lambda cover: any(r.name.startswith("remat.") for r in cover))
