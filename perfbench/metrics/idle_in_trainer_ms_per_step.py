"""Device idle time per training step in the trainer around the step's
work: the window's idle gaps whose midpoint falls inside a ``train.step``
span but outside ``train.forward``, ``train.backward`` and
``train.optimizer`` (planning, the batch's copy, the readback and the log),
in ms."""

from perfbench import spans_join

WORK = ("train.forward", "train.backward", "train.optimizer")


def read(run):
    return spans_join.idle_ms(
        run, lambda cover: (any(r.name == "train.step" for r in cover)
                            and not any(r.name in WORK for r in cover)))
