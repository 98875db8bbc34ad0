"""Spans and counters of the training step, on the device trace's clock.

A span is a named interval of host time, stamped with ``time.time_ns()``:
the epoch clock on which ``torch.profiler`` (Kineto) stamps its host and
device events, so a span lines up with the device timeline of the same
session, as closely as the trace's device stamps agree with its host's.
``span(name, device=True)`` also records a CUDA event pair on the current
stream, and ``records()`` resolves the device milliseconds between them
(on the CPU they are None).  A span does not appear on the device
timeline itself: it is no ``record_function``, so the profiler sees
neither an annotation nor a range.

The recorder records only while a ``torch.profiler`` session is active (the
profiler's own enabled flag), or after ``enable()``; ``enable(False)``
keeps it off even under the profiler.  Off, ``span()`` returns one shared
no-op object, ``backward_span()`` markers return the tensor they are given,
``recompute_context()`` returns the checkpoint's own default, and
``count()`` returns at once: nothing is allocated, no event is recorded
and no autograd node is added.

Parents come from a per-thread stack: autograd runs the backward, and with
it every checkpoint's recompute, on a device thread of its own on CUDA.
Readers attribute time by containment of the host intervals, across
threads.

The training step's spans (``training/trainer.py``, ``training/step.py``,
``models/blocks.py``, ``core/chunking.py``)::

  train.step        one step of ``Trainer.fit``, planning to the log
    train.plan      MACT and placement (``_next_schedule_key``)
    train.batch     the batch's copy to the device
    train.forward   the loss
      attn          an attention mixer, projections to output projection (device)
        mla.proj    MLA's four low-rank projections and their norms (device)
      moe.route     an MoE layer's router, each FCDA chunk (device)
    train.backward  ``torch.autograd.grad``
      attn.bwd      an attention mixer's backward (device)
        mla.proj.bwd  their backward (device)
      remat.layer   a layer checkpoint's recompute (device)
      remat.chunk   an FCDA chunk checkpoint's recompute (device)
    train.optimizer clipping norm, AdamW, router-bias steps (device)
    train.readback  the step's one sync, the loss read back

and the counters ``fcda.chunk_runs``: each run of an FCDA chunk body, in the
forward or either recompute; ``adamw.elems``: the parameter elements each
AdamW update touches (``optim/adamw.py``), on any path; and
``adamw.fused_elems``: those the card's one-pass kernel updated
(``kernels/adamw_cuda.py``).
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import NamedTuple, Optional

import torch
from torch.autograd import profiler as _profiler
from torch.utils.checkpoint import noop_context_fn

_forced: Optional[bool] = None      # None: record while the profiler is on
_done: list = []                    # finished spans, in order of their end
_counts: dict = {}
_lock = threading.Lock()
_local = threading.local()
_ids = itertools.count()
_cuda: Optional[bool] = None


class Record(NamedTuple):
    """A finished span: its id, its parent's id on the same thread (None at
    the top), the thread, host epoch nanoseconds, and its device
    milliseconds (None where not device-timed or on the CPU)."""
    name: str
    id: int
    parent: Optional[int]
    thread: int
    start_ns: int
    end_ns: int
    device_ms: Optional[float]


def recording() -> bool:
    """Whether spans and counters are being recorded now."""
    return _profiler._is_profiler_enabled if _forced is None else _forced


def enable(on: Optional[bool] = True) -> None:
    """Record always (True), never (False), or while a torch profiler
    session is active (None, the default)."""
    global _forced
    _forced = on


def _stack() -> list:
    s = getattr(_local, "stack", None)
    if s is None:
        s = _local.stack = []
    return s


def _on_cuda() -> bool:
    global _cuda
    if _cuda is None:
        _cuda = torch.cuda.is_available()
    return _cuda


class _Off:
    """The shared no-op span and backward marker."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    @staticmethod
    def inputs(t):
        return t

    output = inputs


OFF = _Off()


class _Span:
    __slots__ = ("name", "device", "id", "parent", "thread", "start_ns",
                 "end_ns", "events")

    def __init__(self, name: str, device: bool):
        # no events inside a CUDA graph capture: they would time the capture
        self.name, self.events = name, None
        self.device = (device and _on_cuda()
                       and not torch.cuda.is_current_stream_capturing())

    def __enter__(self):
        stack = _stack()
        self.id = next(_ids)
        self.parent = stack[-1].id if stack else None
        self.thread = threading.get_ident()
        self.start_ns = time.time_ns()
        if self.device:
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        stack.append(self)
        return self

    def __exit__(self, *exc):
        if self.events is not None:
            self.events[1].record()
        self.end_ns = time.time_ns()
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        else:
            stack.remove(self)
        _done.append(self)
        return False


def span(name: str, device: bool = False):
    """A context manager timing ``name``; with ``device`` also on the device."""
    if not recording():
        return OFF
    return _Span(name, device)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    if not recording():
        return
    with _lock:
        _counts[name] = _counts.get(name, 0) + n


class _Close(torch.autograd.Function):
    """Identity on a region's input; its backward closes the region's span."""

    @staticmethod
    def forward(ctx, x, mark):
        ctx.mark = mark
        return x

    @staticmethod
    def backward(ctx, g):
        s = ctx.mark.open
        if s is not None:
            ctx.mark.open = None
            s.__exit__(None, None, None)
        return g, None


class _Open(torch.autograd.Function):
    """Identity on a region's output; its backward opens the region's span."""

    @staticmethod
    def forward(ctx, y, mark):
        ctx.mark = mark
        return y

    @staticmethod
    def backward(ctx, g):
        mark = ctx.mark
        if mark.open is None:
            mark.open = _Span(mark.name, mark.device).__enter__()
        return g, None


class _Marks:
    """The two markers of one region's backward span."""

    __slots__ = ("name", "device", "open")

    def __init__(self, name: str, device: bool):
        self.name, self.device, self.open = name, device, None

    def inputs(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` as the region reads it: the span closes once its gradient
        is complete."""
        return _Close.apply(x, self) if x.requires_grad else x

    def output(self, y: torch.Tensor) -> torch.Tensor:
        """``y`` as the region returns it: the span opens when its gradient
        arrives."""
        return _Open.apply(y, self) if y.requires_grad else y


def backward_span(name: str, device: bool = False):
    """Markers that span a region's backward as ``name``: the region reads
    ``marks.inputs(x)`` and returns ``marks.output(y)``.  Off, or without
    autograd recording, both return their tensor as given."""
    if not (torch.is_grad_enabled() and recording()):
        return OFF
    return _Marks(name, device)


@contextlib.contextmanager
def _within(outer, inner):
    with outer, inner:
        yield


def recompute_context(name: str, base=None):
    """A ``context_fn`` for a non-reentrant checkpoint whose recompute runs
    under span ``name`` (device-timed), composed with ``base``'s contexts
    (default: the checkpoint's own).  Off, ``base`` or that default."""
    base = base or noop_context_fn
    if not recording():
        return base

    def fn():
        fwd, rec = base()
        return fwd, _within(_Span(name, True), rec)

    return fn


def records() -> list:
    """The finished spans, as ``Record``s, their device time resolved (one
    synchronize when any span is device-timed)."""
    done = list(_done)
    if any(s.events is not None for s in done):
        torch.cuda.synchronize()
    return [Record(s.name, s.id, s.parent, s.thread, s.start_ns, s.end_ns,
                   s.events[0].elapsed_time(s.events[1]) if s.events else None)
            for s in done]


def counters() -> dict:
    """The counters, by name."""
    with _lock:
        return dict(_counts)


def clear() -> None:
    """Forget every finished span and counter."""
    with _lock:
        _done.clear()
        _counts.clear()
