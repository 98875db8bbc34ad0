"""FCDA -- Fine-grained Chunk Distribution Algorithm (paper section 4.1).

Forward (Eq. 6): tokens are split into ``c`` chunks; each chunk runs
dispatch -> expert compute -> combine in turn, and the outputs concatenate.
Backward (Eq. 7): each chunk is recomputed on its own -- here each chunk
body runs under a non-reentrant ``torch.utils.checkpoint``, so the saved
residuals and the live dispatch buffers scale with one chunk, not the whole
token set.

``chunked_pipeline`` is the overlapped schedule: waves of ``depth`` chunks,
one checkpoint per wave, so ``depth`` chunks are live at once -- the extra
live chunk that MACT prices (core/mact.py).  Chunks of a wave are mutually
independent, which is what a multi-rank EP exchange can overlap.

``chunk_spans`` is the serving chunked-prefill decomposition.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.runtime import spans


class ScheduleSpec(NamedTuple):
    """One MoE layer's FCDA schedule: ``chunks`` is the MACT-snapped chunk
    bin, ``depth`` the pipeline depth (1 = sequential loop, >= 2 = waves)."""
    chunks: int
    depth: int = 1


class ChunkStages(NamedTuple):
    """The FCDA chunk body split at its communication boundaries.

    ``dispatch``: chunk tokens -> in-flight state (routing, dispatch
      planning, the dispatch exchange); ``compute``: in-flight state ->
      computed state (the expert FFN on the received rows); ``combine``:
      computed state -> (y_chunk, stats) (the return exchange and the
      weighted reduction back to token order)."""
    dispatch: Callable
    compute: Callable
    combine: Callable


def chunk_spans(total: int, chunk: int) -> list[tuple[int, int]]:
    """(start, stop) spans splitting ``total`` tokens into <= ``chunk``-token
    pieces: the serving chunked-prefill decomposition."""
    if chunk <= 0:
        raise ValueError(f"prefill chunk must be positive, got {chunk}")
    return [(i, min(i + chunk, total)) for i in range(0, total, chunk)]


def compose(stages: ChunkStages) -> Callable:
    """The sequential chunk body: combine(compute(dispatch(xc)))."""
    def fn(xc):
        return stages.combine(stages.compute(stages.dispatch(xc)))
    return fn


def _sum_stats(stats: list) -> dict:
    out = stats[0]
    for st in stats[1:]:
        out = {k: out[k] + st[k] for k in out}
    return out


def _counted(fn: Callable) -> Callable:
    """``fn`` counting its runs as ``fcda.chunk_runs`` (``runtime/spans.py``):
    in the forward and in every recompute."""
    def run(*a):
        spans.count("fcda.chunk_runs")
        return fn(*a)
    return run


def _body(fn: Callable, remat: bool) -> Callable:
    """``fn`` under a non-reentrant checkpoint (Eq. 7) when ``remat`` and
    autograd is recording, its recompute under the span ``remat.chunk``;
    as is otherwise."""
    if not remat:
        return fn
    return lambda *a: (checkpoint(fn, *a, use_reentrant=False,
                                  context_fn=spans.recompute_context("remat.chunk"))
                       if torch.is_grad_enabled() else fn(*a))


def chunked_map(fn: Callable, x: torch.Tensor, num_chunks: int, dim: int = 0, *,
                remat: bool = True):
    """Apply ``fn`` chunk by chunk over the token axis ``dim`` of ``x``.

    fn: chunk -> (y_chunk, stats dict).  Stats are summed across chunks.
    Returns (y, stats) with y matching x along ``dim``.  ``remat`` wraps
    each chunk body in a checkpoint: the backward recomputes it (Eq. 7)."""
    T = x.shape[dim]
    if T % num_chunks:
        raise ValueError(f"token count {T} not divisible by c={num_chunks}")
    body = _body(_counted(fn), remat)
    if num_chunks == 1:
        return body(x)
    ys, stats = [], []
    for xc in x.chunk(num_chunks, dim=dim):
        y, st = body(xc)
        ys.append(y)
        stats.append(st)
    return torch.cat(ys, dim=dim), _sum_stats(stats)


def chunked_pipeline(stages: ChunkStages, x: torch.Tensor, num_chunks: int, *,
                     depth: int = 2, remat: bool = True):
    """The overlapped FCDA schedule: the same math as
    ``chunked_map(compose(stages))`` with ``depth`` chunks in flight.

    Chunks run in waves of ``depth`` along the leading (token) axis; the
    chunks of a wave are mutually independent, and one checkpoint covers
    the wave, so the backward recomputes wave by wave and never more than
    ``depth`` chunks' buffers are live.  Falls back to the sequential loop
    when ``depth == 1``, there are fewer than 2 chunks, or ``depth`` does
    not divide the chunk count.  Returns (y, stats summed over chunks)."""
    T = x.shape[0]
    if T % num_chunks:
        raise ValueError(f"token count {T} not divisible by c={num_chunks}")
    if depth < 1:
        raise ValueError(f"pipeline depth must be >= 1, got {depth}")
    depth = min(depth, num_chunks)
    fn = compose(stages)
    if num_chunks < 2 or depth == 1 or num_chunks % depth:
        return chunked_map(fn, x, num_chunks, remat=remat)
    chunk_fn = _counted(fn)

    def wave_fn(xw):
        outs = [chunk_fn(xc) for xc in xw.chunk(depth)]
        return (torch.cat([o[0] for o in outs]), _sum_stats([o[1] for o in outs]))

    body = _body(wave_fn, remat)
    ys, stats = [], []
    for xw in x.chunk(num_chunks // depth):
        y, st = body(xw)
        ys.append(y)
        stats.append(st)
    return torch.cat(ys), _sum_stats(stats)
