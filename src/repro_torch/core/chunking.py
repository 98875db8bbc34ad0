"""FCDA chunking (paper section 4.1) for the serving path.

Tokens are split into ``c`` chunks that run one after the other, so only one
chunk's dispatch buffers are live at a time.  Serving runs without autograd,
so no per-chunk recomputation (the paper's Eq. 7) is needed here.
"""

from __future__ import annotations

from typing import Callable

import torch


def chunk_spans(total: int, chunk: int) -> list[tuple[int, int]]:
    """(start, stop) spans splitting ``total`` tokens into <= ``chunk``-token
    pieces: the serving chunked-prefill decomposition."""
    if chunk <= 0:
        raise ValueError(f"prefill chunk must be positive, got {chunk}")
    return [(i, min(i + chunk, total)) for i in range(0, total, chunk)]


def chunked_map(fn: Callable, x: torch.Tensor, num_chunks: int, dim: int = 0):
    """Apply ``fn`` chunk by chunk over the token axis ``dim`` of ``x``.

    fn: chunk -> (y_chunk, stats dict).  Stats are summed across chunks.
    Returns (y, stats) with y matching x along ``dim``."""
    T = x.shape[dim]
    if T % num_chunks:
        raise ValueError(f"token count {T} not divisible by c={num_chunks}")
    if num_chunks == 1:
        return fn(x)
    ys, stats = [], None
    for xc in x.chunk(num_chunks, dim=dim):
        y, st = fn(xc)
        ys.append(y)
        stats = st if stats is None else {k: stats[k] + st[k] for k in st}
    return torch.cat(ys, dim=dim), stats
