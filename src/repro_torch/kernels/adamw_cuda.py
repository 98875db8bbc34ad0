"""AdamW and its clipping norm on the card: the CUDA kernels' wrappers.

``sumsq`` sums the squares of every gradient, the replicated tensors and
the EP-sharded ones apart, in two launches of ``csrc/adamw.cu`` per
gradient type: partials per block, then their fixed-order sum, so a rerun
gives the same bits.  ``adamw_step`` updates every (parameter, first
moment, second moment) in place from its gradient in one launch per
parameter type (a gradient has its parameter's type), each element read
once and written once, with the plain update's fp32 operations and
rounding points
(``optim/adamw.py::apply_update``, which is its oracle).  Both take CUDA
tensors only; ``optim/adamw.py`` sends the CPU to the plain path.  Each
counts its kernel launches in ``.launches``; ``adamw_step`` also counts the
elements it updated under the span recorder's ``adamw.fused_elems``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _cuda
from repro_torch.runtime import spans

MAX_TENSORS = 64         # entries of one launch's table (csrc/adamw.cu)
_VECTOR, _SHARDED = 1, 2
_BLOCKS_PER_SM = 4


def _grid(device: torch.device) -> int:
    """Blocks a launch strides with: a few per SM, fixed per device (the
    norm's partials, and so its bits, depend on it)."""
    return torch.cuda.get_device_properties(device).multi_processor_count * _BLOCKS_PER_SM


def _indexed(device) -> torch.device:
    """``device`` with its index ("cuda" is the current CUDA device)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _device(op: str, tensors, device=None) -> torch.device:
    """The one CUDA device every tensor (and ``device``, if given) is on."""
    devices = {t.device for t in tensors if t is not None} | (
        set() if device is None else {_indexed(device)})
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"{op}: every tensor must be on one CUDA device; got "
                         f"{sorted(map(str, devices))}")
    return next(iter(devices))


def _check(op: str, t: torch.Tensor, n: int, dtypes, what: str) -> None:
    if t.dtype not in dtypes:
        raise ValueError(f"{op}: {what} must be one of {sorted(map(str, dtypes))}; "
                         f"got {t.dtype}")
    if not t.is_contiguous() or t.numel() != n:
        raise ValueError(f"{op}: {what} must be contiguous with {n} elements; got "
                         f"{tuple(t.shape)}")


def _tables(rows: list) -> list:
    """[(key, int64 host table, entries)]: the rows (key, g, p, m, v, n,
    flags) grouped by key in their order, at most ``MAX_TENSORS`` a table."""
    groups: dict = {}
    for key, *entry in rows:
        groups.setdefault(key, []).append(entry)
    out = []
    for key, entries in groups.items():
        for i in range(0, len(entries), MAX_TENSORS):
            part = entries[i:i + MAX_TENSORS]
            out.append((key, torch.tensor(part, dtype=torch.int64), len(part)))
    return out


def _aligned(*tensors) -> bool:
    return all(t is None or t.data_ptr() % 16 == 0 for t in tensors)


def sumsq(grads: list, sharded=None, device=None) -> tuple:
    """(replicated, sharded): the fp32 sums of the squares of ``grads``
    (CUDA tensors, bf16 or fp32; None skipped), the tensors ``sharded``
    flags apart, as two 0-d fp32 tensors on the device (``device`` where
    every gradient is None)."""
    sharded = [False] * len(grads) if sharded is None else list(sharded)
    device = _device("sumsq", grads, device)
    rows = []
    for g, part in zip(grads, sharded):
        if g is None or g.numel() == 0:
            continue
        _check("sumsq", g, g.numel(), _cuda.SUFFIX, "gradients")
        rows.append((g.dtype, g.data_ptr(), 0, 0, 0, g.numel(),
                     (_VECTOR if _aligned(g) else 0) | (_SHARDED if part else 0)))
    tables = _tables(rows)
    rep, shd = (torch.zeros((), dtype=torch.float32, device=device) for _ in range(2))
    if not tables:
        return rep, shd
    grid = _grid(device)
    partials = torch.empty((len(tables) * grid, 2), dtype=torch.float64, device=device)
    for k, (dtype, desc, count) in enumerate(tables):
        _cuda.launch("adamw", f"sumsq_partials_{_cuda.SUFFIX[dtype]}",
                     [desc, count, partials[k * grid], grid], device)
    _cuda.launch("adamw", "sumsq_finish", [partials, len(tables) * grid, rep, shd], device)
    sumsq.launches += len(tables) + 1
    return rep, shd


def adamw_step(grads: list, mu: list, nu: list, params: list, scale: torch.Tensor,
               bc1: float, bc2: float, *, lr: float, b1: float, b2: float,
               eps: float, weight_decay: float) -> None:
    """Update ``params`` (bf16 or fp32), ``mu`` and ``nu`` (fp32) in place
    from ``grads`` (each of its parameter's type, None for a zero
    gradient), given the clipping ``scale`` (a 0-d fp32 tensor on the
    device) and the bias corrections ``bc1``, ``bc2`` (fp32 values the host
    knows from the step).  Every check and table comes before the first
    launch, and nothing is allocated from the first launch to the return."""
    device = _device("adamw_step", [*grads, *mu, *nu, *params, scale])
    _check("adamw_step", scale, 1, (torch.float32,), "the clipping scale")
    rows, elems = [], 0
    for g, p, m, v in zip(grads, params, mu, nu, strict=True):
        n = p.numel()
        _check("adamw_step", p, n, _cuda.SUFFIX, "parameters")
        _check("adamw_step", m, n, (torch.float32,), "first moments")
        _check("adamw_step", v, n, (torch.float32,), "second moments")
        if g is not None:
            _check("adamw_step", g, n, (p.dtype,), "gradients")
        if n == 0:
            continue
        rows.append((p.dtype, 0 if g is None else g.data_ptr(), p.data_ptr(), m.data_ptr(),
                     v.data_ptr(), n, _VECTOR if _aligned(g, p, m, v) else 0))
        elems += n
    tables = _tables(rows)
    hyper = [float(b1), float(1 - b1), float(b2), float(1 - b2), float(eps),
             float(weight_decay), float(-lr)]
    grid = _grid(device)
    # -- the first write: from here to the return nothing is allocated
    for dtype, desc, count in tables:
        _cuda.launch("adamw", f"adamw_update_{_cuda.SUFFIX[dtype]}",
                     [desc, count, scale, float(bc1), float(bc2), *hyper, grid], device)
    adamw_step.launches += len(tables)
    spans.count("adamw.fused_elems", elems)


sumsq.launches = 0
adamw_step.launches = 0
