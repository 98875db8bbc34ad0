"""Token dispatch and combine: the CUDA kernels' wrappers.

``scatter_rows`` builds a dispatch buffer row by row from a source-row map,
``gather_combine`` sums each token's slot rows back; each is the other's
transpose (``kernels/ops.py`` wires them as each other's backward).  On a
CUDA tensor they launch the kernels of ``csrc/dispatch.cu``; on a CPU tensor
they compute the plain versions of ``kernels/ref.py``.  Each wrapper counts
its kernel launches in ``.launches``.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _cuda, ref

_TRAINABLE = "call it through kernels/ops.py (dispatch_rows, combine_rows)"


def _check_rows(op: str, x: torch.Tensor, w: Optional[torch.Tensor], wshape) -> None:
    if x.dim() != 2:
        raise ValueError(f"{op}: expected a (rows, d) source; got {tuple(x.shape)}")
    if w is not None and tuple(w.shape) != tuple(wshape):
        raise ValueError(f"{op}: weights of shape {tuple(w.shape)}, expected "
                         f"{tuple(wshape)}")


def _check_cuda(op: str, x: torch.Tensor, tensors) -> None:
    if x.shape[1] % 8:
        raise ValueError(f"{op}: d={x.shape[1]} must be a multiple of 8")
    _cuda.no_autograd(op, tensors, _TRAINABLE)
    _cuda.operands(op, tensors, x.dtype, x.device)


def scatter_rows(x: torch.Tensor, src: torch.Tensor, total_rows,
                 weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (T, d); src: (R,) source row of each output row (-1 = empty);
    ``total_rows`` (int or 0-d tensor): rows at or past it are 0;
    ``weights``: optional (R,) per-row scale -> (R, d) in x's type."""
    R = src.shape[0]
    _check_rows("scatter_rows", x, weights, (R,))
    if x.device.type == "cpu":
        return ref.scatter_rows_ref(x, src, total_rows, weights)
    src = _cuda.index32(src, x.device)
    _check_cuda("scatter_rows", x, (x, src, weights))
    out = torch.empty((R, x.shape[1]), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    # a count the host knows goes by value: no device tensor to fill
    rows = (_cuda.total_rows_on(total_rows, x.device), 0) if isinstance(
        total_rows, torch.Tensor) else (None, min(int(total_rows), R))
    _cuda.launch("dispatch", f"scatter_rows_{_cuda.SUFFIX[x.dtype]}",
                 [x, src, *rows, weights, out, R, x.shape[1]], x.device)
    scatter_rows.launches += 1
    return out


def gather_combine(buf: torch.Tensor, slots: torch.Tensor,
                   weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """buf: (R, d); slots: (T, K) rows of buf (-1 = dropped); ``weights``:
    optional (T, K) -> (T, d): each token the weighted sum of its K slot
    rows, in fp32 over k in order, in buf's type."""
    T, K = slots.shape
    _check_rows("gather_combine", buf, weights, (T, K))
    if buf.device.type == "cpu":
        return ref.gather_combine_ref(buf, slots, weights)
    slots = _cuda.index32(slots, buf.device)
    _check_cuda("gather_combine", buf, (buf, slots, weights))
    out = torch.empty((T, buf.shape[1]), dtype=buf.dtype, device=buf.device)
    if out.numel() == 0:
        return out
    _cuda.launch("dispatch", f"gather_combine_{_cuda.SUFFIX[buf.dtype]}",
                 [buf, slots, weights, out, T, K, buf.shape[1]], buf.device)
    gather_combine.launches += 1
    return out


scatter_rows.launches = 0
gather_combine.launches = 0
