"""The fused MoE expert leg: the CUDA kernel's wrapper.

``fused_moe`` runs dispatch -> SwiGLU -> down-projection -> weighted combine
over the ragged layout in one call: token rows are gathered through the
inverted slot map ``src`` inside the kernel, so the (R, d) dispatch buffer
never exists.  On a CUDA tensor it launches the kernels of
``csrc/fused_moe.cu`` (a memset and three launches: up, down + atomic
combine, cast; bf16 runs both passes on the Hopper mainloop of
``csrc/ragged_wgmma.cuh``, fp32 on the tile loop of ``csrc/ragged_tile.cuh``);
on a CPU tensor it computes the plain version of ``kernels/ref.py``.  It
counts its calls on the card in ``.launches``.  In bf16 the down pass takes
its row tile at run time (``ragged_mlp.tuned_row_tile``, cached as
``fused_moe`` at (R, f, d, E, bm)); the up pass gathers its rows and takes
two weights, so its tile keeps 128 rows wherever bm allows.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _cuda, ref
from repro_torch.kernels.ragged_mlp import row_tile, tuned_row_tile


def fused_moe(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor, w2: torch.Tensor,
              src: torch.Tensor, wslot: Optional[torch.Tensor], total_rows,
              block_to_expert: torch.Tensor, *, tm: Optional[int] = None) -> torch.Tensor:
    """x: (T, d) tokens; w1, w3: (E, d, f); w2: (E, f, d); src: (R,) token
    of each buffer row (-1 = empty); wslot: (R,) per-row combine weight
    (None = 1); block_to_expert: (R // bm,) -> (T, d) in x's type.  ``tm``:
    the bf16 down pass's row tile, over the tile cache's."""
    T, d = x.shape
    E, _, f = w1.shape
    R = src.shape[0]
    nb = block_to_expert.shape[0]
    if (tuple(w1.shape) != (E, d, f) or tuple(w3.shape) != (E, d, f)
            or tuple(w2.shape) != (E, f, d)):
        raise ValueError(f"fused_moe: weights {tuple(w1.shape)}, {tuple(w3.shape)}, "
                         f"{tuple(w2.shape)} do not match x {tuple(x.shape)}")
    if nb == 0 or R % nb:
        raise ValueError(f"fused_moe: R={R} rows not a multiple of {nb} blocks")
    if wslot is not None and tuple(wslot.shape) != (R,):
        raise ValueError(f"fused_moe: wslot {tuple(wslot.shape)}, expected ({R},)")
    if x.device.type == "cpu":
        return ref.fused_moe_rows_ref(x, w1, w3, w2, src, wslot, block_to_expert,
                                      total_rows)
    op = "fused_moe"
    if d % 8 or f % 8:
        raise ValueError(f"{op}: d={d} and f={f} must be multiples of 8")
    bm = R // nb
    if x.dtype == torch.bfloat16:
        tm = tuned_row_tile(op, (R, f, d, E, bm), bm, tm)     # the down pass's
    else:
        tm = row_tile(bm)
    src = _cuda.index32(src, x.device)
    b2e = _cuda.index32(block_to_expert, x.device)
    if wslot is None:
        wslot = torch.ones(R, dtype=x.dtype, device=x.device)
    _cuda.no_autograd(op, (x, w1, w3, w2, wslot),
                      "train through kernels/ops.py::moe_ffn")
    _cuda.operands(op, (x, w1, w3, w2, src, wslot, b2e), x.dtype, x.device)
    h = torch.empty((R, f), dtype=x.dtype, device=x.device)     # workspace
    acc = torch.empty((T, d), dtype=torch.float32, device=x.device)
    args = [x, w1, w3, w2, src, wslot, b2e,
            _cuda.total_rows_on(total_rows, x.device), h, acc]
    out = acc
    if x.dtype != torch.float32:
        out = torch.empty((T, d), dtype=x.dtype, device=x.device)
        args.append(out)
    if T * d == 0:
        return out.zero_()
    _cuda.launch("fused_moe", f"fused_moe_{_cuda.SUFFIX[x.dtype]}",
                 args + [T, R, d, f, E, bm, tm], x.device)
    fused_moe.launches += 1
    return out


fused_moe.launches = 0
