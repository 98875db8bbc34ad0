"""The expert-leg operations on the port's kernels, with their gradients.

* ``expert_ffn``: the capacity-layout expert FFN on the grouped kernels
  (serving; the kernels have no backward and refuse to run under autograd
  on the card).
* ``dispatch_rows`` / ``combine_rows``: dispatch and combine with the JAX
  package's transpose-symmetric gradients.  Combine is the exact transpose
  of dispatch, so dispatch's backward *is* the combine kernel and combine's
  backward *is* the dispatch kernel with the router weight riding along,
  plus a (T, K) segment dot for the weight's gradient.  Only the int32 maps
  (and combine's own inputs) are saved for the backward.
* ``ragged_expert_ffn``: the SwiGLU FFN of the three-launch ragged leg
  over the dispatch buffer, ``ragged_swiglu`` then ``ragged_matmul``
  forward.  It saves only its inputs and the int32 maps (no (R, f)
  tensor); its backward recomputes both up-projections with
  ``ragged_matmul``.
* ``moe_ffn``: the fused expert leg, one ``fused_moe`` call forward.  It
  saves only its inputs and the int32 maps; its backward recomputes the
  dispatch buffer with ``scatter_rows``, runs the same FFN interior as
  ``ragged_expert_ffn``'s backward (``_ffn_backward``) and returns the token
  gradient through ``gather_combine``.

On CPU tensors every kernel call takes its plain version, so the same
autograd Functions run, and are tested, on the CPU.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.dispatch import invert_slots
from repro_torch.kernels.dispatch_cuda import gather_combine, scatter_rows
from repro_torch.kernels.fused_moe import fused_moe
from repro_torch.kernels.grouped_mlp import grouped_matmul, grouped_swiglu
from repro_torch.kernels.ragged_mlp import ragged_matmul, ragged_swiglu


def expert_ffn(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
               w2: torch.Tensor) -> torch.Tensor:
    """Per-expert SwiGLU FFN over dispatched buffers.

    x: (..., E, C, d); w1, w3: (E, d, f); w2: (E, f, d) -> (..., E, C, d).

    The leading batch dims are folded into the row dim: x is permuted to
    (E, B*C, d), each kernel launches once, and the result is permuted back.
    Every output row is computed independently, so this is the function the
    JAX package computes with one launch per batch row, but each expert's
    weights are read once per call instead of once per row.
    """
    lead = x.shape[:-3]
    E, C, d = x.shape[-3:]
    xe = x.reshape(-1, E, C, d).transpose(0, 1).reshape(E, -1, d).contiguous()
    h = grouped_swiglu(xe, w1, w3)
    y = grouped_matmul(h, w2)
    return y.reshape(E, -1, C, d).transpose(0, 1).reshape(*lead, E, C, d)


# ---------------------------------------------------------------------------
# dispatch / combine
# ---------------------------------------------------------------------------

def _row_side(slots: torch.Tensor, rows: int):
    """(pos, src): each buffer row's flat token-slot (t*K + k) and token,
    -1 for an empty row."""
    K = slots.shape[1]
    pos = invert_slots(slots, rows)
    return pos, torch.where(pos >= 0, torch.div(pos, K, rounding_mode="floor"), -1)


def _slot_weights(weights: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """(R,) combine weight of each buffer row (0 for an empty row)."""
    w = weights.reshape(-1)[pos.clamp_min(0).long()]
    return torch.where(pos >= 0, w, torch.zeros((), dtype=w.dtype, device=w.device))


def _weight_grad(g: torch.Tensor, buf: torch.Tensor, slots: torch.Tensor,
                 dtype) -> torch.Tensor:
    """dw[t, k] = <g[t], buf[slots[t, k]]> in fp32, 0 for dropped slots."""
    rows = buf[slots.clamp_min(0).long()]                          # (T, K, d)
    dw = torch.einsum("td,tkd->tk", g.float(), rows.float())
    return torch.where(slots >= 0, dw, 0.0).to(dtype)


class _Dispatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, slots, src):
        ctx.save_for_backward(slots)
        return scatter_rows(x, src, src.shape[0])

    @staticmethod
    def backward(ctx, g):
        (slots,) = ctx.saved_tensors
        # transpose of scatter = gather: dx[t] = sum_k g[slot[t, k]]
        return gather_combine(g.contiguous(), slots), None, None


class _Combine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, buf, slots, weights, total_rows):
        ctx.save_for_backward(buf, slots, weights, total_rows)
        return gather_combine(buf, slots, weights)

    @staticmethod
    def backward(ctx, g):
        buf, slots, weights, total_rows = ctx.saved_tensors
        g = g.contiguous()
        # transpose of gather = scatter, the combine weight riding along:
        # dbuf[r] = w_flat[pos(r)] * g[token(r)]; total_rows predicates off
        # the dead rows of a prefix (ragged) layout
        pos, src = _row_side(slots, buf.shape[0])
        dbuf = scatter_rows(g, src, total_rows, _slot_weights(weights, pos))
        return dbuf, None, _weight_grad(g, buf, slots, weights.dtype), None


def dispatch_rows(x: torch.Tensor, slots: torch.Tensor, rows: int,
                  total_rows=None) -> torch.Tensor:
    """Build the (rows, d) dispatch buffer from x (T, d) and the planner's
    slot map (T, K), on the ``scatter_rows`` kernel; rows at or past
    ``total_rows`` (a prefix layout's routed load) are left empty.  Its
    backward is the ``gather_combine`` kernel."""
    _, src = _row_side(slots, rows)
    if total_rows is not None:
        live = torch.arange(rows, device=x.device) < torch.as_tensor(
            total_rows, device=x.device)
        src = torch.where(live, src, -1)
    return _Dispatch.apply(x, slots.to(torch.int32), src.to(torch.int32))


def combine_rows(buf: torch.Tensor, slots: torch.Tensor,
                 weights: Optional[torch.Tensor] = None,
                 total_rows=None) -> torch.Tensor:
    """(rows, d) -> (T, d), each token the weighted sum of its K slot rows,
    on the ``gather_combine`` kernel.  Its backward is the ``scatter_rows``
    kernel; pass ``total_rows`` for a prefix (ragged) layout so the backward
    leaves the dead rows empty."""
    T, K = slots.shape
    if weights is None:
        weights = torch.ones((T, K), dtype=buf.dtype, device=buf.device)
    total = torch.as_tensor(buf.shape[0] if total_rows is None else total_rows,
                            device=buf.device).to(torch.int32)
    return _Combine.apply(buf, slots.to(torch.int32), weights, total)


# ---------------------------------------------------------------------------
# the ragged expert FFN and the fused expert leg
# ---------------------------------------------------------------------------

def _segment_outer(a: torch.Tensor, b: torch.Tensor, b2e: torch.Tensor,
                   num_experts: int) -> torch.Tensor:
    """dw[e] = sum over the row blocks of expert e of a_blockᵀ @ b_block, in
    fp32.  The blocks are visited in order, each product added into its
    expert's slot with ``index_add_`` on a one-element device index: no
    host sync, and no (nb, K, N) tensor (9.4 GB at Mixtral's widths)."""
    nb = b2e.shape[0]
    R = a.shape[0]
    ab = a.reshape(nb, R // nb, a.shape[1])
    bb = b.reshape(nb, R // nb, b.shape[1])
    b2e = b2e.long()
    acc = torch.zeros((num_experts, a.shape[1], b.shape[1]), dtype=torch.float32,
                      device=a.device)
    for i in range(nb):
        contrib = ab[i].float().T @ bb[i].float()
        acc.index_add_(0, b2e[i:i + 1], contrib[None])
    return acc


class _FFNGrads(NamedTuple):
    dbuf: torch.Tensor      # (R, d) gradient of the FFN's input rows
    dw1: torch.Tensor
    dw3: torch.Tensor
    dw2: torch.Tensor
    a: torch.Tensor         # (R, f) the recomputed SwiGLU output, x's type


def _ffn_backward(buf: torch.Tensor, g_buf: torch.Tensor, w1: torch.Tensor,
                  w3: torch.Tensor, w2: torch.Tensor, b2e: torch.Tensor, rows,
                  block_m: int) -> _FFNGrads:
    """The backward of y = silu(buf @ w1[e]) * (buf @ w3[e]) @ w2[e] over the
    ragged layout, given dL/dy = ``g_buf``: both up-projections recomputed
    with ``ragged_matmul`` (no (R, f) tensor was saved), the elementwise
    gradient in fp32 cast to the rows' type, the row gradient through the
    transposed weights read in place, the weight gradients with
    ``_segment_outer``.  The JAX package's ragged and fused VJPs share this
    arithmetic, rounding point for rounding point."""
    E = w1.shape[0]
    dt = buf.dtype

    def mm(a, w, transpose=False):
        return ragged_matmul(a, w, b2e, rows, block_m, transpose_w=transpose)

    h1 = mm(buf, w1).float()
    h3 = mm(buf, w3).float()
    s = torch.sigmoid(h1)
    silu_h1 = h1 * s
    a = (silu_h1 * h3).to(dt)
    da = mm(g_buf, w2, True).float()
    dh3 = (da * silu_h1).to(dt)
    dh1 = (da * h3 * (s + silu_h1 * (1 - s))).to(dt)
    del h1, h3, s, silu_h1, da
    dbuf = (mm(dh1, w1, True) + mm(dh3, w3, True)).to(dt)
    dw1 = _segment_outer(buf, dh1, b2e, E).to(w1.dtype)
    dw3 = _segment_outer(buf, dh3, b2e, E).to(w3.dtype)
    dw2 = _segment_outer(a, g_buf, b2e, E).to(w2.dtype)
    return _FFNGrads(dbuf, dw1, dw3, dw2, a)


class _RaggedFFN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, w3, w2, b2e, rows, block_m):
        ctx.save_for_backward(x, w1, w3, w2, b2e, rows)
        ctx.block_m = block_m
        h = ragged_swiglu(x, w1, w3, b2e, rows, block_m)
        return ragged_matmul(h, w2, b2e, rows, block_m)

    @staticmethod
    def backward(ctx, gy):
        x, w1, w3, w2, b2e, rows = ctx.saved_tensors
        g = _ffn_backward(x, gy.contiguous(), w1, w3, w2, b2e, rows, ctx.block_m)
        return g.dbuf, g.dw1, g.dw3, g.dw2, None, None, None


def ragged_expert_ffn(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
                      w2: torch.Tensor, block_to_expert: torch.Tensor, total_rows,
                      *, block_m: int = 128) -> torch.Tensor:
    """The SwiGLU FFN over the ragged layout: x (R, d) expert-grouped,
    bm-aligned rows -> (R, d), rows at or past ``total_rows`` 0.  Forward is
    one ``ragged_swiglu`` and one ``ragged_matmul`` launch; the backward
    recomputes the up-projections (``_ffn_backward``)."""
    rows = torch.as_tensor(total_rows, device=x.device).to(torch.int32)
    return _RaggedFFN.apply(x, w1, w3, w2, block_to_expert.to(torch.int32), rows,
                            block_m)


class _FusedMoE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, w3, w2, src, wslot, slots, b2e, rows, has_weights,
                block_m):
        ctx.save_for_backward(x, w1, w3, w2, src, wslot, slots, b2e, rows)
        ctx.has_weights, ctx.block_m = has_weights, block_m
        return fused_moe(x, w1, w3, w2, src, wslot, rows, b2e)

    @staticmethod
    def backward(ctx, gy):
        x, w1, w3, w2, src, wslot, slots, b2e, rows = ctx.saved_tensors
        gy = gy.contiguous()
        # combine-bwd = dispatch kernel: dL/dy[r] = wslot[r] * gy[token(r)]
        g_buf = scatter_rows(gy, src, rows, wslot)
        # dispatch recompute: the buffer exists only inside this backward
        buf = scatter_rows(x, src, rows)
        g = _ffn_backward(buf, g_buf, w1, w3, w2, b2e, rows, ctx.block_m)
        # dispatch-bwd = combine kernel: dx[t] = sum_k dbuf[slot[t, k]]
        dx = gather_combine(g.dbuf, slots)
        d_wslot = None
        if ctx.has_weights:
            # d wslot[r] = <gy[token(r)], y[r]>: the (T, K) segment dot of
            # the combine's backward, then permuted to rows
            y_buf = ragged_matmul(g.a, w2, b2e, rows, ctx.block_m)
            dwtk = _weight_grad(gy, y_buf, slots, wslot.dtype)
            pos = invert_slots(slots, wslot.shape[0])
            d_wslot = _slot_weights(dwtk, pos)
        return (dx, g.dw1, g.dw3, g.dw2, None, d_wslot, None, None, None, None,
                None)


def moe_ffn(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor, w2: torch.Tensor,
            slots: torch.Tensor, block_to_expert: torch.Tensor, total_rows,
            weights: Optional[torch.Tensor] = None, *,
            block_m: int = 128) -> torch.Tensor:
    """The per-chunk expert leg in one ``fused_moe`` call: x (T, d) + slot
    map (T, K) -> (T, d) weighted expert-FFN combine over the ragged layout
    of ``block_to_expert`` / ``total_rows`` (R = len(block_to_expert) *
    block_m rows)."""
    R = block_to_expert.shape[0] * block_m
    T, K = slots.shape
    # the row-side maps are made outside the Function: wslot is a
    # differentiable gather of the router weights, so its gradient flows
    # back to (T, K) through autograd
    pos, src = _row_side(slots, R)
    w = (weights if weights is not None
         else torch.ones((T, K), dtype=x.dtype, device=x.device))
    wslot = _slot_weights(w, pos)
    rows = torch.as_tensor(total_rows, device=x.device).to(torch.int32)
    return _FusedMoE.apply(x, w1, w3, w2, src.to(torch.int32), wslot,
                           slots.to(torch.int32),
                           block_to_expert.to(torch.int32), rows,
                           weights is not None, block_m)
