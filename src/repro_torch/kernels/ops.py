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
* ``shared_weight_grads``: one MoE layer's gradient buffers, one per expert
  weight, shared by the layer's FCDA chunks.  Each chunk's backward adds its
  weight gradients into them with the ``segment_outer`` kernel, so a layer's
  backward holds one full-size gradient per expert weight however many
  chunks it has (the JAX package's scan transpose carries the same single
  cotangent buffer).

On CPU tensors every kernel call takes its plain version, so the same
autograd Functions run, and are tested, on the CPU.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.dispatch import invert_slots
from repro_torch.kernels.dispatch_cuda import gather_combine, scatter_rows
from repro_torch.kernels.fused_moe import fused_moe
from repro_torch.kernels.grouped_mlp import grouped_matmul, grouped_swiglu
from repro_torch.kernels.ragged_mlp import ragged_matmul, ragged_swiglu
from repro_torch.kernels.weight_grad import segment_outer


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

class WeightGrads:
    """The gradient buffers of one MoE layer's expert weights (w1, w3, w2),
    one each.  They are made when the first chunk's backward starts, so
    every chunk's backward runs beside the same buffers whatever the chunk
    count (as the scan transpose's carry in the JAX package), and filled in
    the order autograd runs the chunks' backwards: the first writes its sum
    (``segment_outer``'s write mode), each later one adds into it in the
    weight's type, the JAX package's rounding points for a cotangent summed
    over ``lax.map``'s chunks."""

    def __init__(self):
        self.dw = None
        self.filled = [False, False, False]

    def open(self, *weights: torch.Tensor) -> None:
        """Make the buffers, once, shaped and typed as the weights."""
        if self.dw is None:
            self.dw = [torch.empty_like(w) for w in weights]

    def add(self, i: int, a: torch.Tensor, b: torch.Tensor, b2e: torch.Tensor, rows,
            block_m: int) -> None:
        """Weight ``i``'s gradient from this chunk: aᵀ @ b per expert."""
        segment_outer(a, b, b2e, rows, block_m, self.dw[i],
                      accumulate=self.filled[i])
        self.filled[i] = True

    def take(self) -> list:
        """The buffers, handed over once: a second backward through a kept
        graph starts new ones instead of adding into gradients already
        handed to autograd."""
        dw, self.dw, self.filled = self.dw, None, [False, False, False]
        return dw


class _SharedGrads(torch.autograd.Function):
    """The expert weights pass through once per layer, before its chunks;
    the chunks' Functions add their weight gradients into ``grads`` and
    return none, so this backward, which autograd runs only after every
    chunk's, returns the buffers as the weights' gradients."""

    @staticmethod
    def forward(ctx, grads, w1, w3, w2):
        ctx.grads = grads
        # the chunks return no weight gradient: no zeros in their place
        ctx.set_materialize_grads(False)
        return w1.view_as(w1), w3.view_as(w3), w2.view_as(w2)

    @staticmethod
    def backward(ctx, *unused):
        return (None, *ctx.grads.take())


def shared_weight_grads(w1: torch.Tensor, w3: torch.Tensor, w2: torch.Tensor):
    """(w1, w3, w2, grads): the expert weights as the layer's chunks should
    use them, and the ``WeightGrads`` to pass to each chunk's ``moe_ffn`` or
    ``ragged_expert_ffn``.  Outside autograd, or for weights that want no
    gradient, the weights themselves and None."""
    if not (torch.is_grad_enabled() and any(w.requires_grad for w in (w1, w3, w2))):
        return w1, w3, w2, None
    grads = WeightGrads()
    return (*_SharedGrads.apply(grads, w1, w3, w2), grads)


#: the FFN backward's elementwise part runs in row slices of this many
#: elements (32 MB of fp32 per operand), so its fp32 temporaries stay at a
#: few slices instead of several (R, f) tensors
_SLICE_ELEMS = 1 << 23


def _swiglu_backward_(h1: torch.Tensor, h3: torch.Tensor, da: torch.Tensor):
    """SwiGLU's forward recompute and backward from the up-projections h1,
    h3 and dL/da, in fp32 and in place, slice by slice: h1 becomes a =
    silu(h1) * h3, h3 becomes dh1 and da becomes dh3, each cast to the
    rows' type.  The same fp32 operations in the same order as the JAX
    package's VJP, so the same bits; returns (a, dh1, dh3)."""
    step = max(1, _SLICE_ELEMS // max(1, h1.shape[1]))
    for r0 in range(0, h1.shape[0], step):
        sl = slice(r0, r0 + step)
        # copies, also in fp32: the slices are overwritten below
        x1, x3, d = (t[sl].to(torch.float32, copy=True) for t in (h1, h3, da))
        s = torch.sigmoid(x1)
        silu = x1.mul_(s)
        h1[sl] = silu * x3                               # a
        dsilu = torch.rsub(s, 1).mul_(silu).add_(s)      # s + silu (1 - s)
        h3[sl] = (d * x3).mul_(dsilu)                    # dh1 = da h3 silu'
        da[sl] = d.mul_(silu)                            # dh3 = da silu
        del x1, x3, d, s, silu, dsilu
    return h1, h3, da


def _ffn_backward(buf: torch.Tensor, g_buf: torch.Tensor, w1: torch.Tensor,
                  w3: torch.Tensor, w2: torch.Tensor, b2e: torch.Tensor, rows,
                  block_m: int, grads: WeightGrads):
    """The backward of y = silu(buf @ w1[e]) * (buf @ w3[e]) @ w2[e] over the
    ragged layout, given dL/dy = ``g_buf``: both up-projections recomputed
    with ``ragged_matmul`` (no (R, f) tensor was saved), the elementwise
    gradient in fp32 cast to the rows' type (``_swiglu_backward_``), the row
    gradient through the transposed weights read in place, the weight
    gradients added into ``grads`` with ``segment_outer``.  The JAX
    package's ragged and fused VJPs share this arithmetic, rounding point
    for rounding point.  Returns (dbuf (R, d), a (R, f) the recomputed
    SwiGLU output in the rows' type)."""
    dt = buf.dtype

    def mm(a, w, transpose=False):
        return ragged_matmul(a, w, b2e, rows, block_m, transpose_w=transpose)

    grads.open(w1, w3, w2)
    a, dh1, dh3 = _swiglu_backward_(mm(buf, w1), mm(buf, w3), mm(g_buf, w2, True))
    dbuf = (mm(dh1, w1, True) + mm(dh3, w3, True)).to(dt)
    grads.add(0, buf, dh1, b2e, rows, block_m)
    grads.add(1, buf, dh3, b2e, rows, block_m)
    grads.add(2, a, g_buf, b2e, rows, block_m)
    return dbuf, a


def _chunk_grads(ctx):
    """The chunk's weight-gradient target: the layer's shared buffers, or,
    for a call outside an EP layer, buffers of its own that it returns."""
    return ctx.grads if ctx.grads is not None else WeightGrads()


def _returned(ctx, grads: WeightGrads) -> list:
    """The weight gradients a chunk Function returns: none when they went
    into the layer's shared buffers (returning them too would count them
    twice), else its own."""
    return [None, None, None] if grads is ctx.grads else grads.take()


class _RaggedFFN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, w3, w2, b2e, rows, block_m, grads):
        ctx.save_for_backward(x, w1, w3, w2, b2e, rows)
        ctx.block_m, ctx.grads = block_m, grads
        h = ragged_swiglu(x, w1, w3, b2e, rows, block_m)
        return ragged_matmul(h, w2, b2e, rows, block_m)

    @staticmethod
    def backward(ctx, gy):
        x, w1, w3, w2, b2e, rows = ctx.saved_tensors
        grads = _chunk_grads(ctx)
        dx, _ = _ffn_backward(x, gy.contiguous(), w1, w3, w2, b2e, rows, ctx.block_m,
                              grads)
        return (dx, *_returned(ctx, grads), None, None, None, None)


def ragged_expert_ffn(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
                      w2: torch.Tensor, block_to_expert: torch.Tensor, total_rows,
                      *, block_m: int = 128,
                      grads: Optional[WeightGrads] = None) -> torch.Tensor:
    """The SwiGLU FFN over the ragged layout: x (R, d) expert-grouped,
    bm-aligned rows -> (R, d), rows at or past ``total_rows`` 0.  Forward is
    one ``ragged_swiglu`` and one ``ragged_matmul`` launch; the backward
    recomputes the up-projections (``_ffn_backward``).  ``grads``: the
    layer's shared weight-gradient buffers (``shared_weight_grads``), which
    the backward adds into instead of returning the weights' gradients."""
    rows = torch.as_tensor(total_rows, device=x.device).to(torch.int32)
    return _RaggedFFN.apply(x, w1, w3, w2, block_to_expert.to(torch.int32), rows,
                            block_m, grads)


class _FusedMoE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, w3, w2, src, wslot, slots, b2e, rows, has_weights,
                block_m, grads):
        ctx.save_for_backward(x, w1, w3, w2, src, wslot, slots, b2e, rows)
        ctx.has_weights, ctx.block_m, ctx.grads = has_weights, block_m, grads
        return fused_moe(x, w1, w3, w2, src, wslot, rows, b2e)

    @staticmethod
    def backward(ctx, gy):
        x, w1, w3, w2, src, wslot, slots, b2e, rows = ctx.saved_tensors
        gy = gy.contiguous()
        # combine-bwd = dispatch kernel: dL/dy[r] = wslot[r] * gy[token(r)]
        g_buf = scatter_rows(gy, src, rows, wslot)
        # dispatch recompute: the buffer exists only inside this backward
        buf = scatter_rows(x, src, rows)
        grads = _chunk_grads(ctx)
        dbuf, a = _ffn_backward(buf, g_buf, w1, w3, w2, b2e, rows, ctx.block_m, grads)
        # dispatch-bwd = combine kernel: dx[t] = sum_k dbuf[slot[t, k]]
        dx = gather_combine(dbuf, slots)
        d_wslot = None
        if ctx.has_weights:
            # d wslot[r] = <gy[token(r)], y[r]>: the (T, K) segment dot of
            # the combine's backward, then permuted to rows
            y_buf = ragged_matmul(a, w2, b2e, rows, ctx.block_m)
            dwtk = _weight_grad(gy, y_buf, slots, wslot.dtype)
            pos = invert_slots(slots, wslot.shape[0])
            d_wslot = _slot_weights(dwtk, pos)
        return (dx, *_returned(ctx, grads), None, d_wslot, None, None, None, None,
                None, None)


def moe_ffn(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor, w2: torch.Tensor,
            slots: torch.Tensor, block_to_expert: torch.Tensor, total_rows,
            weights: Optional[torch.Tensor] = None, *,
            block_m: int = 128, grads: Optional[WeightGrads] = None) -> torch.Tensor:
    """The per-chunk expert leg in one ``fused_moe`` call: x (T, d) + slot
    map (T, K) -> (T, d) weighted expert-FFN combine over the ragged layout
    of ``block_to_expert`` / ``total_rows`` (R = len(block_to_expert) *
    block_m rows).  ``grads``: the layer's shared weight-gradient buffers
    (``shared_weight_grads``), which the backward adds into instead of
    returning the weights' gradients."""
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
                           weights is not None, block_m, grads)
