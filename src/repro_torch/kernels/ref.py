"""Plain PyTorch versions of the port's kernels.

They are the CPU path of the kernel wrappers and the reference the CUDA
kernels are held against on the card.  The arithmetic matches the JAX
package's ``kernels/ref.py``, rounding point for rounding point: products
and sums in fp32 (JAX's ``preferred_element_type=float32``), the result cast
to the input type; in the FFNs ``h`` is cast to the input type *before* the
down-projection; in the fused leg the FFN output ``y`` stays fp32 through
the combine.

Layouts:

* capacity: x (..., E, M, K) against stacked weights (E, K, N);
* ragged (MegaBlocks-style): x (R, K) rows grouped by expert, every group
  padded to the row-block size bm, ``block_to_expert`` (R // bm,) naming
  each block's expert and ``total_rows`` the occupied prefix; rows at or
  past it are 0.  ``total_rows`` may be a Python int or a 0-d tensor.
* attention: q (BH, S, hd), k and v (BH, Skv, hd), heads folded into the
  leading dim and KV already repeated to the query heads.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _mm_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(..., E, M, K) @ (E, K, N) -> (..., E, M, N) in fp32."""
    return torch.matmul(x.float(), w.float())


def grouped_matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (..., E, M, K), w: (E, K, N) -> (..., E, M, N)."""
    return _mm_f32(x, w).to(x.dtype)


def grouped_swiglu_ref(x: torch.Tensor, w1: torch.Tensor,
                       w3: torch.Tensor) -> torch.Tensor:
    """silu(x @ w1) * (x @ w3), per expert group, silu in fp32."""
    return (F.silu(_mm_f32(x, w1)) * _mm_f32(x, w3)).to(x.dtype)


def expert_ffn_ref(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
                   w2: torch.Tensor) -> torch.Tensor:
    """Full per-expert SwiGLU FFN: (..., E, C, d) -> (..., E, C, d)."""
    return grouped_matmul_ref(grouped_swiglu_ref(x, w1, w3), w2)


# ---------------------------------------------------------------------------
# ragged layout
# ---------------------------------------------------------------------------

def _live_rows(R: int, total_rows, device) -> torch.Tensor:
    """(R, 1) bool: row r < total_rows."""
    total = torch.as_tensor(total_rows, device=device)
    return (torch.arange(R, device=device) < total)[:, None]


def _blocked_mm_f32(x: torch.Tensor, w: torch.Tensor,
                    block_to_expert: torch.Tensor) -> torch.Tensor:
    """Per bm-row block, x_block @ w[b2e[block]] in fp32 -> (R, N).  The
    weights are gathered per block, (nb, K, N), never per row."""
    R, K = x.shape
    nb = block_to_expert.shape[0]
    xb = x.reshape(nb, R // nb, K).float()
    wb = w.float()[block_to_expert.long()]
    return torch.bmm(xb, wb).reshape(R, -1)


def ragged_matmul_ref(x: torch.Tensor, w: torch.Tensor,
                      block_to_expert: torch.Tensor, total_rows) -> torch.Tensor:
    """x: (R, K) expert-grouped rows, w: (E, K, N) -> (R, N); rows past
    total_rows are 0."""
    out = _blocked_mm_f32(x, w, block_to_expert).to(x.dtype)
    return torch.where(_live_rows(x.shape[0], total_rows, x.device), out, 0)


def ragged_swiglu_ref(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
                      block_to_expert: torch.Tensor, total_rows) -> torch.Tensor:
    a = _blocked_mm_f32(x, w1, block_to_expert)
    b = _blocked_mm_f32(x, w3, block_to_expert)
    out = (F.silu(a) * b).to(x.dtype)
    return torch.where(_live_rows(x.shape[0], total_rows, x.device), out, 0)


def ragged_expert_ffn_ref(x: torch.Tensor, w1, w3, w2, block_to_expert,
                          total_rows) -> torch.Tensor:
    h = ragged_swiglu_ref(x, w1, w3, block_to_expert, total_rows)
    return ragged_matmul_ref(h, w2, block_to_expert, total_rows)


def segment_outer_ref(a: torch.Tensor, b: torch.Tensor, block_to_expert: torch.Tensor,
                      total_rows, out: torch.Tensor, accumulate: bool) -> torch.Tensor:
    """The expert weights' gradient over the ragged layout, into ``out``:
    a (R, K), b (R, N) -> out (E, K, N), out[e] the sum over the row blocks
    of expert e that start below ``total_rows`` of a_blockᵀ @ b_block, each
    block's product in fp32 added into its expert's fp32 sum in block order
    (the JAX package's ``_segment_outer`` scan).  ``accumulate``: out[e] =
    w(float(out[e]) + float(w(sum))), w() the cast to out's type, the JAX
    package's rounding points for a weight's cotangent summed over FCDA
    chunks; otherwise out[e] = w(sum).  Returns ``out``."""
    E = out.shape[0]
    nb = block_to_expert.shape[0]
    R = a.shape[0]
    bm = R // nb
    ab = a.reshape(nb, bm, a.shape[1])
    bb = b.reshape(nb, bm, b.shape[1])
    live = torch.arange(nb, device=a.device) * bm < torch.as_tensor(total_rows,
                                                                   device=a.device)
    # dead blocks add into a slot past the last expert, which is dropped: no
    # host sync
    eid = torch.where(live, block_to_expert.long(), E)
    acc = torch.zeros((E + 1, a.shape[1], b.shape[1]), dtype=torch.float32,
                      device=a.device)
    for i in range(nb):
        acc.index_add_(0, eid[i:i + 1], (ab[i].float().T @ bb[i].float())[None])
    total = acc[:E].to(out.dtype)
    if accumulate:
        total = (out.float() + total.float()).to(out.dtype)
    return out.copy_(total)


# ---------------------------------------------------------------------------
# dispatch / combine and the fused leg
# ---------------------------------------------------------------------------

def scatter_rows_ref(x: torch.Tensor, src: torch.Tensor, total_rows,
                     weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (T, d), src: (R,) source-row map (-1 = empty) -> (R, d):
    out[r] = weights[r] * x[src[r]] in fp32, cast to x's type; 0 where
    src < 0 or r >= total_rows."""
    R = src.shape[0]
    src = src.long()
    rows = x[src.clamp_min(0)].float()
    if weights is not None:
        rows = rows * weights[:, None].float()
    live = (src >= 0)[:, None] & _live_rows(R, total_rows, x.device)
    return torch.where(live, rows, 0.0).to(x.dtype)


def gather_combine_ref(buf: torch.Tensor, slots: torch.Tensor,
                       weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """buf: (R, d), slots: (T, K) (-1 = dropped) -> (T, d): each token the
    weighted sum of its K slot rows, accumulated slot by slot (k ascending)
    in fp32 and cast to buf's type."""
    T, K = slots.shape
    slots = slots.long()
    acc = torch.zeros((T, buf.shape[1]), dtype=torch.float32, device=buf.device)
    for k in range(K):
        s = slots[:, k]
        row = buf[s.clamp_min(0)].float()
        if weights is not None:
            row = row * weights[:, k, None].float()
        acc = acc + torch.where((s >= 0)[:, None], row, 0.0)
    return acc.to(buf.dtype)


def fused_moe_y_ref(x: torch.Tensor, w1, w3, w2, src: torch.Tensor,
                    block_to_expert: torch.Tensor, total_rows) -> torch.Tensor:
    """The fused leg's FFN output per buffer row, (R, d) in fp32: dispatch
    by ``src``, SwiGLU with h cast to x's type, down-projection kept fp32."""
    buf = scatter_rows_ref(x, src, total_rows)
    h = ragged_swiglu_ref(buf, w1, w3, block_to_expert, total_rows)
    return _blocked_mm_f32(h, w2, block_to_expert)


def fused_moe_ref(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
                  w2: torch.Tensor, src: torch.Tensor, slots: torch.Tensor,
                  block_to_expert: torch.Tensor, total_rows,
                  weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """dispatch -> SwiGLU -> down-proj -> weighted combine into (T, d).

    Each token's slots are combined in ascending buffer-row order (the TPU
    kernel walks the ragged layout front to back), accumulating the fp32 y
    rows in fp32; the sum is cast to x's type once.  Under exact arithmetic
    (integer-valued inputs, power-of-two weights) any correct evaluation
    gives these bits."""
    T = x.shape[0]
    R = src.shape[0]
    y = fused_moe_y_ref(x, w1, w3, w2, src, block_to_expert, total_rows)
    slots = slots.long()
    order = torch.argsort(torch.where(slots < 0, R, slots), dim=1, stable=True)
    ss = torch.gather(slots, 1, order)
    ww = None if weights is None else torch.gather(weights, 1, order)
    acc = torch.zeros((T, y.shape[1]), dtype=torch.float32, device=x.device)
    for k in range(ss.shape[1]):
        s = ss[:, k]
        row = y[s.clamp_min(0)]
        if ww is not None:
            row = row * ww[:, k, None].float()
        acc = acc + torch.where((s >= 0)[:, None], row, 0.0)
    return acc.to(x.dtype)


def fused_moe_rows_ref(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
                       w2: torch.Tensor, src: torch.Tensor,
                       wslot: Optional[torch.Tensor],
                       block_to_expert: torch.Tensor, total_rows) -> torch.Tensor:
    """``fused_moe_ref`` from the row side, as the fused kernel sees it:
    out[t] = sum over live rows r with src[r] == t of wslot[r] * y[r], each
    token's rows added in ascending row order in fp32, cast to x's type."""
    T, d = x.shape
    R = src.shape[0]
    y = fused_moe_y_ref(x, w1, w3, w2, src, block_to_expert, total_rows)
    if wslot is not None:
        y = y * wslot[:, None].float()
    src = src.long()
    live = (src >= 0) & _live_rows(R, total_rows, x.device)[:, 0]
    tok = torch.where(live, src, T)
    order = torch.argsort(tok, stable=True)          # by token, rows ascending
    tok_s, y_s = tok[order], y[order]
    rank = (torch.arange(R, device=x.device)
            - torch.searchsorted(tok_s, tok_s))      # position within its token
    acc = torch.zeros((T + 1, d), dtype=torch.float32, device=x.device)
    for k in range(int(rank.max()) + 1 if R else 0):
        # one row per token per k: each add is exact and in row order
        acc.index_add_(0, torch.where(rank == k, tok_s, T), y_s)
    return acc[:T].to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

#: the score of a masked (query, key) pair: finite, as in the JAX kernel, so
#: exp(s - m) never meets inf - inf
NEG_INF = -1e30


def attention_mask(S: int, Skv: int, causal: bool, window: int,
                   device=None) -> torch.Tensor:
    """(S, Skv) bool, True where query position q sees key position k:
    k <= q when causal, and k > q - window when a window is given (with or
    without causal)."""
    qpos = torch.arange(S, device=device)[:, None]
    kpos = torch.arange(Skv, device=device)[None, :]
    mask = torch.ones((S, Skv), dtype=torch.bool, device=device)
    if causal:
        mask = kpos <= qpos
    if window:
        mask = mask & (kpos > qpos - window)
    return mask


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0) -> torch.Tensor:
    """softmax(q kᵀ * hd**-0.5) v over the visible pairs: scores, softmax
    and P·V in fp32, masked scores ``NEG_INF``, the result divided by
    max(l, 1e-30) and cast to q's type.  Head slices are taken a few at a
    time, so the fp32 scores stay within ~512 MB."""
    BH, S, hd = q.shape
    Skv = k.shape[1]
    scale = hd ** -0.5
    mask = attention_mask(S, Skv, causal, window, q.device)
    out = torch.empty_like(q)
    step = max(1, (1 << 27) // max(1, S * Skv))
    for b0 in range(0, BH, step):
        sl = slice(b0, b0 + step)
        s = torch.matmul(q[sl].float(), k[sl].float().transpose(1, 2)) * scale
        s = torch.where(mask, s, NEG_INF)
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        del s
        l = p.sum(dim=-1, keepdim=True)
        o = torch.matmul(p, v[sl].float())
        out[sl] = (o / l.clamp_min(1e-30)).to(q.dtype)
    return out
