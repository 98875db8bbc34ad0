"""Mamba-2 (SSD, state-space duality) mixer -- arXiv:2405.21060.

The port's counterpart of the JAX package's ``models/ssm.py``, in its dtypes
and rounding points.  Prefill and chunk extension use the chunked SSD
algorithm: an attention-like quadratic term *within* ``chunk``-token blocks
plus a linear recurrence of the (H, P, N) state *across* blocks (the
reference's ``lax.scan``, here a loop over the chunks).  Decode is the
constant-size recurrent step on that state and a width-(w-1) tail of the
convolution's input.

Single B/C group (G = 1), scalar A per head, as the 130m reference.  The
reference writes the within-chunk term as one four-operand ``einsum``; here
it is two pairwise products, so no intermediate is larger than the
(b, nc, H, cl, cl) decay matrix.

The state is a dict ``{"ssm": (B, H, P, N), "conv": (B, w-1, d_conv)}``,
the reference's ``SSMState._asdict()``.  These functions make new tensors;
the serving cache is written in place by ``models/blocks.py``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMSpec
from repro_torch.models.layers import apply_norm


def dims(d_model: int, spec: SSMSpec):
    d_in = spec.expand * d_model
    heads = d_in // spec.head_dim
    d_conv = d_in + 2 * spec.state_dim
    return d_in, heads, d_conv


def init_ssm(normal, d_model: int, spec: SSMSpec) -> dict:
    """The reference's shapes and scales; ``normal(shape, scale)`` draws the
    matrices (``models/transformer.py::_Normal``) in the weights' type."""
    d_in, heads, d_conv = dims(d_model, spec)
    dev = normal.device
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "in_proj": normal((d_model, 2 * d_in + 2 * spec.state_dim + heads),
                          d_model ** -0.5),
        "conv_w": normal((spec.conv_width, d_conv), 0.1),
        "conv_b": torch.zeros(d_conv, dtype=normal.dtype, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, heads, **f32)),
        "D": torch.ones(heads, **f32),
        "dt_bias": torch.zeros(heads, **f32),
        "norm": {"scale": torch.ones(d_in, **f32)},
        "out_proj": normal((d_in, d_model), d_in ** -0.5),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 tail: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal convolution.  x: (B, T, C), w: (K, C); ``tail``
    (B, K-1, C) is the prepended history (zeros without one)."""
    K = w.shape[0]
    if tail is None:
        tail = x.new_zeros((x.shape[0], K - 1, x.shape[2]))
    xp = torch.cat([tail, x], dim=1)
    T = x.shape[1]
    out = xp[:, 0:T] * w[0]
    for i in range(1, K):
        out = out + xp[:, i:i + T] * w[i]
    return F.silu(out + b)


def _segsum(dA: torch.Tensor) -> torch.Tensor:
    """dA: (..., L, H) -> (..., H, L, L) with s[i, j] = sum_{j<k<=i} dA_k,
    -inf above the diagonal."""
    L = dA.shape[-2]
    csh = torch.cumsum(dA, dim=-2).movedim(-1, -2)               # (..., H, L)
    s = csh[..., :, None] - csh[..., None, :]                    # (..., H, L, L)
    mask = torch.ones((L, L), dtype=torch.bool, device=dA.device).tril()
    return s.masked_fill(~mask, float("-inf"))


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, chunk: int,
             initial_state: Optional[torch.Tensor] = None):
    """Chunked SSD.  x: (b, T, H, P); dt: (b, T, H); A: (H,) negative;
    B, C: (b, T, N).  Returns (y (b, T, H, P), final state (b, H, P, N))."""
    b, T, H, Pd = x.shape
    N = B.shape[-1]
    T0 = T
    if T % chunk:                                # pad with dt = 0: no-op steps
        pad = chunk - T % chunk
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
        T = T + pad
    nc, cl = T // chunk, chunk
    xd = x * dt[..., None]                       # dt-weighted input
    dA = dt * A                                  # (b, T, H)

    xc = xd.reshape(b, nc, cl, H, Pd)
    dAc = dA.reshape(b, nc, cl, H)
    Bc = B.reshape(b, nc, cl, N)
    Cc = C.reshape(b, nc, cl, N)

    dA_cum = torch.cumsum(dAc, dim=2)                            # (b, nc, cl, H)
    L = torch.exp(_segsum(dAc))                                  # (b, nc, H, cl, cl)
    # the reference's einsum("bcln,bcsn,bchls,bcshp->bclhp"), pairwise:
    # C.B per chunk, weighted by the decay, then against the inputs
    CB = torch.einsum("bcln,bcsn->bcls", Cc, Bc)                 # (b, nc, cl, cl)
    y_diag = torch.einsum("bchls,bcshp->bclhp", L * CB[:, :, None], xc)

    decay_states = torch.exp(dA_cum[:, :, -1:, :] - dA_cum)      # (b, nc, cl, H)
    states = torch.einsum("bcln,bclhp->bchpn", Bc,
                          xc * decay_states[..., None])          # (b, nc, H, P, N)
    chunk_decay = torch.exp(dA_cum[:, :, -1, :])                 # (b, nc, H)

    s = (initial_state if initial_state is not None
         else x.new_zeros((b, H, Pd, N)))
    prev = []
    for c in range(nc):                          # the inter-chunk recurrence
        prev.append(s)
        s = s * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                       # (b, nc, H, P, N)

    decay_out = torch.exp(dA_cum)                                # (b, nc, cl, H)
    y_off = (torch.einsum("bcln,bchpn->bclhp", Cc, prev_states)
             * decay_out[..., None])
    y = (y_diag + y_off).reshape(b, T, H, Pd)
    return y[:, :T0], s


def _split(zxbcdt: torch.Tensor, d_in: int, d_conv: int):
    return (zxbcdt[..., :d_in], zxbcdt[..., d_in:d_in + d_conv],
            zxbcdt[..., d_in + d_conv:])


def _dt_A(params: dict, dt: torch.Tensor, dtype):
    dt = F.softplus(dt.float() + params["dt_bias"]).to(dtype)
    A = (-torch.exp(params["A_log"])).to(dtype)
    return dt, A


def apply_ssm(params: dict, x: torch.Tensor, spec: SSMSpec,
              return_state: bool = False,
              initial_state: Optional[dict] = None):
    """Prefill and chunk extension.  x: (B, T, d_model) -> (B, T, d_model),
    and the state after the last token with ``return_state``.
    ``initial_state`` continues from a prefix: its conv tail is the
    prefix's pre-convolution history and the scan starts from its state."""
    d_model = x.shape[-1]
    d_in, heads, d_conv = dims(d_model, spec)
    N = spec.state_dim
    z, xBC, dt = _split(x @ params["in_proj"], d_in, d_conv)
    tail = None if initial_state is None else initial_state["conv"].to(xBC.dtype)
    hist = xBC if tail is None else torch.cat([tail, xBC], dim=1)
    conv_tail = hist[:, max(0, hist.shape[1] - (spec.conv_width - 1)):]
    xBC = _causal_conv(xBC, params["conv_w"], params["conv_b"], tail=tail)
    xs, B, C = xBC[..., :d_in], xBC[..., d_in:d_in + N], xBC[..., d_in + N:]
    dt, A = _dt_A(params, dt, x.dtype)
    xh = xs.reshape(*xs.shape[:-1], heads, spec.head_dim)
    y, final = ssd_scan(xh, dt, A, B, C, min(spec.chunk, x.shape[1]),
                        initial_state=None if initial_state is None else
                        initial_state["ssm"].to(x.dtype))
    y = y + params["D"].to(x.dtype)[:, None] * xh
    y = y.reshape(*x.shape[:-1], d_in)
    y = apply_norm(params["norm"], y * F.silu(z))
    out = y @ params["out_proj"]
    if return_state:
        pad = spec.conv_width - 1 - conv_tail.shape[1]
        if pad > 0:
            conv_tail = F.pad(conv_tail, (0, 0, pad, 0))
        return out, {"ssm": final, "conv": conv_tail}
    return out


def state_shapes(d_model: int, spec: SSMSpec) -> dict:
    """One request's state leaves: the SSD state and the conv tail."""
    d_in, heads, d_conv = dims(d_model, spec)
    return {"ssm": (heads, spec.head_dim, spec.state_dim),
            "conv": (spec.conv_width - 1, d_conv)}


def init_state(batch: int, d_model: int, spec: SSMSpec, dtype, device) -> dict:
    return {n: torch.zeros((batch,) + shape, dtype=dtype, device=device)
            for n, shape in state_shapes(d_model, spec).items()}


def decode_ssm(params: dict, x: torch.Tensor, state: dict, spec: SSMSpec):
    """Single-token decode.  x: (B, 1, d_model) -> (y, new state).

    As in the reference, the convolution and the recurrence run in the
    promotion of the activations' and the state's types (dt, A and D stay in
    the activations' type), so an fp32 state under bf16 weights keeps fp32
    at every token.  The mixer's output is cast back to the activations'
    type before the norm and ``out_proj``, as the attention mixer casts its
    output, so the residual stream stays in the weights' type; the
    reference lets it promote."""
    d_model = x.shape[-1]
    d_in, heads, d_conv = dims(d_model, spec)
    N = spec.state_dim
    z, xBC, dt = _split(x @ params["in_proj"], d_in, d_conv)
    st = torch.promote_types(x.dtype, state["ssm"].dtype)
    conv = state["conv"].to(st)
    xBC = xBC.to(st)
    new_conv = torch.cat([conv[:, 1:], xBC], dim=1) if spec.conv_width > 1 else conv
    xBC = _causal_conv(xBC, params["conv_w"], params["conv_b"], tail=conv)
    xs, B, C = xBC[..., :d_in], xBC[..., d_in:d_in + N], xBC[..., d_in + N:]
    dt, A = _dt_A(params, dt, x.dtype)
    Bsz = x.shape[0]
    xh = xs.reshape(Bsz, heads, spec.head_dim)                  # (B, H, P)
    dt1 = dt[:, 0]                                               # (B, H)
    dec = torch.exp(dt1 * A)                                     # (B, H)
    upd = (xh * dt1[..., None])[..., None] * B[:, 0, None, None, :]   # (B, H, P, N)
    s_new = state["ssm"].to(st) * dec[:, :, None, None] + upd
    y = torch.einsum("bn,bhpn->bhp", C[:, 0], s_new)
    y = y + params["D"].to(x.dtype)[:, None] * xh
    y = y.reshape(Bsz, 1, d_in).to(x.dtype)
    y = apply_norm(params["norm"], y * F.silu(z))
    return y @ params["out_proj"], {"ssm": s_new, "conv": new_conv}
