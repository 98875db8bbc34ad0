"""Plain PyTorch pieces the references share: fp32 arithmetic, with the
matrix products in one place so that the control can run them in fp8.

Nothing here imports the program.  ``Prec`` holds the precision a
reference runs in: ``"fp32"`` (TF32 off, the reference itself) or
``"fp8"`` (the control: both operands of every matrix product rounded to
float8 e4m3 under a per-tensor scale, as an fp8 GEMM with an fp32
accumulator computes; everything between the products stays fp32).
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


def no_tf32() -> None:
    """fp32 products in fp32: TF32 off for cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to e4m3 under a per-tensor scale, back in fp32."""
    amax = t.detach().abs().amax().clamp_min(1e-30)
    s = E4M3_MAX / amax
    q = (t * s).to(torch.float8_e4m3fn).to(torch.float32) / s
    # straight-through: the rounding has no gradient of its own
    return t + (q - t).detach()


class Prec:
    def __init__(self, mode: str = "fp32"):
        if mode not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {mode!r}")
        self.mode = mode

    def cast(self, t: torch.Tensor) -> torch.Tensor:
        return _fp8(t) if self.mode == "fp8" else t

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a @ b in this precision (fp32 out)."""
        return self.cast(a.float()) @ self.cast(b.float())

    def einsum(self, eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.einsum(eq, self.cast(a.float()), self.cast(b.float()))


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale.float()


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half RoPE. x: (S, H, hd); pos: (S,)."""
    hd = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd)
    ang = pos.float()[:, None] * inv
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    a, b = x[..., : hd // 2], x[..., hd // 2:]
    return torch.cat([a * cos - b * sin, a * sin + b * cos], dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     prec: Prec, window: int = 0, block: int = 1024,
                     q_offset: int = 0) -> torch.Tensor:
    """Softmax attention of queries at positions q_offset.. against keys
    0..Sk-1, causal (and banded to ``window`` keys when it is > 0).
    q: (Sq, H, hd); k, v: (Sk, KH, hd); grouped heads share a KV head."""
    Sq, H, hd = q.shape
    Sk, KH = k.shape[0], k.shape[1]
    g = H // KH
    kk = k.repeat_interleave(g, dim=1)
    vv = v.repeat_interleave(g, dim=1)
    kpos = torch.arange(Sk, device=q.device)
    outs = []
    for s in range(0, Sq, block):
        qb = q[s:s + block]
        qpos = q_offset + s + torch.arange(qb.shape[0], device=q.device)
        hi = int(qpos[-1]) + 1
        sc = prec.einsum("qhd,khd->hqk", qb, kk[:hi]) * hd ** -0.5
        m = kpos[None, :hi] <= qpos[:, None]
        if window:
            m = m & (kpos[None, :hi] > qpos[:, None] - window)
        sc = sc.masked_fill(~m[None], float("-inf"))
        p = torch.softmax(sc, dim=-1)
        outs.append(prec.einsum("hqk,khd->qhd", p, vv[:hi]))
    return torch.cat(outs, dim=0)


def swiglu(x: torch.Tensor, w1, w3, w2, prec: Prec) -> torch.Tensor:
    return prec.mm(torch.nn.functional.silu(prec.mm(x, w1)) * prec.mm(x, w3), w2)


def moe(x: torch.Tensor, ffn: dict, top_k: int, prec: Prec):
    """Top-k softmax routing (ties to the lower expert index) and the
    weighted sum of the chosen experts' SwiGLU outputs.  x: (T, d) fp32.
    Returns (y, probs (T, E), chosen (T, k)).  Each expert's weights are
    cast to fp32 when it runs, so one expert at a time is held in fp32."""
    logits = prec.mm(x, ffn["router"]["w"])
    probs = torch.softmax(logits, dim=-1)
    chosen = torch.sort(probs.detach(), dim=-1, descending=True, stable=True).indices[:, :top_k]
    gate = torch.gather(probs, -1, chosen)
    gate = gate / gate.sum(-1, keepdim=True)
    y = torch.zeros_like(x)
    for e in range(probs.shape[-1]):
        tok, slot = torch.nonzero(chosen == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        h = swiglu(x[tok], ffn["w1"][e], ffn["w3"][e], ffn["w2"][e], prec)
        y = y.index_add(0, tok, h * gate[tok, slot][:, None])
    return y, probs, chosen
