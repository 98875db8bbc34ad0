"""Flash attention forward: the CUDA kernel's wrapper.

``flash_attention`` computes softmax(q kᵀ * hd**-0.5) v over the visible
(query, key) pairs, causal and/or within a sliding window, in the JAX
package's layout: heads folded into the leading dim, KV already repeated to
the query heads.  On a CUDA tensor it launches a kernel of
``csrc/flash_attention.cu``, picked by dtype alone: bf16 runs the Hopper
kernel (TMA, an mbarrier ring, wgmma, the softmax in registers), fp32 the
simple FMA kernel.  On a CPU tensor it computes the plain version of
``kernels/ref.py``.  It counts its kernel launches in ``.launches``.

As in the JAX package, no model calls it: it is a kernel with its plain
version, held against the JAX kernel by the tests.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _cuda, ref

_HD_MAX = 128


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (BH, S, hd); k, v: (BH, Skv, hd) -> (BH, S, hd) in q's type.

    Key position j is visible from query position i when j <= i (causal)
    and j > i - window (a window, with or without causal).  Every query row
    must see at least one key: a row that sees none (only possible when
    S >= Skv + window) is refused, since the TPU kernel's output there
    depends on its block shapes."""
    if q.dim() != 3 or k.shape != v.shape or k.dim() != 3 or (
            k.shape[0], k.shape[2]) != (q.shape[0], q.shape[2]):
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}; expected (BH, S, hd) and (BH, Skv, hd)")
    BH, S, hd = q.shape
    Skv = k.shape[1]
    if window < 0:
        raise ValueError(f"flash_attention: window={window} must be >= 0")
    if (window and S >= Skv + window) or (S and not Skv):
        raise ValueError(f"flash_attention: with window={window} and Skv={Skv}, "
                         f"some query rows see no key")
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    op = "flash_attention"
    if hd % 8 or hd > _HD_MAX:
        raise ValueError(f"{op}: hd={hd} must be a multiple of 8, at most {_HD_MAX}")
    _cuda.no_autograd(op, (q, k, v), "the kernel is forward only")
    _cuda.operands(op, (q, k, v), q.dtype, q.device)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    _cuda.launch("flash_attention", f"{op}_{_cuda.SUFFIX[q.dtype]}",
                 [q, k, v, out, BH, S, Skv, hd, int(causal), int(window),
                  float(hd ** -0.5)], q.device)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
