"""The peaks and the arithmetic that the work counts share.

The yardstick for the utilisation and roofline metrics is what the model
requires, not what a kernel happens to do.  Each input byte is read once
and each output byte written once; recomputation is not counted; products
are 2 FLOPs per multiply-add.  An architecture file (``arch/<arch>.py``)
counts its model's operations and bytes from its spec with these.

Peaks are the published H100 SXM figures (NVIDIA's data sheet, dense, no
sparsity): 989 TFLOP/s in bf16 and 3.35 TB/s of HBM3.  A card run below
its 700 W limit does not reach them; the harness prints the limit beside
the numbers.
"""

from __future__ import annotations

BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def least_s(flops: float, nbytes: float) -> float:
    """The least time at the peaks: the larger of the two bounds."""
    return max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S)


def causal_visible(seq: int, window: int = 0) -> float:
    """Sum over the positions of a causal sequence of the keys each sees."""
    if not window or window >= seq:
        return seq * (seq + 1) / 2
    return window * (window + 1) / 2 + (seq - window) * window
