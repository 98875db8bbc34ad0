"""Tile-size selection for the port's kernels.

The JAX package's ``kernels/tiling.py`` with its names and semantics:

* ``pick_block``: the largest divisor of a dimension no bigger than the
  preferred block (degrades to 1 on primes);
* ``choose_block``: keep the preferred block and pad the dimension instead
  when the best divisor is degenerate (under half the achievable block);
* ``resolve_tiles``: the tile preferences of one kernel call, resolved
  through the measured autotuner's cache (``kernels/autotune.py``).

Of the port's kernels, three take a tile at run time: the bf16 Hopper
``ragged_matmul``, ``fused_moe``'s down pass and ``segment_outer`` each
take a row tile ``tm`` of 64 or 128 (``kernels/ragged_mlp.py``,
``kernels/fused_moe.py``, ``kernels/weight_grad.py``).  Each wrapper asks
``resolve_tiles`` with today's rule as the default, and replaces a tile its
kernel cannot take at the call's shape by the default, so a cached winner
stays legal on any shape.  The others have their tiles compiled in.
"""

from __future__ import annotations

from typing import NamedTuple


def pick_block(dim: int, preferred: int) -> int:
    """Largest divisor of ``dim`` that is <= preferred; 1 on primes past it."""
    b = min(preferred, dim)
    while dim % b:
        b -= 1
    return max(b, 1)


class BlockChoice(NamedTuple):
    """A legal (block, padded_dim) pair: ``block`` divides ``padded``, and
    ``padded - dim`` is the tail a kernel's wrapper pads and cuts off."""
    block: int
    padded: int

    @property
    def grid(self) -> int:
        return self.padded // self.block


def choose_block(dim: int, preferred: int) -> BlockChoice:
    """A block for ``dim`` targeting ``preferred``: the best divisor when it
    is at least half the achievable block (min(preferred, dim)), unpadded;
    otherwise the achievable block, with ``dim`` padded up to a multiple."""
    if dim <= 0:
        raise ValueError(f"dimension must be positive, got {dim}")
    target = min(max(preferred, 1), dim)
    b = pick_block(dim, preferred)
    if 2 * b >= target:
        return BlockChoice(b, dim)
    return BlockChoice(target, -(-dim // target) * target)


def resolve_tiles(op: str, shape: tuple, dtype, defaults: dict,
                  explicit: dict | None = None) -> dict:
    """The named tiles of one kernel call.  Per name: an ``explicit`` value
    that is not None, else the autotuner's cached winner for (op, shape,
    dtype, device kind), else ``defaults``.  A failed cache lookup gives the
    defaults and never raises; the lookup reads the in-process view of the
    cache and never touches the device."""
    out = dict(defaults)
    try:
        from repro_torch.kernels.autotune import lookup
        cached = lookup(op, shape, dtype)
    except Exception:
        cached = None
    if cached:
        for k in out:
            if k in cached:
                out[k] = int(cached[k])
    if explicit:
        for k, v in explicit.items():
            if v is not None:
                out[k] = int(v)
    return out


def resolve_tm(op: str, shape: tuple, dtype, default: int, legal,
               explicit: int | None = None) -> int:
    """The row tile ``tm`` of a call with a runtime tile: ``resolve_tiles``'
    choice (``explicit`` first) when the kernel takes it (``legal``), else
    ``default``."""
    tm = resolve_tiles(op, shape, dtype, {"tm": default}, {"tm": explicit})["tm"]
    return tm if tm in legal else default
