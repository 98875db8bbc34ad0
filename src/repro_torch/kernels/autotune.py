"""Measured tile autotuner for the port's kernels.

The JAX package's ``kernels/autotune.py`` in PyTorch.  Kernels declare
which tile names they take and a default (``kernels/tiling.py``); this
module finds winners and remembers them.

* **Search**: ``autotune`` times a caller-built kernel closure over a grid
  of candidate tiles with the paired-block method: every candidate is warmed
  once, then the candidates are timed interleaved in blocks (the minimum
  over repeats within a block, the median across blocks per candidate), so
  a drift of the machine hits every candidate alike.  The default tiles win
  unless another candidate beats them by more than the spread of the block
  times.  A candidate that fails
  to build or launch is skipped.  A candidate whose output differs from the
  baseline's in one bit is refused: a cached winner must never change a
  result.  On a card the closure is timed with CUDA events, so the time is
  the kernel's and not its launch's.
* **Persistence**: winners are kept per (op, shape, dtype, device kind) in
  a JSON file, ``REPRO_TORCH_AUTOTUNE_CACHE`` or
  ``~/.cache/repro_torch/autotune.json`` (not the JAX package's file: the
  two name the same ops with other tiles).  The wrappers with a runtime tile
  read it through ``tiling.resolve_tiles``; a missing or corrupt file is an
  empty cache, and the defaults apply.

Search on the card at the shapes a run gives the kernels with
``chip_smoke.py`` (its tile checks), or by hand::

    from repro_torch.kernels import autotune
    res = autotune.autotune("segment_outer", (R, K, N, E, bm), torch.bfloat16,
                            make_fn, [{"tm": 64}, {"tm": 128}],
                            baseline={"tm": 128}, device=a.device)
"""

from __future__ import annotations

import functools
import json
import os
import statistics
import time
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

DEFAULT_CACHE = os.path.join(os.path.expanduser("~"), ".cache", "repro_torch",
                             "autotune.json")
_ENV = "REPRO_TORCH_AUTOTUNE_CACHE"

# the in-process view of the cache file, read once per path
_cache: Optional[dict] = None
_cache_from: Optional[str] = None


def cache_path() -> str:
    return os.environ.get(_ENV, DEFAULT_CACHE)


def set_cache_path(path: Optional[str]) -> None:
    """Point the process at another cache file; ``None`` restores the
    environment's or the default."""
    global _cache, _cache_from
    if path is None:
        os.environ.pop(_ENV, None)
    else:
        os.environ[_ENV] = path
    _cache, _cache_from = None, None


def load_cache(path: Optional[str] = None) -> dict:
    """The JSON cache; a missing, unreadable or corrupt file is empty."""
    path = path or cache_path()
    try:
        with open(path) as f:
            data = json.load(f)
        return data if isinstance(data, dict) else {}
    except (OSError, ValueError):
        return {}


def save_cache(cache: dict, path: Optional[str] = None) -> None:
    """Write the cache whole, by an atomic rename."""
    path = path or cache_path()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(cache, f, indent=2, sort_keys=True)
    os.replace(tmp, path)


@functools.lru_cache(maxsize=None)
def device_kind() -> str:
    """The card's name with spaces as ``_``, or ``cpu`` without a card."""
    import torch
    if not torch.cuda.is_available():
        return "cpu"
    return torch.cuda.get_device_name().replace(" ", "_")


def _dtype_name(dtype) -> str:
    name = getattr(dtype, "__name__", None) or getattr(dtype, "name", None)
    return str(name or dtype).removeprefix("torch.")


def cache_key(op: str, shape: Sequence[int], dtype, kind: str | None = None) -> str:
    return "|".join([op, "x".join(str(int(s)) for s in shape), _dtype_name(dtype),
                     kind or device_kind()])


def _loaded() -> dict:
    global _cache, _cache_from
    path = cache_path()
    if _cache is None or _cache_from != path:
        _cache = load_cache(path)
        _cache_from = path
    return _cache


def lookup(op: str, shape: Sequence[int], dtype) -> Optional[dict]:
    """The cached winner's tiles for this (op, shape, dtype, device kind),
    or None."""
    entry = _loaded().get(cache_key(op, shape, dtype))
    return (dict(entry["tiles"]) if isinstance(entry, dict) and "tiles" in entry
            else None)


def record(op: str, shape: Sequence[int], dtype, tiles: dict, *,
           time_ms: Optional[float] = None,
           baseline_ms: Optional[float] = None,
           spread_ms: Optional[float] = None) -> None:
    """Persist a winner and refresh the in-process view."""
    cache = _loaded()
    cache[cache_key(op, shape, dtype)] = {
        "tiles": {k: int(v) for k, v in tiles.items()},
        "time_ms": time_ms, "baseline_ms": baseline_ms, "spread_ms": spread_ms,
    }
    save_cache(cache)


# ---------------------------------------------------------------------------
# measured search
# ---------------------------------------------------------------------------

@dataclass
class AutotuneResult:
    op: str
    winner: dict                      # the winning tiles
    winner_ms: float
    baseline: Optional[dict]          # the default tiles, if given
    baseline_ms: Optional[float]
    spread_ms: float                  # the margin a winner had to beat the default by
    table: list = field(default_factory=list)     # [(tiles, median ms)]
    skipped: list = field(default_factory=list)   # failed to build or launch
    refused: list = field(default_factory=list)   # output not bit-equal

    @property
    def speedup_vs_baseline(self) -> Optional[float]:
        if self.baseline_ms is None:
            return None
        return self.baseline_ms / self.winner_ms


def bit_equal(a, b) -> bool:
    """Two outputs (tensors, arrays, tuples of them, or None) equal bit for
    bit: same type, shape and bits."""
    import numpy as np
    import torch
    if isinstance(a, (tuple, list)):
        return (isinstance(b, (tuple, list)) and len(a) == len(b)
                and all(bit_equal(x, y) for x, y in zip(a, b)))
    if isinstance(a, torch.Tensor):
        def bits(t):
            return t.reshape(-1).contiguous().view(torch.uint8)
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and a.shape == b.shape and a.device == b.device
                and bool(torch.equal(bits(a), bits(b))))
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and a.shape == b.shape and a.tobytes() == b.tobytes())
    return a == b


def _kept(out):
    """``out`` as the check holds it: tensors copied, so a closure that
    writes one buffer in place cannot compare the buffer with itself."""
    import torch
    if isinstance(out, (tuple, list)):
        return type(out)(_kept(o) for o in out)
    return out.clone() if isinstance(out, torch.Tensor) else out


def _min_time(fn: Callable, repeats: int, device) -> float:
    """The least seconds of ``repeats`` calls: CUDA events around each call
    on a card, the host clock otherwise."""
    best = float("inf")
    if device is not None and getattr(device, "type", device) == "cuda":
        import torch
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        for _ in range(repeats):
            start.record()
            fn()
            stop.record()
            stop.synchronize()
            best = min(best, start.elapsed_time(stop) / 1e3)
        return best
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def autotune(op: str, shape: Sequence[int], dtype,
             make_fn: Callable[..., Callable[[], object]],
             candidates: Sequence[dict], *, baseline: Optional[dict] = None,
             blocks: int = 3, repeats: int = 3, persist: bool = True,
             device=None, same: Callable = bit_equal) -> AutotuneResult:
    """Measure ``candidates`` and persist the winner for (op, shape, dtype,
    device kind).

    ``make_fn(**tiles)`` returns a closure that runs the kernel and returns
    its output.  ``baseline`` (the default tiles) goes first, added when it is
    not among the candidates, so the winner is never slower than the default on
    the measurements that chose it; and the default stays the winner unless the
    fastest median beats the default's by more than the spread (the largest
    less the least block time) of either's blocks, so noise is never cached.
    Each candidate is warmed once; its warm output must be ``same`` as the
    first runnable candidate's (the baseline's, when it runs), or the
    candidate is refused.  ``device``:
    the card the closures run on (timed with CUDA events), or None (the host
    clock).  Raises RuntimeError when no candidate ran."""
    cands = [dict(c) for c in candidates]
    if baseline is not None:
        if baseline in cands:
            cands.remove(baseline)
        cands.insert(0, dict(baseline))

    runnable: list[tuple[dict, Callable]] = []
    skipped: list[dict] = []
    refused: list[dict] = []
    want = None
    for c in cands:
        try:
            fn = make_fn(**c)
            out = fn()                                 # build + warm
        except Exception:
            skipped.append(c)
            continue
        if not runnable:
            want = _kept(out)                          # the baseline, if it ran
        elif not same(out, want):
            refused.append(c)
            continue
        runnable.append((c, fn))
    del want
    if not runnable:
        raise RuntimeError(f"autotune({op}): no candidate ran")

    times: dict[int, list[float]] = {i: [] for i in range(len(runnable))}
    for _ in range(blocks):                        # interleaved: paired blocks
        for i, (_, fn) in enumerate(runnable):
            times[i].append(_min_time(fn, repeats, device))
    medians = [statistics.median(times[i]) for i in range(len(runnable))]
    win = min(range(len(runnable)), key=medians.__getitem__)
    spread = max(times[win]) - min(times[win])

    base_ms = None
    base = next((i for i, (c, _) in enumerate(runnable) if c == baseline), None)
    if base is not None:
        base_ms = medians[base] * 1e3
        # a winner must beat the default by more than the block times' spread
        spread = max(spread, max(times[base]) - min(times[base]))
        if medians[base] - medians[win] <= spread:
            win = base
    result = AutotuneResult(
        op=op, winner=dict(runnable[win][0]), winner_ms=medians[win] * 1e3,
        baseline=baseline, baseline_ms=base_ms, spread_ms=spread * 1e3,
        table=[(dict(c), m * 1e3) for (c, _), m in zip(runnable, medians)],
        skipped=skipped, refused=refused)
    if persist:
        record(op, shape, dtype, result.winner, time_ms=result.winner_ms,
               baseline_ms=base_ms, spread_ms=result.spread_ms)
    return result


def matmul_candidates(M: int, N: int, K: int, *,
                      sizes: Sequence[int] = (32, 64, 128, 256, 512),
                      cap: int = 24) -> list[dict]:
    """A bounded (bm, bn, bk) grid for matmul-shaped ops: every size <= twice
    the dim, deduplicated, largest first, cut to ``cap``."""
    def opts(dim):
        out = [s for s in sizes if s <= 2 * dim]
        return out or [min(sizes)]
    cands, seen = [], set()
    for bm in opts(M):
        for bn in opts(N):
            for bk in opts(K):
                key = (min(bm, 2 * M), min(bn, 2 * N), min(bk, 2 * K))
                if key in seen:
                    continue
                seen.add(key)
                cands.append({"bm": bm, "bn": bn, "bk": bk})
    cands.sort(key=lambda c: -(c["bm"] * c["bn"] * c["bk"]))
    return cands[:cap]
