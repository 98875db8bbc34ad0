"""The port's tile autotuner (``repro_torch.kernels.autotune``) and tile
selection (``repro_torch.kernels.tiling``) against the JAX package's
modules: the cache's round trip, a corrupt and a missing file (the
reference's own cases, ``tests/test_fused_moe.py``), ``pick_block`` and
``choose_block`` over a grid of dims and preferences with primes,
``matmul_candidates`` and ``cache_key`` for the same inputs, the measured
search with a fake kernel closure, ``resolve_tiles``' precedence, the
runtime row tile's legality rule, and the CPU wrappers' outputs, which no
cache entry may change."""

import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels import autotune as jautotune  # noqa: E402
from repro.kernels import tiling as jtiling  # noqa: E402
from repro_torch.kernels import autotune, tiling  # noqa: E402
from repro_torch.kernels.fused_moe import fused_moe  # noqa: E402
from repro_torch.kernels.ragged_mlp import (ragged_matmul, row_tile,  # noqa: E402
                                            tuned_row_tile)
from repro_torch.kernels.weight_grad import segment_outer  # noqa: E402

torch.set_num_threads(min(torch.get_num_threads(), 2))


@pytest.fixture
def cache_file(tmp_path):
    path = str(tmp_path / "autotune.json")
    autotune.set_cache_path(path)
    yield path
    autotune.set_cache_path(None)


def test_the_cache_has_its_own_file_and_variable(tmp_path, monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE_CACHE", raising=False)
    assert autotune.cache_path().endswith("repro_torch/autotune.json")
    assert autotune.cache_path() != jautotune.DEFAULT_CACHE
    path = str(tmp_path / "c.json")
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", path)
    assert autotune.cache_path() == path
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "jax.json"))
    assert autotune.cache_path() == path
    assert autotune.device_kind() == "cpu"


def test_cache_round_trip(cache_file):
    shape, dtype = (24, 16, 16, 4, 8), torch.float32
    assert autotune.lookup("fused_moe", shape, dtype) is None
    autotune.record("fused_moe", shape, dtype, {"tm": 64}, time_ms=1.0)
    assert autotune.lookup("fused_moe", shape, dtype) == {"tm": 64}
    # a fresh load from disk (not the in-process view) sees the entry too
    autotune.set_cache_path(cache_file)
    assert autotune.lookup("fused_moe", shape, dtype) == {"tm": 64}
    with open(cache_file) as f:
        entry = json.load(f)[autotune.cache_key("fused_moe", shape, dtype)]
    assert entry == {"tiles": {"tm": 64}, "time_ms": 1.0, "baseline_ms": None,
                     "spread_ms": None}
    # the cached winner beats the defaults, an explicit value beats both
    assert tiling.resolve_tiles("fused_moe", shape, dtype, {"tm": 128}) == {"tm": 64}
    assert tiling.resolve_tiles("fused_moe", shape, dtype, {"tm": 128},
                                {"tm": 128}) == {"tm": 128}
    assert tiling.resolve_tiles("fused_moe", shape, dtype, {"tm": 128},
                                {"tm": None}) == {"tm": 64}
    # a name the defaults do not have is not added; another shape is a miss
    autotune.record("fused_moe", shape, dtype, {"tm": 64, "bn": 8})
    assert tiling.resolve_tiles("fused_moe", shape, dtype, {"tm": 128}) == {"tm": 64}
    assert tiling.resolve_tiles("fused_moe", (1, 2), dtype, {"tm": 128}) == {"tm": 128}


def test_corrupt_cache_falls_back(cache_file):
    with open(cache_file, "w") as f:
        f.write("{not json !!")
    assert autotune.load_cache(cache_file) == {}
    assert autotune.lookup("fused_moe", (1, 2), torch.float32) is None
    assert tiling.resolve_tiles("fused_moe", (1, 2), torch.float32,
                                {"tm": 128}) == {"tm": 128}
    # recording over a corrupt file heals it
    autotune.record("op", (1, 2), torch.float32, {"tm": 8})
    with open(cache_file) as f:
        assert "op|1x2" in json.dumps(json.load(f))


def test_missing_cache_is_empty(tmp_path):
    autotune.set_cache_path(str(tmp_path / "nope" / "autotune.json"))
    try:
        assert autotune.lookup("x", (1,), torch.float32) is None
        assert tiling.resolve_tiles("x", (1,), torch.float32, {"tm": 8}) == {"tm": 8}
    finally:
        autotune.set_cache_path(None)


def test_a_failing_lookup_gives_the_defaults(monkeypatch):
    def broken(*a, **k):
        raise OSError("unreadable")
    monkeypatch.setattr(autotune, "lookup", broken)
    assert tiling.resolve_tiles("x", (1,), torch.float32, {"tm": 8}) == {"tm": 8}


DIMS = (1, 2, 7, 8, 24, 64, 100, 127, 128, 131, 257, 1000, 1009, 4096)
PREFS = (1, 8, 32, 64, 128, 512)


@pytest.mark.parametrize("pref", PREFS)
def test_pick_and_choose_block_match_the_reference(pref):
    for dim in DIMS:
        assert tiling.pick_block(dim, pref) == jtiling.pick_block(dim, pref)
        got, want = tiling.choose_block(dim, pref), jtiling.choose_block(dim, pref)
        assert tuple(got) == tuple(want) and got.grid == want.grid
        assert got.padded % got.block == 0 and got.padded >= dim
    for dim in (131, 257, 1009):                       # primes past the block
        if 8 <= pref < dim:
            assert tiling.pick_block(dim, pref) == 1
            assert tiling.choose_block(dim, pref).block == pref
    with pytest.raises(ValueError):
        tiling.choose_block(0, pref)


@pytest.mark.parametrize("mnk", [(1, 1, 1), (8, 8, 8), (24, 100, 16), (128, 4096, 14336),
                                 (5120, 14336, 4096), (3, 1000, 257)])
def test_matmul_candidates_match_the_reference(mnk):
    assert autotune.matmul_candidates(*mnk) == jautotune.matmul_candidates(*mnk)
    assert (autotune.matmul_candidates(*mnk, sizes=(64, 128), cap=3)
            == jautotune.matmul_candidates(*mnk, sizes=(64, 128), cap=3))


@pytest.mark.parametrize("tdtype,jdtype", [(torch.float32, jnp.float32),
                                           (torch.bfloat16, jnp.bfloat16),
                                           ("float32", "float32"),
                                           (np.float32, np.float32)])
def test_cache_key_matches_the_reference(tdtype, jdtype):
    for op, shape in (("fused_moe", (5120, 14336, 4096, 8, 128)),
                      ("segment_outer", (3072, 5120, 8192, 16, 128)), ("x", ())):
        assert (autotune.cache_key(op, shape, tdtype, "NVIDIA_H100_80GB_HBM3")
                == jautotune.cache_key(op, shape, jdtype, "NVIDIA_H100_80GB_HBM3"))
    assert autotune.cache_key("x", (1,), tdtype).endswith("|cpu")


def _fake(times: dict, outs: dict, calls: list):
    """make_fn over fake kernels: tile tm sleeps times[tm] seconds and
    returns outs[tm]; a tile missing from ``times`` fails to build."""
    import time

    def make_fn(tm):
        if tm not in times:
            raise RuntimeError(f"tile {tm} does not build")

        def fn():
            calls.append(tm)
            time.sleep(times[tm])
            return outs[tm]
        return fn
    return make_fn


def test_autotune_measures_skips_refuses_and_persists(cache_file):
    out = torch.arange(6, dtype=torch.float32)
    other = out.clone()
    other[3] = -other[3]
    calls = []
    make_fn = _fake({128: 0.004, 64: 0.0005, 32: 0.0001},
                    {128: out, 64: out.clone(), 32: other}, calls)
    res = autotune.autotune("segment_outer", (8, 16, 16, 2, 8), torch.bfloat16, make_fn,
                            [{"tm": 64}, {"tm": 16}, {"tm": 32}],
                            baseline={"tm": 128}, blocks=3, repeats=2)
    assert calls[0] == 128                       # the baseline runs first
    assert [c for c, _ in res.table] == [{"tm": 128}, {"tm": 64}]
    assert res.skipped == [{"tm": 16}]           # fails to build: skipped
    assert res.refused == [{"tm": 32}]           # faster, but another output
    assert calls.count(32) == 1                  # refused after its warm call
    assert res.winner == {"tm": 64} and res.baseline == {"tm": 128}
    assert res.baseline_ms > res.winner_ms and res.speedup_vs_baseline > 1
    assert calls.count(64) == 1 + 3 * 2          # warm, then blocks x repeats
    assert autotune.lookup("segment_outer", (8, 16, 16, 2, 8), torch.bfloat16) == {"tm": 64}
    entry = autotune.load_cache(cache_file)[
        autotune.cache_key("segment_outer", (8, 16, 16, 2, 8), torch.bfloat16)]
    assert entry["time_ms"] == res.winner_ms and entry["baseline_ms"] == res.baseline_ms


def test_autotune_keeps_the_baseline_when_it_wins_and_need_not_persist(cache_file):
    calls = []
    make_fn = _fake({128: 0.0, 64: 0.003}, {128: None, 64: None}, calls)
    res = autotune.autotune("op", (1,), torch.float32, make_fn, [{"tm": 64}, {"tm": 128}],
                            baseline={"tm": 128}, persist=False)
    assert calls[0] == 128 and res.winner == {"tm": 128}
    assert res.speedup_vs_baseline == 1.0
    assert autotune.lookup("op", (1,), torch.float32) is None
    res = autotune.autotune("op", (1,), torch.float32, make_fn, [{"tm": 64}],
                            persist=False)
    assert res.baseline is None and res.speedup_vs_baseline is None


@pytest.mark.parametrize("blocks,winner", [
    # tm 64's median 1.00 beats 1.10 by more than either's spread (0.02)
    ({128: (1.09, 1.10, 1.11), 64: (0.99, 1.00, 1.01)}, 64),
    # by 0.10, inside the default's spread of 0.30: the default stays
    ({128: (0.90, 1.10, 1.20), 64: (0.99, 1.00, 1.01)}, 128),
    # inside the candidate's own spread of 0.30
    ({128: (1.09, 1.10, 1.11), 64: (0.70, 1.00, 1.00)}, 128)])
def test_autotune_keeps_the_default_within_the_block_spread(cache_file, monkeypatch,
                                                            blocks, winner):
    """A candidate wins only by more than the spread of the block times, and
    the cache keeps the margin it had to beat."""
    made = {}
    block = {tm: iter(ts) for tm, ts in blocks.items()}
    monkeypatch.setattr(autotune, "_min_time", lambda fn, repeats, device: next(block[fn.tm]))

    def make_fn(tm):
        fn = made[tm] = lambda: torch.zeros(2)
        fn.tm = tm
        return fn
    res = autotune.autotune("ragged_matmul", (8, 8, 8, 1, 8), torch.bfloat16, make_fn,
                            [{"tm": 64}], baseline={"tm": 128}, blocks=3)
    assert res.winner == {"tm": winner}
    spread = max(max(ts) - min(ts) for ts in blocks.values())
    np.testing.assert_allclose(res.spread_ms, spread * 1e3)
    assert [c for c, _ in res.table] == [{"tm": 128}, {"tm": 64}]
    assert autotune.lookup("ragged_matmul", (8, 8, 8, 1, 8), torch.bfloat16) == {"tm": winner}
    entry = autotune.load_cache(cache_file)[
        autotune.cache_key("ragged_matmul", (8, 8, 8, 1, 8), torch.bfloat16)]
    np.testing.assert_allclose(entry["spread_ms"], spread * 1e3)


def test_autotune_raises_when_nothing_runs(cache_file):
    with pytest.raises(RuntimeError, match="no candidate ran"):
        autotune.autotune("op", (1,), torch.float32, _fake({}, {}, []),
                          [{"tm": 64}, {"tm": 128}], baseline={"tm": 32})
    assert autotune.lookup("op", (1,), torch.float32) is None


def test_bit_equal_sees_one_bit():
    a = torch.tensor([0.0, 1.0, float("nan")])
    assert autotune.bit_equal(a, a.clone())
    assert not autotune.bit_equal(a, torch.tensor([-0.0, 1.0, float("nan")]))
    assert not autotune.bit_equal(a, a.double())
    assert autotune.bit_equal((a, None), (a.clone(), None))
    assert not autotune.bit_equal(np.zeros(2), np.zeros(3))


def test_the_runtime_row_tile_takes_only_a_legal_cached_tile(cache_file):
    # the defaults: today's rule
    for bm in (8, 32, 64, 128, 256, 192):
        assert tuned_row_tile("ragged_matmul", (1024, 16, 16, 2, bm), bm) == row_tile(
            bm, wide=True)
    for bm, cached, want in ((128, 64, 64), (256, 64, 64), (64, 128, 64), (192, 128, 64),
                             (32, 64, 32), (32, 128, 32), (128, 96, 128), (128, 128, 128)):
        shape = (1024, 16, 16, 2, bm)
        autotune.record("ragged_matmul", shape, torch.bfloat16, {"tm": cached})
        assert tuned_row_tile("ragged_matmul", shape, bm) == want, (bm, cached)
    # segment_outer: 128 rows of K only when K > 64
    for K, cached, want in ((128, 64, 64), (4096, 64, 64), (64, 128, 64), (4096, 32, 128)):
        shape = (512, K, 16, 2, 128)
        autotune.record("segment_outer", shape, torch.bfloat16, {"tm": cached})
        default = 128 if K > 64 else 64
        assert tiling.resolve_tm("segment_outer", shape, torch.bfloat16, default,
                                 (64, 128) if K > 64 else (64,)) == want


def _ragged_case(seed=0, R=512, bm=128, E=3, K=64, N=32):
    rng = np.random.default_rng(seed)
    b2e = torch.as_tensor(np.sort(rng.integers(0, E, R // bm)).astype(np.int32))
    x = torch.as_tensor(rng.standard_normal((R, K)).astype(np.float32))
    w = torch.as_tensor(rng.standard_normal((E, K, N)).astype(np.float32))
    return x, w, b2e, R - bm // 2


def test_cpu_wrappers_ignore_the_cache(cache_file):
    """On a CPU tensor the plain versions run whatever the cache holds: a
    cache that names every tile the kernels could take gives the same
    output, bit for bit."""
    x, w, b2e, total = _ragged_case()
    R, K = x.shape
    E, _, N = w.shape
    f = 48
    rng = np.random.default_rng(1)
    h, w1, w3, w2 = (torch.as_tensor(rng.standard_normal(s).astype(np.float32))
                     for s in ((R, f), (E, K, f), (E, K, f), (E, f, K)))
    src = torch.arange(R, dtype=torch.int32)

    def run():
        return (ragged_matmul(x, w, b2e, total, 128),
                ragged_matmul(x, w.transpose(1, 2).contiguous(), b2e, total, 128,
                              transpose_w=True),
                fused_moe(x, w1, w3, w2, src, None, total, b2e),
                segment_outer(x, h, b2e, total, 128, torch.zeros(E, K, f), accumulate=False))
    want = run()
    for dt in (torch.float32, torch.bfloat16):
        for op, shape in (("ragged_matmul", (R, K, N, E, 128)),
                          ("ragged_matmul_t", (R, K, N, E, 128)),
                          ("fused_moe", (R, f, K, E, 128)),
                          ("segment_outer", (R, K, f, E, 128))):
            autotune.record(op, shape, dt, {"tm": 64})
    assert autotune.bit_equal(run(), want)


def test_autotune_refuses_a_candidate_that_writes_one_buffer_otherwise(cache_file):
    """A closure that writes one output buffer in place returns the same
    tensor for every candidate: the check holds a copy of the baseline's
    output, so a candidate writing other values is still refused."""
    buf = torch.zeros(4)

    def make_fn(tm):
        def fn():
            buf.fill_(float(tm == 64))
            return buf
        return fn
    res = autotune.autotune("op", (4,), torch.float32, make_fn, [{"tm": 64}],
                            baseline={"tm": 128}, persist=False)
    assert res.refused == [{"tm": 64}] and res.winner == {"tm": 128}
