"""Encoder-decoder, patch and learned-position inputs in the port against
the JAX package: ``whisper-small`` (an encoder over seeded frame
embeddings, cross attention in every decoder layer, LayerNorm with a bias,
learned positions) and ``internvl2-76b`` (seeded patch embeddings ahead of
the tokens), at ``.reduced()`` sizes in fp32, weights from the JAX init
through ``bridge.params_from_jax``.

The cases are the reference's for these configs: the full model's forward
and decode (``tests/test_models.py:140-168``), single-pass prefill against
the token-by-token replay (``tests/test_serving.py:24-33``), the schedulers'
refusal (``:366-370``), paged decode with cross K/V in the state block
(``tests/test_paging.py:238-268``) and the modality stubs of the data
pipeline (``tests/test_substrate.py:69-77``); and the port's own contracts:
per-row learned positions, cross K/V only read after prefill, the cosine
schedule.

Tolerances: logits against JAX rtol = atol = 2e-4 (the reference's own for
decode against forward); caches and steps against JAX 1e-4.  Prefill
against replay, paged against slot map, and token streams are exact."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import registry  # noqa: E402
from repro.core.moe import DistContext as JCtx  # noqa: E402
from repro.data.pipeline import SyntheticLMData as JData  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.optim.schedule import cosine_schedule as j_cosine  # noqa: E402
from repro.serving import engine as jeng  # noqa: E402
from repro.serving import paged_cache as jpc  # noqa: E402
from repro_torch.bridge import cache_from_jax, params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.moe import DistContext  # noqa: E402
from repro_torch.data.pipeline import SyntheticLMData as TData  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.optim.schedule import cosine_schedule  # noqa: E402
from repro_torch.serving import engine as teng  # noqa: E402
from repro_torch.serving import paged_cache as tpc  # noqa: E402
from repro_torch.serving.paged_scheduler import PagedScheduler  # noqa: E402
from repro_torch.serving.scheduler import (ContinuousBatchingScheduler,  # noqa: E402
                                           ServeConfig)

CPU = torch.device("cpu")
TCTX = DistContext(device=CPU)
JCTX = JCtx()
LOGITS_TOL = dict(rtol=2e-4, atol=2e-4)
TOL = dict(rtol=1e-4, atol=1e-4)
WHISPER, VLM = "whisper-small", "internvl2-76b"
torch.set_num_threads(min(torch.get_num_threads(), 2))
_j_decode = jax.jit(jtf.decode_step, static_argnums=(1, 2))
_j_extend = jax.jit(jtf.extend_step, static_argnums=(1, 2))


def _setup(arch: str, layers: int = 0, seed: int = 0, **over):
    jc, tc = registry()[arch].reduced(), get_config(arch).reduced()
    if layers:
        over["num_layers"] = layers
    jc, tc = dataclasses.replace(jc, **over), dataclasses.replace(tc, **over)
    jp = jtf.init_params(jax.random.PRNGKey(seed), jc)
    return jc, tc, jp, params_from_jax(jax.tree.map(np.asarray, jp), tc, CPU)


def _inputs(cfg, B: int, S: int, seed: int = 1) -> dict:
    """Seeded tokens, and the config's frames or patches, as numpy."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.encoder_layers:
        b["frames"] = rng.standard_normal((B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.num_patch_tokens:
        b["patches"] = rng.standard_normal((B, cfg.num_patch_tokens,
                                            cfg.d_model)).astype(np.float32)
    return b


def _j(b: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in b.items()}


def _t(b: dict) -> dict:
    return {k: torch.as_tensor(v).long() if k == "tokens" else torch.as_tensor(v)
            for k, v in b.items()}


# ---------------------------------------------------------------------------
# the full model: forward, decode (tests/test_models.py:140-168)
# ---------------------------------------------------------------------------

def test_whisper_forward_matches_jax_and_decode_matches_forward():
    jc, tc, jp, tp = _setup(WHISPER, layers=4)
    B, S = 2, 32
    b = _inputs(tc, B, S)
    jl, _ = jtf.forward(jp, jc, JCTX, _j(b))
    with torch.no_grad():
        tl, _ = ttf.forward(tp, tc, TCTX, _t(b))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS_TOL)
        enc = ttf.encode(tp, tc, _t(b)["frames"], TCTX)
        np.testing.assert_allclose(enc.numpy(), np.asarray(
            jtf.encode(jp, jc, jnp.asarray(b["frames"]), JCTX)), **TOL)
        cache = ttf.init_cache(tp, tc, B, S, torch.float32, CPU, enc_out=enc)
        toks = _t(b)["tokens"]
        for i in range(S):
            logits, cache = ttf.decode_step(tp, tc, TCTX, cache, toks[:, i:i + 1])
    np.testing.assert_allclose(logits[:, 0].numpy(), tl[:, -1].numpy(), **LOGITS_TOL)


def test_internvl_prefill_with_patches_and_greedy_decode_match_jax():
    """The reference skips its decode check for patch inputs; the port is
    held against the JAX package's own prefill and decode instead: the
    cache counts the patch positions, the greedy streams are equal."""
    jc, tc, jp, tp = _setup(VLM, layers=4)
    B, S = 2, 24
    b = _inputs(tc, B, S)
    n = tc.num_patch_tokens
    cache_len = S + n + 8
    jl, _, jcache = jtf.forward(jp, jc, JCTX, _j(b), return_cache=True,
                                cache_len=cache_len)
    tl, tcache = teng.prefill(tp, tc, TCTX, _t(b), cache_len)
    assert tl.shape == (B, 1, tc.padded_vocab)
    assert tcache["pos"].tolist() == [S + n] * B == [int(jcache["pos"])] * B
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl[:, -1:]), **LOGITS_TOL)
    jnext, tnext = jnp.argmax(jl[:, -1], -1), tl[:, -1].argmax(-1)
    with torch.no_grad():
        for _ in range(6):
            assert tnext.tolist() == np.asarray(jnext).tolist()
            jl, jcache = _j_decode(jp, jc, JCTX, jcache, jnext[:, None].astype(jnp.int32))
            tl, tcache = ttf.decode_step(tp, tc, TCTX, tcache, tnext[:, None])
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS_TOL)
            jnext, tnext = jnp.argmax(jl[:, -1], -1), tl[:, -1].argmax(-1)


def test_whisper_generate_matches_jax():
    jc, tc, jp, tp = _setup(WHISPER)
    b = _inputs(tc, 2, 12)
    want = jeng.generate(jp, jc, JCTX, _j(b), 8, 24)
    got = teng.generate(tp, tc, TCTX, _t(b), 8, 24)
    assert got.tolist() == np.asarray(want).tolist()


# ---------------------------------------------------------------------------
# serving: prefill against replay, extension, the schedulers' refusal
# (tests/test_serving.py:24-33, 366-370)
# ---------------------------------------------------------------------------

def test_whisper_prefill_matches_replay_bit_for_bit_and_jax():
    jc, tc, jp, tp = _setup(WHISPER)
    S = 24
    b = _inputs(tc, 2, S)
    cache_len = S + 8
    lr, cr = teng.prefill_replay(tp, tc, TCTX, _t(b), cache_len)
    lp, cp = teng.prefill(tp, tc, TCTX, _t(b), cache_len)
    assert cp["pos"].tolist() == cr["pos"].tolist() == [S, S]
    assert all("cross_k" in layer and "cross_v" in layer for layer in cp["layers"])
    for a, c in zip(teng.leaves(cr), teng.leaves(cp)):
        assert a.shape == c.shape and torch.equal(a, c)
    assert torch.equal(lr, lp)
    jlp, jcp = jeng.prefill(jp, jc, JCTX, _j(b), cache_len)
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), **LOGITS_TOL)
    want = cache_from_jax(jax.tree.map(np.asarray, jcp), tc, 2, CPU)
    for a, c in zip(teng.leaves(want), teng.leaves(cp)):
        np.testing.assert_allclose(c.numpy(), a.numpy(), **TOL)


def test_whisper_extend_matches_jax_and_leaves_cross_kv_unwritten():
    """Extension and decode read the cross K/V the prefill wrote, and
    write neither (their tensors' versions do not move)."""
    jc, tc, jp, tp = _setup(WHISPER)
    b = _inputs(tc, 2, 16)
    jl, jc_cache = jeng.prefill(jp, jc, JCTX, _j(b), 40)
    _, cache = teng.prefill(tp, tc, TCTX, _t(b), 40)
    cross = [layer[n] for layer in cache["layers"] for n in ("cross_k", "cross_v")]
    versions = [t._version for t in cross]
    snap = [t.clone() for t in cross]
    chunk = np.random.default_rng(5).integers(0, tc.vocab_size, (2, 8)).astype(np.int32)
    jl, jc_cache = _j_extend(jp, jc, JCTX, jc_cache, jnp.asarray(chunk))
    with torch.no_grad():
        tl, cache = ttf.extend_step(tp, tc, TCTX, cache, torch.as_tensor(chunk).long())
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS_TOL)
        nxt = np.asarray([[3], [4]], np.int32)
        jl, jc_cache = _j_decode(jp, jc, JCTX, jc_cache, jnp.asarray(nxt))
        tl, cache = ttf.decode_step(tp, tc, TCTX, cache, torch.as_tensor(nxt).long())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS_TOL)
    assert cache["pos"].tolist() == [25, 25]
    assert [t._version for t in cross] == versions
    assert all(torch.equal(a, c) for a, c in zip(cross, snap))


def test_learned_positions_are_read_per_row_and_clamped_to_the_table():
    """A decode batch whose rows sit at different positions gives each row
    the logits it gets alone, and alone the JAX package's; past the table's
    end the last row is read, as the reference clamps it."""
    jc, tc, jp, tp = _setup(WHISPER, learned_pos=20)
    b = _inputs(tc, 2, 12)
    enc = ttf.encode(tp, tc, _t(b)["frames"], TCTX).detach()
    rows = []
    with torch.no_grad():
        for r, start in enumerate((3, 18)):
            cache = ttf.init_cache(tp, tc, 1, 32, torch.float32, CPU,
                                   enc_out=enc[r:r + 1])
            cache["pos"].fill_(start)
            jcache = jtf.init_cache(jp, jc, 1, 32, jnp.float32,
                                    enc_out=jnp.asarray(enc[r:r + 1].numpy()))
            jcache["pos"] = jnp.int32(start)
            out = []
            for t in range(4):                  # the second row runs past 20
                tok = torch.tensor([[7 + t]])
                lg, cache = ttf.decode_step(tp, tc, TCTX, cache, tok)
                jl, jcache = _j_decode(jp, jc, JCTX, jcache, jnp.asarray(tok.numpy(), jnp.int32))
                np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **LOGITS_TOL)
                out.append(lg)
            rows.append(torch.cat(out, 1))
        cache = ttf.init_cache(tp, tc, 2, 32, torch.float32, CPU, enc_out=enc)
        cache["pos"].copy_(torch.tensor([3, 18]))
        both = []
        for t in range(4):
            lg, cache = ttf.decode_step(tp, tc, TCTX, cache, torch.full((2, 1), 7 + t))
            both.append(lg)
    both = torch.cat(both, 1)
    for r in range(2):
        np.testing.assert_allclose(both[r].numpy(), rows[r][0].numpy(), **LOGITS_TOL)


@pytest.mark.parametrize("arch", [WHISPER, VLM])
def test_schedulers_and_serve_launcher_reject_encoder_and_patch_configs(arch, monkeypatch):
    tc = get_config(arch).reduced()
    tp = ttf.init_params(tc, device=CPU, seed=0)
    for cls, kw in ((ContinuousBatchingScheduler, {}), (PagedScheduler, {"page_size": 8})):
        with pytest.raises(ValueError, match="encoder"):
            cls(tp, tc, TCTX, ServeConfig(**kw))

    def built(*a, **k):
        raise AssertionError("the launcher built weights before refusing")
    monkeypatch.setattr(ttf, "init_params", built)
    with pytest.raises(ValueError, match="encoder"):
        tserve.main(["--arch", arch, "--smoke", "--device", "cpu"])


# ---------------------------------------------------------------------------
# paged decode with cross K/V in the state block (tests/test_paging.py:238-268)
# ---------------------------------------------------------------------------

def test_paged_decode_enc_dec_cross_attention():
    """The reference's case: a 16-token prefill installed in a 2-slot pool
    of 8-token pages, three decode steps bit-equal to the slot map's
    decode over the same cache (slot 1 empty), and equal to the JAX
    package's paged wave; then a spill and restore of the request (cross
    K/V included) decodes on bit for bit; the allocator audits clean."""
    jc, tc, jp, tp = _setup(WHISPER)
    toks = (np.arange(16, dtype=np.int32)[None] % tc.vocab_size)
    frames = np.asarray(jax.random.normal(jax.random.PRNGKey(2),
                                          (1, tc.encoder_seq, tc.d_model)))
    b = {"tokens": toks, "frames": frames}
    _, cache = teng.prefill(tp, tc, TCTX, _t(b), 24)
    _, jcache = jeng.prefill(jp, jc, JCTX, _j(b), 24)
    enc_zero = torch.zeros((1, tc.encoder_seq, tc.d_model))
    pool = tpc.PagedCachePool(tp, tc, TCTX, 2, 24, 8)
    jpool = jpc.PagedCachePool(jp, jc, JCTX, 2, 24, 8, enc_out=jnp.asarray(enc_zero.numpy()))
    assert pool.layout.state_bytes(2) == jpool.layout.state_bytes(2) > 0
    rp, jrp = pool.ops.new_request(), jpool.ops.new_request()
    pool.install(rp, cache, 16)
    jpool.install(jrp, jcache, 16)
    empty = ttf.init_cache(tp, tc, 1, 24, torch.float32, CPU, enc_out=enc_zero)
    ref = {"pos": torch.cat([cache["pos"], empty["pos"]]),
           "layers": teng._fill(cache["layers"], iter(
               [torch.cat([a, e]) for a, e in zip(teng.leaves(cache["layers"]),
                                                  teng.leaves(empty["layers"]))]))}
    tok = 7
    with torch.no_grad():
        for step in range(3):
            pos = np.asarray([16 + step, 0], np.int64)
            ref_logits, ref = ttf.decode_step(tp, tc, TCTX, ref,
                                              torch.tensor([[tok], [0]]))
            ref["pos"][1] = 0                  # the empty slot stays at 0
            pool.prepare_decode_write(rp, 16 + step)
            got = pool.decode_wave(tp, [rp, None], pos, np.asarray([[tok], [0]]))
            assert torch.equal(got[0], ref_logits[0])
            jpool.prepare_decode_write(jrp, 16 + step)
            jgot = jpool.decode_wave(jp, [jrp, None], pos.astype(np.int32),
                                     np.asarray([[[tok]], [[0]]], np.int32))
            np.testing.assert_allclose(got[0].numpy(),
                                       np.asarray(jgot[0]).reshape(got[0].shape),
                                       **LOGITS_TOL)
            tok = int(ref_logits[0, -1].argmax())
        saved = pool.spill(rp)
        pool.alloc.audit()
        rp = pool.restore(saved)
        pool.prepare_decode_write(rp, 19)
        got = pool.decode_wave(tp, [rp, None], np.asarray([19, 0]), np.asarray([[tok], [0]]))
        ref_logits, ref = ttf.decode_step(tp, tc, TCTX, ref, torch.tensor([[tok], [0]]))
    assert torch.equal(got[0], ref_logits[0])
    pool.release(rp)
    pool.alloc.audit()


# ---------------------------------------------------------------------------
# the data pipeline's modality stubs (tests/test_substrate.py:69-77)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [VLM, WHISPER])
def test_batches_equal_the_reference_array_for_array(arch):
    jc, tc = registry()[arch].reduced(), get_config(arch).reduced()
    for step in (0, 3):
        want = JData(jc, 32, 2, seed=5).batch_at(step)
        got = TData(tc, 32, 2, seed=5).batch_at(step)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if tc.num_patch_tokens:
        assert got["patches"].shape == (2, tc.num_patch_tokens, tc.d_model)
        assert got["labels"].shape == (2, 32)
        assert (got["labels"][:, :tc.num_patch_tokens] == -1).all()
    else:
        assert got["frames"].shape == (2, tc.encoder_seq, tc.d_model)


# ---------------------------------------------------------------------------
# the learning-rate schedule (optim/schedule.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("warmup", [0, 4])
def test_cosine_schedule_matches_jax(warmup):
    total = 20
    for step in range(total + 6):
        kw = dict(peak_lr=3e-4, warmup_steps=warmup, total_steps=total)
        np.testing.assert_allclose(cosine_schedule(step, **kw),
                                   float(j_cosine(step, **kw)), rtol=1e-6, atol=0)
