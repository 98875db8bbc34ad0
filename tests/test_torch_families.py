"""Every architecture of the registry in the port against the JAX package,
the reference's per-architecture smoke (``tests/test_arch_smoke.py``) made
a parity test: at ``.reduced()`` sizes in fp32, parameters from the JAX
init through ``bridge.params_from_jax``, batches from both packages'
``SyntheticLMData`` (equal array for array), for each registry name:

* the forward: shapes, finiteness, logits to rtol = atol = 2e-4;
* one training step (``make_train_step`` at lr 1e-3 on the default
  strategy): loss and grad norm to 1e-4, AdamW's first moments (the
  clipped gradients) and every updated parameter to 1e-4 (router biases
  under loss-free balancing included; ``_assert_step_close`` says where
  the first update is too ill-conditioned to compare);
* one decode step from an empty cache (cross K/V from zero frames for
  the encoder-decoder): logits to 1e-4, every position advanced;
* the training launcher: two steps of the reduced config on the CPU,
  finite losses and grad norms, parameters changed.

Beside them: a config with an MoE block but no MoE layer in its depth
(Jamba cut to 1 layer, mamba/dense), and the EP fused leg at one peer
with top-1 routing and a shared expert (Llama-4-Scout) and with a dense
prefix and loss-free bias balancing (DeepSeek-mini) against the JAX
trainer on a 1x1 mesh: losses, grad norms, moments and parameters to
1e-4, chunk traces exactly."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import registry  # noqa: E402
from repro.core import moe as jmoe  # noqa: E402
from repro.core.moe import DistContext as JCtx  # noqa: E402
from repro.data.pipeline import SyntheticLMData as JData  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.training import step as jstep  # noqa: E402
from repro.training import trainer as jtrainer  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs import registry as tregistry  # noqa: E402
from repro_torch.core.moe import DistContext  # noqa: E402
from repro_torch.data.pipeline import SyntheticLMData as TData  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.optim.adamw import named_params  # noqa: E402
from repro_torch.training.step import make_train_state, make_train_step  # noqa: E402
from repro_torch.training.trainer import Trainer  # noqa: E402

CPU = torch.device("cpu")
TCTX = DistContext(device=CPU)
JCTX = JCtx()
ARCHS = sorted(registry())
LOGITS_TOL = dict(rtol=2e-4, atol=2e-4)     # the reference's own decode tolerance
TOL = dict(rtol=1e-4, atol=1e-4)
torch.set_num_threads(min(torch.get_num_threads(), 2))


def _cfgs(arch: str, **kw):
    return registry()[arch].reduced(**kw), get_config(arch).reduced(**kw)


def _batches(jc, tc, B=2, S=32):
    want = JData(jc, S, B, seed=1).batch_at(0)
    got = TData(tc, S, B, seed=1).batch_at(0)
    assert sorted(want) == sorted(got)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    return ({k: jnp.asarray(v) for k, v in want.items()},
            {k: torch.as_tensor(v).long() if v.dtype.kind == "i" else torch.as_tensor(v)
             for k, v in got.items()})


def _models(jc, tc, seed=0):
    jp = jtf.init_params(jax.random.PRNGKey(seed), jc)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), tc, CPU)


def _named(jtree, tc) -> list:
    return named_params(params_from_jax(jax.tree.map(np.asarray, jtree), tc, CPU))


def _assert_params_close(jparams, tparams, tc, mask=None):
    """Every parameter to ``TOL``; with ``mask`` (name -> bool array), only
    the masked elements."""
    want = _named(jparams, tc)
    got = dict(named_params(tparams))
    assert len(want) == len(got)
    for name, w in want:
        g, w = got[name].detach().numpy(), w.numpy()
        if mask is not None:
            g, w = g[mask[name]], w[mask[name]]
        np.testing.assert_allclose(g, w, **TOL, err_msg=name)


def _assert_step_close(jnew, tnew, tc) -> None:
    """After AdamW steps: the first moments (after one step, 0.1 times the
    clipped gradient) to rtol 1e-4 and 1e-4 of each tensor's largest; the
    parameters to ``TOL`` wherever the bias-corrected second moment's root
    is at least 1e-6.  Below that the update lr m / (sqrt(v) + 1e-8) turns
    on fp32 noise in the gradient (the two packages' gradients differ by
    ~2e-8) and may differ by up to lr."""
    names = [n for n, _ in named_params(tnew.params)]
    got_mu = dict(zip(names, tnew.opt.mu))
    nu = dict(_named(jnew.opt.nu, tc))
    bc2 = 1 - 0.95 ** int(jnew.opt.step)
    well_posed = {}
    for name, w in _named(jnew.opt.mu, tc):
        w, g = w.numpy(), got_mu[name].numpy()
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * np.abs(w).max(),
                                   err_msg=f"first moment of {name}")
        well_posed[name] = np.sqrt(nu[name].numpy() / bc2) >= 1e-6
    _assert_params_close(jnew.params, tnew.params, tc, well_posed)


def test_every_reference_architecture_is_registered():
    # beside the reference's, the port's own DeepSeek-V3 configs
    # (tests/test_torch_deepseek.py)
    assert sorted(tregistry()) == sorted([*ARCHS, "deepseek-v3", "deepseek-v3-ep32"])
    assert {c.family for c in tregistry().values()} >= {
        "hybrid", "dense", "moe", "audio", "vlm", "ssm"}


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_shapes_finite_and_match_jax(arch):
    jc, tc = _cfgs(arch)
    jp, tp = _models(jc, tc)
    jb, tb = _batches(jc, tc)
    jl, jst = jtf.forward(jp, jc, JCTX, jb)
    with torch.no_grad():
        tl, tst = ttf.forward(tp, tc, TCTX, tb)
    S = tb["labels"].shape[1]
    assert tl.shape == (2, S, tc.padded_vocab)
    assert bool(torch.isfinite(tl).all()) and bool(torch.isfinite(tst["aux_loss"]))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS_TOL)
    np.testing.assert_allclose(float(tst["aux_loss"]), float(jst["aux_loss"]), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch):
    jc, tc = _cfgs(arch)
    jstate = jstep.init_train_state(jax.random.PRNGKey(0), jc)
    tstate = make_train_state(params_from_jax(jax.tree.map(np.asarray, jstate.params),
                                              tc, CPU))
    jb, tb = _batches(jc, tc)
    jnew, jm = jax.jit(jstep.make_train_step(jc, JCTX, lr=1e-3))(jstate, jb)
    before = [p.detach().clone() for _, p in named_params(tstate.params)]
    tnew, tm = make_train_step(tc, TCTX, lr=1e-3)(tstate, tb)
    assert tnew.step == 1
    for key in ("loss", "grad_norm", "ce", "aux"):
        assert np.isfinite(float(tm[key])), key
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), **TOL, err_msg=key)
    after = [p for _, p in named_params(tnew.params)]
    assert any(not torch.equal(a, b) for a, b in zip(before, after))
    _assert_step_close(jnew, tnew, tc)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_jax(arch):
    jc, tc = _cfgs(arch)
    jp, tp = _models(jc, tc)
    j_enc = t_enc = None
    if jc.encoder_layers:
        frames = np.zeros((2, jc.encoder_seq, jc.d_model), np.float32)
        j_enc = jtf.encode(jp, jc, jnp.asarray(frames), JCTX)
        with torch.no_grad():
            t_enc = ttf.encode(tp, tc, torch.as_tensor(frames), TCTX)
    jcache = jtf.init_cache(jp, jc, 2, 16, jnp.float32, enc_out=j_enc)
    tcache = ttf.init_cache(tp, tc, 2, 16, torch.float32, CPU, enc_out=t_enc)
    jl, jcache = jtf.decode_step(jp, jc, JCTX, jcache, jnp.zeros((2, 1), jnp.int32))
    with torch.no_grad():
        tl, tcache = ttf.decode_step(tp, tc, TCTX, tcache,
                                     torch.zeros((2, 1), dtype=torch.long))
    assert tl.shape == (2, 1, tc.padded_vocab) and bool(torch.isfinite(tl).all())
    assert tcache["pos"].tolist() == [1, 1] and int(jcache["pos"]) == 1
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_trains_every_config(arch, capsys):
    """``launch/train.py --arch <any> --smoke --device cpu``: the EP fused
    leg where the config has MoE layers, the default path elsewhere."""
    moe = registry()[arch].moe is not None
    trainer, state = tlaunch.main(
        ["--arch", arch, "--smoke", "--device", "cpu", "--steps", "2",
         "--seq-len", "32", "--global-batch", "2"] + (["--ep", "--fused"] if moe else []))
    assert state.step == 2 and len(trainer.log) == 2
    for rec in trainer.log:
        assert np.isfinite(rec["loss"]) and np.isfinite(rec["grad_norm"])
    assert trainer.log[0]["loss"] != trainer.log[1]["loss"]
    assert f"final loss {trainer.log[-1]['loss']:.4f}" in capsys.readouterr().out


def test_train_step_without_moe_layers_in_the_depth():
    """Jamba cut to 1 layer keeps its MoE block but runs no MoE layer: the
    load matrix is (0, E), the aux term 0, and MACT's schedule vector
    empty; the step equals the JAX package's."""
    # the reduction of Jamba's own first layer (mamba/dense); its smoke
    # pattern starts with a mamba/MoE layer instead
    jc, tc = (dataclasses.replace(dataclasses.replace(
        c, smoke_pattern=(c.pattern[0],) * 2).reduced(), num_layers=1)
        for c in (registry()["jamba-1.5-large-398b"],
                  get_config("jamba-1.5-large-398b")))
    assert ttf.num_moe_layers(tc) == 0 and tc.moe is not None
    jstate = jstep.init_train_state(jax.random.PRNGKey(2), jc)
    tstate = make_train_state(params_from_jax(jax.tree.map(np.asarray, jstate.params),
                                              tc, CPU))
    jb, tb = _batches(jc, tc)
    jnew, jm = jax.jit(jstep.make_train_step(jc, JCTX, lr=1e-3))(jstate, jb)
    tnew, tm = make_train_step(tc, TCTX, lr=1e-3)(tstate, tb)
    assert tuple(tm["load_per_layer"].shape) == (0, tc.moe.num_experts)
    assert float(tm["aux"]) == 0.0
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), **TOL, err_msg=key)
    _assert_step_close(jnew, tnew, tc)
    trainer = Trainer(tc, DistContext(device=CPU, moe_strategy="ep_shardmap",
                                      moe_fused=True), seq_len=32, global_batch=2,
                      adaptive_mact=True)
    trainer.fit(2)
    assert trainer.schedule_trace == [] and all(np.isfinite(r["loss"])
                                                for r in trainer.log)


@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e", "deepseek-mini-8l"])
def test_fused_leg_trainer_matches_jax_on_one_peer(arch):
    """Llama-4-Scout: top-1 of its experts plus a shared expert on the fused
    leg; DeepSeek-mini: a dense prefix layer, a shared expert and loss-free
    bias balancing.  Two steps each way, MACT on."""
    jc, tc = _cfgs(arch)
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))
    jt = jtrainer.Trainer(jc, jmoe.DistContext(mesh=mesh, moe_strategy="ep_shardmap",
                                               moe_fused=True),
                          seq_len=64, global_batch=2, lr=1e-3)
    tt = Trainer(tc, DistContext(device=CPU, moe_strategy="ep_shardmap", moe_fused=True),
                 seq_len=64, global_batch=2, lr=1e-3)
    jstate = jtrainer.init_train_state(jax.random.PRNGKey(0), jc)
    tstate = make_train_state(params_from_jax(jax.tree.map(np.asarray, jstate.params),
                                              tc, CPU))
    jstate = jt.fit(2, jstate)
    tstate = tt.fit(2, tstate)
    for key in ("loss", "ce", "aux", "grad_norm", "max_load", "drops"):
        np.testing.assert_allclose([r[key] for r in tt.log], [r[key] for r in jt.log],
                                   **TOL, err_msg=key)
    assert tt.chunk_trace == jt.chunk_trace
    _assert_step_close(jstate, tstate, tc)
