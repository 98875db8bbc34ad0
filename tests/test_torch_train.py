"""The port's training slice against the JAX package: the memory model and
MACT (values and choices equal), AdamW, the data pipeline, and the trainer
on the EP strategy at one peer with the fused leg against the JAX trainer
on a 1x1 mesh (``use_pallas=False``): losses to 1e-4, chunk and pipeline
traces exactly, parameters after step 1 to 1e-4."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import registry  # noqa: E402
from repro.configs.base import HardwareProfile as JHardwareProfile  # noqa: E402
from repro.core import mact as jmact  # noqa: E402
from repro.core import memory_model as jmm  # noqa: E402
from repro.core import moe as jmoe  # noqa: E402
from repro.data.pipeline import SyntheticLMData as JData  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.training import trainer as jtrainer  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import H100_80G, get_config  # noqa: E402
from repro_torch.core import mact as tmact  # noqa: E402
from repro_torch.core import memory_model as tmm  # noqa: E402
from repro_torch.core.moe import DistContext  # noqa: E402
from repro_torch.data.pipeline import SyntheticLMData as TData  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.training.step import make_train_state  # noqa: E402
from repro_torch.training.trainer import Trainer  # noqa: E402

CPU = torch.device("cpu")
# the suite runs several test processes on one host; PyTorch's default of a
# thread per core in each of them oversubscribes the cores many times over
torch.set_num_threads(min(torch.get_num_threads(), 2))
J_H100 = JHardwareProfile(H100_80G.name, H100_80G.hbm_bytes, H100_80G.peak_flops,
                          H100_80G.hbm_bw, H100_80G.ici_bw, H100_80G.alpha)


def _cfgs(full: bool, layers: int = 2):
    j, t = registry()["mixtral-8x7b"], get_config("mixtral-8x7b")
    if not full:
        return j.reduced(), t.reduced()
    return (dataclasses.replace(j, num_layers=layers),
            dataclasses.replace(t, num_layers=layers))


@pytest.mark.parametrize("full,seq,b,e", [(False, 64, 2, 1), (True, 2048, 2, 1),
                                          (True, 4096, 1, 4), (True, 2048, 8, 8)])
def test_memory_model_matches_jax(full, seq, b, e):
    jc, tc = _cfgs(full)
    jpar, tpar = jmm.Parallelism(e=e, b=b), tmm.Parallelism(e=e, b=b)
    jd, td = jmm.LayerDims.from_config(jc), tmm.LayerDims.from_config(tc)
    st_j, st_t = jmm.static_bytes(jc, jpar), tmm.static_bytes(tc, tpar)
    assert st_t == st_j
    assert tmm.worst_case_s_prime(seq, tpar, td.topk) == jmm.worst_case_s_prime(
        seq, jpar, jd.topk)
    assert tmm.m_g(tpar) == jmm.m_g(jpar)
    for fused in (False, True):
        sj = jmm.s_prime_max(jd, seq, jpar, J_H100, st_j, fused=fused)
        assert tmm.s_prime_max(td, seq, tpar, H100_80G, st_t, fused=fused) == sj
        for chunks, depth in ((1, 1), (2, 2), (8, 2)):
            kw = dict(chunks=chunks, pipeline_depth=depth, fused=fused)
            a_j = jmm.activation_bytes(jd, seq, 5000.0, jpar, **kw)
            assert tmm.activation_bytes(td, seq, 5000.0, tpar, **kw) == a_j
            assert tmm.fits(st_t, a_j, H100_80G) == jmm.fits(st_j, a_j, J_H100)
        for s_pp in (1.0, 8192.0, 3e5):
            for depth in (1, 2):
                assert (tmm.optimal_chunks(s_pp, sj, depth)
                        == jmm.optimal_chunks(s_pp, sj, depth))


@pytest.mark.parametrize("full,layers,seq,b", [(False, 2, 64, 2), (True, 2, 2048, 2),
                                               (True, 3, 2048, 2), (True, 1, 4096, 4)])
def test_mact_matches_jax(full, layers, seq, b):
    """Cold start and observed loads, both depths, fused or not: the same
    s'_max, choices, history and memory reports.  At 3 full-width layers
    nothing fits the card's budget and both pick the largest bin."""
    jc, tc = _cfgs(full, layers)
    rng = np.random.default_rng(layers + seq)
    E = tc.moe.num_experts
    for fused in (False, True):
        jm = jmact.MACTController(jc, jmm.Parallelism(b=b), J_H100, seq, fused=fused)
        tm = tmact.MACTController(tc, tmm.Parallelism(b=b), H100_80G, seq, fused=fused)
        assert tm.s_prime_max() == jm.s_prime_max()
        assert tm.schedule_space(2) == tuple(tuple(s) for s in jm.schedule_space(2))
        loads = [None] + [rng.integers(0, 4 * seq * b, E) for _ in range(3)]
        for load in loads:
            for depth in (1, 2):
                assert (tm.choose_schedule(load, 1, max_depth=depth)
                        == jm.choose_schedule(load, 1, max_depth=depth))
            assert tm.choose(load) == jm.choose(load)
        assert tm.history == jm.history
        assert tm.optimal_c(9000.0) == jm.optimal_c(9000.0)
        assert tm.snap(3) == jm.snap(3) and tm.snap(99) == jm.snap(99)
        assert tm.memory_report(8192.0, 2, 2) == jm.memory_report(8192.0, 2, 2)
    if full and layers == 2 and seq == 2048:
        assert tm.choose_schedule(None, 1, max_depth=2) == (2, 2)


def test_adamw_matches_jax():
    """Two steps (the first unclipped, the second clipped) against the JAX
    AdamW; a missing gradient updates as a zero one."""
    rng = np.random.default_rng(0)
    shapes = [(8, 4), (5,), (3, 2, 2)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jp = list(map(jnp.asarray, params))
    tp = [torch.from_numpy(p.copy()) for p in params]
    jst, tst = jadamw.adamw_init(jp), tadamw.adamw_init(tp)
    for scale in (0.1, 3.0):
        grads = [rng.standard_normal(s).astype(np.float32) * scale for s in shapes]
        jp, jst, jm = jadamw.adamw_update(list(map(jnp.asarray, grads)), jst, jp, lr=1e-2)
        tst, tm = tadamw.adamw_update([torch.from_numpy(g) for g in grads], tst, tp,
                                      lr=1e-2)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=1e-6)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
    assert tst.step == 2 and all(m.dtype == torch.float32 for m in tst.mu)
    twin = tadamw.AdamWState(2, [m.clone() for m in tst.mu], [v.clone() for v in tst.nu])
    twin_p = [p.clone() for p in tp]
    g = [torch.ones(s) for s in shapes]
    tadamw.adamw_update([g[0], None, g[2]], tst, tp, lr=1e-2)
    tadamw.adamw_update([g[0], torch.zeros(shapes[1]), g[2]], twin, twin_p, lr=1e-2)
    for a, b in zip(tp, twin_p):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_synthetic_data_matches_jax():
    jc, tc = _cfgs(False)
    for step in (0, 5):
        want = JData(jc, 32, 3, seed=4).batch_at(step)
        got = TData(tc, 32, 3, seed=4).batch_at(step)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(got[k], want[k])


def test_trainer_matches_jax_on_one_peer():
    """Two steps of the reduced Mixtral on the EP strategy at one peer with
    the fused leg and MACT on: the same losses, schedules and parameters."""
    jc, tc = _cfgs(False)
    seq, batch = 64, 2
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))
    jt = jtrainer.Trainer(jc, jmoe.DistContext(mesh=mesh, moe_strategy="ep_shardmap",
                                               moe_fused=True),
                          seq_len=seq, global_batch=batch, lr=1e-3, hw=J_H100)
    tt = Trainer(tc, DistContext(device=CPU, moe_strategy="ep_shardmap", moe_fused=True),
                 seq_len=seq, global_batch=batch, lr=1e-3)
    jstate = jtrainer.init_train_state(jax.random.PRNGKey(0), jc)
    tstate = make_train_state(params_from_jax(jax.tree.map(np.asarray, jstate.params),
                                              tc, CPU))
    jstate = jt.fit(1, jstate)
    tstate = tt.fit(1, tstate)
    got = params_from_jax(jax.tree.map(np.asarray, jstate.params), tc, CPU)
    flat_j = tadamw.named_params(got)
    flat_t = dict(tadamw.named_params(tstate.params))
    assert len(flat_j) == len(flat_t)
    for name, want in flat_j:
        np.testing.assert_allclose(flat_t[name].detach().numpy(), want.numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    jt.fit(1, jstate)
    tt.fit(1, tstate)
    np.testing.assert_allclose([r["loss"] for r in tt.log], [r["loss"] for r in jt.log],
                               rtol=1e-4, atol=1e-4)
    for key in ("ce", "aux", "grad_norm", "max_load", "drops"):
        np.testing.assert_allclose([r[key] for r in tt.log], [r[key] for r in jt.log],
                                   rtol=1e-4, atol=1e-4, err_msg=key)
    assert tt.chunk_trace == jt.chunk_trace
    assert tt.pipeline_trace == jt.pipeline_trace == [2, 2]
