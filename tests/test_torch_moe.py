"""The port's router, dispatch planner and MoE layer against the JAX package.

Integer outputs (chosen experts, slots, loads, drops) must be exactly equal,
ties included; float outputs agree to fp32 tolerance (1e-5)."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import registry  # noqa: E402
from repro.core import dispatch as jdsp  # noqa: E402
from repro.core import moe as jmoe  # noqa: E402
from repro.core import router as jrouter  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import dispatch as tdsp  # noqa: E402
from repro_torch.core import moe as tmoe  # noqa: E402
from repro_torch.core import router as trouter  # noqa: E402

CPU = torch.device("cpu")


def test_top_k_breaks_ties_like_jax():
    """torch.topk picks [1, 7, 5] here; jax.lax.top_k picks [1, 3, 5]."""
    scores = np.array([[.25, .5, .25, .5, .25, .5, .1, .5]], np.float32)
    _, want = jax.lax.top_k(jnp.asarray(scores), 3)
    got = trouter.top_k(torch.from_numpy(scores), 3)
    assert got.tolist() == np.asarray(want).tolist() == [[1, 3, 5]]


def _router_case(seed, T, d, E, ties):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, d)).astype(np.float32)
    w = (rng.standard_normal((d, E)) * d ** -0.5).astype(np.float32)
    if ties:                         # duplicate expert columns -> tied scores
        w[:, E // 2:] = w[:, :E - E // 2]
    return x, {"w": w, "bias": np.zeros(E, np.float32)}


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("E,k", [(8, 2), (4, 2), (8, 3)])
def test_route_matches_jax(E, k, ties):
    cfg = get_config("mixtral-8x7b").moe
    cfg = dataclasses.replace(cfg, num_experts=E, top_k=k)
    x, p = _router_case(E + k, 24, 32, E, ties)
    want = jrouter.route({k_: jnp.asarray(v) for k_, v in p.items()},
                         jnp.asarray(x), cfg)
    got = trouter.route({k_: torch.from_numpy(v) for k_, v in p.items()},
                        torch.from_numpy(x), cfg)
    assert got.expert_idx.tolist() == np.asarray(want.expert_idx).tolist()
    assert got.load.tolist() == np.asarray(want.load).tolist()
    np.testing.assert_allclose(got.weights.numpy(), np.asarray(want.weights),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.aux_loss.item(), float(want.aux_loss),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("T,k,E,cap", [(16, 2, 4, 16), (24, 2, 8, 4),
                                       (7, 3, 8, 2), (32, 1, 4, 8)])
def test_unified_plan_matches_jax(T, k, E, cap):
    """Dropless and clipped capacities; skewed ids so several experts
    overflow the clipped ones."""
    rng = np.random.default_rng(T * E + cap)
    ids = np.minimum(rng.geometric(0.4, (T, k)) - 1, E - 1).astype(np.int32)
    want = jdsp.make_unified_plan(jnp.asarray(ids), E, 1, cap_expert=cap)
    got = tdsp.make_unified_plan(torch.from_numpy(ids), E, cap_expert=cap)
    assert got.expert_slots.tolist() == np.asarray(want.expert_slots).tolist()
    assert got.expert_load.tolist() == np.asarray(want.expert_load).tolist()
    assert int(got.drops_expert) == int(want.drops_expert)


@pytest.mark.parametrize("B,S,chunks,mode", [(2, 16, 1, "dropless"),
                                             (3, 8, 2, "dropless"),
                                             (2, 16, 1, "capacity")])
def test_moe_ffn_matches_jax(B, S, chunks, mode):
    """The whole local MoE layer: per-row routing, dispatch, the expert FFN
    and the weighted combine, with the stats contract."""
    base = registry()["mixtral-8x7b"].reduced()
    jcfg = dataclasses.replace(base.moe, capacity_mode=mode)
    tcfg = dataclasses.replace(get_config("mixtral-8x7b").reduced().moe,
                               capacity_mode=mode)
    jp = jmoe.init_moe(jax.random.PRNGKey(3), base.d_model, jcfg)
    x = np.random.default_rng(4).standard_normal((B, S, base.d_model)).astype(np.float32)
    y_j, st_j = jmoe.moe_ffn(jp, jnp.asarray(x), jcfg,
                             jmoe.DistContext(moe_chunks=chunks))
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    y_t, st_t = tmoe.moe_ffn(tp, torch.from_numpy(x), tcfg,
                             tmoe.DistContext(device=CPU, moe_chunks=chunks))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=1e-5, atol=1e-5)
    assert st_t["load"].tolist() == np.asarray(st_j["load"]).tolist()
    assert float(st_t["drops"]) == float(st_j["drops"])
    np.testing.assert_allclose(float(st_t["aux_loss"]), float(st_j["aux_loss"]),
                               rtol=1e-5)
    if mode == "dropless":
        assert float(st_t["drops"]) == 0.0


def test_unported_strategies_raise():
    """EP, dense and local resolve; an unknown strategy is refused; under a
    multi-rank mesh "auto" is EP, a non-EP strategy raises and so does an EP
    layer whose tokens do not split (the JAX package's message); an expert
    placement for another expert count raises (the JAX package's check) and
    one for another EP group size is not applied; the ragged leg runs and
    computes what the fused leg does."""
    from repro_torch.core.ep import moe_ffn_ep
    from repro_torch.core.placement import plan_placement
    from repro_torch.launch.mesh import Mesh
    cfg = get_config("mixtral-8x7b").reduced().moe
    for strategy in ("ep_shardmap", "dense", "tp_gspmd"):
        assert tmoe.resolve_strategy(
            cfg, tmoe.DistContext(device=CPU, moe_strategy=strategy)) == strategy
    with pytest.raises(ValueError, match="unknown MoE strategy"):
        tmoe.resolve_strategy(cfg, tmoe.DistContext(device=CPU, moe_strategy="tp"))
    # resolving reads only the mesh's shape: no process group is needed
    mesh = Mesh(shape=(1, 2), coords=(0, 0), ep_group=None, dp_group=None)
    on_mesh = lambda **kw: tmoe.DistContext(device=CPU, mesh=mesh, **kw)  # noqa: E731
    assert tmoe.resolve_strategy(cfg, on_mesh(), (1, 4)) == "ep_shardmap"
    for strategy in ("tp_gspmd", "dense"):
        with pytest.raises(ValueError, match="no rank holds all the experts"):
            tmoe.resolve_strategy(cfg, on_mesh(moe_strategy=strategy))
    with pytest.raises(ValueError, match="do not divide mesh axes"):
        tmoe.resolve_strategy(cfg, on_mesh(moe_strategy="ep_shardmap", moe_chunks=8),
                              (1, 4))
    x = torch.zeros((1, 4, 256))
    params = {"router": {"w": torch.zeros((256, 4)), "bias": torch.zeros(4)},
              **{k: torch.zeros((4, 256, 512) if k != "w2" else (4, 512, 256))
                 for k in ("w1", "w3", "w2")}}
    with pytest.raises(ValueError, match="placement for E=8"):
        moe_ffn_ep(params, x, cfg, fused=True,
                   placement=plan_placement([100, 50, 1, 1, 1, 1, 1, 1], 2))
    gen = torch.Generator().manual_seed(0)
    for leaf in (params["router"]["w"], params["w1"], params["w3"], params["w2"]):
        leaf.copy_(torch.randn(leaf.shape, generator=gen) * leaf.shape[-2] ** -0.5)
    x = torch.randn((1, 4, 256), generator=gen)
    y_r, st_r = tmoe.moe_ffn(params, x, cfg, tmoe.DistContext(
        device=CPU, moe_strategy="ep_shardmap", moe_ragged=True))
    y_f, st_f = tmoe.moe_ffn(params, x, cfg, tmoe.DistContext(
        device=CPU, moe_strategy="ep_shardmap", moe_fused=True))
    assert y_r.abs().max() > 0
    torch.testing.assert_close(y_r, y_f, rtol=1e-5, atol=1e-5)
    assert st_r["load"].tolist() == st_f["load"].tolist()
    assert float(st_r["drops"]) == float(st_f["drops"]) == 0.0
    spec = plan_placement([100, 50, 1, 1], 2, replicas=1)     # 2 peers, run at 1
    y_p, _ = tmoe.moe_ffn(params, x, cfg, tmoe.DistContext(
        device=CPU, moe_strategy="ep_shardmap", moe_fused=True, placement=spec))
    assert not spec.is_identity and torch.equal(y_p, y_f)


def test_bridge_unstacks_scanned_periods():
    """The reduced mixtral's pattern is two layers long, so at 4 layers the
    JAX package scans 2 periods of 2; the bridge lays them out one layer per
    list entry, period-major."""
    from repro.models import transformer as jtf
    cfg = dataclasses.replace(registry()["mixtral-8x7b"].reduced(), num_layers=4)
    tcfg = dataclasses.replace(get_config("mixtral-8x7b").reduced(), num_layers=4)
    jp = jax.tree.map(np.asarray, jtf.init_params(jax.random.PRNGKey(0), cfg))
    assert jp["periods"] is not None and not jp["rem"]
    tp = params_from_jax(jp, tcfg, CPU)
    assert len(tp["layers"]) == 4
    period_len = len(cfg.pattern)
    for i, layer in enumerate(tp["layers"]):
        stacked = jp["periods"][i % period_len]["ffn"]["w2"]
        np.testing.assert_array_equal(layer["ffn"]["w2"].numpy(),
                                      stacked[i // period_len])
