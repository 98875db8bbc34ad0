"""Expert placement on the EP layer and in the trainer across gloo ranks on
the CPU, against the JAX package's placed ``shard_map`` layer and against
the port's own unplaced layer.

* The JAX side runs in one subprocess with 4 host devices
  (``--xla_force_host_platform_device_count``) and writes its inputs and
  outputs to a ``.npz``; the torch side runs as 4 spawned gloo ranks
  (``test_torch_ep.run_ranks``), each taking the JAX device's block of the
  sequence, so both packages split the same tokens over the same replicas.
* The layer (the counterparts of ``tests/test_placement.py``'s
  ``test_ep_placement_bit_parity_forward_and_grads`` and
  ``test_ep_placement_all_to_one_routing_round_trip``): on a 1x4 mesh, for
  the identity, a permutation and a replicated spec, on each expert leg.
  Against the port's unplaced layer: y, the loss, load and drops bit for
  bit; every gradient bit for bit under identity and the permutation;
  under replication the router's and x's gradients bit for bit and the
  three expert weights' within rtol 1e-6, atol 1e-5 (the reference's own
  tolerance: replica partial sums reassociate the reduction).  Against
  the JAX layer under the same spec: y to 1e-5, load and drops exactly,
  the gradients to 1e-4 (``test_torch_ep``'s tolerances).
* The trainer (the port's replacement of the reference's standing failure
  ``test_migration_then_step_equals_cold_start_on_mesh``): on 2 ranks, a
  trainer that steps at identity, then replans to a placement, equals a
  trainer cold-started at that placement from the same state, bit for bit.

This module's top level and its workers import no JAX (the ranks import
it by name).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_ep import JAX_S, REPO, run_ranks

CPU = torch.device("cpu")
MESH = (1, 4)
LEGS = ("plain", "ragged", "fused")
# the layer case of tests/test_placement.py: E 8, top-2, d 32, f 64,
# x (4, 16, 32), 2 FCDA chunks; the all-to-one case: d 16, f 32, x (2, 16, 16)
E, K, D_MODEL, D_FF, B, S = 8, 2, 32, 64, 4, 16
A1_D, A1_F, A1_B = 16, 32, 2
SPECS = {"identity": [0, 1, 2, 3, 4, 5, 6, 7],
         "permutation": [3, 5, 0, 6, 1, 7, 2, 4]}       # replicated: planned
HOT = [100, 50, 1, 1, 1, 1, 1, 1]

JAX_BODY = """
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.compat import set_mesh
from repro.configs.base import MoEConfig
from repro.core import moe as M
from repro.core import placement as plc
from repro.core.placement import PlacementSpec

out_path, E, K, d, f, B, S, a1_d, a1_f, a1_b, specs, hot = sys.argv[1:13]
E, K, d, f, B, S, a1_d, a1_f, a1_b = map(int, (E, K, d, f, B, S, a1_d, a1_f, a1_b))
mesh = jax.make_mesh((1, 4), ("data", "model"))
specs = {k: PlacementSpec(E, 4, tuple(v)) for k, v in json.loads(specs).items()}
specs["replicated"] = plc.plan_placement(json.loads(hot), 4, replicas=1)
out = {"replicated": np.asarray(specs["replicated"].slot_to_expert)}

cfg = MoEConfig(num_experts=E, top_k=K, d_ff_expert=f)
params = M.init_moe(jax.random.PRNGKey(0), d, cfg)
x = np.random.default_rng(1).standard_normal((B, S, d)).astype(np.float32)
for k in ("w1", "w3", "w2"):
    out[k] = np.asarray(params[k])
out["x"], out["router_w"] = x, np.asarray(params["router"]["w"])
out["router_bias"] = np.asarray(params["router"]["bias"])
for leg in ("plain", "ragged", "fused"):
    for name in ("none", *specs):
        ctx = M.DistContext(mesh=mesh, moe_chunks=2, moe_strategy="ep_shardmap",
                            moe_ragged=leg == "ragged", moe_fused=leg == "fused",
                            placement=specs.get(name))

        def loss(p, xx, ctx=ctx):
            y, s = M.moe_ffn(p, xx, cfg, ctx)
            return (y ** 2).sum(), (y, s)

        with set_mesh(mesh):
            (l, (y, s)), (gp, gx) = jax.jit(jax.value_and_grad(
                loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
        key = f"{leg}/{name}"
        out[key + "/y"], out[key + "/gx"] = np.asarray(y), np.asarray(gx)
        out[key + "/load"], out[key + "/drops"] = np.asarray(s["load"]), np.asarray(s["drops"])
        out[key + "/g_router"] = np.asarray(gp["router"]["w"])
        for k in ("w1", "w3", "w2"):
            out[f"{key}/g_{k}"] = np.asarray(gp[k])

# all-to-one routing: a zero router ties every score, so top-2 picks (0, 1)
cfg1 = MoEConfig(num_experts=E, top_k=K, d_ff_expert=a1_f)
p1 = M.init_moe(jax.random.PRNGKey(0), a1_d, cfg1)
p1["router"]["w"] = jnp.zeros((a1_d, E), jnp.float32)
x1 = np.random.default_rng(2).standard_normal((a1_b, S, a1_d)).astype(np.float32)
T = a1_b * S
load = np.zeros(E); load[0] = load[1] = T
spec1 = plc.plan_placement(load, 4, replicas=1)
out["a1/spec"] = np.asarray(spec1.slot_to_expert)
out["a1/x"] = x1
for k in ("w1", "w3", "w2"):
    out["a1/" + k] = np.asarray(p1[k])
for name, spec in (("none", None), ("placed", spec1)):
    ctx = M.DistContext(mesh=mesh, moe_chunks=2, moe_strategy="ep_shardmap",
                        placement=spec)
    with set_mesh(mesh):
        y, s = jax.jit(lambda p, xx: M.moe_ffn(p, xx, cfg1, ctx))(p1, jnp.asarray(x1))
    out[f"a1/{name}/y"], out[f"a1/{name}/load"] = np.asarray(y), np.asarray(s["load"])
np.savez(out_path, **out)
"""


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    pytest.importorskip("jax")
    path = tmp_path_factory.mktemp("placement_jax") / "ref.npz"
    src = ("import os\nos.environ['XLA_FLAGS'] = "
           "'--xla_force_host_platform_device_count=4'\n" + textwrap.dedent(JAX_BODY))
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    out = subprocess.run(
        [sys.executable, "-c", src, str(path),
         *map(str, (E, K, D_MODEL, D_FF, B, S, A1_D, A1_F, A1_B)),
         json.dumps(SPECS), json.dumps(HOT)],
        capture_output=True, text=True, timeout=JAX_S, env=env)
    assert out.returncode == 0, f"stdout:\n{out.stdout}\nstderr:\n{out.stderr}"
    return dict(np.load(path))


# ---------------------------------------------------------------------------
# the layer on 4 ranks
# ---------------------------------------------------------------------------

def _layer_worker(mesh, inputs: str, out_dir: str) -> None:
    from repro_torch.configs.base import MoEConfig
    from repro_torch.core import moe as tmoe
    from repro_torch.core import placement as plc
    from repro_torch.core.placement import PlacementSpec
    ref = np.load(inputs)
    P, j = mesh.peers, mesh.coords[1]
    specs = {"none": None, **{k: PlacementSpec(E, P, tuple(v)) for k, v in SPECS.items()},
             "replicated": plc.plan_placement(HOT, P, replicas=1)}
    out = {"replicated": np.asarray(specs["replicated"].slot_to_expert)}

    def run(cfg, x_all, w, router_w, router_b, spec, leg, grad: bool):
        x = torch.from_numpy(np.array(x_all[:, j * S // P:(j + 1) * S // P]))
        params = {"router": {"w": torch.from_numpy(np.array(router_w)),
                             "bias": torch.from_numpy(np.array(router_b))}}
        for k in ("w1", "w3", "w2"):
            params[k] = mesh.local_experts(torch.from_numpy(np.array(w[k]))).clone()
        leaves = [x, params["router"]["w"], params["w1"], params["w3"], params["w2"]]
        for t in leaves:
            t.requires_grad_(grad)
        ctx = tmoe.DistContext(device=CPU, mesh=mesh, moe_strategy="ep_shardmap",
                               moe_chunks=2, moe_ragged=leg == "ragged",
                               moe_fused=leg == "fused", placement=spec)
        y, st = tmoe.moe_ffn(params, x, cfg, ctx)
        rec = {"y": y.detach().numpy(), "load": st["load"].numpy(),
               "drops": st["drops"].numpy()}
        if grad:
            loss = (y ** 2).sum()
            loss.backward()
            rec["loss"] = loss.detach().numpy()
            for name, t in zip(("gx", "g_router", "g_w1", "g_w3", "g_w2"), leaves):
                rec[name] = t.grad.numpy()
        return rec

    cfg = MoEConfig(num_experts=E, top_k=K, d_ff_expert=D_FF)
    w = {k: ref[k] for k in ("w1", "w3", "w2")}
    for leg in LEGS:
        for name, spec in specs.items():
            for k, v in run(cfg, ref["x"], w, ref["router_w"], ref["router_bias"], spec,
                            leg, True).items():
                out[f"{leg}/{name}/{k}"] = v
    cfg1 = MoEConfig(num_experts=E, top_k=K, d_ff_expert=A1_F)
    w1 = {k: ref["a1/" + k] for k in ("w1", "w3", "w2")}
    spec1 = plc.plan_placement(np.bincount([0, 1], minlength=E) * A1_B * S, P, replicas=1)
    out["a1/spec"] = np.asarray(spec1.slot_to_expert)
    zero = np.zeros((A1_D, E), np.float32)
    for name, spec in (("none", None), ("placed", spec1), ("again", spec1)):
        for k, v in run(cfg1, ref["a1/x"], w1, zero, ref["router_bias"], spec, "plain",
                        False).items():
            out[f"a1/{name}/{k}"] = v
    np.savez(Path(out_dir) / f"rank{mesh.rank}.npz", **out)


@pytest.fixture(scope="module")
def layer_runs(jax_ref, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("placement_layer")
    inputs = tmp / "inputs.npz"
    np.savez(inputs, **{k: v for k, v in jax_ref.items()
                        if k in ("x", "router_w", "router_bias", "w1", "w3", "w2",
                                 "a1/x", "a1/w1", "a1/w3", "a1/w2")})
    run_ranks(_layer_worker, MESH, tmp, str(inputs), str(tmp))
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(MESH[1])]


def _cat(ranks: list, key: str) -> np.ndarray:
    """An expert weight's gradient over the ranks' canonical slices."""
    return np.concatenate([r[key] for r in ranks])


@pytest.mark.parametrize("spec", ("identity", "permutation", "replicated"))
@pytest.mark.parametrize("leg", LEGS)
def test_placed_layer_equals_the_unplaced_layer(layer_runs, leg, spec):
    for r, got in enumerate(layer_runs):
        base, placed = f"{leg}/none/", f"{leg}/{spec}/"
        for k in ("y", "loss", "load", "drops", "gx", "g_router"):
            np.testing.assert_array_equal(got[placed + k], got[base + k],
                                          err_msg=f"{k}, rank {r}")
        assert float(got[placed + "drops"]) == 0.0
        for k in ("g_w1", "g_w3", "g_w2"):
            if spec == "replicated":
                np.testing.assert_allclose(got[placed + k], got[base + k], rtol=1e-6,
                                           atol=1e-5, err_msg=f"{k}, rank {r}")
            else:
                np.testing.assert_array_equal(got[placed + k], got[base + k],
                                              err_msg=f"{k}, rank {r}")


@pytest.mark.parametrize("spec", ("none", "identity", "permutation", "replicated"))
@pytest.mark.parametrize("leg", LEGS)
def test_placed_layer_matches_the_jax_placed_layer(jax_ref, layer_runs, leg, spec):
    np.testing.assert_array_equal(layer_runs[0]["replicated"], jax_ref["replicated"])
    key = f"{leg}/{spec}/"
    P = MESH[1]
    for j, got in enumerate(layer_runs):
        cols = slice(j * S // P, (j + 1) * S // P)
        np.testing.assert_allclose(got[key + "y"], jax_ref[key + "y"][:, cols],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(got[key + "load"], jax_ref[key + "load"])
        assert float(got[key + "drops"]) == float(jax_ref[key + "drops"]) == 0.0
        np.testing.assert_allclose(got[key + "gx"], jax_ref[key + "gx"][:, cols],
                                   rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(sum(g[key + "g_router"] for g in layer_runs),
                               jax_ref[key + "g_router"], rtol=1e-4, atol=1e-4)
    for k in ("w1", "w3", "w2"):
        np.testing.assert_allclose(_cat(layer_runs, f"{key}g_{k}"),
                                   jax_ref[f"{key}g_{k}"], rtol=1e-4, atol=1e-4)


def test_all_to_one_routing_round_trip(jax_ref, layer_runs):
    """Every token routes to experts (0, 1), which identity puts on one
    rank; the planned spec moves and replicates them: y bit-equal to the
    unplaced layer, repeat runs identical, no drops, the same load, and y
    as the JAX placed layer's."""
    np.testing.assert_array_equal(layer_runs[0]["a1/spec"], jax_ref["a1/spec"])
    assert list(jax_ref["a1/spec"]) != list(range(E))
    T = A1_B * S
    P = MESH[1]
    for j, got in enumerate(layer_runs):
        assert got["a1/none/load"][0] == T
        np.testing.assert_array_equal(got["a1/placed/y"], got["a1/none/y"])
        np.testing.assert_array_equal(got["a1/again/y"], got["a1/placed/y"])
        np.testing.assert_array_equal(got["a1/placed/load"], got["a1/none/load"])
        assert float(got["a1/placed/drops"]) == 0.0
        np.testing.assert_array_equal(got["a1/placed/load"], jax_ref["a1/placed/load"])
        np.testing.assert_allclose(got["a1/placed/y"],
                                   jax_ref["a1/placed/y"][:, j * S // P:(j + 1) * S // P],
                                   rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the trainer on 2 ranks: a replan mid-run equals a cold start at the placement
# ---------------------------------------------------------------------------

def _clone_state(state):
    from repro_torch.optim import adamw
    from repro_torch.training.step import make_train_state

    def tree(t):
        if isinstance(t, dict):
            return {k: tree(v) for k, v in t.items()}
        if isinstance(t, list):
            return [tree(v) for v in t]
        return t.detach().clone()

    st = make_train_state(tree(state.params))
    return st._replace(opt=adamw.AdamWState(state.opt.step,
                                            [m.clone() for m in state.opt.mu],
                                            [v.clone() for v in state.opt.nu]),
                       step=state.step)


def _migrate_worker(mesh, out_dir: str) -> None:
    from repro_torch.configs import get_config
    from repro_torch.core.moe import DistContext
    from repro_torch.optim.adamw import param_list
    from repro_torch.training.step import init_train_state
    from repro_torch.training.trainer import Trainer
    cfg = get_config("mixtral-8x7b").reduced()
    E_ = cfg.moe.num_experts
    ctx = DistContext(device=CPU, mesh=mesh, moe_chunks=2, moe_strategy="ep_shardmap",
                      moe_fused=True)
    kw = dict(seq_len=32, global_batch=2, lr=1e-3, use_mact=False,
              use_placement=True, placement_replicas=1)
    skew = np.tile([100.0, 50.0] + [1.0] * (E_ - 2), (2, 1))
    a = Trainer(cfg, ctx, **kw)
    state = init_train_state(cfg, device=CPU, seed=0, mesh=mesh)
    batch = {k: torch.as_tensor(v[a._rows]) for k, v in a.data.batch_at(0).items()}
    k0 = a._with_placements(a._next_schedule_key())
    state, _ = a._step_for(k0)(state, batch)
    s1 = _clone_state(state)
    a.telemetry.update(skew)
    ka = a._with_placements(a._next_schedule_key())
    sa, ma = a._step_for(ka)(state, batch)
    b = Trainer(cfg, ctx, **kw)
    b.telemetry.update(skew)
    kb = b._with_placements(b._next_schedule_key())
    sb, mb = b._step_for(kb)(s1, batch)
    leaves = lambda s: param_list(s.params) + s.opt.mu + s.opt.nu  # noqa: E731
    rec = {"k0": repr(k0), "moved": ka != k0,
           "placements": [list(p.slot_to_expert) for p in a._placements],
           "same_placements": a._placements == b._placements,
           "loss": [float(ma["loss"]), float(mb["loss"])],
           "bit_equal": all(torch.equal(x, y) for x, y in zip(leaves(sa), leaves(sb)))}
    Path(out_dir, f"rank{mesh.rank}.json").write_text(json.dumps(rec))


def test_replan_mid_run_equals_cold_start_at_the_placement(tmp_path):
    run_ranks(_migrate_worker, (1, 2), tmp_path, str(tmp_path))
    recs = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in (0, 1)]
    for rec in recs:
        assert rec["moved"] and rec["same_placements"], rec
        assert any(p != list(range(len(p))) for p in rec["placements"])
        assert rec["loss"][0] == rec["loss"][1] and rec["bit_equal"], rec
    assert recs[0] == recs[1]
