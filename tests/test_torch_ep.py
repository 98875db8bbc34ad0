"""EP across ranks: the port's exchange, layer and train step on gloo ranks
on the CPU, against the JAX package's ``shard_map`` layer on host meshes and
against the port's own one-rank step.

* The JAX side runs in one subprocess with
  ``--xla_force_host_platform_device_count`` (this process keeps its one
  JAX device) and writes its inputs and outputs to a ``.npz``.
* The torch side runs as D x P gloo ranks started with ``spawn`` and joined
  through a ``FileStore`` under the test's temporary directory; the ranks
  import torch and the port only (the workers below, and this module's
  top level, import no JAX).
* Every wait (the subprocesses, the ranks' joins) has its own timeout, so a
  deadlock fails a test instead of stalling the suite.

The layer: on (1, 2), (1, 4) and (2, 2) meshes, rank (i, j) takes the JAX
device's block x[iB/D:(i+1)B/D, jS/P:(j+1)S/P] and the experts
[jE/P, (j+1)E/P); y to 1e-5, load and drops exactly (drops 0, dropless),
aux to 1e-6, and the gradients of y.sum() + aux_loss to 1e-4: x's block,
the router summed over ranks, and each expert slice summed over its
data-parallel group.  The step: the reduced Mixtral in fp32, global batch
4, against the port's one-rank step on the same global batch.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
MESHES = ((1, 2), (1, 4), (2, 2))
LEGS = ("plain", "ragged", "fused")
JOIN_S = 240            # a rank group's run, joins included
JAX_S = 420             # the JAX subprocess

# the layer case: E 8, top-2, d 32, f 64, x (2, 32, 32), 2 FCDA chunks
E, K, D_MODEL, D_FF, B, S = 8, 2, 32, 64, 2, 32
# the step case: reduced Mixtral, fp32.  AdamW divides by |g| + eps, so a
# gradient element near eps (1e-8) turns the rounding of its sum over ranks
# (another order than one rank's) into up to ~1e-2 lr of parameter; lr 1e-4
# keeps that below the 1e-5 the parameters are held to
STEP_SEQ, STEP_BATCH, STEP_LR, STEP_SEED = 32, 4, 1e-4, 3


# ---------------------------------------------------------------------------
# rank groups (torch only)
# ---------------------------------------------------------------------------

def _join(rank: int, shape: tuple, store: str):
    from repro_torch.launch import mesh as mesh_lib
    torch.set_num_threads(1)
    mesh_lib.init_world(rank, shape[0] * shape[1], store, "cpu")
    return mesh_lib.make_host_mesh(shape)


def _entry(rank: int, fn, shape: tuple, store: str, *args) -> None:
    import torch.distributed as dist
    try:
        fn(_join(rank, shape, store), *args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, shape: tuple, tmp: Path, *args) -> None:
    """Run ``fn(mesh, *args)`` on D x P spawned gloo ranks; fails (and
    kills the ranks) if any rank fails or the group outlives JOIN_S."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    store = f"file://{tmp}/store-{shape[0]}x{shape[1]}-{fn.__name__}"
    procs = [ctx.Process(target=_entry, args=(r, fn, shape, store, *args))
             for r in range(shape[0] * shape[1])]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(JOIN_S)
        hung = [p.pid for p in procs if p.is_alive()]
        assert not hung, f"ranks {hung} did not finish in {JOIN_S} s"
        assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)


# ---------------------------------------------------------------------------
# the JAX side (one subprocess, host meshes)
# ---------------------------------------------------------------------------

JAX_BODY = """
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.compat import set_mesh
from repro.configs import registry
from repro.configs.base import HardwareProfile, MoEConfig
from repro.core import moe as M
from repro.training import trainer as T

out_path, E, K, d, f, B, S, seq, batch, hw = sys.argv[1:11]
E, K, d, f, B, S, seq, batch = map(int, (E, K, d, f, B, S, seq, batch))
cfg = MoEConfig(num_experts=E, top_k=K, d_ff_expert=f)
params = M.init_moe(jax.random.PRNGKey(0), d, cfg)
w = np.array(params["router"]["w"])
w[:, 0] += 1.0                                   # uneven expert loads
params["router"]["w"] = jnp.asarray(w)
x = np.random.default_rng(1).standard_normal((B, S, d)).astype(np.float32)
out = {"x": x, "router_w": w, "router_bias": np.asarray(params["router"]["bias"])}
for k in ("w1", "w3", "w2"):
    out[k] = np.asarray(params[k])
plans = {}
hw = HardwareProfile(*json.loads(hw))
for shape in ((1, 2), (1, 4), (2, 2)):
    mesh = jax.make_mesh(shape, ("data", "model"))
    tag = f"{shape[0]}x{shape[1]}"
    for leg in ("plain", "ragged", "fused"):
        for depth in (1, 2):
            ctx = M.DistContext(mesh=mesh, moe_strategy="ep_shardmap", moe_chunks=2,
                                pipeline_chunks=depth, moe_ragged=leg == "ragged",
                                moe_fused=leg == "fused", use_pallas=False)

            def loss(p, x, ctx=ctx):
                y, st = M.moe_ffn(p, x, cfg, ctx)
                return y.sum() + st["aux_loss"], (y, st)

            with set_mesh(mesh):
                (_, (y, st)), (gp, gx) = jax.jit(jax.value_and_grad(
                    loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
            key = f"{tag}/{leg}/{depth}"
            out[key + "/y"] = np.asarray(y)
            for s in ("aux_loss", "load", "drops"):
                out[f"{key}/{s}"] = np.asarray(st[s])
            out[key + "/gx"] = np.asarray(gx)
            out[key + "/g_router"] = np.asarray(gp["router"]["w"])
            for k in ("w1", "w3", "w2"):
                out[f"{key}/g_{k}"] = np.asarray(gp[k])
    # the reference trainer's planning for this mesh (MACT, cold start)
    mcfg = registry()["mixtral-8x7b"].reduced()
    tr = T.Trainer(mcfg, M.DistContext(mesh=mesh, moe_strategy="ep_shardmap",
                                       moe_fused=True),
                   seq_len=seq, global_batch=batch, hw=hw)
    plans[tag] = {"e": tr.par.e, "b": tr.par.b,
                  "schedule": list(tr.choose_schedule())}
out["plans"] = np.asarray(json.dumps(plans))
np.savez(out_path, **out)
"""


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    from repro_torch.configs import H100_80G
    path = tmp_path_factory.mktemp("ep_jax") / "ref.npz"
    hw = json.dumps([H100_80G.name, H100_80G.hbm_bytes, H100_80G.peak_flops,
                     H100_80G.hbm_bw, H100_80G.ici_bw, H100_80G.alpha])
    src = ("import os\nos.environ['XLA_FLAGS'] = "
           "'--xla_force_host_platform_device_count=4'\n" + textwrap.dedent(JAX_BODY))
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    out = subprocess.run(
        [sys.executable, "-c", src, str(path), *map(str, (E, K, D_MODEL, D_FF, B, S,
                                                         STEP_SEQ, STEP_BATCH)), hw],
        capture_output=True, text=True, timeout=JAX_S, env=env)
    assert out.returncode == 0, f"stdout:\n{out.stdout}\nstderr:\n{out.stderr}"
    ref = dict(np.load(path))
    ref["plans"] = json.loads(str(ref["plans"]))
    return ref


# ---------------------------------------------------------------------------
# 1. the layer against the JAX shard_map layer
# ---------------------------------------------------------------------------

def _layer_worker(mesh, inputs: str, out_dir: str) -> None:
    from repro_torch.configs.base import MoEConfig
    from repro_torch.core import moe as tmoe
    ref = np.load(inputs)
    cfg = MoEConfig(num_experts=E, top_k=K, d_ff_expert=D_FF)
    (D, P), (i, j) = mesh.shape, mesh.coords
    xb = ref["x"][i * B // D:(i + 1) * B // D, j * S // P:(j + 1) * S // P]
    out = {}
    for leg in LEGS:
        for depth in (1, 2):
            x = torch.from_numpy(np.array(xb)).requires_grad_()
            params = {"router": {"w": torch.from_numpy(ref["router_w"]).requires_grad_(),
                                 "bias": torch.from_numpy(ref["router_bias"])}}
            for k in ("w1", "w3", "w2"):
                params[k] = mesh.local_experts(torch.from_numpy(ref[k])).clone() \
                    .requires_grad_()
            ctx = tmoe.DistContext(device=CPU, mesh=mesh, moe_strategy="ep_shardmap",
                                   moe_chunks=2, pipeline_chunks=depth,
                                   moe_ragged=leg == "ragged", moe_fused=leg == "fused")
            y, st = tmoe.moe_ffn(params, x, cfg, ctx)
            (y.sum() + st["aux_loss"]).backward()
            key = f"{leg}/{depth}"
            out[key + "/y"] = y.detach().numpy()
            for s in ("aux_loss", "load", "drops"):
                out[f"{key}/{s}"] = st[s].detach().numpy()
            out[key + "/gx"] = x.grad.numpy()
            out[key + "/g_router"] = params["router"]["w"].grad.numpy()
            for k in ("w1", "w3", "w2"):
                out[f"{key}/g_{k}"] = params[k].grad.numpy()
    np.savez(Path(out_dir) / f"rank{mesh.rank}.npz", **out)


@pytest.fixture(scope="module")
def layer_runs(jax_ref, tmp_path_factory):
    """Each mesh's ranks run every (leg, depth) once: {mesh: [rank outputs]}."""
    tmp = tmp_path_factory.mktemp("ep_layer")
    inputs = tmp / "inputs.npz"
    np.savez(inputs, **{k: jax_ref[k] for k in ("x", "router_w", "router_bias",
                                                 "w1", "w3", "w2")})
    runs = {}
    for shape in MESHES:
        out_dir = tmp / f"{shape[0]}x{shape[1]}"
        out_dir.mkdir()
        run_ranks(_layer_worker, shape, tmp, str(inputs), str(out_dir))
        runs[shape] = [dict(np.load(out_dir / f"rank{r}.npz"))
                       for r in range(shape[0] * shape[1])]
    return runs


@pytest.mark.parametrize("depth", (1, 2))
@pytest.mark.parametrize("leg", LEGS)
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_ep_layer_matches_the_jax_shard_map_layer(jax_ref, layer_runs, shape, leg,
                                                  depth):
    (D, P), ranks = shape, layer_runs[shape]
    want = {k.split("/", 3)[3]: v for k, v in jax_ref.items()
            if k.startswith(f"{D}x{P}/{leg}/{depth}/")}
    key = f"{leg}/{depth}"
    e_l = E // P
    for r, got in enumerate(ranks):
        i, j = divmod(r, P)
        rows = slice(i * B // D, (i + 1) * B // D)
        cols = slice(j * S // P, (j + 1) * S // P)
        np.testing.assert_allclose(got[key + "/y"], want["y"][rows, cols],
                                   rtol=1e-5, atol=1e-5, err_msg=f"y, rank {r}")
        np.testing.assert_array_equal(got[key + "/load"], want["load"])
        assert float(got[key + "/drops"]) == float(want["drops"]) == 0.0
        np.testing.assert_allclose(got[key + "/aux_loss"], want["aux_loss"],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got[key + "/gx"], want["gx"][rows, cols],
                                   rtol=1e-4, atol=1e-4, err_msg=f"dx, rank {r}")
    np.testing.assert_allclose(sum(g[key + "/g_router"] for g in ranks),
                               want["g_router"], rtol=1e-4, atol=1e-4)
    for k in ("w1", "w3", "w2"):
        for j in range(P):
            got = sum(ranks[i * P + j][f"{key}/g_{k}"] for i in range(D))
            np.testing.assert_allclose(got, want[f"g_{k}"][j * e_l:(j + 1) * e_l],
                                       rtol=1e-4, atol=1e-4,
                                       err_msg=f"d{k}, model index {j}")


# ---------------------------------------------------------------------------
# 2. the exchange itself
# ---------------------------------------------------------------------------

def _exchange_worker(mesh, out_dir: str) -> None:
    from repro_torch.core import dispatch as dsp
    from repro_torch.core.ep import _all_to_all
    from repro_torch.launch.mesh import make_host_mesh
    P, r = mesh.peers, mesh.rank
    try:                          # a mesh the world's size does not fit
        make_host_mesh((mesh.size, 2))
        refused = False
    except RuntimeError:
        refused = True
    t = (1000.0 * r + 10.0 * torch.arange(P)[:, None, None]
         + torch.arange(6.0).reshape(1, 3, 2)).requires_grad_()
    out = _all_to_all(t, mesh)
    g = -(1000.0 * r + 10.0 * torch.arange(P)[:, None, None]
          + torch.arange(6.0).reshape(1, 3, 2)) - 0.5
    out.backward(g)
    idx = torch.from_numpy(np.random.default_rng(r).integers(0, E, (16, K))
                           ).to(torch.int32)
    idx = torch.where(idx[:, 1:] == idx[:, :1], (idx + 1) % E, idx)   # distinct
    plan = dsp.make_unified_plan(idx, E, P, cap_send=16 * K)
    np.savez(Path(out_dir) / f"rank{r}.npz", sent=t.detach().numpy(),
             got=out.detach().numpy(), g=g.numpy(), dt=t.grad.numpy(),
             counts=plan.counts.numpy(), recv_counts=mesh.all_to_all(plan.counts).numpy(),
             refused=refused, coords=np.asarray(mesh.coords))


@pytest.fixture(scope="module")
def exchange_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ep_exchange")
    runs = {}
    for shape in ((1, 4), (2, 2)):
        out_dir = tmp / f"{shape[0]}x{shape[1]}"
        out_dir.mkdir()
        run_ranks(_exchange_worker, shape, tmp, str(out_dir))
        runs[shape] = [dict(np.load(out_dir / f"rank{r}.npz"))
                       for r in range(shape[0] * shape[1])]
    return runs


def _a2a_model(blocks: list) -> list:
    """``lax.all_to_all(x, axis, 0, 0, tiled=True)`` over one EP group:
    peer p's output block q is peer q's input block p."""
    return [np.stack([blocks[q][p] for q in range(len(blocks))])
            for p in range(len(blocks))]


@pytest.mark.parametrize("what", ("forward", "backward", "counts"))
@pytest.mark.parametrize("shape", ((1, 4), (2, 2)), ids=lambda s: f"{s[0]}x{s[1]}")
def test_exchange_is_the_block_permutation(exchange_runs, shape, what):
    """The forward is a permutation of blocks bit for bit, the backward the
    reverse permutation, and the counts matrix arrives as the JAX
    package's all_to_all of ``uplan.counts`` delivers it."""
    D, P = shape
    ranks = exchange_runs[shape]
    src, got = {"forward": ("sent", "got"), "backward": ("g", "dt"),
                "counts": ("counts", "recv_counts")}[what]
    for i in range(D):
        group = ranks[i * P:(i + 1) * P]
        want = _a2a_model([r[src] for r in group])
        for j, r in enumerate(group):
            np.testing.assert_array_equal(r[got], want[j])
    if what == "counts":
        for r in ranks:
            assert r["counts"].shape == (P, E // P)
            assert r["counts"].sum() == 16 * K
    for r, rec in enumerate(ranks):          # rank (i, j) is i P + j
        assert tuple(rec["coords"]) == divmod(r, P) and bool(rec["refused"])


@pytest.mark.parametrize("text,shape", [("local", None), ("1x1", None), ("1x2", (1, 2)),
                                        ("2X4", (2, 4)), ("2", ValueError),
                                        ("0x2", ValueError), ("1x2x2", ValueError),
                                        ("axb", ValueError)])
def test_mesh_flag_parses_like_the_jax_launcher(text, shape):
    from repro_torch.launch.mesh import parse_mesh
    if shape is ValueError:
        with pytest.raises(ValueError, match="DxP"):
            parse_mesh(text)
    else:
        assert parse_mesh(text) == shape


@pytest.mark.parametrize("argv,message", [
    (["--mesh", "1x2"], "needs --ep"),
    (["--ep", "--mesh", "1x2", "--nproc", "3"], "not the rank count"),
    (["--ep", "--mesh", "2by2"], "DxP")])
def test_launcher_refuses_a_mesh_it_cannot_run(argv, message, capsys):
    from repro_torch.launch import train
    with pytest.raises(SystemExit):
        train.parse_args(["--arch", "mixtral-8x7b", *argv])
    assert message in capsys.readouterr().err


# ---------------------------------------------------------------------------
# 3-4. the train step and the trainer's planning against one rank
# ---------------------------------------------------------------------------

def _step_cfg(aux: bool):
    from repro_torch.configs import get_config
    cfg = get_config("mixtral-8x7b").reduced()
    if not aux:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               router_aux_coef=0.0))
    return cfg


def _step_worker(mesh, out_dir: str) -> None:
    from repro_torch.core.moe import DistContext
    from repro_torch.models import transformer
    from repro_torch.optim.adamw import named_params, param_list
    from repro_torch.training import step as tstep
    from repro_torch.training.trainer import Trainer
    out = {}
    for aux in (False, True):
        cfg = _step_cfg(aux)
        ctx = DistContext(device=CPU, mesh=mesh, moe_strategy="ep_shardmap",
                          moe_fused=True)
        trainer = Trainer(cfg, ctx, seq_len=STEP_SEQ, global_batch=STEP_BATCH,
                          lr=STEP_LR)
        state = tstep.make_train_state(transformer.init_params(
            cfg, device=CPU, seed=STEP_SEED, mesh=mesh))
        flags = tstep.expert_flags(state.params, cfg)
        rec = {"par": [trainer.par.e, trainer.par.b], "loads": [], "dense": []}
        if aux:
            # the first step's gradients, reduced as the step reduces them
            chunks, depth = trainer.choose_schedule()
            batch = {k: torch.as_tensor(v[trainer._rows])
                     for k, v in trainer.data.batch_at(0).items()}
            loss, _ = tstep.loss_fn(state.params, cfg, trainer._context(chunks, depth),
                                    batch)
            grads = list(torch.autograd.grad(loss, param_list(state.params),
                                             allow_unused=True))
            tstep._reduce_grads(grads, flags, mesh)
            rec["router_grads"] = [g for g, (path, _) in zip(
                grads, named_params(state.params)) if path.endswith("router/w")]
            rec["schedule0"] = [chunks, depth]
        for _ in range(2):
            state = trainer.fit(1, state)
            rec["loads"].append(trainer._last_load.tolist())
            rec["dense"].append([p.detach().clone() for p, e in
                                 zip(param_list(state.params), flags) if not e])
        rec.update(log=trainer.log, chunks=trainer.chunk_trace,
                   pipeline=trainer.pipeline_trace,
                   params=[p.detach().clone() for p in param_list(state.params)],
                   flags=flags)
        out["aux" if aux else "noaux"] = rec
    torch.save(out, Path(out_dir) / f"rank{mesh.rank}.pt")


@pytest.fixture(scope="module")
def step_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ep_step")
    runs = {}
    for shape in MESHES:
        out_dir = tmp / f"{shape[0]}x{shape[1]}"
        out_dir.mkdir()
        run_ranks(_step_worker, shape, tmp, str(out_dir))
        runs[shape] = [torch.load(out_dir / f"rank{r}.pt")
                       for r in range(shape[0] * shape[1])]
    return runs


@pytest.fixture(scope="module")
def one_rank():
    """The port's one-rank trainer on the same global batch (held to the
    JAX trainer by tests/test_torch_train.py), with the aux coefficient 0."""
    from repro_torch.core.moe import DistContext
    from repro_torch.models import transformer
    from repro_torch.optim.adamw import param_list
    from repro_torch.training.step import make_train_state
    from repro_torch.training.trainer import Trainer
    torch.set_num_threads(min(torch.get_num_threads(), 2))
    cfg = _step_cfg(False)
    trainer = Trainer(cfg, DistContext(device=CPU, moe_strategy="ep_shardmap",
                                       moe_fused=True),
                      seq_len=STEP_SEQ, global_batch=STEP_BATCH, lr=STEP_LR)
    state = make_train_state(transformer.init_params(cfg, device=CPU, seed=STEP_SEED))
    loads = []
    for _ in range(2):
        state = trainer.fit(1, state)
        loads.append(trainer._last_load.tolist())
    return trainer, loads, [p.detach() for p in param_list(state.params)]


def _gather(ranks: list, key: str, P: int) -> list:
    """The full parameters from the ranks: dense from rank 0, each expert
    weight concatenated over the model index."""
    flags = ranks[0][key]["flags"]
    return [torch.cat([ranks[j][key]["params"][n] for j in range(P)]) if e
            else ranks[0][key]["params"][n] for n, e in enumerate(flags)]


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_step_without_aux_equals_one_rank(step_runs, one_rank, shape):
    """(a) router_aux_coef 0: ce, load, drops and grad_norm equal, and every
    parameter after 2 AdamW steps within 1e-5, the experts gathered."""
    D, P = shape
    ranks = step_runs[shape]
    trainer, loads, params = one_rank
    for r in ranks:
        rec = r["noaux"]
        assert rec["loads"] == loads
        for got, want in zip(rec["log"], trainer.log):
            assert got["drops"] == want["drops"] == 0.0
            np.testing.assert_allclose([got["ce"], got["grad_norm"]],
                                       [want["ce"], want["grad_norm"]], rtol=1e-5)
    for n, (got, want) in enumerate(zip(_gather(ranks, "noaux", P), params)):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5,
                                   msg=lambda m, n=n: f"parameter {n}: {m}")
    for i in range(1, D):           # each data group holds the same experts
        for j in range(P):
            for a, b in zip(ranks[j]["noaux"]["params"], ranks[i * P + j]["noaux"]["params"]):
                assert torch.equal(a, b)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_step_aux_is_the_mean_over_ranks(step_runs, shape):
    """(b) the config's own coefficient: aux is the mean over ranks of the
    one-rank port's aux on each rank's sequences, and the router's gradient
    is the gradient of the global loss with that mean."""
    from repro_torch.core.moe import DistContext
    from repro_torch.models import transformer
    from repro_torch.optim.adamw import named_params, param_list
    from repro_torch.training import step as tstep
    from repro_torch.data.pipeline import SyntheticLMData
    D, P = shape
    W = D * P
    ranks = step_runs[shape]
    rec0 = ranks[0]["aux"]
    cfg = _step_cfg(True)
    chunks, depth = rec0["schedule0"]
    assert [rec0["chunks"][0], rec0["pipeline"][0]] == [chunks, depth]
    params = transformer.init_params(cfg, device=CPU, seed=STEP_SEED)
    leaves = param_list(params)
    for p in leaves:
        p.requires_grad_(True)
    ctx = DistContext(device=CPU, moe_strategy="ep_shardmap", moe_fused=True,
                      moe_chunks=chunks, pipeline_chunks=depth)
    batch = SyntheticLMData(cfg, STEP_SEQ, STEP_BATCH).batch_at(0)
    rows = STEP_BATCH // W
    n_moe = transformer.num_moe_layers(cfg)
    count = float((batch["labels"] >= 0).sum())
    auxes, total = [], 0.0
    for r in range(W):
        br = {k: torch.as_tensor(v[r * rows:(r + 1) * rows]) for k, v in batch.items()}
        logits, stats = transformer.forward(params, cfg, ctx, br)
        ce_sum, _ = tstep._ce_terms(logits, br["labels"])
        aux_r = stats["aux_loss"] / n_moe
        auxes.append(float(aux_r.detach()))
        total = total + ce_sum / count + cfg.moe.router_aux_coef * aux_r / W
    for r in ranks:
        np.testing.assert_allclose(r["aux"]["log"][0]["aux"], np.mean(auxes), rtol=1e-5)
    grads = torch.autograd.grad(total, leaves, allow_unused=True)
    want = [g for g, (path, _) in zip(grads, named_params(params))
            if path.endswith("router/w")]
    for r in ranks:
        for got, w in zip(r["aux"]["router_grads"], want):
            torch.testing.assert_close(got, w, rtol=1e-5, atol=1e-6)


def _metrics(rec: dict) -> dict:
    """A log record without the times each rank took on its own clock."""
    return {k: v for k, v in rec.items() if k not in ("time_s", "tgs")}


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_dense_weights_and_schedules_equal_on_every_rank(step_runs, shape):
    """The replicated dense weights stay bit-equal across ranks after each
    step, and every rank logs the same schedules and metrics."""
    ranks = step_runs[shape]
    for key in ("noaux", "aux"):
        first = ranks[0][key]
        for r in ranks[1:]:
            rec = r[key]
            assert rec["chunks"] == first["chunks"]
            assert rec["pipeline"] == first["pipeline"]
            for a, b in zip(rec["log"], first["log"]):
                assert _metrics(a) == _metrics(b)
            for step_a, step_b in zip(rec["dense"], first["dense"]):
                assert all(torch.equal(a, b) for a, b in zip(step_a, step_b))


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_trainer_plans_as_the_reference_trainer(jax_ref, step_runs, shape):
    """Trainer on a DxP mesh builds Parallelism(e=P, b=global_batch // D),
    as the JAX trainer's __post_init__ does for that mesh, and its
    cold-start schedule is the reference MACTController's."""
    want = jax_ref["plans"][f"{shape[0]}x{shape[1]}"]
    for r in step_runs[shape]:
        rec = r["noaux"]
        assert rec["par"] == [want["e"], want["b"]] == [shape[1], STEP_BATCH // shape[0]]
        assert [rec["chunks"][0], rec["pipeline"][0]] == want["schedule"]
        assert rec["log"][0]["recv_by_peer"] and len(rec["log"][0]["recv_by_peer"]) \
            == shape[1]


# ---------------------------------------------------------------------------
# 5. the entry point
# ---------------------------------------------------------------------------

def test_launcher_trains_on_a_spawned_1x2_mesh(tmp_path):
    log = tmp_path / "log.json"
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "mixtral-8x7b",
         "--smoke", "--device", "cpu", "--ep", "--fused", "--mesh", "1x2",
         "--nproc", "2", "--steps", "3", "--log-json", str(log)],
        capture_output=True, text=True, timeout=JOIN_S, env=env)
    assert out.returncode == 0, f"stdout:\n{out.stdout}\nstderr:\n{out.stderr}"
    logs = [json.loads((tmp_path / f"log.rank{r}.json").read_text()) for r in (0, 1)]
    assert [len(lg) for lg in logs] == [3, 3]
    assert [(s["chunks"], s["pipeline"]) for s in logs[0]] == \
        [(s["chunks"], s["pipeline"]) for s in logs[1]]
    assert all(np.isfinite(s["loss"]) for s in logs[0])
    assert "gloo backend, 2 ranks" in out.stdout
    assert out.stdout.count("final loss") == 2
