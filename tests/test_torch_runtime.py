"""The port's resilience path: fault injection, the OOM degradation ladder,
crash-consistent checkpoints and resume, and the train step's transaction.

* Against the JAX package: ``parse_spec`` and ``DegradationLadder`` equal
  the reference's outputs exactly, and the port's ``Trainer`` on the EP
  strategy at one peer on the fused leg walks injected faults as the JAX
  ``Trainer`` does on a 1x1 mesh: the same chunk and pipeline traces,
  per-step ``oom_retries``, escalation keys and audited model bytes, losses
  to ``test_torch_train.py``'s 1e-4.  The JAX trainer's audit also lowers
  the failed schedule to read XLA's buffer bytes; the port has no XLA, so
  that lowering is stubbed out here and its ``hlo_hbm_gb`` is not compared.
* The port's counterparts of ``tests/test_runtime.py``'s ladder and
  checkpoint tests.
* Kill-and-resume bit for bit (``torch.equal`` on every parameter and
  moment), a torn checkpoint skipped, a bf16 round trip bit for bit, the
  failed attempt freed before the next rung, and the rollback: an OOM in
  the backward or in AdamW's allocations leaves the state bit for bit as
  it was, and the retried step equals an uninterrupted one on its rung.

The reduced Mixtral in fp32, seq 32, batch 2, on the CPU.
"""

import dataclasses
import gc
import sys
import weakref

import numpy as np
import pytest
import torch

from repro_torch import checkpointing
from repro_torch.configs import get_config
from repro_torch.core.moe import DistContext
from repro_torch.kernels import ops
from repro_torch.optim import adamw
from repro_torch.optim.adamw import param_list
from repro_torch.runtime import guard as tguard
from repro_torch.runtime.faults import (FaultInjector, FaultSpec, SimulatedCrash,
                                        SimulatedOOM, parse_spec)
from repro_torch.runtime.guard import (FULL_REMAT, DegradationLadder, OOMGuard,
                                       is_oom_error)
from repro_torch.training.step import init_train_state, make_train_state, make_train_step
from repro_torch.training.trainer import Trainer

CPU = torch.device("cpu")
# the suite runs several test processes on one host
torch.set_num_threads(min(torch.get_num_threads(), 2))
CFG = get_config("mixtral-8x7b").reduced()
KW = dict(seq_len=32, global_batch=2, lr=1e-3)
SPECS = ("oom@3,burst@2x1.5,ckpt_truncate@4*2", "crash@0", "stall@7x0.5*3",
         "oom@1*4", "burst@2x2.0")


def _ctx(**kw):
    return DistContext(device=CPU, moe_strategy="ep_shardmap", moe_fused=True, **kw)


def _tensors(state) -> list:
    return param_list(state.params) + list(state.opt.mu) + list(state.opt.nu)


def _clone(state):
    params = _map(state.params, lambda t: t.detach().clone())
    st = make_train_state(params)
    return st._replace(opt=adamw.AdamWState(state.opt.step,
                                            [m.clone() for m in state.opt.mu],
                                            [v.clone() for v in state.opt.nu]),
                       step=state.step)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def _bit_equal(a, b) -> bool:
    ta, tb = _tensors(a), _tensors(b)
    return (len(ta) == len(tb) and a.step == b.step and a.opt.step == b.opt.step
            and all(torch.equal(x, y) for x, y in zip(ta, tb)))


# ---------------------------------------------------------------------------
# faults and the ladder, against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("text", SPECS)
def test_parse_spec_matches_the_reference(text):
    pytest.importorskip("jax")
    from repro.runtime import faults as jfaults
    fields = lambda specs: [(s.kind, s.at, s.times, s.magnitude, s.fired)  # noqa: E731
                            for s in specs]
    assert fields(parse_spec(text)) == fields(jfaults.parse_spec(text))
    for bad in ("oom", "nonsense@1"):
        with pytest.raises(ValueError):
            jfaults.parse_spec(bad)
        with pytest.raises(ValueError):
            parse_spec(bad)


def test_ladder_rungs_match_the_reference():
    """Every key of the schedule space MACT emits at depth 2, plus the floor,
    walks the reference's rungs in the reference's order."""
    pytest.importorskip("jax")
    from repro.configs import registry
    from repro.core import mact as jmact
    from repro.core import memory_model as jmm
    from repro.runtime import guard as jguard
    from repro_torch.configs import H100_80G
    from repro_torch.core import mact as tmact
    from repro_torch.core import memory_model as tmm
    jm = jmact.MACTController(registry()["mixtral-8x7b"].reduced(), jmm.Parallelism(e=1, b=2),
                              jguard_hw(), 32)
    tm = tmact.MACTController(CFG, tmm.Parallelism(e=1, b=2), H100_80G, 32)
    space = tm.schedule_space(2)
    assert [tuple(s) for s in space] == [tuple(s) for s in jm.schedule_space(2)]
    mine, ref = DegradationLadder(space), jguard.DegradationLadder(jm.schedule_space(2))
    assert tguard.FULL_REMAT == jguard.FULL_REMAT
    for key in [tuple(s) for s in space] + [(FULL_REMAT, 8)]:
        assert mine.rungs_after(key) == ref.rungs_after(key), key
        assert tguard._conservatism(key) == jguard._conservatism(key)


def jguard_hw():
    from repro.configs.base import HardwareProfile
    from repro_torch.configs import H100_80G
    return HardwareProfile(H100_80G.name, H100_80G.hbm_bytes, H100_80G.peak_flops,
                           H100_80G.hbm_bw, H100_80G.ici_bw, H100_80G.alpha)


def _injector(case, faults_mod):
    if case == "oom_times_4":
        return faults_mod.FaultInjector(specs=[faults_mod.FaultSpec(kind="oom", at=1,
                                                                    times=4)])
    return faults_mod.FaultInjector.from_string(case)


@pytest.mark.parametrize("case,steps", [("oom@2", 4), ("oom_times_4", 2),
                                        ("burst@2x2.0", 4)])
def test_injected_faults_walk_as_the_reference_trainer(monkeypatch, case, steps):
    jax = pytest.importorskip("jax")
    import repro.launch
    from repro.configs import registry
    from repro.core import moe as jmoe
    from repro.runtime import faults as jfaults
    from repro.training import trainer as jtrainer
    from repro_torch.bridge import params_from_jax
    from repro_torch.runtime import faults as tfaults
    # the JAX audit's lowering of the failed schedule (XLA's buffer bytes,
    # which the port cannot have) fails to import and records None
    monkeypatch.delattr(repro.launch, "hlo_analysis", raising=False)
    monkeypatch.setitem(sys.modules, "repro.launch.hlo_analysis", None)
    jc = registry()["mixtral-8x7b"].reduced()
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))
    jt = jtrainer.Trainer(jc, jmoe.DistContext(mesh=mesh, moe_strategy="ep_shardmap",
                                               moe_fused=True),
                          injector=_injector(case, jfaults), hw=jguard_hw(), **KW)
    tt = Trainer(CFG, _ctx(), injector=_injector(case, tfaults), **KW)
    jstate = jtrainer.init_train_state(jax.random.PRNGKey(0), jc)
    tstate = make_train_state(params_from_jax(jax.tree.map(np.asarray, jstate.params),
                                              CFG, CPU))
    jt.fit(steps, jstate)
    tt.fit(steps, tstate)
    assert tt.chunk_trace == jt.chunk_trace
    assert tt.pipeline_trace == jt.pipeline_trace
    assert [r["oom_retries"] for r in tt.log] == [r["oom_retries"] for r in jt.log]
    keys = lambda esc: [(e["step"], e["failed"], e["next"], e["retries"])  # noqa: E731
                        for e in esc]
    assert keys(tt.guard.escalations) == keys(jt.guard.escalations)
    audit = lambda a: [(x["step"], x["key"], x["modeled_total_gb"], x["modeled_fits"])  # noqa: E731
                       for x in a]
    assert audit(tt.guard.audits) == audit(jt.guard.audits)
    assert tt.headroom_widenings == jt.headroom_widenings
    np.testing.assert_allclose([r["loss"] for r in tt.log], [r["loss"] for r in jt.log],
                               rtol=1e-4, atol=1e-4)
    assert tt.injector.fired == jt.injector.fired
    if case == "oom_times_4":
        assert tt.log[1]["chunks"] == max(tt.mact.bins)        # the floor ran
        assert tt.guard.escalations[-1]["next"] == (FULL_REMAT, max(tt.mact.bins))


# ---------------------------------------------------------------------------
# the port's counterparts of tests/test_runtime.py
# ---------------------------------------------------------------------------

def test_injector_fires_once_then_disarms_and_bursts_once():
    inj = FaultInjector.from_string("oom@3,burst@2x3.0")
    inj.maybe_fail_step(2)                     # not armed yet
    with pytest.raises(SimulatedOOM):
        inj.maybe_fail_step(3)
    inj.maybe_fail_step(3)                     # fired out
    assert inj.burst_factor(1) == 1.0
    assert inj.burst_factor(2) == 3.0
    assert inj.burst_factor(2) == 1.0
    assert inj.fired == [("oom", 3), ("burst", 2)]
    crash = FaultInjector(specs=[FaultSpec("crash", 1), FaultSpec("oom", 1)])
    with pytest.raises(SimulatedOOM):          # OOM before crash
        crash.maybe_fail_step(1)
    with pytest.raises(SimulatedCrash):
        crash.maybe_fail_step(1)


def test_is_oom_error_classification():
    for exc in (SimulatedOOM(), torch.cuda.OutOfMemoryError("CUDA out of memory."),
                MemoryError(), RuntimeError("CUDA out of memory. Tried to allocate 2 GiB"),
                RuntimeError("RESOURCE_EXHAUSTED: HBM"), RuntimeError("Out of memory")):
        assert is_oom_error(exc), exc
    for exc in (SimulatedCrash("boom"), ValueError("bad shape"), KeyError("oom")):
        assert not is_oom_error(exc), exc


def test_ladder_is_bounded_and_non_oom_errors_propagate():
    space = tuple((b, 1) for b in (1, 2, 4, 8)) + ((2, 2), (4, 2), (8, 2))
    calls = []

    def always_oom(k):
        calls.append(k)
        raise SimulatedOOM()

    g = OOMGuard(DegradationLadder(space), max_retries=2)
    with pytest.raises(RuntimeError, match="ladder exhausted"):
        g.run((2, 2), always_oom, step=5)
    assert calls == [(2, 2), (2, 1), (4, 1)]   # max_retries + 1 attempts
    assert [(e["failed"], e["next"], e["retries"]) for e in g.escalations] == [
        ((2, 2), (2, 1), 1), ((2, 1), (4, 1), 2), ((4, 1), (8, 1), 3)]
    for exc in (SimulatedCrash("dead"), ValueError("not memory")):
        def fail(k, exc=exc):
            raise exc
        g = OOMGuard(DegradationLadder(space))
        with pytest.raises(type(exc)):
            g.run((1, 1), fail, step=0)
        assert g.escalations == []
    g = OOMGuard(DegradationLadder(space))     # the floor has no rung after it
    with pytest.raises(RuntimeError, match="ladder exhausted"):
        g.run((FULL_REMAT, 8), always_oom, step=0)


def test_a_real_oom_under_a_mesh_names_its_rank_and_injected_ones_walk():
    space = ((1, 1), (2, 1))

    def real(k):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 1 GiB")

    with pytest.raises(RuntimeError, match="rank 1 ran out of memory"):
        OOMGuard(DegradationLadder(space), rank=1).run((1, 1), real, step=3)
    seen = []

    def injected(k):
        seen.append(k)
        if len(seen) == 1:
            raise SimulatedOOM()
        return "done"

    assert OOMGuard(DegradationLadder(space), rank=1).run((1, 1), injected, 3) == (
        "done", (2, 1))


def test_the_failed_attempt_is_freed_before_the_next_rung():
    """A tensor the failed attempt made (held only by its frames, or by a
    reference cycle among them) is dead when the next rung starts."""
    refs = []

    class Cycle:
        def __init__(self, t):
            self.t, self.me = t, self

    def deep(k):
        t = torch.ones(1000)
        held = Cycle(torch.ones(1000))
        refs.extend([weakref.ref(t), weakref.ref(held.t)])
        raise SimulatedOOM()

    def attempt(k):
        if k == (1, 1):
            deep(k)
        assert refs and all(r() is None for r in refs), "the failed attempt is alive"
        return k

    g = OOMGuard(DegradationLadder(((1, 1), (2, 1))))
    gc.disable()
    try:
        assert g.run((1, 1), attempt, 0) == ((2, 1), (2, 1))
    finally:
        gc.enable()


def _small_state(dtype=torch.float32, seed=0):
    gen = torch.Generator().manual_seed(seed)
    params = {"w": torch.randn(4, 6, generator=gen).to(dtype),
              "layers": [{"b": torch.randn(5, generator=gen).to(dtype)}]}
    st = make_train_state(params)
    for m, v in zip(st.opt.mu, st.opt.nu):
        m.normal_(generator=gen)
        v.uniform_(generator=gen)
    return st._replace(opt=st.opt._replace(step=3), step=3)


def test_checkpoint_checksum_catches_truncation(tmp_path):
    d = str(tmp_path)
    checkpointing.save(d, 2, _small_state())
    checkpointing.save(d, 4, _small_state())
    assert checkpointing.valid_steps(d) == [2, 4]
    payload = tmp_path / "step_00000004.npz"
    payload.write_bytes(payload.read_bytes()[:payload.stat().st_size // 2])
    ok, why = checkpointing.verify(d, 4)
    assert not ok and "checksum" in why
    assert checkpointing.valid_steps(d) == [2]
    assert checkpointing.latest_step(d) == 2
    (tmp_path / "step_00000002.json").unlink()       # an uncommitted save
    assert checkpointing.verify(d, 2) == (False, "manifest missing or unreadable")
    assert checkpointing.latest_step(d) is None


def test_checkpoint_restore_refuses_another_structure_and_keeps_extra(tmp_path):
    d = str(tmp_path)
    extra = {"last_load": [3.0, 5.0], "mact_headroom": 0.31, "telemetry": None}
    saved = _small_state()
    checkpointing.save(d, 3, saved, extra=extra)
    assert checkpointing.load_extra(d, 3) == extra
    into = _small_state(seed=1)._replace(step=0)
    got = checkpointing.restore(d, 3, into)
    assert _bit_equal(got, saved)
    fewer = make_train_state({"w": torch.zeros(4, 6)})
    with pytest.raises(ValueError, match="leaves"):
        checkpointing.restore(d, 3, fewer)
    renamed = make_train_state({"w": torch.zeros(4, 6), "layers": [{"c": torch.zeros(5)}]})
    with pytest.raises(ValueError, match="structure"):
        checkpointing.restore(d, 3, renamed)           # same leaf count, other tree
    retyped = make_train_state({"w": torch.zeros(4, 6, dtype=torch.bfloat16),
                                "layers": [{"b": torch.zeros(5)}]})
    with pytest.raises(ValueError, match="structure"):
        checkpointing.restore(d, 3, retyped)


def test_bf16_checkpoint_round_trip_is_bit_exact(tmp_path):
    """Every bf16 bit pattern but NaNs' (whose payload numpy may not keep)
    comes back, as do the fp32 moments."""
    d = str(tmp_path)
    bits = torch.arange(-2**15, 2**15, dtype=torch.int32).to(torch.int16)
    w = bits.view(torch.bfloat16)
    w = torch.where(torch.isnan(w), torch.zeros_like(w), w).reshape(256, 256)
    saved = make_train_state({"w": w.clone(), "v": torch.randn(7).to(torch.bfloat16)})
    checkpointing.save(d, 1, saved)
    got = checkpointing.restore(d, 1, make_train_state(
        {"w": torch.zeros(256, 256, dtype=torch.bfloat16),
         "v": torch.zeros(7, dtype=torch.bfloat16)}))
    assert torch.equal(got.params["w"].view(torch.int16), w.view(torch.int16))
    assert _bit_equal(got, saved)


# ---------------------------------------------------------------------------
# the trainer: kill and resume, torn saves, the launcher
# ---------------------------------------------------------------------------

def test_kill_and_resume_is_bit_identical(tmp_path):
    a = Trainer(CFG, _ctx(), checkpoint_dir=str(tmp_path / "a"), checkpoint_every=2, **KW)
    state_a = a.fit(4)
    with pytest.raises(SimulatedCrash):
        Trainer(CFG, _ctx(), checkpoint_dir=str(tmp_path / "b"), checkpoint_every=2,
                injector=FaultInjector.from_string("crash@3"), **KW).fit(4)
    assert checkpointing.valid_steps(str(tmp_path / "b")) == [2]
    c = Trainer(CFG, _ctx(), checkpoint_dir=str(tmp_path / "b"), resume=True, **KW)
    state_c = c.fit(4)
    assert c.resumed_from == 2 and state_c.step == 4
    assert [r["step"] for r in c.log] == [3, 4]
    assert [r["loss"] for r in c.log] == [r["loss"] for r in a.log[2:]]
    assert c.chunk_trace == a.chunk_trace[2:] and c.pipeline_trace == a.pipeline_trace[2:]
    assert _bit_equal(state_a, state_c)


def test_resume_skips_a_torn_checkpoint_and_can_have_nothing_to_do(tmp_path):
    d = str(tmp_path)
    t = Trainer(CFG, _ctx(), checkpoint_dir=d, checkpoint_every=2,
                injector=FaultInjector.from_string("ckpt_truncate@4"), **KW)
    t.fit(6)
    assert checkpointing.valid_steps(d) == [2, 4]      # the step-6 save was torn
    assert t.injector.fired == [("ckpt_truncate", 5)]
    tr = Trainer(CFG, _ctx(), checkpoint_dir=d, resume=True, **KW)
    state = tr.fit(4)                                  # already at the target
    assert tr.resumed_from == 4 and state.step == 4 and tr.log == []


@pytest.mark.parametrize("where", ["backward", "adamw"])
def test_an_oom_in_the_step_rolls_back_and_the_retry_equals_the_rung(monkeypatch, where):
    """A SimulatedOOM raised inside the backward (the expert FFN's
    elementwise gradient) or by AdamW's workspace allocation leaves the
    state bit for bit as it was; the trainer then retries on (2, 1) and ends
    bit-equal to a run that started there."""
    start = init_train_state(CFG, torch.float32, CPU, seed=0)
    first = Trainer(CFG, _ctx(), use_mact=False, **KW)
    start = first.fit(1, start)                 # moments no longer zero
    target = {"backward": (ops, "_swiglu_backward_"),
              "adamw": (adamw, "_workspace")}[where]
    real = getattr(*target)
    armed = []

    def failing(*args, **kwargs):
        if armed:
            armed.pop()
            raise SimulatedOOM(where)
        return real(*args, **kwargs)

    monkeypatch.setattr(*target, failing)
    before = _clone(start)
    batch = {k: torch.as_tensor(v) for k, v in first.data.batch_at(1).items()}
    armed.append(True)
    with pytest.raises(SimulatedOOM):
        make_train_step(CFG, _ctx(moe_chunks=1, pipeline_chunks=1), lr=KW["lr"])(start, batch)
    assert not armed and _bit_equal(start, before)

    armed.append(True)
    tr = Trainer(CFG, _ctx(moe_chunks=1, pipeline_chunks=1), use_mact=False, **KW)
    tr._last_load = first._last_load
    got = tr.fit(1, start)
    assert [(e["failed"], e["next"]) for e in tr.guard.escalations] == [((1, 1), (2, 1))]
    ref = Trainer(CFG, _ctx(moe_chunks=2, pipeline_chunks=1), use_mact=False, **KW)
    want = ref.fit(1, before)
    assert tr.log[0]["loss"] == ref.log[0]["loss"]
    assert _bit_equal(got, want)


def test_launcher_walks_the_ladder_checkpoints_and_resumes(tmp_path, capsys):
    from repro_torch.launch import train
    base = ["--arch", "mixtral-8x7b", "--smoke", "--device", "cpu", "--ep", "--fused",
            "--seq-len", "32", "--global-batch", "2", "--checkpoint-dir", str(tmp_path),
            "--checkpoint-every", "2"]
    trainer, _ = train.main(base + ["--steps", "4", "--inject", "oom@1"])
    out = capsys.readouterr().out
    assert "OOM ladder: 1 escalation(s), headroom now" in out
    assert "oom_retries=1" in out and "checkpoint step 4:" in out
    assert [r["oom_retries"] for r in trainer.log] == [0, 1, 0, 0]
    assert checkpointing.valid_steps(str(tmp_path)) == [2, 4]
    trainer, state = train.main(base + ["--steps", "5", "--resume"])
    out = capsys.readouterr().out
    assert "resumed from checkpoint step 4" in out and state.step == 5
    train.main(base + ["--steps", "4", "--resume"])
    assert "nothing to do: checkpoint already at step 4 >= target 4" in capsys.readouterr().out


def test_trainer_still_refuses_what_is_not_ported():
    """Adaptive MACT and expert placement are ported and construct; a
    config whose inputs the port has not ported still raises."""
    tr = Trainer(CFG, _ctx(), **KW, adaptive_mact=True, use_placement=True,
                 placement_replicas=1)
    assert tr.mact.replica_slots == 1 and tr.telemetry.num_layers == 2
    learned = dataclasses.replace(CFG, learned_pos=64)
    with pytest.raises(NotImplementedError, match="not ported"):
        Trainer(learned, _ctx(), **KW, adaptive_mact=True).fit(1)


def test_injected_oom_under_adaptive_mact_walks_as_the_reference_trainer(monkeypatch):
    """An injected OOM under adaptive MACT (per-layer vectors, re-planned
    every 3 steps): the same rungs, schedule vectors, plans and audits as
    the JAX trainer's, and the audit forces a fresh per-layer plan at the
    next step."""
    jax = pytest.importorskip("jax")
    import repro.launch
    from repro.configs import registry
    from repro.core import moe as jmoe
    from repro.runtime import faults as jfaults
    from repro.training import trainer as jtrainer
    from repro_torch.bridge import params_from_jax
    monkeypatch.delattr(repro.launch, "hlo_analysis", raising=False)
    monkeypatch.setitem(sys.modules, "repro.launch.hlo_analysis", None)
    jc = registry()["mixtral-8x7b"].reduced()
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))
    kw = dict(KW, adaptive_mact=True, replan_interval=3)
    jt = jtrainer.Trainer(jc, jmoe.DistContext(mesh=mesh, moe_strategy="ep_shardmap",
                                               moe_fused=True),
                          injector=jfaults.FaultInjector.from_string("oom@1"),
                          hw=jguard_hw(), **kw)
    tt = Trainer(CFG, _ctx(), injector=FaultInjector.from_string("oom@1"), **kw)
    jstate = jtrainer.init_train_state(jax.random.PRNGKey(0), jc)
    tstate = make_train_state(params_from_jax(jax.tree.map(np.asarray, jstate.params),
                                              CFG, CPU))
    jt.fit(4, jstate)
    tt.fit(4, tstate)
    vecs = lambda tr: [[tuple(s) for s in v] for v in tr.schedule_trace]  # noqa: E731
    assert vecs(tt) == vecs(jt)
    assert tt.chunk_trace == jt.chunk_trace and tt.pipeline_trace == jt.pipeline_trace
    assert [r["oom_retries"] for r in tt.log] == [r["oom_retries"] for r in jt.log] \
        == [0, 1, 0, 0]
    keys = lambda esc: [(e["step"], e["failed"], e["next"], e["retries"])  # noqa: E731
                        for e in esc]
    assert keys(tt.guard.escalations) == keys(jt.guard.escalations)
    audit = lambda a: [(x["step"], x["key"], x["modeled_total_gb"], x["modeled_fits"])  # noqa: E731
                       for x in a]
    assert audit(tt.guard.audits) == audit(jt.guard.audits)
    assert tt.headroom_widenings == jt.headroom_widenings and tt.headroom_widenings
    plans = lambda tr: [h for h in tr.mact.history if "layer_schedules" in h]  # noqa: E731
    assert [h["s_pp"] for h in plans(tt)] == [h["s_pp"] for h in plans(jt)]
    # the second plan ran at step 2, just after the OOM, not at step 3 as
    # the interval alone would have it (a run without the fault)
    calm = Trainer(CFG, _ctx(), **kw)
    calm.fit(4, make_train_state(params_from_jax(
        jax.tree.map(np.asarray, jtrainer.init_train_state(jax.random.PRNGKey(0),
                                                           jc).params), CFG, CPU)))
    assert (tt._plan_age, jt._plan_age, calm._plan_age) == (2, 2, 1)
    assert len(plans(tt)) == len(plans(calm)) == 2
    np.testing.assert_array_equal(tt.telemetry.loads, jt.telemetry.loads)
    np.testing.assert_allclose([r["loss"] for r in tt.log], [r["loss"] for r in jt.log],
                               rtol=1e-4, atol=1e-4)


def test_audit_reads_the_model_and_widens_the_headroom():
    """The model said the failed schedule fit: plan wider.  On the CPU the
    card's measures are None."""
    tr = Trainer(CFG, _ctx(), injector=FaultInjector.from_string("oom@0"), **KW)
    before = tr.mact_headroom
    tr.fit(1)
    (audit,) = tr.guard.audits
    assert audit["modeled_fits"] is True and tr.mact_headroom > before
    assert audit["headroom"] == (before, tr.mact_headroom)
    assert audit["peak_allocated_gb"] is None and audit["tried_gb"] is None
    assert audit["modeled_total_gb"] == pytest.approx(
        tr.mact.memory_report(audit["s_pp"], *audit["key"])["total_gb"])


def test_sliced_adamw_equals_the_per_tensor_update(monkeypatch):
    """The transactional update, its tensors cut into several slices, gives
    the bits the per-tensor update it replaced gave (the same fp32
    operations, element by element)."""
    monkeypatch.setattr(adamw, "_SLICE_ELEMS", 1024)
    gen = torch.Generator().manual_seed(0)
    specs = [((64, 48), torch.bfloat16), ((5,), torch.float32), ((3000,), torch.float32),
             ((7, 300), torch.bfloat16)]
    params = [torch.randn(s, generator=gen).to(dt) for s, dt in specs]
    grads = [torch.randn(s, generator=gen).to(dt) * 3 for s, dt in specs]
    grads[1] = None
    state = adamw.adamw_init(params)
    for m, v in zip(state.mu, state.nu):
        m.normal_(generator=gen)
        v.uniform_(generator=gen)
    p2, m2, v2 = ([t.clone() for t in ts] for ts in (params, state.mu, state.nu))
    adamw.adamw_update(grads, state._replace(step=4), params, lr=1e-2)
    gnorm = adamw.global_norm(grads)
    scale = torch.clamp(1.0 / torch.clamp(gnorm, min=1e-9), max=1.0)
    bc1, bc2 = (1 - torch.tensor(b, dtype=torch.float32) ** 5 for b in (0.9, 0.95))
    for p, g, m, v in zip(p2, grads, m2, v2):          # the per-tensor update
        gf = torch.zeros_like(m) if g is None else g.to(torch.float32) * scale
        m.mul_(0.9).add_(gf, alpha=1 - 0.9)
        v.mul_(0.95).addcmul_(gf, gf, value=1 - 0.95)
        u = (m / bc1).div_((v / bc2).sqrt_().add_(1e-8))
        pf = p.to(torch.float32)
        u.add_(pf, alpha=0.1)
        p.copy_(pf.add_(u, alpha=-1e-2))
    for got, want in zip(params + state.mu + state.nu, p2 + m2 + v2):
        assert torch.equal(got, want)
