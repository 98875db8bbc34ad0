"""The span recorder (``runtime/spans.py``) and its spans in the training step.

* Off (no profiler session, no ``enable()``), ``span()`` is one shared
  no-op, the ``attn.bwd`` markers return the very tensor they are given,
  and a checkpoint gets its default context: nothing is recorded and no
  autograd node is added.
* Spans nest by a per-thread stack; a torch profiler session turns the
  recorder on and its end turns it off.
* One step of the reduced Mixtral under ``remat_policy="memfine"`` (the EP
  strategy at one peer, the fused leg) records each layer's recompute, each
  chunk checkpoint's recompute, each attention backward, each run of an
  FCDA chunk body and AdamW's updated elements, and every ``attn.bwd``
  inside ``train.backward``.
* The step's loss, gradients and updated state are bitwise those of the
  same step with the recorder off."""

import dataclasses
import sys
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils.checkpoint import noop_context_fn

from repro_torch.configs import get_config
from repro_torch.core.moe import DistContext
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.optim.adamw import param_list
from repro_torch.runtime import spans
from repro_torch.training.step import init_train_state, loss_fn, make_train_step
from repro_torch.training.trainer import Trainer

CPU = torch.device("cpu")
torch.set_num_threads(min(torch.get_num_threads(), 2))
SEQ, BATCH = 32, 2


@pytest.fixture(autouse=True)
def _fresh():
    spans.enable(None)
    spans.clear()
    yield
    spans.enable(None)
    spans.clear()


def _names(recs):
    return [r.name for r in recs]


def test_off_the_recorder_returns_shared_no_ops_and_adds_no_node():
    assert not spans.recording()
    assert spans.span("attn", device=True) is spans.OFF
    x = torch.randn(3, requires_grad=True)
    y = x * 2
    marks = spans.backward_span("attn.bwd", device=True)
    assert marks is spans.OFF
    assert marks.inputs(x) is x
    out = marks.output(y)
    assert out is y and out.grad_fn is y.grad_fn
    assert spans.recompute_context("remat.layer") is noop_context_fn
    base = object()
    assert spans.recompute_context("remat.layer", base) is base
    with spans.span("train.step"):
        spans.count("fcda.chunk_runs")
    assert spans.records() == [] and spans.counters() == {}


def test_on_the_markers_add_identity_nodes_and_span_the_backward():
    spans.enable()
    x = torch.randn(3, requires_grad=True)
    with spans.span("outer"):
        marks = spans.backward_span("attn.bwd")
        xin = marks.inputs(x)
        assert xin is not x and torch.equal(xin, x)
        y = marks.output(xin * 3)
        assert type(y.grad_fn).__name__ == "_OpenBackward"
        (g,) = torch.autograd.grad(y.sum(), x)
    assert torch.equal(g, torch.full((3,), 3.0))
    recs = {r.name: r for r in spans.records()}
    assert set(recs) == {"outer", "attn.bwd"}
    assert recs["attn.bwd"].parent == recs["outer"].id
    assert recs["outer"].start_ns <= recs["attn.bwd"].start_ns <= recs["attn.bwd"].end_ns
    assert recs["attn.bwd"].device_ms is None            # no device on the CPU


def test_nested_spans_get_their_parents_and_threads_their_own_stack():
    spans.enable()
    seen = {}

    def other():
        with spans.span("thread.top"):
            with spans.span("thread.inner"):
                seen["ident"] = threading.get_ident()

    with spans.span("a"):
        t = threading.Thread(target=other)
        t.start()
        t.join()
        with spans.span("b"):
            with spans.span("c", device=True):
                spans.count("n", 2)
            spans.count("n")
    recs = {r.name: r for r in spans.records()}
    assert recs["a"].parent is None and recs["thread.top"].parent is None
    assert recs["b"].parent == recs["a"].id
    assert recs["c"].parent == recs["b"].id
    assert recs["thread.inner"].parent == recs["thread.top"].id
    assert recs["thread.inner"].thread == seen["ident"] != recs["a"].thread
    assert _names(spans.records())[:2] == ["thread.inner", "thread.top"]
    assert spans.counters() == {"n": 3}
    spans.clear()
    assert spans.records() == [] and spans.counters() == {}


def test_threads_lose_no_count_and_no_span():
    """More threads than cores, switching often: every count and span kept."""
    spans.enable()
    threads, each = 16, 400
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(each):
                with spans.span("s"):
                    spans.count("n")

        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(old)
    recs = spans.records()
    assert spans.counters() == {"n": threads * each}
    assert len(recs) == threads * each and len({r.id for r in recs}) == len(recs)
    assert all(r.parent is None for r in recs)


def test_a_profiler_session_turns_the_recorder_on_and_its_end_off():
    with spans.span("before"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        assert spans.recording()
        with spans.span("inside"):
            spans.count("fcda.chunk_runs")
        spans.enable(False)                  # forced off under the profiler
        assert spans.span("forced") is spans.OFF
        spans.enable(None)
    assert not spans.recording()
    with spans.span("after"):
        pass
    assert _names(spans.records()) == ["inside"]
    assert spans.counters() == {"fcda.chunk_runs": 1}


def _trainer(chunks: int, depth: int, policy: str = "memfine"):
    cfg = get_config("mixtral-8x7b").reduced()
    cfg = dataclasses.replace(cfg, remat_policy=policy)
    ctx = DistContext(device=CPU, moe_strategy="ep_shardmap", moe_fused=True,
                      moe_chunks=chunks, pipeline_chunks=depth)
    return cfg, ctx, Trainer(cfg, ctx, seq_len=SEQ, global_batch=BATCH, lr=1e-3,
                             use_mact=False)


@pytest.mark.parametrize("chunks,depth", [(2, 1), (4, 2)])
def test_one_memfine_step_records_each_recompute_and_chunk_run(chunks, depth):
    cfg, _, tr = _trainer(chunks, depth)
    layers = cfg.num_layers
    state = tr.fit(1, init_train_state(cfg, torch.float32, CPU, 0))
    assert spans.records() == []                      # off: nothing recorded
    spans.enable()
    tr.fit(1, state)
    spans.enable(None)
    assert (tr.log[-1]["chunks"], tr.log[-1]["pipeline"]) == (chunks, depth)
    recs = spans.records()
    by = {}
    for r in recs:
        by.setdefault(r.name, []).append(r)
    for name in ("train.step", "train.plan", "train.batch", "train.readback",
                 "train.forward", "train.backward", "train.optimizer"):
        assert len(by[name]) == 1, name
    # each layer's checkpoint recomputes once; each wave of ``depth`` chunks
    # has its own checkpoint; attention runs in the forward and again in its
    # layer's recompute, and its backward once
    assert len(by["remat.layer"]) == layers
    assert len(by["remat.chunk"]) == layers * chunks // depth
    assert len(by["attn"]) == 2 * layers
    assert len(by["attn.bwd"]) == layers
    # chunk bodies: c in the forward, c again in the chunk recomputes, and
    # c - depth in the layer's recompute, which stops (early stop) once the
    # last wave's input is saved again, before that wave runs; AdamW counts
    # every parameter element it updated, none of them by the card's kernel
    assert spans.counters() == {"fcda.chunk_runs": layers * (3 * chunks - depth),
                                "adamw.elems": sum(p.numel() for p in param_list(state.params))}
    # the router runs in every chunk's forward and in each recompute of it
    assert len(by["moe.route"]) == layers * (3 * chunks - depth)
    (step,), (bwd,) = by["train.step"], by["train.backward"]
    for r in recs:
        assert step.start_ns <= r.start_ns <= r.end_ns <= step.end_ns, r.name
    for r in by["attn.bwd"] + by["remat.layer"] + by["remat.chunk"]:
        assert bwd.start_ns <= r.start_ns <= r.end_ns <= bwd.end_ns, r.name
    assert by["train.forward"][0].parent == step.id


def _snapshot(state):
    return ([p.detach().clone() for p in param_list(state.params)],
            [m.clone() for m in state.opt.mu], [v.clone() for v in state.opt.nu])


@pytest.mark.parametrize("policy", ["memfine", "selective"])
def test_the_step_is_bitwise_the_same_with_the_recorder_on(policy):
    cfg, ctx, _ = _trainer(4, 2, policy)
    batch = {k: torch.as_tensor(v, device=CPU)
             for k, v in SyntheticLMData(cfg, SEQ, BATCH, 0).batch_at(0).items()}
    out = {}
    for on in (False, True):
        spans.enable(on)
        state = init_train_state(cfg, torch.float32, CPU, 0)
        loss, _ = loss_fn(state.params, cfg, ctx, batch)
        grads = torch.autograd.grad(loss, param_list(state.params), allow_unused=True)
        state, metrics = make_train_step(cfg, ctx, lr=1e-3)(state, batch)
        out[on] = (loss.detach(), grads, metrics["loss"], *_snapshot(state))
    assert {r.name for r in spans.records()} >= {"attn.bwd", "remat.layer",
                                                 "remat.chunk", "train.optimizer"}
    (l0, g0, m0, p0, mu0, nu0), (l1, g1, m1, p1, mu1, nu1) = out[False], out[True]
    assert torch.equal(l0, l1) and torch.equal(m0, m1)
    for a, b in zip(g0, g1):
        assert (a is None and b is None) or torch.equal(a, b)
    for xs, ys in ((p0, p1), (mu0, mu1), (nu0, nu1)):
        assert all(torch.equal(a, b) for a, b in zip(xs, ys))
