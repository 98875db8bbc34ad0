"""Training cells: the program's ``Trainer.fit`` (the EP strategy at one
peer with the fused expert leg, MACT choosing the FCDA schedule), on the
benchmark's weights and the mix's batches.

Set-up builds one trainer and one train state, drives them through the
first ``WARM`` steps with the window's own call and feed, and reads from
them what the check compares: each step's loss, the first gradient from
AdamW's first moments (m = (1 - b1) g s, s the clipping scale of the
logged global norm) and, after the last of them, the parameters' change
against the initial weights made again from the seed.  The same trainer
and state then run the window: whole steps through ``Trainer.fit(1)``
until ``seconds`` have passed.  The batches were made in set-up; their
copy to the device is inside each step.

After the window the program's state is freed and the configuration's
plain reference (``cell.reference``) runs the same three steps in fp32
from the same weights and rows.  The weights' leaves come from the
configuration's architecture file (``cell.arch.plan``); this driver reads
only the spec's generic keys (``perfbench/spec.py``).
"""

from __future__ import annotations

import gc
import math
import statistics
import sys
import time

import torch

from perfbench import check, generator, weights
from perfbench.reference.common import Prec, no_tf32

LR = 3e-4
WARM = 3           # the checked steps, which are also the warm-up


class Feed:
    """The trainer's data source (``trainer.data``): the batches by step."""

    def __init__(self, feed: generator.TrainFeed):
        self.batch_at = feed.batch


def build(cell):
    """(trainer, state) on the benchmark's weights, before any step."""
    from repro_torch.core.moe import DistContext
    from repro_torch.training.step import make_train_state
    from repro_torch.training.trainer import Trainer
    mix = cell.mix
    params = weights.make(cell.arch.plan(cell.spec), cell.seed, cell.device, cell.dtype)
    ctx = DistContext(device=torch.device(cell.device), moe_strategy="ep_shardmap",
                      moe_fused=True)
    trainer = Trainer(cell.pcfg, ctx, seq_len=int(mix["seq_len"]),
                      global_batch=int(mix["batch"]), lr=LR, seed=cell.seed,
                      dtype=cell.dtype, max_pipeline_depth=2)
    trainer.data = Feed(cell.feed)
    return trainer, make_train_state(params)


@torch.no_grad()
def _delta_norms(params: list, plan: list, seed: int, device, dtype) -> list:
    """Per leaf, the norm of (now - initial), the initial leaf made again."""
    out = []
    for i, p in enumerate(params):
        p0 = weights.leaf(plan, seed, i, device, dtype).reshape(-1)
        pv, acc = p.detach().reshape(-1), 0.0
        for a in range(0, pv.numel(), 1 << 26):
            acc += float((pv[a:a + (1 << 26)].double() - p0[a:a + (1 << 26)].double())
                         .pow(2).sum())
        out.append(acc ** 0.5)
        del p0
    return out


SAMPLE = 1 << 20    # elements of each leaf's first gradient held for the check


def sample_index(numel: int, seed: int, leaf: int, device) -> torch.Tensor:
    """A seeded sample of a leaf's flat positions (all of a small leaf)."""
    if numel <= SAMPLE:
        return torch.arange(numel, device=device)
    gen = torch.Generator(device=device).manual_seed(weights.leaf_seed(seed, 1000 + leaf))
    return torch.randint(numel, (SAMPLE,), generator=gen, device=device)


def warm(trainer, state, cell):
    """The first WARM steps; returns (state, the program's readings)."""
    state = trainer.fit(1, state)
    b1 = cell.reference.ADAMW["b1"]
    scale = min(1.0, 1.0 / max(trainer.log[0]["grad_norm"], 1e-9))
    grad = [float(m.norm()) / (1 - b1) / scale for m in state.opt.mu]
    sample = [(m.reshape(-1)[sample_index(m.numel(), cell.seed, i, m.device)]
               / ((1 - b1) * scale)).cpu() for i, m in enumerate(state.opt.mu)]
    state = trainer.fit(WARM - 1, state)
    from repro_torch.optim.adamw import param_list
    delta = _delta_norms(param_list(state.params), cell.arch.plan(cell.spec), cell.seed,
                         cell.device, cell.dtype)
    return state, {"loss": [r["loss"] for r in trainer.log[:WARM]],
                   "grad_norms": grad, "delta_norms": delta, "grad_sample": sample,
                   "chunks": [r["chunks"] for r in trainer.log[:WARM]]}


def _reference_leaf(t: torch.Tensor):
    """A leaf as the reference trains it: fp32, and a stack of experts as
    one independent tensor per expert, so that an expert's gradient never
    takes the size of the whole stack."""
    if t.dim() == 3:
        return [t[e].float().clone() for e in range(t.shape[0])]
    return t.float()


def reference_readings(cell, chunks: list, prec: Prec, rows=None) -> dict:
    """The reference's readings over the same first steps and rows, per
    leaf of the program's tree."""
    if torch.device(cell.device).type == "cuda":
        no_tf32()
    plan = cell.arch.plan(cell.spec)
    tree = weights.make(plan, cell.seed, cell.device, cell.dtype)
    sizes = [t.shape[0] if t.dim() == 3 else 1 for t in weights.flat(tree)]
    params = _tree_map(tree, _reference_leaf)
    del tree
    batches = [{k: torch.as_tensor(v, device=cell.device)
                for k, v in cell.feed.batch(i).items()} for i in range(len(chunks))]

    def sample(part_grads):
        """Each leaf's gradient at the program's sampled positions, read
        from the leaf's parts (one per expert of a stack)."""
        out, at = [], 0
        parts = weights.flat(params)
        for i, n in enumerate(sizes):
            per = parts[at].numel()
            idx = sample_index(per * n, cell.seed, i, parts[at].device)
            got = torch.zeros(idx.shape, dtype=torch.float32, device=idx.device)
            for e in range(n):
                g = part_grads[at + e]
                sel = idx // per == e
                if g is not None:
                    got[sel] = g.reshape(-1)[idx[sel] % per]
            out.append(got.cpu())
            at += n
        return out

    out = cell.reference.train(params, batches, cell.spec, chunks, LR, prec, rows=rows,
                               sample=sample)
    parts, grads, at = weights.flat(params), [], 0
    delta = []
    with torch.no_grad():
        for i, n in enumerate(sizes):
            grads.append(math.sqrt(sum(g * g for g in out["grad_norms"][at:at + n])))
            p0 = weights.leaf(plan, cell.seed, i, cell.device, cell.dtype)
            p0 = p0.reshape(n, *parts[at].shape) if n > 1 else p0[None]
            delta.append(math.sqrt(sum(float((parts[at + e].double() - p0[e].double())
                                             .pow(2).sum()) for e in range(n))))
            at += n
            del p0
    out["grad_norms"], out["delta_norms"] = grads, delta
    del params, parts
    return out


def _tree_map(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree_map(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(v, fn) for v in tree]
    return fn(tree)


def _free() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run(cell, window) -> dict:
    """Set up, warm, measure, check.  ``window`` is the measured window's
    context (``trace.Window``).  Returns the run's record."""
    mix, spec = cell.mix, cell.spec
    B, S = int(mix["batch"]), int(mix["seq_len"])
    t0 = time.perf_counter()
    cell.feed = generator.train_feed(mix, spec["vocab_size"], cell.seed, cell.seconds, WARM)
    t1 = time.perf_counter()
    trainer, state = build(cell)
    t2 = time.perf_counter()
    state, prog = warm(trainer, state, cell)
    print(f"set-up: feed {t1 - t0:.2f} s, weights and trainer {t2 - t1:.2f} s, "
          f"{WARM} checked steps {[round(r['time_s'], 3) for r in trainer.log]} s, "
          f"readings {time.perf_counter() - t2 - sum(r['time_s'] for r in trainer.log):.2f} s, "
          f"process start to here {time.perf_counter() - cell.t_start:.2f} s", file=sys.stderr)
    cuda = torch.device(cell.device).type == "cuda"
    trainer.max_memory_allocated = None
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    cell.mark_setup()
    n = 0
    with window:
        t0 = time.perf_counter()
        while True:
            state = trainer.fit(1, state)
            n += 1
            if time.perf_counter() - t0 >= cell.seconds:
                break
    steps = trainer.log[WARM:]
    peak = max(trainer.max_memory_allocated or 0,
               torch.cuda.max_memory_allocated() if cuda else 0)
    last = trainer.log[-1]
    s_pp = trainer.mact.history[-1]["s_pp"]
    s_pp = max(s_pp) if isinstance(s_pp, list) else s_pp
    modeled = trainer.mact.memory_report(s_pp, last["chunks"], last["pipeline"])
    # the log's load is summed over the MoE layers
    fair = B * S * spec["top_k"] / spec["n_experts"] * sum(
        1 for lay in spec["layers"] if lay["ffn"] == "moe")
    print(f"train: {n} steps in {window.window_s:.3f} s, chunks "
          f"{[r['chunks'] for r in trainer.log]}, depth "
          f"{[r['pipeline'] for r in trainer.log]}, max expert load over the fair "
          f"share {statistics.mean(r['max_load'] for r in steps) / fair:.3f}, drops "
          f"{sum(r['drops'] for r in steps):.0f}, oom retries "
          f"{sum(r['oom_retries'] for r in trainer.log)}", file=sys.stderr)
    record = {
        "steps": steps, "tokens": n * B * S, "batch": B, "seq": S,
        "peak_bytes": trainer.max_memory_allocated or 0,
        "modeled_bytes": modeled["total_gb"] * 2**30,
        "memory_peak_bytes": peak,
    }
    e2e = {"train_tokens_per_s": (n * B * S / window.window_s, "tokens/s"),
           "train_peak_gb": ((trainer.max_memory_allocated or 0) / 1e9, "GB")}
    del trainer, state
    _free()
    t_ref = time.perf_counter()
    refr = reference_readings(cell, prog["chunks"], Prec("fp32"))
    _free()
    readings = check.train_gaps(prog, refr)
    print(f"train check: program losses {prog['loss']}, reference losses "
          f"{refr['loss']}, first step's loss gap {readings.pop('loss_gap')!r} (not "
          f"compared), reference {time.perf_counter() - t_ref:.1f} s", file=sys.stderr)
    bad = sum(1 for r in steps if not math.isfinite(r["loss"]))
    return {"record": record, "e2e": e2e, "readings": readings,
            "attempted": n, "failed": bad}
