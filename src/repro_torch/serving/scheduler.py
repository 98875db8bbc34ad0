"""Continuous-batching scheduler on the MemFine serving memory model.

* **Slot map.**  The decode batch is a fixed pool of ``max_slots``
  per-request cache slots.  One decode wave runs ``transformer.decode_step``
  over the whole pool with one position per slot (RoPE positions, ring
  write cursors and valid lengths included), so requests join and leave at
  step boundaries.  The pool's cache is fp32 whatever the weights' type.
* **Admission control.**  A queued request starts only when the serving
  memory model (``core/memory_model.py::serving_fits``: weights +
  per-request caches + the worse of a decode wave and a prefill chunk) says
  the modeled peak still fits ``alpha * M_GPU``.
* **Chunked prefill interleave.**  Prompts are split by
  ``core/chunking.py::chunk_spans`` and prefilled one chunk per scheduler
  step between decode waves.
* **Compiled steps.**  Waves and chunks run the engine's compiled steps
  (``serving/engine.py``): on a CUDA device each replays a captured CUDA
  graph.  The slot pool is the decode step's static cache, and the one
  request prefilling at a time runs on the extend step's static B=1 cache,
  so a wave copies only its tokens in and its logits out.  ``eager=True``
  runs the same steps' eager functions instead, the counterpart of
  ``jax.disable_jit``: for same-call comparisons and the tests.

Request lifecycle: WAITING -> PREFILL -> ACTIVE -> FINISHED, plus the
overload exit WAITING -> SHED for never-admitted requests whose deadline
lapsed or that arrived past the queue bound.  A decode wave that runs out of
device memory (or meets an injected fault, ``runtime/faults.py``) requeues
its accepted requests with their tokens intact.

The paged cache, prefix reuse and preemption are the subclass in
``serving/paged_scheduler.py``, which overrides this class's hooks
(``_make_slot_pool``, ``submit``, ``_admit``, ``_install``,
``_requeue_active``, ``_decode_wave``, ``_evict``).  The JAX package's expert-aware waves and
expert-weight residency are not ported yet; asking for them raises.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import H100_80G, HardwareProfile, ModelConfig
from repro_torch.core import memory_model as mm
from repro_torch.core.chunking import chunk_spans
from repro_torch.core.moe import DistContext
from repro_torch.runtime.faults import FaultInjector
from repro_torch.runtime.guard import ServingGuard, is_oom_error
from repro_torch.serving import engine

WAITING, PREFILL, ACTIVE, FINISHED, SHED = ("waiting", "prefill", "active",
                                            "finished", "shed")


@dataclass
class Request:
    rid: int
    tokens: np.ndarray                  # (S,) int32 prompt (grows on requeue)
    max_new_tokens: int
    arrival: float = 0.0                # seconds after scheduler start
    deadline_s: Optional[float] = None  # admission deadline (None = guard's)
    priority: int = 0                   # preemption rank (paged scheduler):
                                        # higher may preempt strictly lower
    # -- runtime (scheduler-owned) -----------------------------------------
    state: str = WAITING
    slot: int = -1
    chunks_done: int = 0
    cache: object = None                # its (B=1) cache while prefilling
    next_token: int = -1
    out: list = field(default_factory=list)
    t_first: Optional[float] = None     # first-token time (s after start)
    t_done: Optional[float] = None
    accepted: bool = False              # ever admitted -- shed-exempt
    prompt: Optional[np.ndarray] = None
    pending_token: int = -1             # requeue: already-sampled token the
                                        # re-prefill must not resample
    requeues: int = 0
    retry_after: Optional[float] = None
    # -- paged scheduler runtime --------------------------------------------
    rp: object = None                   # its RequestPages while resident
    pos: int = 0                        # decode write position (host-side)
    spill: object = None                # its pages on the host while preempted
    preemptions: int = 0


@dataclass(frozen=True)
class ServeConfig:
    max_slots: int = 4
    cache_len: int = 128
    prefill_chunk: int = 32
    hw: HardwareProfile = H100_80G
    dtype_bytes: int = 2                # modeled cache/act bytes
    weight_bytes: float = mm.WEIGHT_ONLY_BYTES
    temperature: float = 0.0
    seed: int = 0                       # sampling seed (temperature > 0)
    deadline_s: Optional[float] = None
    max_waiting: int = 0
    # paging (serving/paged_scheduler.py; 0/False = the slot map)
    page_size: int = 0                  # tokens per cache page
    prefix_cache: bool = False          # trie-shared prompt prefixes
    preemption: bool = False            # spill low-priority residents to the
                                        # host under admission pressure
    # the JAX package's expert-aware serving; not ported yet
    expert_batching: bool = False
    wave_size: int = 0
    resident_experts: int = 0
    probe_router: bool = False


_NOT_PORTED = ("expert_batching", "wave_size", "resident_experts",
               "probe_router")


class ContinuousBatchingScheduler:
    def __init__(self, params: dict, cfg: ModelConfig, ctx: DistContext,
                 scfg: ServeConfig, eager: bool = False,
                 injector: Optional[FaultInjector] = None):
        asked = [f for f in _NOT_PORTED if getattr(scfg, f)]
        if asked:
            raise NotImplementedError(f"serving options {asked} are not "
                                      "ported yet; the port serves the slot "
                                      "map and the paged cache")
        if cfg.encoder_layers or cfg.num_patch_tokens:
            raise ValueError("continuous batching serves token-only decoders; "
                             f"{cfg.name!r} needs per-request encoder state")
        self.params, self.cfg, self.ctx, self.scfg = params, cfg, ctx, scfg
        self.eager = eager
        self.queue: deque[Request] = deque()
        self.active: dict[int, Request] = {}          # slot -> request
        self.free_slots = list(range(scfg.max_slots))
        self._prefilling: Optional[Request] = None
        self._decode = engine.get_decode_step(cfg, ctx)
        self._extend = engine.get_extend_step(cfg, ctx)
        self._prefill = engine.get_prefill_fn(cfg, ctx, scfg.cache_len)
        self.cache = self._make_slot_pool()
        # the prefilling request's cache (None: each prefill makes its own)
        self._pcache = None if eager else self._static(self._extend, 1)
        self.injector = injector
        self.guard = ServingGuard(deadline_s=scfg.deadline_s,
                                  max_waiting=scfg.max_waiting)
        self.steps = 0
        self.decode_waves = 0
        self.prefill_chunks = 0
        self.max_occupancy = 0
        self.modeled_peak = 0.0
        self.nonfinite_logits = 0       # sampled logit rows with a NaN or inf
        self.admission_order: list[int] = []
        self.finished: list[Request] = []
        self.shed: list[Request] = []
        self.requeued = 0
        self.faults = 0

    def _make_slot_pool(self):
        """The decode step's slot pool: one cache row per slot."""
        return self._static(self._decode, self.scfg.max_slots)

    def _static(self, step: engine.CompiledStep, rows: int) -> dict:
        """A zeroed fp32 cache of ``rows`` rows: one of ``step``'s static
        caches, held by this scheduler, unless ``eager``."""
        cache = engine.init_serve_cache(self.params, self.cfg, rows,
                                        self.scfg.cache_len)
        return cache if self.eager else step.static_cache(cache, self)

    def _call(self, step: engine.CompiledStep, *args):
        """A compiled step, or its eager function under ``eager``."""
        return (step.eager if self.eager else step)(self.params, *args)

    # -- memory model -------------------------------------------------------

    def occupancy(self) -> int:
        """Requests currently holding cache memory (installed + prefilling)."""
        return len(self.active) + (1 if self._prefilling is not None else 0)

    def _model_kw(self) -> dict:
        s = self.scfg
        return dict(cache_len=s.cache_len, decode_tokens=s.max_slots,
                    prefill_tokens=s.prefill_chunk, dtype_bytes=s.dtype_bytes,
                    weight_bytes=s.weight_bytes)

    def modeled_bytes(self, requests: Optional[int] = None) -> float:
        return mm.serving_peak_bytes(
            self.cfg, requests=self.occupancy() if requests is None else requests,
            **self._model_kw())

    def _admissible(self, requests: int) -> bool:
        return mm.serving_fits(self.cfg, self.scfg.hw, requests=requests,
                               **self._model_kw())

    # -- request intake -----------------------------------------------------

    def submit(self, req: Request, now: float = 0.0) -> None:
        s = self.scfg
        if len(req.tokens) + req.max_new_tokens > s.cache_len:
            raise ValueError(
                f"request {req.rid}: prompt {len(req.tokens)} + gen "
                f"{req.max_new_tokens} exceeds cache_len {s.cache_len}")
        if not self._admissible(1):
            raise ValueError(
                f"request {req.rid} can never be admitted: modeled bytes for "
                f"one request ({self.modeled_bytes(1) / 1e9:.2f} GB) exceed "
                f"{s.hw.alpha:.2f} * {s.hw.hbm_bytes / 1e9:.0f} GB")
        req.prompt = np.asarray(req.tokens)
        if self.guard.overloaded(len(self.queue)):
            self._shed(req, now)
            return
        req.state = WAITING
        self.queue.append(req)

    # -- shedding / fault recovery ------------------------------------------

    def _service_rate(self, now: float) -> float:
        return len(self.finished) / now if now > 0 else 0.0

    def _shed(self, req: Request, now: float) -> None:
        """Refuse a never-accepted request with a client-visible retry-after."""
        if req.accepted:
            raise RuntimeError(f"request {req.rid} was accepted; it cannot be shed")
        req.state = SHED
        req.t_done = now
        backlog = len(self.queue) + self.occupancy()
        req.retry_after = self.guard.retry_after(backlog + 1,
                                                 self._service_rate(now))
        self.shed.append(req)

    def _expire_deadlines(self, now: float) -> None:
        """Shed WAITING requests whose admission deadline lapsed; accepted
        (requeued) requests are exempt."""
        kept = deque()
        for req in self.queue:
            if not req.accepted and self.guard.expired(req, now):
                self._shed(req, now)
            else:
                kept.append(req)
        self.queue = kept

    def _requeue_active(self) -> None:
        """Evict every ACTIVE slot and requeue its request at the head of
        the queue, keeping its sampled tokens: ``tokens`` becomes prompt +
        generated-so-far minus the pending one, which re-arms the decode."""
        for slot in sorted(self.active.keys(), reverse=True):
            req = self.active.pop(slot)
            self.free_slots.append(slot)
            req.tokens = np.concatenate(
                [req.prompt, np.asarray(req.out[:-1], np.int32)])
            req.pending_token = req.out[-1]
            req.chunks_done = 0
            req.cache = None
            req.state = WAITING
            req.requeues += 1
            self.requeued += 1
            self.queue.appendleft(req)

    def _admit(self) -> None:
        """FIFO admission at step boundaries: a slot must be free, at most
        one request prefills at a time, and the serving memory model must
        accept one more resident cache."""
        while (self.queue and self.free_slots and self._prefilling is None
               and self._admissible(self.occupancy() + 1)):
            req = self.queue.popleft()
            req.state = PREFILL
            req.accepted = True
            req.slot = self.free_slots.pop(0)
            self._prefilling = req
            self.admission_order.append(req.rid)
        # occupancy peaks at admission, so measure it here
        self.max_occupancy = max(self.max_occupancy, self.occupancy())
        self.modeled_peak = max(self.modeled_peak, self.modeled_bytes())

    # -- prefill interleave -------------------------------------------------

    def _prefill_step(self, now: float) -> None:
        req = self._prefilling
        spans = chunk_spans(len(req.tokens), self.scfg.prefill_chunk)
        start, stop = spans[req.chunks_done]
        seg = torch.as_tensor(req.tokens[None, start:stop], dtype=torch.long,
                              device=self.ctx.device)
        if req.cache is None:
            logits, cache = self._call(self._prefill, {"tokens": seg})
            if self._pcache is not None:
                engine.copy_cache_(self._pcache, cache)
                cache = self._pcache
        else:
            full, cache = self._call(self._extend, req.cache, seg)
            logits = full[:, -1:]
        req.cache = cache
        req.chunks_done += 1
        self.prefill_chunks += 1
        if req.chunks_done == len(spans):
            self._install(req, logits, now)

    def _install(self, req: Request, logits: torch.Tensor, now: float) -> None:
        """Join at a step boundary: copy the private prefill cache into the
        reserved slot and sample the first token from the prefill logits."""
        _copy_row(self.cache, req.cache, req.slot)
        req.cache = None
        req.state = ACTIVE
        if req.t_first is None:
            req.t_first = now
        self.active[req.slot] = req
        self._prefilling = None
        if req.pending_token >= 0:
            req.next_token = req.pending_token
            req.pending_token = -1
        else:
            self._append_token(req, logits[0, -1].cpu().numpy(), now)

    # -- decode -------------------------------------------------------------

    def _sample(self, req: Request, logits_v: np.ndarray) -> int:
        if self.scfg.temperature > 0:
            # seeded per (request, position): the draw does not depend on
            # which other requests share the wave
            rng = np.random.default_rng([self.scfg.seed, req.rid, len(req.out)])
            z = logits_v.astype(np.float64) / self.scfg.temperature
            p = np.exp(z - z.max())
            return int(rng.choice(len(p), p=p / p.sum()))
        return int(np.argmax(logits_v))

    def _append_token(self, req: Request, logits_v: np.ndarray,
                      now: float) -> None:
        if not np.isfinite(logits_v).all():
            self.nonfinite_logits += 1
        tok = self._sample(req, logits_v)
        req.out.append(tok)
        req.next_token = tok
        if len(req.out) >= req.max_new_tokens:
            self._evict(req, now)

    def _evict(self, req: Request, now: float) -> None:
        """Leave at a step boundary: release the slot (its contents are dead
        until the next install overwrites them)."""
        req.state = FINISHED
        req.t_done = now
        self.active.pop(req.slot, None)
        self.free_slots.append(req.slot)
        self.finished.append(req)

    def _decode_wave(self, now: float) -> None:
        toks = np.zeros((self.scfg.max_slots, 1), np.int64)
        for slot, req in self.active.items():
            toks[slot, 0] = req.next_token
        try:
            if self.injector is not None:
                self.injector.maybe_fail_step(self.steps, "decode_wave")
            logits, self.cache = self._call(
                self._decode, self.cache,
                torch.as_tensor(toks, device=self.ctx.device))
            logits = logits.cpu().numpy()      # (slots, 1, V): the host fetch
        except Exception as exc:               # is where a real OOM surfaces
            if not is_oom_error(exc):
                raise
            # the wave's slot pool may be half-written: requeue the accepted
            # requests and zero it in place (it is the decode graph's static
            # cache); their re-prefills repopulate it
            self.faults += 1
            self._requeue_active()
            for t in engine.leaves(self.cache):
                t.zero_()
            return
        self.decode_waves += 1
        for slot, req in list(self.active.items()):
            self._append_token(req, logits[slot, -1], now)

    # -- main loop ----------------------------------------------------------

    def step(self, now: float = 0.0) -> bool:
        """One scheduler step: expire lapsed deadlines, admit, run one
        prefill chunk, run one decode wave.  Returns False when there was
        nothing to do."""
        if self.injector is not None:
            self.injector.maybe_stall(self.steps)      # a stalled prefill
        self._expire_deadlines(now)
        self._admit()
        busy = False
        if self._prefilling is not None:
            self._prefill_step(now)
            busy = True
        if self.active:
            self._decode_wave(now)
            busy = True
        self.steps += 1
        return busy

    def run(self, requests: list[Request]) -> dict:
        """Drive a trace of requests (``arrival`` = seconds after start) to
        completion against the wall clock; returns the metrics dict."""
        pending = sorted(requests, key=lambda r: r.arrival)
        t0 = time.perf_counter()
        i = 0
        while (i < len(pending) or self.queue or self.active
               or self._prefilling is not None):
            now = time.perf_counter() - t0
            while i < len(pending) and pending[i].arrival <= now:
                self.submit(pending[i], now)
                i += 1
            if not self.step(now) and i < len(pending):
                time.sleep(min(pending[i].arrival - now, 0.01))
        return self.metrics(time.perf_counter() - t0)

    def metrics(self, elapsed: float) -> dict:
        lat = [r.t_done - r.arrival for r in self.finished]
        gen = sum(len(r.out) for r in self.finished)
        return {
            "requests": len(self.finished),
            "generated_tokens": gen,
            "elapsed_s": elapsed,
            "tok_per_s": gen / elapsed if elapsed > 0 else 0.0,
            "latency_p50_s": float(np.percentile(lat, 50)) if lat else 0.0,
            "latency_p99_s": float(np.percentile(lat, 99)) if lat else 0.0,
            "decode_waves": self.decode_waves,
            "prefill_chunks": self.prefill_chunks,
            "max_occupancy": self.max_occupancy,
            "modeled_peak_bytes": self.modeled_peak,
            "budget_bytes": self.scfg.hw.alpha * self.scfg.hw.hbm_bytes,
            "nonfinite_logits": self.nonfinite_logits,
            "shed": len(self.shed),
            "retry_after_p50_s": (float(np.percentile(
                [r.retry_after for r in self.shed], 50))
                if self.shed else 0.0),
            "requeues": self.requeued,
            "faults": self.faults,
        }


def _copy_row(pool, one, slot: int) -> None:
    """Copy row 0 of every tensor of a B=1 cache into row ``slot`` of the
    pool's matching tensor."""
    if isinstance(pool, dict):
        for k in pool:
            _copy_row(pool[k], one[k], slot)
    elif isinstance(pool, list):
        for p, o in zip(pool, one):
            _copy_row(p, o, slot)
    else:
        pool[slot] = one[0]
