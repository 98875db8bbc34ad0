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

* **Expert-aware waves.**  ``wave_size``, ``expert_batching`` or
  ``resident_experts`` engage the masked subset wave
  (``engine.get_decode_step_masked``): at most ``wave_size`` residents
  decode per wave, chosen FIFO by age or, with ``expert_batching``,
  greedily by least growth of the wave's predicted expert union (per-request
  ``ExpertTelemetry``, seeded by the router probe with ``probe_router``),
  with a starvation guard (``max_wave_wait``).  Every step reports its
  routed loads, which feed the telemetry.
* **Expert residency.**  ``resident_experts`` keeps that many experts per
  MoE layer on the device (``serving/residency.py``); the wave's predicted
  set is prefetched and a run that touched a cold expert is rewound, the
  expert restored and the run re-issued (``_demand_fixpoint``), so tokens
  are bit-identical to the all-resident run.  Admission prices the resident
  set plus the prefetch buffer.  The tier writes the weights in place:
  ``close`` restores them whole for the next user of the same ``params``.

The paged cache, prefix reuse and preemption are the subclass in
``serving/paged_scheduler.py``, which overrides this class's hooks
(``_make_slot_pool``, ``submit``, ``_admit``, ``_chunk_done``,
``_install``, ``_requeue_active``, ``_decode_wave``, ``_evict``, and the
expert-aware wave's ``_run_wave``, ``_wave_fault_ok``, ``_wave_recover``
and ``_advance_member``).
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
from repro_torch.core.telemetry import ExpertTelemetry
from repro_torch.models import transformer
from repro_torch.runtime.faults import FaultInjector
from repro_torch.runtime.guard import ServingGuard, is_oom_error
from repro_torch.serving import engine, residency

WAITING, PREFILL, ACTIVE, FINISHED, SHED = ("waiting", "prefill", "active",
                                            "finished", "shed")

#: the residency tier's modeled in-flight prefetch buffer: expert-layer rows
#: the memory model prices on top of the resident set
PREFETCH_EXPERTS = 1


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
    wave_wait: int = 0                  # consecutive decode waves skipped
                                        # while ACTIVE (starvation guard)
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
    replica_weight_bytes: float = 0.0   # static cost of the build-time expert
                                        # placement's replica slots
                                        # (engine.build_placements), priced
                                        # by admission like any weight bytes
    # expert-aware decode + residency
    expert_batching: bool = False       # group waves by predicted expert
                                        # overlap instead of FIFO age order
    wave_size: int = 0                  # max members per decode wave (0 =
                                        # every resident; >0 engages the
                                        # masked subset step)
    max_wave_wait: int = 4              # starvation guard: a resident that
                                        # skipped this many waves is force-
                                        # included in the next one
    resident_experts: int = 0           # per-MoE-layer resident expert
                                        # capacity (0 = all resident, tier
                                        # off); cold experts host-offloaded
    probe_router: bool = False          # router-only probe on prompt tokens
                                        # seeds the prefetch prediction of
                                        # requests with no telemetry yet


def check_servable(cfg: ModelConfig) -> None:
    """The schedulers serve token-only decoders, as the reference's do: an
    encoder or patch-input config raises (``engine.prefill`` and
    ``engine.generate`` serve it), and so does a config with latent
    attention, which only trains."""
    if cfg.encoder_layers or cfg.num_patch_tokens:
        raise ValueError("continuous batching serves token-only decoders; "
                         f"{cfg.name!r} needs per-request encoder state")
    if cfg.mla is not None:
        raise ValueError(f"{cfg.name!r} has multi-head latent attention, which "
                         f"the port only trains (launch/train.py): it has no "
                         f"latent cache to serve from")


class ContinuousBatchingScheduler:
    def __init__(self, params: dict, cfg: ModelConfig, ctx: DistContext,
                 scfg: ServeConfig, eager: bool = False,
                 injector: Optional[FaultInjector] = None):
        check_servable(cfg)
        self.params, self.cfg, self.ctx, self.scfg = params, cfg, ctx, scfg
        self.eager = eager
        self.queue: deque[Request] = deque()
        self.active: dict[int, Request] = {}          # slot -> request
        self.free_slots = list(range(scfg.max_slots))
        self._prefilling: Optional[Request] = None
        # expert-aware decode + weight residency: any of the three knobs
        # engages the masked subset wave and the routed-load telemetry
        self._expert_aware = (scfg.expert_batching or scfg.wave_size > 0
                              or scfg.resident_experts > 0)
        self.telemetry: Optional[ExpertTelemetry] = None
        self.residency: Optional[residency.ExpertResidency] = None
        self._probe = None
        if self._expert_aware:
            if cfg.moe is None:
                raise ValueError("expert-aware serving (expert_batching / "
                                 "wave_size / resident_experts) needs a MoE "
                                 f"config; {cfg.name!r} is dense")
            self.telemetry = ExpertTelemetry(transformer.num_moe_layers(cfg),
                                             cfg.moe.num_experts)
            self._decode = engine.get_decode_step_masked(cfg, ctx)
            if scfg.probe_router:
                self._probe = engine.get_router_probe(cfg, ctx)
        else:
            self._decode = engine.get_decode_step(cfg, ctx)
        self._extend = engine.get_extend_step(cfg, ctx)
        self._prefill = engine.get_prefill_fn(cfg, ctx, scfg.cache_len)
        self.cache = self._make_slot_pool()
        # the prefilling request's cache (None: each prefill makes its own)
        self._pcache = None if eager else self._static(self._extend, 1)
        if scfg.resident_experts > 0:
            n_moe = transformer.num_moe_layers(cfg)
            always = residency.always_resident_sets(
                ctx.placements, n_moe, cfg.moe.num_experts)
            self.residency = residency.ExpertResidency(
                params, cfg, scfg.resident_experts, always_resident=always)
            self.residency.offload_cold(params)
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
        self._reset_wave_stats()

    def _reset_wave_stats(self) -> None:
        self.expert_waves = 0          # waves run through the masked step
        self.wave_distinct_sum = 0     # sum over waves of distinct activated
        self.wave_members_sum = 0      # experts / of member count
        self.forced_includes = 0       # starvation-guard force-inclusions
        self.prefetch_hits = 0         # activated expert-layer pairs already
        self.prefetch_misses = 0       # resident / restored on demand
        self.demand_reruns = 0         # wave/chunk re-runs after a restore

    def reset(self) -> None:
        """Clear the request state, counters, wave statistics and telemetry,
        and keep the compiled steps, their CUDA graphs, the static caches
        and the slot pool: a benchmark warms the steps with a throwaway
        trace, resets, then times a steady state that captures nothing.
        The residency tier keeps its resident sets and zeroes its
        counters."""
        self.queue.clear()
        self.active.clear()
        self.free_slots = list(range(self.scfg.max_slots))
        self._prefilling = None
        self.steps = self.decode_waves = self.prefill_chunks = 0
        self.max_occupancy = 0
        self.modeled_peak = 0.0
        self.nonfinite_logits = 0
        self.admission_order = []
        self.finished = []
        self.shed = []
        self.requeued = 0
        self.faults = 0
        self._reset_wave_stats()
        if self.telemetry is not None:
            self.telemetry.clear()
        if self.residency is not None:
            self.residency.reset_stats()

    def close(self) -> None:
        """Hand the weights back whole: the residency tier restores every
        offloaded expert in place (schedulers sharing one ``params`` see each
        other's offloads) and releases its host mirror.  Idempotent."""
        if self.residency is not None:
            self.residency.close(self.params)

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

    def _resident_kw(self) -> dict:
        """Memory-model kwargs of the residency tier: with a capacity set,
        admission prices the resident experts plus the in-flight prefetch
        buffer instead of the whole expert table."""
        s = self.scfg
        if s.resident_experts <= 0:
            return {}
        return {"resident_experts": s.resident_experts,
                "prefetch_experts": PREFETCH_EXPERTS}

    def _model_kw(self) -> dict:
        s = self.scfg
        return dict(cache_len=s.cache_len, decode_tokens=s.max_slots,
                    prefill_tokens=s.prefill_chunk, dtype_bytes=s.dtype_bytes,
                    weight_bytes=s.weight_bytes,
                    replica_weight_bytes=s.replica_weight_bytes,
                    **self._resident_kw())

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
        if self._expert_aware:
            logits, cache = self._prefill_compute(req, seg)
        elif req.cache is None:
            logits, cache, _ = self._call(self._prefill, {"tokens": seg})
        else:
            full, cache, _ = self._call(self._extend, req.cache, seg)
            logits = full[:, -1:]
        if req.cache is None and self._pcache is not None:
            engine.copy_cache_(self._pcache, cache)
            cache = self._pcache
        req.cache = cache
        req.chunks_done += 1
        self.prefill_chunks += 1
        self._chunk_done(req, stop)
        if req.chunks_done == len(spans):
            self._install(req, logits, now)

    def _chunk_done(self, req: Request, stop: int) -> None:
        pass                                    # paged: a boundary's state

    def _prefill_compute(self, req: Request, seg: torch.Tensor):
        """One expert-aware prefill or extend chunk for ``req``: its routed
        load feeds the request's telemetry and, under
        residency, is driven to the demand fixpoint (an extend re-run first
        puts back the rows and position the discarded run overwrote).
        Returns (logits on the host, cache)."""
        if (self.residency is not None and self._probe is not None
                and req.chunks_done == 0):
            # no telemetry yet: probe the prompt's routing on embeddings and
            # prefetch the predicted experts before the first chunk
            counts = _host(self._call(self._probe, seg[0]))[0]
            self.residency.prefetch(self.params, counts.sum(0) > 0)
        out = {}
        if req.cache is None:
            def once():
                logits, out["cache"], load = self._call(self._prefill,
                                                        {"tokens": seg})
                out["logits"], out["load"] = _host(logits, load)
                return out["load"] > 0
            rewind = None
        else:
            snap = (engine.snapshot_chunk(req.cache, self.cfg, seg.shape[1])
                    if self.residency is not None else None)

            def once():
                full, out["cache"], load = self._call(self._extend, req.cache,
                                                      seg)
                out["logits"], out["load"] = _host(full[:, -1:], load)
                return out["load"] > 0

            def rewind():
                engine.rewind_chunk(req.cache, snap)
        self._demand_fixpoint(once, rewind)
        self.telemetry.update(req.rid, out["load"])
        if self.residency is not None:
            self.residency.note(out["load"])
            self.residency.evict_to_capacity(self.params)
        return torch.from_numpy(out["logits"]), out["cache"]

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
        if self.telemetry is not None:
            self.telemetry.forget(req.rid)

    # -- expert-aware wave formation ------------------------------------------

    def _predicted_support(self, req: Request) -> Optional[np.ndarray]:
        """(L_moe, E) bool predicted-activation mask of ``req``: its
        telemetry support when seen, the router probe on its last 8 tokens
        as the cold-start fallback."""
        sup = self.telemetry.support(req.rid)
        if sup is not None:
            return sup
        if self._probe is not None:
            toks = torch.as_tensor(np.asarray(req.tokens[-8:], np.int64),
                                   device=self.ctx.device)
            return _host(self._call(self._probe, toks))[0].sum(axis=0) > 0
        return None

    def _expert_set(self, req: Request) -> frozenset:
        sup = self._predicted_support(req)
        if sup is None:
            return frozenset()
        return frozenset(int(e) for e in np.flatnonzero(sup.any(axis=0)))

    def _form_wave(self) -> list:
        """This wave's member slots.

        Everyone decodes when the residents fit ``wave_size``.  Over it,
        FIFO mode takes the longest-waiting residents; expert mode seeds
        with the starvation guard's force-includes (wave_wait >=
        max_wave_wait) and the longest-waiting request, then greedily adds
        the resident whose predicted expert set grows the wave's union the
        least: fewer distinct experts per wave is what the residency tier
        streams and decode bandwidth pays for."""
        s = self.scfg
        items = sorted(self.active.items())
        cap = s.wave_size if s.wave_size > 0 else len(items)
        if len(items) <= cap:
            return [slot for slot, _ in items]
        by_age = sorted(items, key=lambda kv: (-kv[1].wave_wait, kv[1].rid))
        if not s.expert_batching:
            return [slot for slot, _ in by_age[:cap]]
        chosen = [kv for kv in by_age
                  if kv[1].wave_wait >= s.max_wave_wait][:cap]
        self.forced_includes += len(chosen)
        taken = {slot for slot, _ in chosen}
        pool = [kv for kv in by_age if kv[0] not in taken]
        if not chosen and pool:
            chosen.append(pool.pop(0))            # seed: longest-waiting
        union = set()
        for _, req in chosen:
            union |= self._expert_set(req)
        while len(chosen) < cap and pool:
            best = min(pool, key=lambda kv: (
                len(self._expert_set(kv[1]) - union),
                -kv[1].wave_wait, kv[1].rid))
            pool.remove(best)
            chosen.append(best)
            union |= self._expert_set(best[1])
        return [slot for slot, _ in chosen]

    def _demand_fixpoint(self, run_once, rewind=None) -> np.ndarray:
        """Drive one compute (decode wave or prefill chunk) to the residency
        fixpoint.  ``run_once() -> act``, the (L_moe, E) bool matrix of
        experts the run's members routed through; ``rewind()`` puts back
        the state a run wrote, before a re-run.  A run that touched a cold
        expert is discarded, the expert restored on demand and the run
        re-issued from the same inputs, so the state the last run leaves is
        bitwise the all-resident run's.  Layer-0 routing depends on dense
        weights only, so each re-run trues a strictly longer prefix of MoE
        layers.  Returns the clean run's activation matrix."""
        demand: set = set()
        for attempt in range(residency.RERUN_LIMIT):
            if attempt and rewind is not None:
                rewind()
            act = run_once()
            if self.residency is None:
                break
            missing = self.residency.missing(act)
            if not missing:
                break
            self.demand_reruns += 1
            demand.update(missing)
            self.residency.ensure(self.params, missing, demand=True)
        else:
            raise RuntimeError("residency demand loop did not converge "
                               f"within {residency.RERUN_LIMIT} re-runs")
        if self.residency is not None:
            pairs = {(int(j), int(e)) for j, e in zip(*np.nonzero(act))}
            self.prefetch_misses += len(demand)
            self.prefetch_hits += len(pairs - demand)
        return act

    # hook points the paged subclass overrides ------------------------------

    def _wave_fault_ok(self, exc: Exception) -> bool:
        return is_oom_error(exc)

    def _wave_recover(self, now: float) -> None:
        """A faulted wave: the slot pool may be half-written, so requeue the
        accepted requests and zero it in place (it is the decode graph's
        static cache); their re-prefills repopulate it."""
        self.faults += 1
        self._requeue_active()
        for t in engine.leaves(self.cache):
            t.zero_()

    def _advance_member(self, req: Request) -> None:
        pass                                    # paged: decode cursor bump

    def _run_wave(self, members: list, mask: np.ndarray):
        """Run one member wave to the fixpoint.  Returns (logits, load) host
        arrays over all slots; non-member load rows are zero.  A re-run puts
        back the positions and the members' mamba states the discarded run
        advanced and rewrites the same K/V rows from the same inputs."""
        toks = np.zeros((self.scfg.max_slots, 1), np.int64)
        for slot, req in self.active.items():
            toks[slot, 0] = req.next_token
        if self.injector is not None:
            self.injector.maybe_fail_step(self.steps, "decode_wave")
        dev = self.ctx.device
        toks_t = torch.as_tensor(toks, device=dev)
        mask_t = torch.as_tensor(mask, device=dev)
        pos0 = self.cache["pos"].clone()
        rows = state = None
        if self.residency is not None:          # only a residency run re-runs
            rows = torch.as_tensor(members, device=dev)
            state = engine.snapshot_state(self.cache, rows)
        out = {}

        def once():
            logits, self.cache, load = self._call(self._decode, self.cache,
                                                  toks_t, mask_t)
            out["logits"], out["load"] = _host(logits, load)
            return out["load"].sum(0) > 0

        def rewind():
            self.cache["pos"].copy_(pos0)
            engine.restore_state(self.cache, state, rows)

        self._demand_fixpoint(once, rewind)
        return out["logits"], out["load"]

    def _decode_wave_expert(self, now: float) -> None:
        members = self._form_wave()
        if not members:
            return
        mask = np.zeros((self.scfg.max_slots,), bool)
        mask[members] = True
        if self.residency is not None:
            predicted = np.zeros((self.residency.num_layers,
                                  self.residency.num_experts), bool)
            for slot in members:
                sup = self._predicted_support(self.active[slot])
                if sup is not None:
                    predicted |= sup
            self.residency.prefetch(self.params, predicted)
        try:
            logits, load = self._run_wave(members, mask)
        except Exception as exc:               # the host fetch is where a
            if not self._wave_fault_ok(exc):   # real OOM surfaces
                raise
            self._wave_recover(now)
            return
        self.decode_waves += 1
        self.expert_waves += 1
        self.wave_members_sum += len(members)
        self.wave_distinct_sum += int(
            np.count_nonzero(load.sum(axis=(0, 1)) > 0))
        member_set = set(members)
        for slot, req in list(self.active.items()):
            if slot not in member_set:
                req.wave_wait += 1
                continue
            req.wave_wait = 0
            self.telemetry.update(req.rid, load[slot])
            self._advance_member(req)
            self._append_token(req, logits[slot, -1], now)
        if self.residency is not None:
            self.residency.note(load.sum(axis=0))

    def _decode_wave(self, now: float) -> None:
        if self._expert_aware:
            self._decode_wave_expert(now)
            return
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
            if not self._wave_fault_ok(exc):
                raise
            self._wave_recover(now)
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
            # -- expert-aware wave + residency counters ----------------------
            "expert_waves": self.expert_waves,
            "mean_distinct_experts": (self.wave_distinct_sum / self.expert_waves
                                      if self.expert_waves else 0.0),
            "mean_wave_occupancy": (self.wave_members_sum / self.expert_waves
                                    if self.expert_waves else 0.0),
            "forced_includes": self.forced_includes,
            "prefetch_hits": self.prefetch_hits,
            "prefetch_misses": self.prefetch_misses,
            "demand_reruns": self.demand_reruns,
            **({"residency": self.residency.stats()}
               if self.residency is not None else {}),
        }


def _host(*tensors) -> list:
    """``tensors`` as fp32 numpy arrays through one device-to-host copy: the
    demand loop reads a run's loads (and its logits with them) on the host
    after every run."""
    flat = torch.cat([t.reshape(-1).float() for t in tensors]).cpu().numpy()
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].reshape(t.shape))
        at += t.numel()
    return out


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
