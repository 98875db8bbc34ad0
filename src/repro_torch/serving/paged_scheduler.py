"""Paged continuous batching: page allocation, prefix reuse, preemption.

``PagedScheduler`` keeps the parent's control flow (FIFO admission at step
boundaries, chunked-prefill interleave, requeue on a fault) and swaps the
memory substrate, as the JAX package's ``serving/paged_scheduler.py`` does:

* **Paged residency.**  The slot pool becomes page pools
  (``serving/paged_cache.py``); a request holds pages for the blocks it has
  filled, and admission charges the paged memory model
  (``core/memory_model.py::serving_paged_fits``) with the allocated bytes
  plus each resident's outstanding worst-case reservation, so a short
  request no longer reserves a whole max-length cache.
* **Prefix reuse.**  With ``prefix_cache``, finished prefills register the
  whole aligned blocks of their prompt in a token-id trie, each node with a
  host snapshot of the mamba layers' state at its boundary (taken as the
  prefill passes it); a later request sharing the prefix adopts those pages
  (CoW-shared), resumes its chunked prefill from the deepest matched node's
  boundary and snapshot, and pays pages only for the tail.
* **Preemption.**  With ``preemption``, a refused head-of-queue request
  walks the ServingGuard's escalation ladder: reclaim prefix pages, then
  spill the lowest-priority active request (strictly below the incoming
  one) to the host; the victim re-enters the queue, accepted and
  deadline-exempt, and restores bit-exactly once pages free up.

The decode wave gathers per-slot dense caches from the page tables and runs
the unchanged ``transformer.decode_step`` (one CUDA graph per pool on the
card), so paged decode gives the slot map's tokens.  Prefill chunks run on
the extend step's static B=1 cache, as in the parent, and ``install``
scatters it into pages.  Expert-aware waves and the residency tier are
the parent's, with the paged wave (``PagedCachePool.decode_wave_loads``):
membership rides the page tables, a non-member slot reading the zero page
and writing the scratch page.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import memory_model as mm
from repro_torch.core.moe import DistContext
from repro_torch.runtime.faults import FaultInjector
from repro_torch.runtime.guard import is_oom_error
from repro_torch.serving import engine
from repro_torch.serving.paged_cache import PagedCachePool
from repro_torch.serving.paging import (PagesExhausted, PrefixTrie,
                                        prefix_align)
from repro_torch.serving.scheduler import (ACTIVE, PREFILL, WAITING,
                                           ContinuousBatchingScheduler,
                                           Request, ServeConfig, _host)


class PagedScheduler(ContinuousBatchingScheduler):
    def __init__(self, params: dict, cfg: ModelConfig, ctx: DistContext,
                 scfg: ServeConfig, eager: bool = False,
                 injector: Optional[FaultInjector] = None):
        if scfg.page_size < 1:
            raise ValueError("PagedScheduler needs ServeConfig.page_size >= 1")
        super().__init__(params, cfg, ctx, scfg, eager=eager, injector=injector)
        self.pool = PagedCachePool(
            params, cfg, ctx, scfg.max_slots, scfg.cache_len, scfg.page_size,
            dtype_bytes=scfg.dtype_bytes, eager=eager)
        self.align = prefix_align(scfg.page_size, scfg.prefill_chunk)
        self.trie = (PrefixTrie(self.pool.ops, self.align)
                     if scfg.prefix_cache else None)
        if injector is not None:
            self.pool.ops.fault_hook = self._fault_hook
        self.preemptions = 0
        self.prefix_evictions = 0
        self._shared_len: dict[int, int] = {}   # rid -> adopted prefix length
        self._snapshots: dict[int, dict] = {}   # rid -> {aligned boundary:
                                                # state snapshot}

    def _make_slot_pool(self):
        return None                     # the page pools replace the slot pool

    def _fault_hook(self, where: str) -> None:
        self.injector.maybe_fail_step(self.steps, where)

    # -- paged memory model --------------------------------------------------

    def _outstanding_reservations(self) -> float:
        """Bytes residents may still allocate: each one's worst case minus
        what it privately owns already.  Admission charges allocated +
        outstanding, so later on-demand allocations never push the modeled
        peak past the budget."""
        residents = list(self.active.values())
        if self._prefilling is not None:
            residents.append(self._prefilling)
        total = 0.0
        for req in residents:
            if req.rp is None:
                continue
            wc = self._worst_case(req, self._shared_len.get(req.rid, 0))
            total += max(0.0, wc - req.rp.private_bytes)
        return total

    def _worst_case(self, req: Request, shared_len: int) -> float:
        return self.pool.ops.worst_case_bytes(
            len(req.prompt) + req.max_new_tokens, shared_len)

    def _page_bytes_now(self, extra: float = 0.0) -> float:
        return (self.pool.alloc.allocated_bytes()
                + self._outstanding_reservations() + extra)

    def _paged_kw(self) -> dict:
        s = self.scfg
        return dict(prefill_tokens=s.prefill_chunk, dtype_bytes=s.dtype_bytes,
                    weight_bytes=s.weight_bytes,
                    replica_weight_bytes=s.replica_weight_bytes,
                    **self._resident_kw())

    def modeled_bytes(self, requests: Optional[int] = None) -> float:
        occ = self.occupancy() if requests is None else requests
        return mm.serving_paged_peak_bytes(
            self.cfg, page_bytes=self._page_bytes_now(),
            decode_tokens=min(self.scfg.max_slots, occ), **self._paged_kw())

    def _fits_extra(self, extra_bytes: float, occ_after: int) -> bool:
        return mm.serving_paged_fits(
            self.cfg, self.scfg.hw, page_bytes=self._page_bytes_now(extra_bytes),
            decode_tokens=min(self.scfg.max_slots, occ_after), **self._paged_kw())

    # -- intake --------------------------------------------------------------

    def submit(self, req: Request, now: float = 0.0) -> None:
        s = self.scfg
        if len(req.tokens) + req.max_new_tokens > s.cache_len:
            raise ValueError(
                f"request {req.rid}: prompt {len(req.tokens)} + gen "
                f"{req.max_new_tokens} exceeds cache_len {s.cache_len}")
        req.prompt = np.asarray(req.tokens)
        wc = self._worst_case(req, 0)
        if not mm.serving_paged_fits(self.cfg, s.hw, page_bytes=wc,
                                     decode_tokens=1, **self._paged_kw()):
            raise ValueError(
                f"request {req.rid} can never be admitted: its worst-case "
                f"pages ({wc / 1e9:.2f} GB) plus weights exceed "
                f"{s.hw.alpha:.2f} * {s.hw.hbm_bytes / 1e9:.0f} GB")
        if self.guard.overloaded(len(self.queue)):
            self._shed(req, now)
            return
        req.state = WAITING
        self.queue.append(req)

    # -- admission: prefix reuse + escalation ladder -------------------------

    def _admit(self) -> None:
        while self.queue and self.free_slots:
            req = self.queue[0]
            if req.spill is not None:
                if not self._readmit_preempted(req):
                    break
                continue
            if self._prefilling is not None:
                break
            matched, nodes = (self.trie.lookup(req.tokens)
                              if self.trie is not None else (0, []))
            while matched >= len(req.tokens):   # keep >= 1 token to prefill
                nodes.pop()
                matched -= self.align
            wc = self._worst_case(req, matched)
            if not self._fits_extra(wc, self.occupancy() + 1):
                if not self._relieve_pressure(req):
                    break
                continue
            self.queue.popleft()
            req.state = PREFILL
            req.accepted = True
            req.slot = self.free_slots.pop(0)
            req.rp = self.pool.ops.new_request()
            self._shared_len[req.rid] = matched
            self._snapshots[req.rid] = {}
            if matched:
                self.trie.adopt(req.rp, nodes)
                dense = self.pool.gather_dense(req.rp.tables, nodes[-1].snapshot,
                                               matched)
                if self._pcache is not None:  # resume on the static cache
                    engine.copy_cache_(self._pcache, dense)
                    dense = self._pcache
                req.cache = dense
                req.chunks_done = matched // self.scfg.prefill_chunk
            self._prefilling = req
            self.admission_order.append(req.rid)
        self.max_occupancy = max(self.max_occupancy, self.occupancy())
        self.modeled_peak = max(self.modeled_peak, self.modeled_bytes())

    def _readmit_preempted(self, req: Request) -> bool:
        """A spilled request at the queue head: restore its pages (fully
        private: sharing does not survive a spill) straight into ACTIVE; its
        position, sampled tokens and decode feed are where the preemption
        left them."""
        wc = self._worst_case(req, 0)
        if not self._fits_extra(wc, self.occupancy() + 1):
            if self.trie is not None and self.trie.evict_lru_leaf():
                self.prefix_evictions += 1
                return True
            return False
        try:
            rp = self.pool.restore(req.spill)
        except PagesExhausted:
            return False
        self.queue.popleft()
        req.spill = None
        req.rp = rp
        self._shared_len[req.rid] = 0
        req.slot = self.free_slots.pop(0)
        req.state = ACTIVE
        self.active[req.slot] = req
        return True

    def _relieve_pressure(self, incoming: Request) -> bool:
        """Walk the guard's escalation ladder for a refused admission: evict
        a prefix-cache leaf, then preempt the lowest-priority active request
        strictly below the incoming one.  Returns True if a rung freed
        memory (the caller re-checks admission)."""
        for rung in self.guard.admission_escalation(
                self.trie is not None, self.scfg.preemption):
            if rung == "evict_prefix":
                if self.trie.evict_lru_leaf():
                    self.prefix_evictions += 1
                    return True
            elif rung == "preempt":
                victim = self._pick_victim(incoming.priority)
                if victim is not None and self._preempt(victim):
                    return True
        return False

    def _pick_victim(self, above: int) -> Optional[Request]:
        cands = [r for r in self.active.values() if r.priority < above]
        if not cands:
            return None
        # lowest priority first; among ties the most recently admitted (its
        # lost batching time is the smallest)
        return max(cands, key=lambda r: (-r.priority, r.t_first or 0.0))

    def _preempt(self, victim: Request) -> bool:
        hook = self._fault_hook if self.injector is not None else None
        try:
            saved = self.pool.spill(victim.rp, fault_hook=hook)
        except Exception as exc:
            if not is_oom_error(exc):
                raise
            # a fault mid-preemption: the spill aborted before any reference
            # dropped, so the victim stays resident and nothing is lost
            self.faults += 1
            return False
        victim.rp = None
        victim.spill = saved
        victim.preemptions += 1
        self.preemptions += 1
        self._shared_len.pop(victim.rid, None)
        self.active.pop(victim.slot)
        self.free_slots.append(victim.slot)
        victim.state = WAITING               # accepted: deadline-exempt
        # behind the incoming head it was evicted for: in front it would be
        # readmitted into the pages just freed and preempted again, forever;
        # behind everything would starve an accepted request
        self.queue.insert(min(1, len(self.queue)), victim)
        return True

    # -- prefill: state snapshots, paged install, prefix registration --------

    def _chunk_done(self, req: Request, stop: int) -> None:
        """A prefill chunk ending at an aligned boundary that may register:
        keep the mamba layers' state there, what a prefix-hit resume needs."""
        if (self.trie is not None and stop % self.align == 0
                and stop <= self._registrable_len(len(req.tokens))):
            self._snapshots[req.rid][stop] = self.pool.state_snapshot(req.cache)

    def _registrable_len(self, prompt_len: int) -> int:
        """Prefix blocks are stable only while no ring has wrapped: a prompt
        longer than a ring overwrote its earliest blocks during prefill, so
        nothing of it registers."""
        for g in self.pool.groups:
            if g.ring and prompt_len > g.length:
                return 0
        return prompt_len

    def _install(self, req: Request, logits: torch.Tensor, now: float) -> None:
        S = len(req.tokens)
        try:
            self.pool.install(req.rp, req.cache, S,
                              shared_len=self._shared_len.get(req.rid, 0))
        except Exception as exc:
            if not (is_oom_error(exc) or isinstance(exc, PagesExhausted)):
                raise
            # pages ran out mid-install (or an injected CoW fault): requeue
            # this request; nothing accepted is lost
            self.faults += 1
            self._requeue_prefilling(req)
            return
        if self.trie is not None:
            upto = self._registrable_len(S) // self.align * self.align
            if upto:
                # the trie creates nodes only at boundaries this prefill
                # passed and snapshotted (an adopted node evicted since stops
                # it, as in the reference)
                self.trie.register(req.tokens, upto, req.rp,
                                   self._snapshots.get(req.rid, {}))
        self._snapshots.pop(req.rid, None)
        req.cache = None
        req.pos = S
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

    def _requeue_prefilling(self, req: Request) -> None:
        self.pool.release(req.rp)
        req.rp = None
        self._shared_len.pop(req.rid, None)
        self._snapshots.pop(req.rid, None)
        req.cache = None
        req.chunks_done = 0
        req.state = WAITING
        req.requeues += 1
        self.requeued += 1
        self.free_slots.append(req.slot)
        self._prefilling = None
        self.queue.appendleft(req)

    # -- decode: the paged wave ----------------------------------------------

    def _requeue_active(self) -> None:
        for req in self.active.values():
            self.pool.release(req.rp)
            req.rp = None
            self._shared_len.pop(req.rid, None)
        super()._requeue_active()

    def _decode_wave(self, now: float) -> None:
        if self._expert_aware:
            self._decode_wave_expert(now)
            return
        n = self.scfg.max_slots
        toks = np.zeros((n, 1), np.int64)
        pos = np.zeros((n,), np.int64)
        try:
            for slot, req in self.active.items():
                toks[slot, 0] = req.next_token
                pos[slot] = req.pos
                # the write block must be exclusively owned before the wave
                # (CoW fires here on a ring wrap into a shared prefix page);
                # before the wave's fault point, so an armed kind@step spec
                # lands mid-CoW when one is pending
                self.pool.prepare_decode_write(req.rp, req.pos)
            if self.injector is not None:
                self.injector.maybe_fail_step(self.steps, "decode_wave")
            slot_rps = [self.active[i].rp if i in self.active else None
                        for i in range(n)]
            logits = self.pool.decode_wave(self.params, slot_rps, pos, toks)
            logits = logits.cpu().numpy()      # (slots, 1, V): the host fetch
        except Exception as exc:               # is where a real OOM surfaces
            if not self._wave_fault_ok(exc):
                raise
            self._wave_recover(now)
            return
        self.decode_waves += 1
        for slot, req in list(self.active.items()):
            req.pos += 1
            self._append_token(req, logits[slot, -1], now)

    # -- expert-aware wave hooks ----------------------------------------------

    def _wave_fault_ok(self, exc: Exception) -> bool:
        return is_oom_error(exc) or isinstance(exc, PagesExhausted)

    def _wave_recover(self, now: float) -> None:
        self.faults += 1
        self._requeue_active()
        if self.ctx.device.type != "cpu":
            # the pools may be torn mid-wave: zero them in place and drop
            # the trie's now-dangling pins (prefixes recompute)
            self._rebuild_pools()

    def _advance_member(self, req: Request) -> None:
        req.pos += 1

    def _run_wave(self, members: list, mask: np.ndarray):
        """The paged member wave to the residency fixpoint.  Membership rides
        the page tables: a non-member slot gets ``rp=None`` (zero-page reads,
        scratch-page writes), so no run touches a non-member's pages or state
        block, and a re-run rewrites the members' rows from the same inputs
        once their state blocks are put back."""
        n = self.scfg.max_slots
        toks = np.zeros((n, 1), np.int64)
        pos = np.zeros((n,), np.int64)
        for slot in members:
            req = self.active[slot]
            toks[slot, 0] = req.next_token
            pos[slot] = req.pos
            # CoW before the wave, as in the FIFO path; ensure_writable is
            # idempotent, so re-runs see the same owned block
            self.pool.prepare_decode_write(req.rp, req.pos)
        if self.injector is not None:
            self.injector.maybe_fail_step(self.steps, "decode_wave")
        slot_rps = [self.active[i].rp if mask[i] and i in self.active else None
                    for i in range(n)]
        # a re-run starts from the members' states before the first run
        state = (self.pool.state_rows([self.active[i].rp for i in members])
                 if self.residency is not None and self.pool.layout.has_state
                 else None)
        out = {}

        def once():
            logits, load = self.pool.decode_wave_loads(self.params, slot_rps,
                                                       pos, toks)
            out["logits"], load = _host(logits, load)
            # non-member slots decoded token 0 from the zero page: zero
            # their load rows so unions and telemetry see members only
            out["load"] = load * mask[:, None, None]
            return out["load"].sum(0) > 0

        self._demand_fixpoint(
            once, None if state is None else lambda: self.pool.put_state_rows(state))
        return out["logits"], out["load"]

    def _rebuild_pools(self) -> None:
        if self.trie is not None:
            self.trie.clear()
        self.pool.clear()

    def _evict(self, req: Request, now: float) -> None:
        if req.rp is not None:
            self.pool.release(req.rp)
            req.rp = None
        self._shared_len.pop(req.rid, None)
        super()._evict(req, now)

    # -- telemetry -----------------------------------------------------------

    def metrics(self, elapsed: float) -> dict:
        m = super().metrics(elapsed)
        m["preemptions"] = self.preemptions
        m["prefix_evictions"] = self.prefix_evictions
        m["page_hwm_bytes"] = self.pool.alloc.hwm_bytes()
        m["page_allocated_bytes"] = self.pool.alloc.allocated_bytes()
        if self.trie is not None:
            m.update({f"prefix_{k}": v for k, v in self.trie.stats().items()})
        return m
