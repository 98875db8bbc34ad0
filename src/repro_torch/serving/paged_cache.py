"""Paged cache pools: the tensor side of the paged serving path.

``serving/paging.py`` owns the bookkeeping (allocator, page tables, prefix
trie); this module owns the page pools and what runs on them.

* **CacheLayout** -- the port's decode cache is ``{"pos": (B,), "layers":
  [{"attn": {"k", "v"}} or {"ssm": {"ssm", "conv"}}, ...]}``
  (``models/transformer.py``), so its leaves are classified directly: every
  K and V leaf is a *token* leaf, paged along its token axis and grouped by
  ``Group(length, ring)`` from ``blocks.cache_len`` and ``blocks._is_ring``;
  a mamba layer's SSD state and conv tail, and an encoder-decoder layer's
  cross K/V (``cross_k``, ``cross_v``: (Se, KH, hd) each, written at
  install and only read by decode), are *state* leaves, one constant-size
  block per request in the allocator's state space; ``pos`` is kept on the
  host, one per request.  An attention decoder's state blocks weigh 0
  bytes, as the reference's do.
* **PagedCachePool** -- one fp32 pool per leaf: ``(RESERVED_PAGES + pages,
  page, KH, hd)`` per token leaf, ``(RESERVED_PAGES + blocks, *state
  shape)`` per state leaf.  A decode wave gathers each slot's page table
  into the dense per-slot cache (``blocks.gather_paged_tokens``) and each
  slot's state block, runs the unchanged ``transformer.decode_step``, writes
  each slot's one new K/V row back to its page and its whole new state back
  to its block: the engine's ``get_paged_decode_step``, a CUDA graph on the
  card whose static cache is the pools themselves.  So every write here --
  install, restore, the CoW page copy, the rebuild after a fault -- goes
  into the same tensors in place; rebinding a pool would leave a warm graph
  reading freed memory.

Paged decode is bit-identical to the slot map: the gathered dense cache
carries the same live values, the zero page stands in for never-filled
blocks (and the zero state block for an empty slot's state), and rows past
a request's filled length (stale rows of a reused page included) are masked
to -inf scores before the softmax, so their weight is exactly zero either
way.  An empty slot writes the scratch page and the scratch state block,
which nothing reads.

Install, gather-dense (a prefix hit's resume point, its state from the
trie node's snapshot), spill, restore and the CoW page copy run eagerly;
only the decode wave is a graph.  A spill copies a request's allocated
pages (not its whole table, as the reference does: at a 4096-token window
that is 256 blocks, almost all unallocated) and its state block to pinned
host tensors on the card, plain tensors on the CPU.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.moe import DistContext
from repro_torch.models import blocks
from repro_torch.models import ssm as ssm_mod
from repro_torch.serving import engine
from repro_torch.serving.paging import (RESERVED_PAGES, SCRATCH_PAGE,
                                        STATE_SPACE, ZERO_PAGE, Group,
                                        PageAllocator, PagesExhausted,
                                        PageTableOps, RequestPages, space_key)

KV = ("k", "v")
STATE = ("ssm", "conv")
CROSS = ("cross_k", "cross_v")


def state_leaf(layer: dict, name: str) -> torch.Tensor:
    """A layer cache's state leaf ``name``: a mamba leaf under ``"ssm"``,
    a cross K/V leaf at the top."""
    return layer["ssm"][name] if name in STATE else layer[name]


class CacheLayout:
    """Per layer of one (cfg, cache_len) decode cache: the page group of an
    attention layer's K and V leaves, or None for a mamba layer, and the
    shapes of the layer's state leaves (``state_shapes``: a mamba layer's
    state and conv tail, an encoder-decoder layer's cross K/V of
    ``cfg.encoder_seq`` encoder rows; None without any)."""

    def __init__(self, cfg: ModelConfig, cache_len: int):
        self.row = cfg.num_kv_heads * cfg.resolved_head_dim  # a leaf's token
        self.layer_groups: list[Optional[Group]] = []
        self.state_shapes: list[Optional[dict]] = []
        # ``encode`` adds the (encoder_seq, d) position table: every encoder
        # output has encoder_seq rows
        enc_seq = cfg.encoder_seq if cfg.encoder_layers else 0
        cross = (enc_seq, cfg.num_kv_heads, cfg.resolved_head_dim)
        for spec in cfg.layer_specs():
            if spec.mixer == "attn":
                Sc = blocks.cache_len(spec, cache_len)
                self.layer_groups.append(Group(length=Sc,
                                               ring=blocks._is_ring(spec, Sc)))
                self.state_shapes.append({n: cross for n in CROSS}
                                         if enc_seq else None)
            else:
                self.layer_groups.append(None)
                self.state_shapes.append(ssm_mod.state_shapes(cfg.d_model, spec.ssm))
        self.groups: list[Group] = sorted(
            {g for g in self.layer_groups if g is not None},
            key=lambda g: (g.length, g.ring))
        self.has_state = any(s is not None for s in self.state_shapes)

    # -- modeled sizes (production dtype, not the fp32 pools) ----------------

    def page_bytes(self, group: Group, page: int, dtype_bytes: int) -> float:
        leaves = len(KV) * self.layer_groups.count(group)
        return float(page * leaves * self.row * dtype_bytes)

    def state_bytes(self, dtype_bytes: int) -> float:
        """One request's state block: every mamba layer's state and conv
        tail and every cross K/V (0 for an attention decoder)."""
        return float(sum(math.prod(shape) for st in self.state_shapes
                         if st is not None for shape in st.values())
                     * dtype_bytes)


class PagedCachePool:
    """Page pools + the paged decode wave, install, gather, spill, restore.

    ``n_slots`` bounds the decode wave's width (the slot map's role).  Each
    group's pool holds the reference's default of ``(n_slots + 2) * blocks
    + 8`` pages and the state pools ``n_slots + 2`` blocks, allocated up
    front; the byte budget is the scheduler's, through the paged memory
    model.  ``eager`` runs the decode wave's eager function instead of its
    graph."""

    def __init__(self, params: dict, cfg: ModelConfig, ctx: DistContext,
                 n_slots: int, cache_len: int, page_size: int, *,
                 dtype_bytes: int = 2, eager: bool = False):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.n_slots = n_slots
        self.page = page_size
        self.eager = eager
        self.device = params["embed"].device
        self.layout = CacheLayout(cfg, cache_len)
        self.groups = self.layout.groups

        self.alloc = PageAllocator()
        for g in self.groups:
            self.alloc.add_space(space_key(g),
                                 (n_slots + 2) * g.blocks(page_size) + 8,
                                 self.layout.page_bytes(g, page_size,
                                                        dtype_bytes))
        self.alloc.add_space(STATE_SPACE, n_slots + 2,
                             self.layout.state_bytes(dtype_bytes))
        self.ops = PageTableOps(self.alloc, self.groups, page_size,
                                state_bytes=self.layout.state_bytes(
                                    dtype_bytes),
                                copy_page_fn=self._copy_page)

        kv = (cfg.num_kv_heads, cfg.resolved_head_dim)
        state_rows = RESERVED_PAGES + self.alloc.spaces[STATE_SPACE].total
        pools = []
        for g, st in zip(self.layout.layer_groups, self.layout.state_shapes):
            pool = {}
            if g is not None:
                rows = RESERVED_PAGES + self.alloc.spaces[space_key(g)].total
                pool = {n: torch.zeros((rows, page_size) + kv,
                                       dtype=torch.float32, device=self.device)
                        for n in KV}
            for n, shape in (st or {}).items():
                pool[n] = torch.zeros((state_rows,) + shape, dtype=torch.float32,
                                      device=self.device)
            pools.append(pool)
        self._decode = engine.get_paged_decode_step(
            cfg, ctx, tuple(self.layout.layer_groups), page_size)
        # the graph's static cache: every later write goes into these tensors
        self.pools = pools if eager else self._decode.static_cache(pools, self)

    def _layer_pools(self, group: Optional[Group] = None):
        """(pool dict, its group) per attention layer, only ``group``'s when
        given."""
        return [(p, g) for p, g in zip(self.pools, self.layout.layer_groups)
                if g is not None and (group is None or g == group)]

    def _state_pools(self) -> list:
        """The pool dict of every mamba layer, in layer order."""
        return [p for p, g in zip(self.pools, self.layout.layer_groups) if g is None]

    # -- table assembly (host) ----------------------------------------------

    def _ids(self, ids) -> torch.Tensor:
        return torch.as_tensor(np.asarray(ids, np.int64), device=self.device)

    def _state_blocks(self, slot_rps: list) -> tuple:
        """The (n_slots,) state blocks to gather and to write, the zero and
        the scratch block for empty slots; () without state leaves."""
        if not self.layout.has_state:
            return ()
        return tuple(self._ids([hole if rp is None or rp.state_block is None
                                else rp.state_block for rp in slot_rps])
                     for hole in (ZERO_PAGE, SCRATCH_PAGE))

    def _tables(self, slot_rps: list) -> tuple:
        """(n_slots, n_blocks_g) page ids per group to gather, the zero page
        for missing blocks and empty slots."""
        out = []
        for g in self.groups:
            t = np.full((self.n_slots, g.blocks(self.page)), ZERO_PAGE, np.int64)
            for s, rp in enumerate(slot_rps):
                if rp is None:
                    continue
                for b, pg in enumerate(rp.tables[g]):
                    if pg is not None:
                        t[s, b] = pg
            out.append(self._ids(t))
        return tuple(out)

    def _write_pages(self, slot_rps: list, pos) -> tuple:
        """(n_slots,) page ids per group that receive each slot's new row at
        ``pos``: the block ``prepare_decode_write`` made writable, the
        scratch page for empty slots."""
        out = []
        for g in self.groups:
            t = np.full((self.n_slots,), SCRATCH_PAGE, np.int64)
            for s, rp in enumerate(slot_rps):
                if rp is not None:
                    t[s] = rp.tables[g][g.block_of(int(pos[s]), self.page)]
            out.append(self._ids(t))
        return tuple(out)

    def _full_tables(self, tables: dict, hole: int) -> dict:
        """One request's 1-D page ids per group, ``hole`` for missing blocks."""
        return {g: self._ids([hole if p is None else p for p in tables[g]])
                for g in self.groups}

    def _copy_page(self, group: Group, src: int, dst: int) -> None:
        for pool, _ in self._layer_pools(group):
            for n in KV:
                pool[n][dst].copy_(pool[n][src])

    def clear(self) -> None:
        """Zero every pool in place (the decode graph keeps its pointers)."""
        for t in engine.leaves(self.pools):
            t.zero_()

    # -- high-level ops ------------------------------------------------------

    def prepare_decode_write(self, rp: RequestPages, pos: int) -> None:
        """Before a wave: the block receiving position ``pos`` must exist and
        be exclusively owned (CoW fires here when a ring write cursor
        re-enters a prefix-shared or trie-pinned page)."""
        for g in self.groups:
            self.ops.ensure_writable(rp, g, g.block_of(pos, self.page))

    def decode_wave(self, params: dict, slot_rps: list, pos: np.ndarray,
                    toks: np.ndarray) -> torch.Tensor:
        """One decode step over the slot map, paged: gather tables and state
        blocks -> dense per-slot caches -> unchanged decode_step -> each
        slot's new row to its page, its new state to its block.
        ``slot_rps[s]`` is the RequestPages of the request in slot s (None =
        empty slot: reads the zero page and block, writes the scratch ones);
        ``toks`` (n_slots, 1).  Returns the (n_slots, 1, V) logits on the
        device."""
        return self.decode_wave_loads(params, slot_rps, pos, toks)[0]

    def decode_wave_loads(self, params: dict, slot_rps: list, pos: np.ndarray,
                          toks: np.ndarray):
        """``decode_wave`` that also reports each slot's routed load: returns
        (logits (n_slots, 1, V), load (n_slots, L_moe, E)) on the device.
        Membership is ``slot_rps[s] is not None``: a non-member reads the
        zero page and block and writes the scratch ones, so a wave never
        touches a non-member's pages or state (its load row is garbage; the
        caller masks it).  Nothing on the host moves: the caller advances
        its members' positions once the residency demand loop has a clean
        run.  A re-run gathers the K/V row the first run wrote at ``pos``
        and rewrites it from the same inputs before any query reads it, but
        the first run advanced every member's state: the caller puts it back
        (``state_rows``, ``put_state_rows``) before a re-run."""
        step = self._decode.eager if self.eager else self._decode
        logits, _, load = step(params, self.pools, self._tables(slot_rps),
                               self._write_pages(slot_rps, pos),
                               self._state_blocks(slot_rps),
                               self._ids(pos), self._ids(toks))
        return logits, load

    def state_rows(self, rps: list):
        """A copy of the state blocks of ``rps`` (device tensors): what
        ``put_state_rows`` writes back before a re-run."""
        ids = self._ids([rp.state_block for rp in rps])
        return ids, [{n: pool[n][ids] for n in STATE} for pool in self._state_pools()]

    def put_state_rows(self, saved) -> None:
        ids, rows = saved
        for pool, r in zip(self._state_pools(), rows):
            for n in STATE:
                pool[n].index_put_((ids,), r[n])

    def install(self, rp: RequestPages, dense: dict, filled: int,
                shared_len: int = 0) -> None:
        """Scatter a finished (B=1) prefill cache into the request's pages
        and its state block.

        Allocates every block holding live rows; prefix-shared blocks stay
        shared when their content provably matches the dense cache (linear
        groups, and rings the prefill did not wrap -- the scatter rewrites
        them with bit-identical rows), otherwise they CoW first.  Blocks
        wholly past ``filled`` stay unallocated and their rows land on the
        scratch page."""
        for g in self.groups:
            live = min(filled, g.length)
            n_live = math.ceil(live / self.page) if live else 0
            if g.ring and filled > g.length:
                for b in range(g.blocks(self.page)):  # the wrap rewrote all
                    self.ops.ensure_writable(rp, g, b)
            else:
                for b in range(n_live):
                    self.ops.ensure_block(rp, g, b)
        self.ops.alloc_state(rp)
        tables = self._full_tables(rp.tables, SCRATCH_PAGE)
        for pool, g, st, layer in zip(self.pools, self.layout.layer_groups,
                                      self.layout.state_shapes, dense["layers"]):
            for n in st or ():
                pool[n][rp.state_block].copy_(state_leaf(layer, n)[0])
            if g is not None:
                for n in KV:
                    blocks.scatter_paged_tokens(pool[n], tables[g],
                                                layer["attn"][n][0], 0, self.page)

    def gather_dense(self, rp_tables: dict, state_vals: list, pos: int) -> dict:
        """A dense (B=1) cache from per-group block -> page lists (a prefix
        trie match) and the state leaves of ``state_vals`` (a trie node's
        ``state_snapshot``) at position ``pos``: the resume point of a
        prefix-hit prefill.  Missing blocks read the zero page, exactly the
        cold cache's zeros."""
        tables = self._full_tables(rp_tables, ZERO_PAGE)
        layers = []
        for pool, g, st in zip(self.pools, self.layout.layer_groups, state_vals):
            if g is None:
                layers.append({"ssm": {n: st[n][None].to(self.device) for n in STATE}})
                continue
            layer = {"attn": {n: blocks.gather_paged_tokens(
                pool[n], tables[g], 0, g.length)[None] for n in KV}}
            for n in st or ():
                layer[n] = st[n][None].to(self.device)
            layers.append(layer)
        return {"pos": self._ids([pos]), "layers": layers}

    def state_snapshot(self, dense: dict) -> list:
        """Host copies of a dense (B=1) cache's state leaves, per layer
        (None for a layer without any): what a prefix-trie node stores, so a
        resume of a hybrid or SSM model is bit-exact."""
        return [None if st is None else
                {n: self._to_host(state_leaf(layer, n)[0].clone()) for n in st}
                for st, layer in zip(self.layout.state_shapes, dense["layers"])]

    # -- preemption: spill to host / restore ---------------------------------

    def _to_host(self, rows: torch.Tensor) -> torch.Tensor:
        if rows.device.type != "cuda":
            return rows                 # the caller's indexing made a copy
        host = torch.empty(rows.shape, dtype=rows.dtype, pin_memory=True)
        host.copy_(rows)
        return host

    def _live(self, tables: dict) -> dict:
        """Per group, the 1-D ids of the allocated pages in block order."""
        return {g: self._ids([p for p in tables[g] if p is not None])
                for g in self.groups}

    def _rows(self, rp: RequestPages):
        """The request's allocated page rows and state block rows, per
        layer and leaf, in pool order."""
        live = self._live(rp.tables)
        for pool, g, st in zip(self.pools, self.layout.layer_groups,
                               self.layout.state_shapes):
            if g is not None:
                for n in KV:
                    yield pool[n], live[g]
            for n in st or ():
                yield pool[n], self._ids([rp.state_block])

    def spill(self, rp: RequestPages, fault_hook=None) -> dict:
        """Copy the request's allocated pages and state block to host
        memory and release every page reference (trie pins survive: they
        hold their own).

        ``fault_hook`` fires mid-preemption -- after the host copy, before
        any reference is dropped -- so an injected fault aborts the spill
        with the resident request and the allocator fully intact."""
        rows = [self._to_host(pool[ids]) for pool, ids in self._rows(rp)]
        if fault_hook is not None:
            fault_hook("preempt_spill")
        saved = {"rows": rows,
                 "mask": {g: [p is not None for p in rp.tables[g]]
                          for g in self.groups}}
        self.ops.release(rp)
        return saved

    def restore(self, saved: dict) -> RequestPages:
        """Re-admission after a spill: fresh fully private pages and state
        block, contents copied back from the host, so the resumed decode is
        bit-identical to one never preempted.  Raises PagesExhausted,
        holding nothing, when the pages run out."""
        rp = self.ops.new_request()
        try:
            for g in self.groups:
                for b, had in enumerate(saved["mask"][g]):
                    if had:
                        self.ops.ensure_block(rp, g, b)
            self.ops.alloc_state(rp)
        except PagesExhausted:
            self.ops.release(rp)
            raise
        for (pool, ids), rows in zip(self._rows(rp), saved["rows"]):
            pool.index_put_((ids,), rows.to(self.device))
        return rp

    def release(self, rp: RequestPages) -> None:
        self.ops.release(rp)
