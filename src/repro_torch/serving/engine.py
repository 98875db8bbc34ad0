"""Serving engine: single-pass batched prefill + compiled decode/extend steps.

Prefill is ONE ``transformer.forward`` pass that writes every layer's decode
cache as it goes; later prefill chunks extend the cache with
``transformer.extend_step``.  ``prefill_replay``, the token-by-token replay,
is kept as the reference oracle for cache-layout parity tests.

Compiled steps are hoisted into a per-(cfg, ctx) cache, as in the JAX
package: ``get_decode_step``, ``get_extend_step``, ``get_prefill_fn`` and
``get_paged_decode_step`` (the paged cache's decode wave,
``serving/paged_cache.py``), and the expert-aware scheduler's
``get_decode_step_masked`` and ``get_router_probe`` return one
``CompiledStep`` per key (``_cached``), and ``step_cache_info`` /
``clear_step_cache`` observe and empty it.  The extend, prefill and paged
decode steps also return the pass's routed load, the expert-aware
scheduler's telemetry (a few small reductions of what the router
computed); the plain decode step does not.  ``jax.jit`` compiles a step per
argument shape; here a step is a CUDA graph per shape:

* On a CUDA device the first call for each key -- the weights' tensors,
  the arguments' shapes and types, and the static cache the call runs on --
  runs the eager function once on a side stream (that run is the call's
  result, and builds every kernel library and handle before capture), then
  captures a ``torch.cuda.CUDAGraph`` of it.  Every later call with that
  key replays the graph: the host launches one graph, not each layer's
  attention, router, plan, dispatch and expert kernels.
* The weights are baked into the graph, so a step replays only for the
  weight tensors it captured; other weights capture anew.  A graph holds
  weak references to its weights: it never keeps dead weights alive, and
  one whose weights died is dropped at the step's next capture.
* The decode and extend steps update their cache in place, as the
  reference donates it.  A step owns static copies of each cache shape; a
  call whose cache is one of them copies nothing (``static_cache`` hands
  one to a caller such as the scheduler's slot pool).  Any other cache is
  copied in before the replay and out after it.  Other inputs (tokens) are
  copied into the graph's own buffers at every call.
* Outputs that are not the cache (logits, prefill's new cache) are copied,
  inside the graph, to buffers allocated outside the graphs' memory pool;
  a call returns those buffers, which the same graph's next replay
  overwrites.  Every live graph shares one memory pool (the first graph's
  ``torch.cuda.graph_pool_handle``, while any graph of it lives); since no
  graph output and no input lives in it, only intermediates that are dead
  when a replay ends, graphs may replay in any order.
* Each kernel wrapper's ``.launches`` counts a replay's launches: a graph
  records what its capture counted and adds that at every replay.
* A capture that fails (a host sync inside the step, say) raises; nothing
  falls back to the eager step.

On the CPU the same objects run the eager function, as the reference jits
without donation on the CPU.  ``CompiledStep.eager`` runs the eager
function on any device: the counterpart of ``jax.disable_jit``.  Nothing
here records autograd state.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
import weakref
from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import memory_model as mm
from repro_torch.core import placement as plc
from repro_torch.core.chunking import chunk_spans
from repro_torch.core.moe import DistContext
from repro_torch.core.router import route
from repro_torch.kernels import _cuda
from repro_torch.models import blocks, transformer
from repro_torch.serving import residency


def init_serve_cache(params: dict, cfg: ModelConfig, batch: int, seq_len: int,
                     dtype=torch.float32,
                     enc_out: Optional[torch.Tensor] = None) -> dict:
    """An empty decode cache for ``batch`` rows on the weights' device; with
    ``enc_out``, the cross K/V projected from it."""
    return transformer.init_cache(params, cfg, batch, seq_len, dtype,
                                  params["embed"].device, enc_out=enc_out)


def build_placements(cfg: ModelConfig, ctx: DistContext, num_peers: int, *,
                     loads=None, replicas: int = 0):
    """Static expert placement chosen at engine build.

    Serving never replans: the placement is resolved here from an offline
    load profile (``loads``: an (L_moe, E) matrix, e.g. a training run's
    telemetry EMA; None means identity) and set in the ctx the steps run
    under.  Returns ``(ctx with per-layer placements, replica_weight_bytes)``;
    the second is what ``ServeConfig.replica_weight_bytes`` should carry so
    admission prices the replica slots.  The local serving path does not
    move experts: the placement is priced and names the always-resident
    experts of the residency tier (``residency.always_resident_sets``)."""
    n_moe = transformer.num_moe_layers(cfg)
    if cfg.moe is None or n_moe == 0 or num_peers <= 1 \
            or cfg.moe.num_experts % num_peers:
        return ctx, 0.0
    placements = plc.choose_placements(
        loads, n_moe, num_peers, num_experts=cfg.moe.num_experts,
        replicas=replicas, hysteresis=0.0)
    extra_slots = max(p.replica_slots for p in placements)
    replica_bytes = mm.replica_weight_bytes(
        cfg, extra_slots, mm.Parallelism(e=num_peers))
    if all(p.is_identity for p in placements):
        return ctx, 0.0
    return dataclasses.replace(ctx, placements=placements), replica_bytes


def make_serve_step(cfg: ModelConfig, ctx: DistContext):
    """Returns step(params, cache, tokens (B,1)) -> (logits, cache), eager."""

    def serve_step(params, cache, tokens):
        return transformer.decode_step(params, cfg, ctx, cache, tokens)

    return serve_step


# ---------------------------------------------------------------------------
# trees of tensors
# ---------------------------------------------------------------------------

def leaves(tree) -> list:
    """The tensors of a tree of dicts, lists and tuples, in order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in leaves(v)]
    return [tree]


def copy_cache_(dst, src) -> None:
    """Copy every tensor of ``src`` into the matching tensor of ``dst``."""
    for d, s in zip(leaves(dst), leaves(src)):
        d.copy_(s)


def clone_cache(tree):
    """A copy of every tensor of ``tree``, in its structure."""
    return _fill(tree, iter([t.clone() for t in leaves(tree)]))


def _fill(skeleton, values):
    """``skeleton``'s structure with its leaves taken from ``values`` in order."""
    if isinstance(skeleton, dict):
        return {k: _fill(v, values) for k, v in skeleton.items()}
    if isinstance(skeleton, (list, tuple)):
        return type(skeleton)(_fill(v, values) for v in skeleton)
    return next(values)


def _signature(tree):
    """Structure, shapes, types and devices: what a graph is captured for."""
    if isinstance(tree, dict):
        return tuple((k, _signature(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return tuple(_signature(v) for v in tree)
    return (tuple(tree.shape), tree.dtype, tree.device)


# ---------------------------------------------------------------------------
# compiled steps
# ---------------------------------------------------------------------------

_GRAPHS = weakref.WeakSet()     # every live captured graph, of every step
_STREAMS: dict = {}             # device -> the side stream of every warm-up and capture


def _stream(device: torch.device) -> torch.cuda.Stream:
    """One side stream per device for every eager warm-up and capture: the
    graphs share a pool only when captured on one stream, and each stream
    that runs a matmul keeps a cuBLAS workspace of its own."""
    if device not in _STREAMS:
        _STREAMS[device] = torch.cuda.Stream(device)
    return _STREAMS[device]


def _pool(device: torch.device):
    """The memory pool every graph on ``device`` captures into: a live
    graph's, else a new one (a pool dies with the last graph that used it,
    and its handle may not be used again)."""
    for g in _GRAPHS:
        if g.device == device:
            return g.graph.pool()
    return torch.cuda.graph_pool_handle()


def pool_bytes() -> Optional[int]:
    """Device bytes the graphs' shared memory pools hold (their segments in
    the caching allocator); None when the allocator does not say."""
    pools = {tuple(g.graph.pool()) for g in _GRAPHS}
    if not pools:
        return 0
    segments = torch.cuda.memory_snapshot()
    if segments and "segment_pool_id" not in segments[0]:
        return None
    return sum(s["total_size"] for s in segments
               if tuple(s["segment_pool_id"]) in pools)


def _launch_counts() -> dict:
    return {w: w.launches for w in _cuda.wrappers()}


class _Static:
    """One static copy of a cache: the tensors the graphs captured over it
    read and write, and the caller it was handed to, if any."""

    def __init__(self, tree):
        self.tree, self.leaves = tree, leaves(tree)
        self.owner = None                      # weakref to the holder

    def held(self) -> bool:
        return self.owner is not None and self.owner() is not None

    def holds(self, tensors: list) -> bool:
        return (len(tensors) == len(self.leaves)
                and all(a is b for a, b in zip(tensors, self.leaves)))


class _Graph:
    """One captured graph, its static inputs and outputs, and what a replay
    launches."""

    def __init__(self, graph, device, weights, static, mutated, skeleton,
                 out_index, static_out, launches):
        self.graph, self.device = graph, device
        self.weights = [weakref.ref(w) for w in weights]
        self.static, self.mutated = static, mutated
        self.skeleton, self.out_index = skeleton, out_index
        self.static_out, self.launches = static_out, launches

    def live(self) -> bool:
        return all(r() is not None for r in self.weights)

    def outputs(self, arg_leaves: list):
        return _fill(self.skeleton, iter(
            arg_leaves[i] if is_arg else self.static_out[i]
            for is_arg, i in self.out_index))

    def replay(self, arg_leaves: list):
        for a, s in zip(arg_leaves, self.static):
            if a is not s:
                s.copy_(a)
        self.graph.replay()
        for j in self.mutated:
            if arg_leaves[j] is not self.static[j]:
                arg_leaves[j].copy_(self.static[j])
        for wrapper, n in self.launches.items():
            wrapper.launches += n
        return self.outputs(arg_leaves)

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.static_out)


class CompiledStep:
    """``step(params, *args)``: ``fn`` compiled per key as a CUDA graph on a
    CUDA device, run eagerly on the CPU (module docstring).

    ``donate_cache_arg`` is the position of the cache that ``fn`` updates
    in place, counting ``params`` as 0, as the reference's ``_jit`` counts
    it; None for a step that makes its outputs anew."""

    def __init__(self, fn: Callable, device, donate_cache_arg: Optional[int] = None):
        self.fn = fn
        self.device = torch.device(device)
        self.donate = donate_cache_arg
        self._graphs: dict = {}          # key -> _Graph
        self._sets: dict = {}            # cache signature -> [_Static]
        self.captures = 0
        self.capture_s = 0.0

    def eager(self, params: dict, *args):
        """The eager function, on any device (``jax.disable_jit``'s
        counterpart)."""
        with torch.no_grad():
            return self.fn(params, *args)

    def __call__(self, params: dict, *args):
        if self.device.type != "cuda":
            return self.eager(params, *args)
        weights = leaves(params)
        static = None
        if self.donate is not None:
            static = self._static_for(args[self.donate - 1])
        key = (tuple(map(id, weights)), _signature(args), id(static))
        graph = self._graphs.get(key)
        if graph is not None and not graph.live():
            del self._graphs[key]
            graph = None
        arg_leaves = leaves(args)
        if graph is None:
            return self._capture(key, weights, params, args, arg_leaves, static)
        return graph.replay(arg_leaves)

    def static_cache(self, cache: dict, owner) -> dict:
        """One of the step's static caches of ``cache``'s shape, holding
        ``cache``'s contents, handed to ``owner`` (held while ``owner``
        lives): calls that pass it copy no cache.  A free static cache (its
        graphs are warm) is reused; else ``cache`` itself becomes one.  On
        the CPU, ``cache`` itself."""
        if self.device.type != "cuda" or self.donate is None:
            return cache
        sets = self._sets.setdefault(_signature(cache), [])
        free = next((s for s in sets if not s.held()), None)
        if free is None:
            free = _Static(cache)
            sets.append(free)
        else:
            copy_cache_(free.tree, cache)
        free.owner = weakref.ref(owner)
        return free.tree

    def _static_for(self, cache) -> _Static:
        """The static cache a call runs on: ``cache`` itself when it is one,
        else a static cache no caller holds (``cache`` is copied in and
        out), made as a copy of ``cache`` when there is none."""
        tensors = leaves(cache)
        sets = self._sets.setdefault(_signature(cache), [])
        for s in sets:
            if s.holds(tensors):
                return s
        free = next((s for s in sets if not s.held()), None)
        if free is None:
            free = _Static(clone_cache(cache))
            sets.append(free)
        return free

    def _capture(self, key, weights, params, args, arg_leaves, static):
        """The first call for ``key``: the eager run on a side stream (this
        call's result), then the capture."""
        t0 = time.perf_counter()
        for k in [k for k, g in self._graphs.items() if not g.live()]:
            del self._graphs[k]                # their weights are gone
        statics = [static.tree if static is not None and i == self.donate - 1
                   else _fill(a, iter([torch.empty_like(t) for t in leaves(a)]))
                   for i, a in enumerate(args)]
        s_leaves = leaves(statics)
        for a, s in zip(arg_leaves, s_leaves):
            if a is not s:
                s.copy_(a)
        alias = {id(s): j for j, s in enumerate(s_leaves)}

        cur = torch.cuda.current_stream(self.device)
        side = _stream(self.device)
        side.wait_stream(cur)
        versions = [s._version for s in s_leaves]
        with torch.no_grad(), torch.cuda.stream(side):
            out = self.fn(params, *statics)
        cur.wait_stream(side)
        mutated = [j for j, s in enumerate(s_leaves) if s._version != versions[j]]
        fresh = [o for o in leaves(out) if id(o) not in alias]
        for o in fresh:
            o.record_stream(cur)
        # outside the pool: a later capture may reuse any pool block
        static_out = [o.clone() for o in fresh]
        skeleton = _fill(out, itertools.repeat(None))
        out_index, k = [], 0
        for o in leaves(out):
            if id(o) in alias:
                out_index.append((True, alias[id(o)]))
            else:
                out_index.append((False, k))
                k += 1
        del out, fresh

        counts = _launch_counts()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.no_grad(), torch.cuda.graph(graph, pool=_pool(self.device),
                                                   stream=side):
                cap = self.fn(params, *statics)
                cap_fresh = [o for o in leaves(cap) if id(o) not in alias]
                if len(cap_fresh) != len(static_out):
                    raise RuntimeError("the step's outputs changed between its "
                                       "eager run and its capture")
                for s, o in zip(static_out, cap_fresh):
                    s.copy_(o)
                del cap, cap_fresh
        finally:
            recorded = {w: w.launches - n for w, n in counts.items()
                        if w.launches != n}
            for w, n in counts.items():        # a capture launches nothing
                w.launches = n
        entry = _Graph(graph, self.device, weights, s_leaves, mutated, skeleton,
                       out_index, static_out, recorded)
        self._graphs[key] = entry
        _GRAPHS.add(entry)
        for j in mutated:
            if arg_leaves[j] is not s_leaves[j]:
                arg_leaves[j].copy_(s_leaves[j])
        self.captures += 1
        self.capture_s += time.perf_counter() - t0
        return entry.outputs(arg_leaves)

    def graphs(self) -> int:
        return len(self._graphs)

    def static_bytes(self) -> int:
        """Device bytes of the step's static caches and graph outputs."""
        sets = sum(t.numel() * t.element_size() for ss in self._sets.values()
                   for s in ss for t in s.leaves)
        return sets + sum(g.nbytes() for g in self._graphs.values())

    def reset(self) -> None:
        """Free every graph and static cache of the step."""
        self._graphs.clear()
        self._sets.clear()


# ---------------------------------------------------------------------------
# compiled-step cache: one step per (cfg, ctx), not one per call
# ---------------------------------------------------------------------------

_STEP_CACHE: dict = {}


def step_cache_info() -> dict:
    """Snapshot of the compiled-step cache: its keys (``entries``, as the
    reference counts them), the CUDA graphs its steps hold, the captures
    made and their seconds, and the device bytes of the graphs' pool and
    of the steps' static buffers."""
    steps = list(_STEP_CACHE.values())
    return {"entries": len(_STEP_CACHE),
            "graphs": sum(s.graphs() for s in steps),
            "captures": sum(s.captures for s in steps),
            "capture_s": sum(s.capture_s for s in steps),
            "pool_bytes": pool_bytes(),
            "static_bytes": sum(s.static_bytes() for s in steps)}


def clear_step_cache() -> None:
    """Drop every compiled step, freeing its graphs and static buffers, and
    then, if no graph lives, the cuBLAS workspaces the warm-ups made."""
    for step in _STEP_CACHE.values():
        step.reset()
    _STEP_CACHE.clear()
    if torch.cuda.is_available() and not _GRAPHS:
        torch._C._cuda_clearCublasWorkspaces()


def _cached(key, build):
    """Memoise ``build()`` under ``key``; unhashable keys skip the cache
    rather than fail."""
    try:
        fn = _STEP_CACHE.get(key)
    except TypeError:
        return build()
    if fn is None:
        fn = build()
        _STEP_CACHE[key] = fn
    return fn


def get_decode_step(cfg: ModelConfig, ctx: DistContext) -> CompiledStep:
    """The compiled single-token step(params, cache, tokens (B,1)) ->
    (logits (B,1,V), cache), the cache updated in place."""
    def build():
        def fn(params, cache, tokens):
            return transformer.decode_step(params, cfg, ctx, cache, tokens)
        return CompiledStep(fn, ctx.device, donate_cache_arg=1)
    return _cached(("decode", cfg, ctx), build)


def get_extend_step(cfg: ModelConfig, ctx: DistContext) -> CompiledStep:
    """The compiled chunk step(params, cache, tokens (B,C)) -> (logits
    (B,C,V), cache, load (L_moe, E)) -- chunked prefill continuation, the
    cache updated in place; ``load`` is the chunk's routed load."""
    def build():
        def fn(params, cache, tokens):
            return transformer.extend_step(params, cfg, ctx, cache, tokens,
                                           return_load=True)
        return CompiledStep(fn, ctx.device, donate_cache_arg=1)
    return _cached(("extend", cfg, ctx), build)


def get_paged_decode_step(cfg: ModelConfig, ctx: DistContext,
                          layer_groups: tuple, page: int) -> CompiledStep:
    """The compiled paged decode wave step(params, pools, gather_tables,
    write_pages, state_blocks, pos (B,), tokens (B,1)) -> (logits (B,1,V),
    pools, load (B, L_moe, E)): ``load`` is each slot's routed load, for the
    expert-aware scheduler.

    ``pools`` holds per layer one {"k", "v"} pair of (pages, page, KH, hd)
    page pools (and for an encoder-decoder layer a {"cross_k", "cross_v"}
    pair of (blocks, Se, KH, hd) state pools, which the wave only reads),
    or for a mamba layer one {"ssm", "conv"} pair of (blocks, *state shape)
    state pools; ``layer_groups[i]`` is layer i's page group
    (``serving/paging.py::Group``), None for a mamba layer.
    ``gather_tables`` is a tuple of (B, n_blocks) page ids and
    ``write_pages`` one of (B,) page ids, one entry per distinct group in
    (length, ring) order; ``state_blocks`` is the pair of (B,) state blocks
    to read and to write when some layer is a mamba layer, () when none is.
    The step gathers every
    slot's pages and state block into the dense (B, ...) cache, runs the
    unchanged ``transformer.decode_step``, writes the one K/V row it added
    per slot, at the slot's position in its group, to the slot's write page
    and the whole new state to the slot's write block: the pools are the
    step's cache, updated in place; tables, positions and tokens are copied
    in at every call."""
    def build():
        groups = sorted({g for g in layer_groups if g is not None},
                        key=lambda g: (g.length, g.ring))
        gidx = [None if g is None else groups.index(g) for g in layer_groups]

        def fn(params, pools, gather_tables, write_pages, state_blocks, pos,
               tokens):
            layers = []
            for pool, g, j in zip(pools, layer_groups, gidx):
                if g is None:               # the slot's state block, a copy
                    layers.append({"ssm": {n: t[state_blocks[0]]
                                           for n, t in pool.items()}})
                    continue
                layer = {"attn": {n: blocks.gather_paged_tokens(
                    pool[n], gather_tables[j], 0, g.length) for n in ("k", "v")}}
                for n in ("cross_k", "cross_v"):  # read-only: never written back
                    if n in pool:
                        layer[n] = pool[n][state_blocks[0]]
                layers.append(layer)
            cache = {"pos": pos.clone(), "layers": layers}
            logits, cache, load = transformer.decode_step(
                params, cfg, ctx, cache, tokens, return_load=True, per_row=True)
            # the row decode_step wrote: Group.slot, clamped as its linear
            # write is (empty slots sit at position 0)
            rows = [pos % g.length if g.ring else pos.clamp(max=g.length - 1)
                    for g in groups]
            b = torch.arange(pos.shape[0], device=pos.device)
            for pool, layer, j in zip(pools, cache["layers"], gidx):
                if j is None:
                    for n, t in pool.items():
                        t.index_put_((state_blocks[1],), layer["ssm"][n])
                    continue
                for n in ("k", "v"):
                    pool[n].index_put_((write_pages[j], rows[j] % page),
                                       layer["attn"][n][b, rows[j]])
            return logits, pools, load
        return CompiledStep(fn, ctx.device, donate_cache_arg=1)
    return _cached(("paged_decode", cfg, ctx, tuple(layer_groups), page), build)


def get_prefill_fn(cfg: ModelConfig, ctx: DistContext, cache_len: int,
                   dtype=torch.float32) -> CompiledStep:
    """The compiled single-pass prefill(params, batch) -> (logits (B,1,V),
    cache, load (L_moe, E)), ``load`` being ``forward``'s
    ``load_per_layer`` ((0, 1) for a config without MoE, as ``decode_step``
    gives it)."""
    def build():
        def fn(params, batch):
            logits, stats, cache = transformer.forward(
                params, cfg, ctx, batch, return_cache=True,
                cache_len=cache_len, cache_dtype=dtype)
            load = (stats["load_per_layer"] if cfg.moe is not None
                    else logits.new_zeros((0, 1)))      # no MoE layer
            return logits[:, -1:], cache, load
        return CompiledStep(fn, ctx.device)
    return _cached(("prefill", cfg, ctx, cache_len, dtype), build)


# ---------------------------------------------------------------------------
# expert-aware steps
#
# The scheduler's residency demand loop may throw a run away and re-run it
# after restoring the experts it missed.  The reference keeps such steps
# non-donating; here every step writes its cache in place, so the caller
# rewinds: the masked decode writes members' rows only and a re-run rewrites
# the same K/V rows from the same inputs once ``pos`` and the members' mamba
# states are put back (``snapshot_state``), and an extend re-run puts back
# the rows and states the chunk overwrote (``snapshot_chunk``).
# ---------------------------------------------------------------------------

def get_decode_step_masked(cfg: ModelConfig, ctx: DistContext) -> CompiledStep:
    """The compiled subset wave over the slot map: step(params, cache,
    tokens (S,1), mask (S,) bool) -> (logits (S,1,V), cache, load
    (S, L_moe, E)).

    Every slot computes (each slot's logits depend on its own row only, so
    members' logits are bitwise those of the unmasked wave); only members
    write their cache row and advance their position, so non-members' cache
    rows and positions are untouched.  Non-member load rows are zero."""
    def build():
        def fn(params, cache, tokens, mask):
            logits, cache, load = transformer.decode_step(
                params, cfg, ctx, cache, tokens, return_load=True,
                per_row=True, mask=mask)
            return logits, cache, load * mask.to(load.dtype)[:, None, None]
        return CompiledStep(fn, ctx.device, donate_cache_arg=1)
    return _cached(("decode_masked", cfg, ctx), build)


def get_router_probe(cfg: ModelConfig, ctx: DistContext) -> CompiledStep:
    """The compiled router-only probe: probe(params, tokens (N,)) ->
    (N, L_moe, E) activation counts.

    Every MoE layer's router runs on the token embeddings (no attention, no
    FFN): a cheap guess at where those tokens will route, the prefetch hint
    for a request with no telemetry yet.  Approximate by construction (real
    routing sees the residual stream); never a correctness input, since
    demand restores cover its misses."""
    refs = residency.moe_layer_refs(cfg)

    def build():
        def fn(params, tokens):
            x = params["embed"][tokens]
            E = cfg.moe.num_experts
            experts = torch.arange(E, device=x.device)
            per_layer = []
            for i in refs:
                r = route(params["layers"][i]["ffn"]["router"], x, cfg.moe)
                per_layer.append((r.expert_idx[..., None] == experts)
                                 .float().sum(-2))                 # (N, E)
            return torch.stack(per_layer, dim=1)                    # (N, L, E)
        return CompiledStep(fn, ctx.device)
    return _cached(("router_probe", cfg, ctx), build)


def snapshot_state(cache: dict, rows: Optional[torch.Tensor] = None) -> list:
    """A copy of every mamba layer's state and conv tail (of ``rows`` only,
    when given): what ``restore_state`` puts back before a re-run.  A run
    advances a mamba layer's state, so a re-run from the advanced state
    would apply its tokens twice."""
    return [None if "ssm" not in layer else
            {n: (t if rows is None else t[rows]).clone()
             for n, t in layer["ssm"].items()}
            for layer in cache["layers"]]


def restore_state(cache: dict, saved: list,
                  rows: Optional[torch.Tensor] = None) -> None:
    """Put back what ``snapshot_state`` saved, in place."""
    for layer, st in zip(cache["layers"], saved):
        for n, t in (st or {}).items():
            if rows is None:
                layer["ssm"][n].copy_(t)
            else:
                layer["ssm"][n][rows] = t


def snapshot_chunk(cache: dict, cfg: ModelConfig, C: int):
    """What a C-token extend of ``cache`` overwrites: the attention rows it
    writes, every mamba layer's state and conv tail, and its positions; what
    ``rewind_chunk`` puts back before a re-run.  A chunk that wraps a ring
    overwrites rows its earlier queries still see, so an extend is not
    re-run-safe without them."""
    pos0 = cache["pos"]
    rows = torch.arange(pos0.shape[0], device=pos0.device)[:, None]
    saved = []
    for spec, layer in zip(cfg.layer_specs(), cache["layers"]):
        if "attn" not in layer:
            saved.append(None)
            continue
        attn = layer["attn"]
        idx = blocks.chunk_write_slots(spec, attn["k"].shape[1], pos0, C)
        saved.append((idx, {n: attn[n][rows, idx] for n in ("k", "v")}))
    return pos0.clone(), saved, snapshot_state(cache)


def rewind_chunk(cache: dict, snapshot) -> None:
    """Put back what ``snapshot_chunk`` saved, in place."""
    pos0, saved, state = snapshot
    rows = torch.arange(pos0.shape[0], device=pos0.device)[:, None]
    for layer, kept in zip(cache["layers"], saved):
        if kept is None:
            continue
        idx, kv = kept
        for n, t in kv.items():
            layer["attn"][n][rows, idx] = t
    restore_state(cache, state)
    cache["pos"].copy_(pos0)


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------

def prefill(params: dict, cfg: ModelConfig, ctx: DistContext, batch: dict,
            cache_len: int, dtype=torch.float32):
    """Single-pass batched prefill of ``batch`` (tokens, and the config's
    ``frames`` or ``patches``; ``cache_len`` counts the patch positions).
    Returns (next_token_logits (B, 1, V), cache)."""
    logits, cache, _ = get_prefill_fn(cfg, ctx, cache_len, dtype)(params, batch)
    return logits, cache


def prefill_replay(params: dict, cfg: ModelConfig, ctx: DistContext,
                   batch: dict, cache_len: int, dtype=torch.float32):
    """Token-by-token replay prefill through the compiled decode step --
    O(S) steps.  The reference oracle for cache-layout parity tests;
    production callers use ``prefill``.  An encoder-decoder config's cache
    starts from the cross K/V of the encoded ``frames``; patches are not
    replayed, as in the reference."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    enc_out = None
    if cfg.encoder_layers:
        with torch.no_grad():
            enc_out = transformer.encode(params, cfg, batch["frames"], ctx)
    cache = init_serve_cache(params, cfg, B, cache_len, dtype, enc_out=enc_out)
    step = get_decode_step(cfg, ctx)
    logits = None
    for i in range(S):
        logits, cache = step(params, cache, tokens[:, i:i + 1])
    return logits, cache


class _Holder:
    """A weak-referenceable owner of a static cache for one call."""


def prefill_chunk(params: dict, cfg: ModelConfig, ctx: DistContext, cache,
                  seg: torch.Tensor, cache_len: int, dtype=torch.float32):
    """One chunked-prefill span: the first (``cache is None``) runs the
    single-pass prefill, later spans the compiled extend step.  Returns
    (next_token_logits (B, 1, V), cache)."""
    if cache is None:
        return prefill(params, cfg, ctx, {"tokens": seg}, cache_len, dtype)
    full, cache, _ = get_extend_step(cfg, ctx)(params, cache, seg)
    return full[:, -1:], cache


def prefill_chunked(params: dict, cfg: ModelConfig, ctx: DistContext,
                    tokens: torch.Tensor, cache_len: int, chunk: int,
                    dtype=torch.float32):
    """Prefill a (B, S) prompt in <= ``chunk``-token pieces.  Returns
    (next_token_logits (B, 1, V), cache)."""
    S = tokens.shape[1]
    if S > cache_len:
        raise ValueError(f"prompt length {S} exceeds cache_len {cache_len}")
    logits = cache = None
    for start, stop in chunk_spans(S, chunk):
        logits, cache = prefill_chunk(params, cfg, ctx, cache,
                                      tokens[:, start:stop], cache_len, dtype)
    return logits, cache


# ---------------------------------------------------------------------------
# generation
# ---------------------------------------------------------------------------

def generate(params: dict, cfg: ModelConfig, ctx: DistContext, batch: dict,
             steps: int, cache_len: int, temperature: float = 0.0,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Greedy (``temperature == 0``) or sampled batched generation;
    returns (B, steps) token ids.  The decode graph runs on the prefill's
    cache as one of its static caches, so no replay copies the cache (an
    encoder-decoder's cross K/V are the largest part of it): a copy, since
    the prefill graph's next replay overwrites the buffers it returned."""
    logits, cache = prefill(params, cfg, ctx, batch, cache_len)
    step = get_decode_step(cfg, ctx)
    holder = _Holder()
    cache = step.static_cache(clone_cache(cache), holder)
    if temperature > 0 and generator is None:
        generator = torch.Generator(device=logits.device).manual_seed(0)
    out = []
    for _ in range(steps):
        if temperature > 0:
            probs = torch.softmax(logits[:, -1] / temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
        else:
            nxt = torch.argmax(logits[:, -1], dim=-1)
        out.append(nxt)
        logits, cache = step(params, cache, nxt[:, None])
    return torch.stack(out, dim=1)
