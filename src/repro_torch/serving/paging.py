"""Paged serving-cache bookkeeping: allocator, page tables, prefix trie.

The port's copy of the JAX package's ``serving/paging.py``, line for line
below this docstring (the port imports nothing of that package).  MemFine's
discipline -- plan memory through an explicit model instead of
over-allocating for the worst case -- applied to serving state: the
slot-map scheduler reserves each request's whole cache up front; here each
cache layout is carved into fixed-size pages handed out on demand.

* **PageAllocator** -- free-list allocation with per-page refcounts over
  named *spaces* (one per distinct token-cache length, plus one for the
  constant-size per-request state bundle).  Refcounts > 1 express
  copy-on-write sharing; byte accounting (allocated + high-watermark)
  feeds ``core/memory_model.py::serving_paged_peak_bytes``.
* **RequestPages** -- one request's page tables: per-group block -> page id
  (None = not yet allocated), a shared-block set (pages the request may
  read but must CoW before writing), and its state block.
* **PrefixTrie** -- token-id-keyed trie at ``align``-token granularity.  A
  node pins the pages holding its block's K/V rows plus a host snapshot of
  the non-token state at the block's end boundary, so a later request with
  the same prompt prefix skips that prefill and copy-on-writes at the first
  divergent append.

Everything here is pure host Python over integer page ids, no tensors.  The
tensor side (page pools, the paged decode wave, install and spill) lives in
``serving/paged_cache.py``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

#: every token space reserves two page ids: ``ZERO_PAGE`` is never written
#: and backs never-filled blocks in gathers (so a paged dense view is
#: bit-identical to the zero-initialised monolithic cache), ``SCRATCH_PAGE``
#: absorbs writes from inactive decode slots and never-read scatter targets.
ZERO_PAGE = 0
SCRATCH_PAGE = 1
RESERVED_PAGES = 2


class PagesExhausted(RuntimeError):
    """Allocation failed: the space has no free pages.  The scheduler treats
    this like an OOM (requeue / preempt), never as a crash."""


class AllocatorCorruption(AssertionError):
    """An allocator invariant failed (double free, leak, negative ref)."""


@dataclass
class _Space:
    total: int                      # usable pages (reserved ids excluded)
    page_bytes: float               # modeled bytes per page (production dtype)
    free: list = field(default_factory=list)
    ref: dict = field(default_factory=dict)   # page id -> refcount (>0)
    hwm: int = 0                    # high watermark of allocated pages


class PageAllocator:
    """Free-list page allocator with refcounts over named spaces.

    Invariants (checked by ``audit()``; the property harness calls it after
    every operation):

    * ``allocated + len(free) == total`` per space — no leak, no double free;
    * every refcount is >= 1 — a page frees exactly when its count hits 0;
    * free pages carry no refcount entry.
    """

    def __init__(self) -> None:
        self.spaces: dict = {}

    def add_space(self, key, pages: int, page_bytes: float = 0.0) -> None:
        if key in self.spaces:
            raise ValueError(f"space {key!r} already exists")
        if pages < 1:
            raise ValueError(f"space {key!r} needs >= 1 usable page")
        self.spaces[key] = _Space(
            total=pages, page_bytes=page_bytes,
            free=list(range(RESERVED_PAGES, RESERVED_PAGES + pages)))

    # -- core ops ------------------------------------------------------------

    def alloc(self, key) -> int:
        sp = self.spaces[key]
        if not sp.free:
            raise PagesExhausted(
                f"space {key!r}: all {sp.total} pages allocated")
        page = sp.free.pop()
        sp.ref[page] = 1
        sp.hwm = max(sp.hwm, len(sp.ref))
        return page

    def incref(self, key, page: int) -> None:
        """Share ``page`` (CoW fork / trie pin): one more owner."""
        sp = self.spaces[key]
        if page not in sp.ref:
            raise AllocatorCorruption(
                f"space {key!r}: incref of unallocated page {page}")
        sp.ref[page] += 1

    def decref(self, key, page: int) -> bool:
        """Drop one owner; frees the page (returns True) at refcount zero."""
        sp = self.spaces[key]
        if page not in sp.ref:
            raise AllocatorCorruption(
                f"space {key!r}: decref of unallocated page {page} "
                f"(double free?)")
        sp.ref[page] -= 1
        if sp.ref[page] == 0:
            del sp.ref[page]
            sp.free.append(page)
            return True
        return False

    def refcount(self, key, page: int) -> int:
        return self.spaces[key].ref.get(page, 0)

    def is_shared(self, key, page: int) -> bool:
        return self.refcount(key, page) > 1

    # -- accounting ----------------------------------------------------------

    def allocated(self, key) -> int:
        return len(self.spaces[key].ref)

    def free_pages(self, key) -> int:
        return len(self.spaces[key].free)

    def hwm(self, key) -> int:
        return self.spaces[key].hwm

    def allocated_bytes(self) -> float:
        return sum(len(sp.ref) * sp.page_bytes for sp in self.spaces.values())

    def hwm_bytes(self) -> float:
        """High-watermark bytes — conservative: per-space watermarks may
        have peaked at different times, so this bounds the true peak."""
        return sum(sp.hwm * sp.page_bytes for sp in self.spaces.values())

    def audit(self) -> None:
        for key, sp in self.spaces.items():
            if len(sp.ref) + len(sp.free) != sp.total:
                raise AllocatorCorruption(
                    f"space {key!r}: {len(sp.ref)} allocated + "
                    f"{len(sp.free)} free != total {sp.total}")
            if len(set(sp.free)) != len(sp.free):
                raise AllocatorCorruption(f"space {key!r}: duplicate free page")
            for page, ref in sp.ref.items():
                if ref < 1:
                    raise AllocatorCorruption(
                        f"space {key!r}: page {page} refcount {ref} < 1")
                if page in sp.free:
                    raise AllocatorCorruption(
                        f"space {key!r}: page {page} both allocated and free")
                if page < RESERVED_PAGES:
                    raise AllocatorCorruption(
                        f"space {key!r}: reserved page {page} was allocated")


# ---------------------------------------------------------------------------
# per-group block math (ring vs linear layouts)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Group:
    """One token-cache layout class: every attention leaf whose cache holds
    ``length`` token slots with the same ring-ness shares this group's page
    tables (the physical pools stay per-leaf — see paged_cache.py)."""
    length: int                     # Sc: token slots in this cache layout
    ring: bool                      # window-sized ring vs linear

    def blocks(self, page: int) -> int:
        return math.ceil(self.length / page)

    def slot(self, pos: int) -> int:
        return pos % self.length if self.ring else pos

    def block_of(self, pos: int, page: int) -> int:
        return self.slot(pos) // page

    def touched_blocks(self, start: int, stop: int, page: int) -> set:
        """Blocks written when positions [start, stop) are appended."""
        if stop <= start:
            return set()
        if self.ring and stop - start >= self.length:
            return set(range(self.blocks(page)))
        return {self.block_of(p, page) for p in range(start, stop)}


def space_key(group: Group) -> tuple:
    return ("kv", group.length, "ring" if group.ring else "linear")


STATE_SPACE = ("state",)


# ---------------------------------------------------------------------------
# per-request page tables
# ---------------------------------------------------------------------------

@dataclass
class RequestPages:
    """One request's view of the paged cache: per-group page tables plus its
    state block.  ``shared`` marks blocks whose page the request does not
    own exclusively — reads are fine, writes must CoW first."""
    tables: dict                    # Group -> list[Optional[int]] page ids
    shared: dict                    # Group -> set of shared block indices
    state_block: Optional[int] = None
    private_bytes: float = 0.0      # modeled bytes of exclusively-owned pages

    @classmethod
    def empty(cls, groups, page: int) -> "RequestPages":
        return cls(tables={g: [None] * g.blocks(page) for g in groups},
                   shared={g: set() for g in groups})

    def pages_of(self, group: Group) -> list:
        return [p for p in self.tables[group] if p is not None]


class PageTableOps:
    """Host-side table operations shared by the scheduler and the property
    harness: allocate-on-demand, CoW resolution, fork-from-prefix, release.

    Array copies are delegated to ``copy_page_fn(group, src, dst)`` /
    ``zero_state_fn(block)`` callbacks so the pure bookkeeping stays
    testable without materialising pools.
    """

    def __init__(self, alloc: PageAllocator, groups, page: int,
                 state_bytes: float = 0.0, copy_page_fn=None):
        self.alloc = alloc
        self.groups = list(groups)
        self.page = page
        self.state_bytes = state_bytes
        self.copy_page_fn = copy_page_fn or (lambda group, src, dst: None)
        # chaos hook (runtime/faults.py): called at the designated fault
        # points BEFORE any bookkeeping mutates, so an injected fault always
        # observes (and leaves behind) a consistent allocator
        self.fault_hook = None

    def _page_bytes(self, group: Group) -> float:
        return self.alloc.spaces[space_key(group)].page_bytes

    # -- request lifecycle ---------------------------------------------------

    def new_request(self) -> RequestPages:
        return RequestPages.empty(self.groups, self.page)

    def alloc_state(self, rp: RequestPages) -> int:
        if rp.state_block is None:
            rp.state_block = self.alloc.alloc(STATE_SPACE)
            rp.private_bytes += self.state_bytes
        return rp.state_block

    def ensure_block(self, rp: RequestPages, group: Group, block: int) -> int:
        """Allocate ``block``'s page if the table has none yet."""
        page = rp.tables[group][block]
        if page is None:
            page = self.alloc.alloc(space_key(group))
            rp.tables[group][block] = page
            rp.private_bytes += self._page_bytes(group)
        return page

    def ensure_writable(self, rp: RequestPages, group: Group,
                        block: int) -> int:
        """CoW: after this, ``block``'s page is exclusively owned.  Copies
        the shared page's contents into a fresh page via ``copy_page_fn``."""
        page = self.ensure_block(rp, group, block)
        if block not in rp.shared[group]:
            return page
        if self.fault_hook is not None:
            self.fault_hook("cow_fork")
        fresh = self.alloc.alloc(space_key(group))
        self.copy_page_fn(group, page, fresh)
        self.alloc.decref(space_key(group), page)
        rp.tables[group][block] = fresh
        rp.shared[group].discard(block)
        rp.private_bytes += self._page_bytes(group)
        return fresh

    def adopt_shared(self, rp: RequestPages, group: Group, block: int,
                     page: int) -> None:
        """Point ``block`` at an existing page owned elsewhere (prefix hit /
        fork).  Increfs; the block is marked shared so writes CoW."""
        assert rp.tables[group][block] is None, "block already mapped"
        self.alloc.incref(space_key(group), page)
        rp.tables[group][block] = page
        rp.shared[group].add(block)

    def release(self, rp: RequestPages) -> None:
        """Drop every reference this request holds (eviction/preemption)."""
        for group in self.groups:
            key = space_key(group)
            for block, page in enumerate(rp.tables[group]):
                if page is not None:
                    self.alloc.decref(key, page)
                rp.tables[group][block] = None
            rp.shared[group].clear()
        if rp.state_block is not None:
            self.alloc.decref(STATE_SPACE, rp.state_block)
            rp.state_block = None
        rp.private_bytes = 0.0

    # -- admission-side worst-case reservation -------------------------------

    def worst_case_bytes(self, total_len: int, shared_len: int = 0) -> float:
        """Modeled bytes this request may come to own exclusively: the
        admission reservation (docs/DESIGN.md §Paging).

        Per linear group the shared prefix is never rewritten, so only the
        tail's blocks count; per ring group a request whose total length
        wraps the ring worst-cases to every block private (each shared page
        CoWs as the ring write cursor re-enters it)."""
        total = self.state_bytes
        for group in self.groups:
            pb = self._page_bytes(group)
            occupied = min(total_len, group.length)
            if group.ring and total_len > group.length:
                blocks = group.blocks(self.page)            # full CoW
            else:
                blocks = (math.ceil(occupied / self.page)
                          - min(shared_len, occupied) // self.page)
            total += blocks * pb
        return total


# ---------------------------------------------------------------------------
# prefix cache trie
# ---------------------------------------------------------------------------

@dataclass
class PrefixNode:
    key: tuple                      # this block's ``align`` token ids
    pages: dict                     # Group -> list[int], align//page pages
    snapshot: object                # host state snapshot at the end boundary
    children: dict = field(default_factory=dict)
    last_used: int = 0
    parent: Optional["PrefixNode"] = None


class PrefixTrie:
    """Token-id-keyed prefix cache at ``align``-token node granularity.

    ``align`` is lcm(page_size, prefill_chunk): node boundaries land on both
    page and prefill-chunk boundaries, which is what makes a prefix-hit
    prefill bit-identical to the cold chunked prefill (the resumed extend
    steps see bitwise-equal cache inputs — tests/test_paging.py).

    The trie owns one reference per pinned page; borrowers take their own
    on lookup.  ``max_nodes`` bounds residency with LRU leaf eviction.
    """

    def __init__(self, ops: PageTableOps, align: int, max_nodes: int = 256):
        self.ops = ops
        self.align = align
        self.max_nodes = max_nodes
        self.root: dict = {}            # key -> PrefixNode
        self.n_nodes = 0
        self.clock = 0
        self.hits = 0
        self.misses = 0
        self.tokens_reused = 0

    def _blocks_per_node(self) -> int:
        return self.align // self.ops.page

    # -- lookup --------------------------------------------------------------

    def lookup(self, tokens) -> tuple:
        """Longest registered prefix of ``tokens`` in whole ``align`` blocks.

        Returns ``(matched_len, nodes)`` — the caller adopts the nodes'
        pages (shared) and resumes from the deepest node's state snapshot.
        Does NOT touch refcounts; ``adopt`` does, per matched node."""
        self.clock += 1
        nodes: list[PrefixNode] = []
        level = self.root
        n_full = len(tokens) // self.align
        for i in range(n_full):
            key = tuple(int(t) for t in tokens[i * self.align:
                                               (i + 1) * self.align])
            node = level.get(key)
            if node is None:
                break
            node.last_used = self.clock
            nodes.append(node)
            level = node.children
        if nodes:
            self.hits += 1
            self.tokens_reused += len(nodes) * self.align
        else:
            self.misses += 1
        return len(nodes) * self.align, nodes

    def adopt(self, rp: RequestPages, nodes) -> None:
        """Map the matched nodes' pages into ``rp`` as shared blocks."""
        bpn = self._blocks_per_node()
        for depth, node in enumerate(nodes):
            for group, pages in node.pages.items():
                base = depth * bpn
                for j, page in enumerate(pages):
                    self.ops.adopt_shared(rp, group, base + j, page)

    # -- registration --------------------------------------------------------

    def register(self, tokens, upto: int, rp: RequestPages,
                 snapshots: dict) -> int:
        """Pin ``rp``'s pages for every whole aligned block of ``tokens[:upto]``
        that has a state snapshot, creating missing trie nodes.  The donor's
        registered blocks become shared (its later ring wraps CoW away from
        the trie's copy instead of corrupting it).  Returns nodes created."""
        bpn = self._blocks_per_node()
        created = 0
        level = self.root
        parent = None
        for i in range(upto // self.align):
            end = (i + 1) * self.align
            key = tuple(int(t) for t in tokens[i * self.align:end])
            node = level.get(key)
            if node is None:
                if end not in snapshots:
                    break                      # no resume state: stop here
                pages: dict = {}
                ok = True
                for group in self.ops.groups:
                    blk = [rp.tables[group][i * bpn + j] for j in range(bpn)]
                    if any(p is None for p in blk):
                        ok = False
                        break
                    pages[group] = blk
                if not ok:
                    break
                for group, blk in pages.items():
                    pb = self.ops._page_bytes(group)
                    for j, page in enumerate(blk):
                        self.ops.alloc.incref(space_key(group), page)
                        if i * bpn + j not in rp.shared[group]:
                            # the donor no longer owns this page outright:
                            # a later ring wrap must CoW away from the trie
                            # copy, so its outstanding reservation grows back
                            rp.private_bytes -= pb
                        rp.shared[group].add(i * bpn + j)
                node = PrefixNode(key=key, pages=pages,
                                  snapshot=snapshots[end], parent=parent,
                                  last_used=self.clock)
                level[key] = node
                self.n_nodes += 1
                created += 1
            else:
                # already registered by an earlier request (possibly with
                # different physical pages); keep the existing node
                node.last_used = self.clock
            parent = node
            level = node.children
        if created:
            self._evict_to_cap()
        return created

    # -- eviction ------------------------------------------------------------

    def _leaves(self):
        out = []

        def walk(level):
            for node in level.values():
                if node.children:
                    walk(node.children)
                else:
                    out.append(node)
        walk(self.root)
        return out

    def _drop(self, node: PrefixNode) -> None:
        for group, pages in node.pages.items():
            for page in pages:
                self.ops.alloc.decref(space_key(group), page)
        level = node.parent.children if node.parent is not None else self.root
        del level[node.key]
        self.n_nodes -= 1

    def _evict_to_cap(self) -> None:
        while self.n_nodes > self.max_nodes:
            victim = min(self._leaves(), key=lambda n: n.last_used)
            self._drop(victim)

    def evict_lru_leaf(self) -> bool:
        """Free the least-recently-used leaf node's pages (memory-pressure
        escalation rung before preemption).  Returns True if one was freed."""
        leaves = self._leaves()
        if not leaves:
            return False
        self._drop(min(leaves, key=lambda n: n.last_used))
        return True

    def clear(self) -> None:
        while self.evict_lru_leaf():
            pass

    def stats(self) -> dict:
        total = self.hits + self.misses
        return {"nodes": self.n_nodes, "hits": self.hits,
                "misses": self.misses,
                "hit_rate": self.hits / total if total else 0.0,
                "tokens_reused": self.tokens_reused}


def prefix_align(page_size: int, prefill_chunk: int) -> int:
    """Prefix-sharing granularity: lcm of the page and the prefill chunk, so
    shared boundaries land on both page edges (whole pages are pinned) and
    chunk edges (the resumed prefill replays the cold path bit-for-bit)."""
    return page_size * prefill_chunk // math.gcd(page_size, prefill_chunk)
