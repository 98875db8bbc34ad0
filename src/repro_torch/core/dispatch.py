"""Sort-based static-shape token dispatch / combine.

Token-slots are ranked within their target group by one stable argsort and
an exclusive cumsum, and placed into fixed buffers: ``(E, capacity)`` per
expert, ``(P, cap_send)`` per EP peer, or the MegaBlocks-style flat layout
(rows grouped by expert, each group padded to a row block).  Overflow past
a capacity is dropped and counted.  The receiver of an EP exchange places
its rows from the exchanged counts matrix with cumsums only.  The same plans
as the JAX package's, integer for integer.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class DispatchPlan(NamedTuple):
    slots: torch.Tensor   # (T, K) int32 -- flat position in (G*capacity), -1 = dropped
    load: torch.Tensor    # (G,) int32 -- demand per group (before capacity clip)
    drops: torch.Tensor   # scalar int32 -- token-slots that exceeded capacity


class UnifiedPlan(NamedTuple):
    """Every dispatch layout read out of ONE stable argsort of expert ids.

    Experts are contiguous per EP peer (peer p owns experts
    [p*E/P, (p+1)*E/P)), so sorting token-slots by global expert id also
    groups them by target peer: the peer (send) plan and the expert plan are
    two read-outs of the same permutation.  Within each peer's send block the
    rows are expert-sorted, so the receiver places them from the ``counts``
    matrix alone (``recv_expert_plan`` / ``recv_ragged_plan``)."""
    send_slots: Optional[torch.Tensor]    # (T, K) int32 into flat (P*cap_send), -1 dropped
    expert_slots: Optional[torch.Tensor]  # (T, K) int32 into flat (E*cap_expert), -1 dropped
    counts: torch.Tensor                  # (P, E//P) int32 slots packed per (peer, local expert)
    expert_load: torch.Tensor             # (E,) int32 demand per expert (pre-clip)
    peer_load: torch.Tensor               # (P,) int32 demand per peer (pre-clip)
    drops: torch.Tensor                   # scalar int32 -- send-side (peer-capacity) drops
    drops_expert: torch.Tensor            # scalar int32 -- expert-capacity drops


def _exclusive_cumsum(t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    return torch.cumsum(t, dim) - t


def _unsort(values: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """out[order[i]] = values[i]: a sorted read-out back in slot order."""
    out = torch.empty_like(values)
    out[order] = values
    return out


def make_unified_plan(expert_idx: torch.Tensor, num_experts: int,
                      num_peers: int = 1, *, cap_send: Optional[int] = None,
                      cap_expert: Optional[int] = None) -> UnifiedPlan:
    """expert_idx: (T, K) int32 global expert ids -> UnifiedPlan, from
    exactly one stable argsort, integer for integer the JAX package's."""
    if num_experts % num_peers:
        raise ValueError(f"E={num_experts} not divisible by P={num_peers}")
    e_local = num_experts // num_peers
    T, K = expert_idx.shape
    N = T * K
    dev = expert_idx.device
    flat = expert_idx.reshape(-1).long()
    order = torch.argsort(flat, stable=True)                   # THE one sort
    sorted_e = flat[order]
    pos = torch.arange(N, device=dev)
    # scatter_add, not bincount, which sizes its output with a device sync
    expert_load = torch.zeros(num_experts, dtype=torch.long, device=dev).scatter_add_(
        0, flat, torch.ones_like(flat))
    e_starts = _exclusive_cumsum(expert_load)
    rank_e = pos - e_starts[sorted_e]                          # rank within expert
    peer_load = expert_load.reshape(num_peers, e_local).sum(1)
    p_starts = _exclusive_cumsum(peer_load)
    sorted_p = torch.div(sorted_e, e_local, rounding_mode="floor")
    rank_p = pos - p_starts[sorted_p]                          # rank within peer

    zero = torch.zeros((), dtype=torch.int32, device=dev)
    send_slots, drops_send = None, zero
    counts = expert_load.reshape(num_peers, e_local)
    if cap_send is not None:
        ok = rank_p < cap_send
        send_slots = _unsort(torch.where(ok, sorted_p * cap_send + rank_p, -1),
                             order).reshape(T, K).to(torch.int32)
        drops_send = (N - ok.sum()).to(torch.int32)
        # slots packed per (peer, expert) after the cap clip: within a peer
        # rows are expert-sorted, so the clip truncates the tail experts
        within = e_starts - p_starts[torch.arange(num_experts, device=dev) // e_local]
        sent = torch.minimum(torch.clamp(cap_send - within, min=0), expert_load)
        counts = sent.reshape(num_peers, e_local)

    expert_slots, drops_expert = None, zero
    if cap_expert is not None:
        ok = rank_e < cap_expert
        expert_slots = _unsort(torch.where(ok, sorted_e * cap_expert + rank_e, -1),
                               order).reshape(T, K).to(torch.int32)
        drops_expert = (N - ok.sum()).to(torch.int32)
    return UnifiedPlan(send_slots, expert_slots, counts.to(torch.int32),
                       expert_load.to(torch.int32), peer_load.to(torch.int32),
                       drops_send, drops_expert)


def scatter_rows(x: torch.Tensor, plan: DispatchPlan, num_groups: int,
                 capacity: int) -> torch.Tensor:
    """x: (T, d) -> buffer (G, capacity, d); each token copied to its K slots.
    Slots are unique, so the copy is a plain indexed write; dropped slots
    land in a spill row that is cut off."""
    T, d = x.shape
    K = plan.slots.shape[1]
    rows = num_groups * capacity
    flat_slots = plan.slots.reshape(-1).long()
    idx = torch.where(flat_slots >= 0, flat_slots, rows)
    buf = x.new_zeros((rows + 1, d))
    buf[idx] = x.repeat_interleave(K, dim=0)
    return buf[:rows].reshape(num_groups, capacity, d)


def gather_rows(buf: torch.Tensor, plan: DispatchPlan,
                weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inverse of scatter_rows: buffer (G, C, d) -> (T, d), summing the K
    slots, optionally weighted by the router's combine weights."""
    G, C, d = buf.shape
    flat = buf.reshape(G * C, d)
    slots = plan.slots.long()
    valid = (slots >= 0).to(flat.dtype)[..., None]                  # (T, K, 1)
    rows = flat[slots.clamp_min(0)]                                 # (T, K, d)
    if weights is not None:
        rows = rows * weights[..., None].to(flat.dtype)
    return (rows * valid).sum(dim=1)


def dropless_capacity(tokens: int) -> int:
    """Worst-case per-group capacity for dropless dispatch: the K experts a
    token picks are distinct, so one expert receives at most T tokens."""
    return tokens


def balanced_capacity(tokens: int, top_k: int, num_groups: int,
                      factor: float) -> int:
    """GShard-style capped capacity: factor * T*K/G, rounded up."""
    return max(1, int(-(-tokens * top_k * factor // num_groups)))


# ---------------------------------------------------------------------------
# the flat (ragged) layout
# ---------------------------------------------------------------------------

class RaggedPlan(NamedTuple):
    slots: torch.Tensor            # (T, K) int32 -- flat row index, -1 dropped
    block_to_expert: torch.Tensor  # (R//bm,) int32
    total_rows: torch.Tensor       # scalar int32 (bm-aligned occupied rows)
    load: torch.Tensor             # (G,) int32
    drops: torch.Tensor            # scalar int32


def _block_to_expert(g_starts: torch.Tensor, rows: int, block_m: int,
                     num_groups: int) -> torch.Tensor:
    """Block b belongs to group g iff g_starts[g] <= b*bm < g_starts[g+1]."""
    block_starts = torch.arange(rows // block_m, device=g_starts.device) * block_m
    b2e = torch.searchsorted(g_starts[1:].contiguous(), block_starts, right=True)
    return b2e.clamp(0, num_groups - 1).to(torch.int32)


def make_ragged_plan(group_idx: torch.Tensor, num_groups: int, rows: int,
                     block_m: int, valid: Optional[torch.Tensor] = None) -> RaggedPlan:
    """MegaBlocks-style flat layout: rows grouped by expert, every group
    padded to a block_m multiple so each row block maps to ONE expert.

    group_idx: (T, K); ``rows`` is the static buffer size (worst case plus
    num_groups*block_m padding).  ``valid`` masks slots to exclude."""
    T, K = group_idx.shape
    dev = group_idx.device
    flat = group_idx.reshape(-1).long()
    if valid is not None:
        flat = torch.where(valid.reshape(-1), flat, num_groups)
    order = torch.argsort(flat, stable=True)
    sorted_g = flat[order]
    ext_load = torch.zeros(num_groups + 1, dtype=torch.long, device=dev).scatter_add_(
        0, flat.clamp(max=num_groups), torch.ones_like(flat))
    load = ext_load[:num_groups]
    aligned = -(-load // block_m) * block_m                    # per-group padded
    starts = torch.cat([torch.zeros(1, dtype=torch.long, device=dev),
                        torch.cumsum(aligned, 0)])             # (G+1,)
    ranks = (torch.arange(T * K, device=dev)
             - _exclusive_cumsum(ext_load)[sorted_g])
    start_g = starts[sorted_g.clamp(max=num_groups)]
    ok = (sorted_g < num_groups) & (start_g + ranks < rows)
    slot_sorted = torch.where(ok, start_g + ranks, -1)
    slots = _unsort(slot_sorted, order).reshape(T, K).to(torch.int32)
    drops = ((flat < num_groups).sum() - ok.sum()).to(torch.int32)
    return RaggedPlan(slots, _block_to_expert(starts, rows, block_m, num_groups),
                      starts[-1].to(torch.int32), load.to(torch.int32), drops)


def scatter_rows_flat(x: torch.Tensor, slots: torch.Tensor, rows: int) -> torch.Tensor:
    """x: (T, d), slots: (T, K) -> flat buffer (rows, d)."""
    T, d = x.shape
    K = slots.shape[1]
    flat_slots = slots.reshape(-1).long()
    idx = torch.where(flat_slots >= 0, flat_slots, rows)
    buf = x.new_zeros((rows + 1, d))
    buf[idx] = x.repeat_interleave(K, dim=0)
    return buf[:rows]


def gather_rows_flat(buf: torch.Tensor, slots: torch.Tensor,
                     weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inverse of scatter_rows_flat: (rows, d) -> (T, d) summing K slots."""
    valid = (slots >= 0).to(buf.dtype)[..., None]
    out = buf[slots.clamp_min(0).long()]                       # (T, K, d)
    if weights is not None:
        out = out * weights[..., None].to(buf.dtype)
    return (out * valid).sum(dim=1)


# ---------------------------------------------------------------------------
# the receiver side of an EP exchange: cumsums over the counts matrix
# ---------------------------------------------------------------------------

def _recv_positions(recv_counts: torch.Tensor, recv_eid: torch.Tensor):
    """For each received row, its local expert and its rank within that
    expert across all source peers.

    recv_counts: (P, e_local) rows from source p for local expert e.
    recv_eid: (P*cap_send,) local expert id per received row, -1 invalid.
    Relies on the sender invariant that each source block is expert-sorted
    and packed from position 0 (make_unified_plan guarantees both)."""
    P, e_local = recv_counts.shape
    counts = recv_counts.long()
    Rr = recv_eid.shape[0]
    cap_src = Rr // P
    src_off = _exclusive_cumsum(counts, 0)       # rows from sources before p
    blk_start = _exclusive_cumsum(counts, 1)     # start of e in source block p
    r = torch.arange(Rr, device=recv_eid.device)
    p = torch.div(r, cap_src, rounding_mode="floor")
    i = r - p * cap_src
    valid = recv_eid >= 0
    e = torch.where(valid, recv_eid.long(), 0)
    idx = p * e_local + e
    rank = src_off.reshape(-1)[idx] + i - blk_start.reshape(-1)[idx]
    return e, rank, valid, counts.sum(0)


def eids_from_counts(recv_counts: torch.Tensor, cap_src: int) -> torch.Tensor:
    """Per-row local expert ids from the counts matrix alone: (P, e_local) ->
    (P*cap_src,) int32, -1 for unoccupied slots.  Row i of block p belongs to
    the first expert whose inclusive cumulative count exceeds i."""
    cum = torch.cumsum(recv_counts.long(), 1)                  # (P, e_local)
    i = torch.arange(cap_src, device=recv_counts.device)
    eid = (i[None, :, None] >= cum[:, None, :]).sum(-1)        # (P, cap_src)
    valid = i[None, :] < cum[:, -1:]
    return torch.where(valid, eid, -1).reshape(-1).to(torch.int32)


def recv_expert_plan(recv_counts: torch.Tensor, recv_eid: torch.Tensor,
                     capacity: int) -> DispatchPlan:
    """Receiver-side (E_local, capacity) plan from the counts matrix."""
    e, rank, valid, load = _recv_positions(recv_counts, recv_eid)
    ok = valid & (rank < capacity)
    slots = torch.where(ok, e * capacity + rank, -1)
    drops = (valid.sum() - ok.sum()).to(torch.int32)
    return DispatchPlan(slots[:, None].to(torch.int32), load.to(torch.int32), drops)


def recv_ragged_plan(recv_counts: torch.Tensor, recv_eid: torch.Tensor,
                     rows: int, block_m: int) -> RaggedPlan:
    """Receiver-side flat plan from the counts matrix: zero sorts; the EP
    path's counterpart of ``make_ragged_plan``."""
    e, rank, valid, load = _recv_positions(recv_counts, recv_eid)
    e_local = recv_counts.shape[1]
    aligned = -(-load // block_m) * block_m
    g_starts = torch.cat([torch.zeros(1, dtype=torch.long, device=load.device),
                          torch.cumsum(aligned, 0)])           # (e_local+1,)
    slot = g_starts[e] + rank
    ok = valid & (slot < rows)
    slots = torch.where(ok, slot, -1)
    drops = (valid.sum() - ok.sum()).to(torch.int32)
    return RaggedPlan(slots[:, None].to(torch.int32),
                      _block_to_expert(g_starts, rows, block_m, e_local),
                      g_starts[-1].to(torch.int32), load.to(torch.int32), drops)


def invert_slots(slots: torch.Tensor, rows: int) -> torch.Tensor:
    """slots: (T, K) -> (rows,) int32 source flat-position map, -1 = empty:
    the scatter as a gather, output row r comes from token-slot inv[r]
    (slots are unique, so this is a true inverse)."""
    flat = slots.reshape(-1).long()
    idx = torch.where(flat >= 0, flat, rows)
    inv = torch.full((rows + 1,), -1, dtype=torch.int32, device=slots.device)
    inv[idx] = torch.arange(flat.shape[0], dtype=torch.int32, device=slots.device)
    return inv[:rows]
