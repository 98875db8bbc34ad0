"""Sort-based static-shape token dispatch / combine.

Token-slots are ranked within their target expert by one stable argsort and
an exclusive cumsum, and scattered into fixed ``(E, capacity)`` buffers;
overflow past the capacity is dropped and counted.  The same plans as the
JAX package's, integer for integer.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class DispatchPlan(NamedTuple):
    slots: torch.Tensor   # (T, K) int32 -- flat position in (G*capacity), -1 = dropped
    load: torch.Tensor    # (G,) int32 -- demand per group (before capacity clip)
    drops: torch.Tensor   # scalar int32 -- token-slots that exceeded capacity


class UnifiedPlan(NamedTuple):
    """The expert layout read out of one stable argsort of expert ids (the
    ``num_peers=1, cap_expert`` read-out the local MoE path uses)."""
    expert_slots: Optional[torch.Tensor]  # (T, K) int32 into flat (E*cap), -1 dropped
    expert_load: torch.Tensor             # (E,) int32 demand per expert (pre-clip)
    drops_expert: torch.Tensor            # scalar int32 -- expert-capacity drops


def make_unified_plan(expert_idx: torch.Tensor, num_experts: int, *,
                      cap_expert: Optional[int] = None) -> UnifiedPlan:
    """expert_idx: (T, K) int32 expert ids -> UnifiedPlan, from exactly one
    stable argsort."""
    T, K = expert_idx.shape
    N = T * K
    dev = expert_idx.device
    flat = expert_idx.reshape(-1).long()
    order = torch.argsort(flat, stable=True)
    sorted_e = flat[order]
    # scatter_add, not bincount, which sizes its output with a device sync
    expert_load = torch.zeros(num_experts, dtype=torch.long, device=dev).scatter_add_(
        0, flat, torch.ones_like(flat))
    e_starts = torch.cumsum(expert_load, 0) - expert_load      # exclusive
    rank_e = torch.arange(N, device=dev) - e_starts[sorted_e]

    expert_slots = None
    drops_expert = torch.zeros((), dtype=torch.int32, device=dev)
    if cap_expert is not None:
        ok = rank_e < cap_expert
        slot_sorted = torch.where(ok, sorted_e * cap_expert + rank_e, -1)
        expert_slots = torch.empty(N, dtype=torch.long, device=dev)
        expert_slots[order] = slot_sorted
        expert_slots = expert_slots.reshape(T, K).to(torch.int32)
        drops_expert = (N - ok.sum()).to(torch.int32)
    return UnifiedPlan(expert_slots, expert_load.to(torch.int32), drops_expert)


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
