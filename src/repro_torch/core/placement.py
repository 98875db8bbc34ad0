"""Telemetry-driven expert placement and hot-expert replication.

MemFine schedules around routing skew (FCDA chunking and recompute depth);
this module moves the work instead.  The per-layer, per-expert EMA that
``core/telemetry.py`` keeps feeds a greedy LPT assignment of experts to EP
peers, then replication of persistently hot experts onto other peers, with
a deterministic split of their tokens at routing time.

The representation is slot-based: each EP peer holds ``slots_per_peer =
e_local + replicas`` expert-weight slots, and ``slot_to_expert``
(peer-major) says whose weights each slot holds.  A replicated expert has
one slot on several peers, never two on one peer.  The EP layer then plans
its dispatch over slot ids instead of expert ids (``core/ep.py``): the
planner does not care what its group ids mean, so the plan stays one sort
and the combine stays its transpose.  An identity spec is detected and
skipped, so it is the unplaced path bit for bit.

Host-side numpy but for ``place_expert_idx``, which maps a chunk's routed
expert ids to slot ids on the ids' device.  The port's copy of the JAX
package's ``core/placement.py``, choice for choice.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

#: cap on the load-split modulus (lcm of replica counts); beyond it the
#: round-robin split is approximately even instead of exactly even
MAX_SPLIT_MOD = 2520


class PlacementSpec(NamedTuple):
    """Expert -> (peer, slot) assignment for one MoE layer.

    ``slot_to_expert`` is peer-major: slot ``s`` lives on peer
    ``s // slots_per_peer`` and holds the weights of expert
    ``slot_to_expert[s]``.  Hashable, so it can sit in ``DistContext``."""
    num_experts: int
    num_peers: int
    slot_to_expert: Tuple[int, ...]

    @property
    def total_slots(self) -> int:
        return len(self.slot_to_expert)

    @property
    def slots_per_peer(self) -> int:
        return self.total_slots // self.num_peers

    @property
    def replica_slots(self) -> int:
        """Extra weight slots per peer beyond the identity e_local."""
        return self.slots_per_peer - self.num_experts // self.num_peers

    @property
    def is_identity(self) -> bool:
        return (self.total_slots == self.num_experts
                and self.slot_to_expert == tuple(range(self.num_experts)))

    @classmethod
    def identity(cls, num_experts: int, num_peers: int) -> "PlacementSpec":
        """The contiguous mapping (expert e on peer e // e_local)."""
        if num_experts % num_peers:
            raise ValueError(f"E={num_experts} not divisible by P={num_peers}")
        return cls(num_experts, num_peers, tuple(range(num_experts)))

    def validate(self) -> None:
        E, P, s2e = self.num_experts, self.num_peers, self.slot_to_expert
        if len(s2e) % P:
            raise ValueError(f"{len(s2e)} slots not divisible by {P} peers")
        spp = len(s2e) // P
        if spp < E // P:
            raise ValueError("fewer slots per peer than e_local")
        seen = set()
        for p in range(P):
            block = s2e[p * spp:(p + 1) * spp]
            if len(set(block)) != spp:
                raise ValueError(f"peer {p} hosts a duplicate expert: {block}")
            seen.update(block)
        if seen != set(range(E)):
            raise ValueError(f"experts {set(range(E)) - seen} unplaced")

    def replica_counts(self) -> np.ndarray:
        """(E,) number of slots hosting each expert (>= 1)."""
        return np.bincount(np.asarray(self.slot_to_expert),
                           minlength=self.num_experts).astype(np.int64)

    def expert_slot_table(self) -> np.ndarray:
        """(E, R) int32: row e lists expert e's slots round-robin.  R is the
        lcm of the replica counts (capped at MAX_SPLIT_MOD), so each replica
        appears equally often per row and the position split
        ``table[e, pos % R]`` is exactly even (approximate past the cap)."""
        counts = self.replica_counts()
        R = 1
        for c in sorted(set(int(c) for c in counts)):
            R = R * c // math.gcd(R, c)
            if R >= MAX_SPLIT_MOD:
                R = MAX_SPLIT_MOD
                break
        slots_of = [[] for _ in range(self.num_experts)]
        for s, e in enumerate(self.slot_to_expert):
            slots_of[e].append(s)
        table = np.empty((self.num_experts, R), dtype=np.int32)
        for e, slots in enumerate(slots_of):
            table[e] = [slots[i % len(slots)] for i in range(R)]
        return table

    def peer_loads(self, load) -> np.ndarray:
        """(P,) predicted per-peer routed load for an (E,) load vector: each
        expert's load split evenly across its replicas, the model that the
        solver and ``MACTController.observed_s_pp`` price."""
        load = np.asarray(load, dtype=np.float64).reshape(-1)
        if load.size != self.num_experts:
            raise ValueError(
                f"load of size {load.size}, expected {self.num_experts}")
        share = load / self.replica_counts()
        s2e = np.asarray(self.slot_to_expert)
        return share[s2e].reshape(self.num_peers, self.slots_per_peer).sum(1)


def bottleneck(spec: PlacementSpec, load) -> float:
    """Hottest-peer predicted load: the quantity LPT minimises."""
    return float(spec.peer_loads(load).max())


def plan_placement(load, num_peers: int, *, replicas: int = 0) -> PlacementSpec:
    """Greedy LPT assignment + hot-expert replication for one layer.

    Pass 1 (LPT): experts in descending load order, each to the least-loaded
    peer with a free canonical slot (the ``replicas`` extra slots per peer
    are kept for pass 2).  Pass 2 (replication): repeatedly replicate the
    hottest-share expert onto its least-loaded non-hosting peer, committing
    only moves that improve the sorted per-peer load vector
    lexicographically.  When no replication helps, the remaining slots are
    padded with each peer's coldest absent expert, so every peer has the
    uniform ``slots_per_peer`` the dispatch shape needs."""
    load = np.asarray(load, dtype=np.float64).reshape(-1)
    E = load.size
    if num_peers <= 0 or E % num_peers:
        raise ValueError(f"E={E} not divisible by P={num_peers}")
    e_local = E // num_peers
    spp = e_local + replicas
    if replicas < 0 or spp > E:
        raise ValueError(f"replicas={replicas} out of range for E={E}, "
                         f"P={num_peers}")
    peer_slots: list[list[int]] = [[] for _ in range(num_peers)]
    peer_load = np.zeros(num_peers)
    for e in np.argsort(-load, kind="stable"):
        p = min((p for p in range(num_peers) if len(peer_slots[p]) < e_local),
                key=lambda p: (peer_load[p], p))
        peer_slots[p].append(int(e))
        peer_load[p] += load[e]
    counts = np.ones(E)

    def peer_loads_now() -> np.ndarray:
        share = load / counts
        return np.array([share[s].sum() for s in peer_slots])

    while any(len(s) < spp for s in peer_slots):
        share = load / counts
        pl = peer_loads_now()
        before = tuple(sorted(pl, reverse=True))
        committed = False
        for e in np.argsort(-share, kind="stable"):
            e = int(e)
            cands = [p for p in range(num_peers)
                     if len(peer_slots[p]) < spp and e not in peer_slots[p]]
            if not cands:
                continue
            p = min(cands, key=lambda p: (pl[p], p))
            peer_slots[p].append(e)
            counts[e] += 1
            if tuple(sorted(peer_loads_now(), reverse=True)) < before:
                committed = True
                break
            peer_slots[p].pop()
            counts[e] -= 1
        if not committed:
            for p in range(num_peers):
                while len(peer_slots[p]) < spp:
                    share = load / counts
                    cold = min((e for e in range(E) if e not in peer_slots[p]),
                               key=lambda e: (share[e], e))
                    peer_slots[p].append(cold)
                    counts[cold] += 1
            break
    # canonical within-peer order (by expert id), so equal assignments
    # compare equal across replans: the hysteresis band depends on it
    s2e = tuple(e for p in range(num_peers) for e in sorted(peer_slots[p]))
    spec = PlacementSpec(E, num_peers, s2e)
    spec.validate()
    return spec


def choose_placements(loads, num_layers: int, num_peers: int, *,
                      num_experts: Optional[int] = None, replicas: int = 0,
                      current: Optional[Sequence[PlacementSpec]] = None,
                      hysteresis: float = 0.1) -> Tuple[PlacementSpec, ...]:
    """Per-MoE-layer placement vector with a hysteresis band.

    ``loads`` is the telemetry's (L_moe, E) EMA (None: identity for every
    layer, sized by ``num_experts``, or ``current`` when given).  A layer
    leaves its incumbent only when the candidate's predicted bottleneck
    beats the incumbent's by more than the hysteresis fraction."""
    if loads is None:
        if num_experts is None:
            raise ValueError("num_experts required when loads is None")
        ident = PlacementSpec.identity(num_experts, num_peers)
        return tuple(current) if current is not None else (ident,) * num_layers
    loads = np.asarray(loads, dtype=np.float64)
    if loads.ndim != 2 or loads.shape[0] != num_layers:
        raise ValueError(f"loads of shape {loads.shape}, expected "
                         f"({num_layers}, E)")
    ident = PlacementSpec.identity(loads.shape[1], num_peers)
    out = []
    for i in range(num_layers):
        row = loads[i]
        inc = current[i] if current is not None else ident
        cand = plan_placement(row, num_peers, replicas=replicas)
        if bottleneck(cand, row) * (1.0 + hysteresis) < bottleneck(inc, row):
            out.append(cand)
        else:
            out.append(inc)
    return tuple(out)


def migrated_slots(old: Optional[PlacementSpec], new: PlacementSpec) -> int:
    """Weight slots whose resident expert changes from ``old`` to ``new``
    (``old=None``: the identity layout of a cold start).  Slots compare by
    (peer, offset); a slot with no predecessor (a replica slot just carved
    out) counts as moved."""
    if old is None:
        old = PlacementSpec.identity(new.num_experts, new.num_peers)
    if old.num_peers != new.num_peers:
        return new.total_slots
    spp_o, spp_n = old.slots_per_peer, new.slots_per_peer
    moved = 0
    for p in range(new.num_peers):
        for o in range(spp_n):
            prev = old.slot_to_expert[p * spp_o + o] if o < spp_o else None
            moved += new.slot_to_expert[p * spp_n + o] != prev
    return moved


def place_expert_idx(expert_idx: torch.Tensor,
                     spec: Optional[PlacementSpec]) -> torch.Tensor:
    """Routed expert ids (T, K) -> weight-slot ids, replicas load-split by
    flat position: slot = table[e, pos % R], pos = t K + k.  With R the lcm
    of the replica counts, consecutive token-slots of an expert's column
    round-robin over its replicas.  An identity spec (or None) returns the
    ids themselves."""
    if spec is None or spec.is_identity:
        return expert_idx
    table = torch.as_tensor(spec.expert_slot_table(), device=expert_idx.device)
    t, k = expert_idx.shape
    pos = torch.arange(t * k, dtype=torch.long,
                       device=expert_idx.device).reshape(t, k)
    return table[expert_idx.long(), pos % table.shape[1]].to(expert_idx.dtype)
