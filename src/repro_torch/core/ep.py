"""Expert parallelism: the paper's dispatch path over an EP group.

Each FCDA chunk routes its tokens, plans every layout with one stable
argsort, sends each peer its rows (``dispatch_rows`` into a (P, cap_send)
send buffer), runs the local experts on what it received, and sends the
rows back to be combined with the router weights (``combine_rows``).

Buffer sizing is the heart of the memory story: under dropless routing the
send block per peer holds the worst case (every local token-slot targets one
peer: cap_send = T_chunk * min(K, E_local)) and the local expert buffer the
group worst case (cap_recv = P * T_chunk).  Unchunked, that is the paper's
s' -> e*s blow-up by construction; FCDA divides both by the chunk count.

Across ranks the EP group is ``mesh.ep_group`` (``launch/mesh.py``): each
of its P ranks holds E / P experts and exchanges dim 0's P blocks of the
send and return buffers with ``all_to_all_single`` (``_all_to_all``, whose
backward is the same exchange of the gradient), and the counts matrix
through the same exchange without autograd.  The blocks keep the JAX
package's fixed worst-case size, cap_send rows per peer, padded: Eq. 2
charges exactly these buffers.  ``mesh=None`` is one peer, where the
exchange is the identity, as ``lax.all_to_all`` over a size-1 axis is.

Each rank routes its own tokens; the layer's stats are global, as the
reference's ``pmean``/``psum`` over every mesh axis make them: ``load`` and
``drops`` summed over the world, ``aux_loss`` the mean over the world of
each rank's own aux.  That mean is a replicated value whose backward passes
each rank's gradient through unchanged (``_Replicated``), so when a train
step sums the dense gradients over the ranks, each rank's aux term counts
once: the router's gradient is the gradient of the mean.

Expert placement (``placement``, core/placement.py): the dispatch groups
are weight slots, not expert ids.  Each rank keeps its E / P canonical
experts (and AdamW's moments with them); once per layer per step, before
the FCDA chunk loop, ``_GatherSlots`` builds the rank's ``slots_per_peer``
slot weights: a slot whose expert this rank owns is read from the local
tensor, the others arrive in one exchange of variable splits
(``Mesh.all_to_all_v``).  That gather is the JAX package's global
``w[slot_to_expert]``; its backward, run once after every chunk's, sends
each received slot's gradient back to its owner and adds every replica's
gradient into the canonical rows, as the gather's transpose does there.
Routing maps each chunk's expert ids to slot ids
(``place_expert_idx``), so the planner, the kernels' ``E_local`` and the
ragged R follow ``slots_per_peer``.  An identity spec is the unplaced path
bit for bit; a spec for another peer count than the EP group's is planned
and priced by the trainer but not applied (at one peer the JAX package runs
its local path, which ignores placement).

The local expert leg is one of:

* ``fused`` -- ``kernels/ops.py::moe_ffn`` over the ragged layout, one
  ``fused_moe`` call forward: token rows are gathered inside the kernel, so
  the (R, d) dispatch buffer never exists on the forward;
* ``ragged`` -- the three-launch leg over the same layout:
  ``dispatch_rows`` builds the (R, d) buffer, ``ragged_expert_ffn`` runs
  ``ragged_swiglu`` and ``ragged_matmul`` on it, ``combine_rows`` returns
  the rows.  This is the buffer the memory model's ``2h`` term charges
  (Eq. 2 with ``fused=False``);
* otherwise the (E_local, cap_recv) capacity layout on the grouped kernels
  (serving kernels: no backward on the card).

Both ragged-layout legs train.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.configs.base import MoEConfig
from repro_torch.core import dispatch as dsp
from repro_torch.core.chunking import ChunkStages, chunked_pipeline
from repro_torch.core.placement import PlacementSpec, place_expert_idx
from repro_torch.core.router import route
from repro_torch.kernels.ops import (combine_rows, dispatch_rows, expert_ffn,
                                     ragged_expert_ffn, shared_weight_grads)
from repro_torch.kernels.ops import moe_ffn as fused_moe_leg

#: default ragged-layout row-block size; per-run override via
#: DistContext.ragged_block (core/moe.py)
RAGGED_BLOCK = 128


def _peers(mesh) -> int:
    """The EP group's size: 1 without a mesh."""
    return 1 if mesh is None else mesh.peers


class _AllToAll(torch.autograd.Function):
    """The exchange of dim 0's peer blocks over the EP group.  It is its own
    transpose: the backward sends each block's gradient back where the block
    came from with the same exchange."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return mesh.all_to_all(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_to_all(g), None


def _all_to_all(t: torch.Tensor, mesh) -> torch.Tensor:
    """The exchange of dim 0's peer blocks; the identity at one peer."""
    if _peers(mesh) == 1:
        return t
    return _AllToAll.apply(t, mesh)


class _Replicated(torch.autograd.Function):
    """The sum of ``t`` over the world; the backward passes the gradient
    through unchanged, so each rank's own term gets its gradient once."""

    @staticmethod
    def forward(ctx, t, mesh):
        return mesh.all_reduce_(t.clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


def _world_mean(t: torch.Tensor, mesh) -> torch.Tensor:
    """The mean over the world of each rank's ``t``, replicated."""
    return t if mesh is None else _Replicated.apply(t, mesh) / mesh.size


def _world_sum(t: torch.Tensor, mesh) -> torch.Tensor:
    """The sum over the world of a statistic without a gradient."""
    return t if mesh is None else mesh.all_reduce_(t.detach().clone())


class SlotRoutes(NamedTuple):
    """How one EP rank builds its slot weights under a placement.  Rows are
    expert rows of the rank's canonical (E / P, ...) tensor; positions are
    slots of the rank's (slots_per_peer, ...) slot tensor."""
    own_pos: tuple       # slots whose expert this rank owns ...
    own_rows: tuple      # ... and those experts' canonical rows
    recv_pos: tuple      # slots filled by the exchange, in arrival order
    send_rows: tuple     # canonical rows this rank sends, peer-major
    send_splits: tuple   # rows sent to each peer
    recv_splits: tuple   # rows received from each peer
    exchange: bool       # whether any rank of the group receives a slot
    view: bool           # the slot tensor is the canonical tensor itself


@functools.lru_cache(maxsize=64)
def slot_routes(spec: PlacementSpec, j: int) -> SlotRoutes:
    """``SlotRoutes`` of the rank at model index ``j``: the slots of peer q
    whose expert peer p owns (p != q) travel from p to q in q's slot
    order."""
    P, spp = spec.num_peers, spec.slots_per_peer
    e_local = spec.num_experts // P
    s2e = spec.slot_to_expert

    def hosted(q):
        """(slot position, expert, owner) of peer q's slots."""
        return [(pos, s2e[q * spp + pos], s2e[q * spp + pos] // e_local)
                for pos in range(spp)]

    mine = hosted(j)
    own = [(pos, e - j * e_local) for pos, e, o in mine if o == j]
    recv = [[pos for pos, _, o in mine if o == p and p != j] for p in range(P)]
    send = [[e - j * e_local for _, e, o in hosted(q) if o == j and q != j]
            for q in range(P)]
    exchange = any(o != q for q in range(P) for _, _, o in hosted(q))
    return SlotRoutes(
        own_pos=tuple(p for p, _ in own), own_rows=tuple(r for _, r in own),
        recv_pos=tuple(p for ps in recv for p in ps),
        send_rows=tuple(r for rs in send for r in rs),
        send_splits=tuple(len(rs) for rs in send),
        recv_splits=tuple(len(ps) for ps in recv), exchange=exchange,
        view=spp == e_local and [r for _, r in own] == list(range(spp)))


def _index(rows, device) -> torch.Tensor:
    return torch.as_tensor(rows, dtype=torch.long, device=device)


def _rows(t: torch.Tensor, rows) -> torch.Tensor:
    """Rows ``rows`` of ``t``, as a new tensor."""
    return t.index_select(0, _index(rows, t.device))


class _GatherSlots(torch.autograd.Function):
    """The canonical expert weights (E / P, ...) -> this rank's slot
    weights (slots_per_peer, ...), one weight at a time, so that only one
    weight's exchange buffers exist at once.  The backward returns each
    received slot's gradient to the expert's owner and sums every slot's
    gradient into its canonical row, the rank's own slot first, then the
    returned ones in peer order.  It writes the canonical gradient into
    the first E / P rows of the slot gradient's own buffer (the layer's
    shared buffer, ``kernels/ops.py::WeightGrads``) and returns that view,
    so a placed layer holds no second gradient of its experts."""

    @staticmethod
    def forward(ctx, mesh, routes, *ws):
        ctx.mesh, ctx.routes = mesh, routes
        ctx.e_local = ws[0].shape[0]
        outs = []
        for w in ws:
            recv = None
            if routes.exchange:
                recv = mesh.all_to_all_v(_rows(w, routes.send_rows), routes.send_splits,
                                         routes.recv_splits)
            if routes.view:
                # every slot holds this rank's own expert, in canonical order
                outs.append(w.view_as(w))
                continue
            out = w.new_empty((len(routes.own_pos) + len(routes.recv_pos),)
                              + tuple(w.shape[1:]))
            out.index_copy_(0, _index(routes.own_pos, w.device), _rows(w, routes.own_rows))
            if recv is not None:
                out.index_copy_(0, _index(routes.recv_pos, w.device), recv)
            outs.append(out)
            del recv
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        mesh, r = ctx.mesh, ctx.routes
        dws = []
        for g in gs:
            back = None
            if r.exchange:
                back = mesh.all_to_all_v(_rows(g, r.recv_pos), r.recv_splits,
                                         r.send_splits)
            if r.view:
                dws.append(g)
                continue
            own = _rows(g, r.own_pos)
            dw = g[:ctx.e_local]               # the slot rows are all read by now
            dw.zero_()
            dw.index_copy_(0, _index(r.own_rows, g.device), own)
            del own
            if back is not None:
                # row by row, in peer order: a fixed order of the sums (an
                # index_add_ on the card adds duplicate rows atomically)
                for n, row in enumerate(r.send_rows):
                    dw[row] += back[n]
            dws.append(dw)
            del back
        return (None, None, *dws)


def _applied(placement, num_experts: int, peers: int):
    """The placement this layer runs: None for none, identity, or a spec
    for another peer count than the EP group's (planned and priced by the
    trainer, not applied); a spec for another expert count raises."""
    if placement is None or placement.is_identity:
        return None
    if placement.num_experts != num_experts:
        raise ValueError(f"placement for E={placement.num_experts}, the layer has "
                         f"E={num_experts}")
    if placement.num_peers != peers:
        return None
    placement.validate()
    return placement


def moe_ffn_ep(params: dict, x: torch.Tensor, moe_cfg: MoEConfig, *,
               mesh=None, chunks: int = 1, remat: bool = True,
               ragged: bool = False, pipeline: int = 1,
               ragged_block: int = RAGGED_BLOCK, fused: bool = False,
               placement=None):
    """x: (B, S, d), this rank's tokens -> (y, stats).  ``params`` holds
    this rank's E / P experts.  ``pipeline`` is the FCDA schedule depth:
    1 = sequential loop, >= 2 = waves of that many chunks.  Stats as the
    JAX package's EP path: aux_loss the world's mean, summed over chunks
    (the caller divides by the chunk count); load and drops summed over the
    world and the chunks.  ``placement``: this layer's PlacementSpec (module
    docstring); None or identity is the contiguous layout."""
    peers = _peers(mesh)
    E = moe_cfg.num_experts
    placement = _applied(placement, E, peers)
    # under a placement the dispatch groups are slots: sorting by slot id
    # still groups by target peer (slots are peer-contiguous), and e_local
    # below is slots per peer
    n_groups = placement.total_slots if placement is not None else E
    e_local = n_groups // peers
    B, S, d = x.shape
    tokens = B * S
    x2 = x.reshape(tokens, d)
    k = moe_cfg.top_k
    t_c = tokens // chunks
    router = params["router"]
    w1, w3, w2 = params["w1"], params["w3"], params["w2"]
    if placement is not None:
        # once per layer, before the chunks: FCDA's recompute reuses these
        # (a placement applies only over a group of more than one rank)
        w1, w3, w2 = _GatherSlots.apply(mesh, slot_routes(placement, mesh.coords[1]),
                                        w1, w3, w2)
    grads = None
    if ragged or fused:
        # one gradient buffer per expert weight for all the layer's chunks:
        # each chunk's backward adds into it (the scan transpose's single
        # cotangent in the JAX package), so chunking never holds a second
        # full-size weight gradient
        w1, w3, w2, grads = shared_weight_grads(w1, w3, w2)

    def stage_dispatch(xc):
        """Route + single-sort plan + the dispatch exchange."""
        r = route(router, xc, moe_cfg)
        # expert id -> slot id, replicas split by flat position (identity:
        # the ids themselves)
        sel = place_expert_idx(r.expert_idx, placement)
        if moe_cfg.capacity_mode == "dropless":
            # a token's k experts are distinct and a peer hosts an expert in
            # at most one slot, so at most min(k, E_local) of its slots
            # target one peer: the exact worst case
            cap_send = t_c * min(k, e_local)
        else:
            cap_send = dsp.balanced_capacity(t_c, k, peers, moe_cfg.capacity_factor)
        uplan = dsp.make_unified_plan(sel, n_groups, peers, cap_send=cap_send)
        send = dispatch_rows(xc, uplan.send_slots, peers * cap_send)
        recv = _all_to_all(send.reshape(peers, cap_send, d), mesh)
        recv_cnt = (uplan.counts if peers == 1
                    else mesh.all_to_all(uplan.counts))
        return {"recv": recv, "recv_cnt": recv_cnt,
                "send_slots": uplan.send_slots, "weights": r.weights,
                "aux_loss": r.aux_loss, "load": r.load, "drops_send": uplan.drops}

    def stage_compute(st):
        """The local expert FFN over the received rows."""
        recv, recv_cnt = st["recv"], st["recv_cnt"]
        _, cap_send, _ = recv.shape
        rows = recv.reshape(peers * cap_send, d)
        # each source block is expert-sorted and packed from 0, so the counts
        # matrix alone gives every row's expert
        local_e = dsp.eids_from_counts(recv_cnt, cap_send)
        if ragged or fused:
            # the flat layout: the worst-case rows plus one block of padding
            # per local expert, blocks past the routed load predicated off
            R = peers * cap_send + e_local * ragged_block
            R = -(-R // ragged_block) * ragged_block
            plan = dsp.recv_ragged_plan(recv_cnt, local_e, R, ragged_block)
            # the router weight is applied after the return exchange
            # (stage_combine), so this combine is unweighted
            if fused:
                back = fused_moe_leg(rows, w1, w3, w2, plan.slots,
                                     plan.block_to_expert, plan.total_rows, None,
                                     block_m=ragged_block, grads=grads)
            else:
                buf = dispatch_rows(rows, plan.slots, R, total_rows=plan.total_rows)
                h = ragged_expert_ffn(buf, w1, w3, w2, plan.block_to_expert,
                                      plan.total_rows, block_m=ragged_block,
                                      grads=grads)
                back = combine_rows(h, plan.slots, None, plan.total_rows)
        else:
            if moe_cfg.capacity_mode == "dropless":
                cap_recv = peers * t_c
            else:
                cap_recv = dsp.balanced_capacity(peers * t_c, k, E,
                                                 moe_cfg.capacity_factor)
            plan = dsp.recv_expert_plan(recv_cnt, local_e, cap_recv)
            buf = dispatch_rows(rows, plan.slots, e_local * cap_recv)
            h = expert_ffn(buf.reshape(e_local, cap_recv, d), w1, w3, w2)
            back = combine_rows(h.reshape(e_local * cap_recv, d), plan.slots)
        return {"back": back.reshape(peers, cap_send, d),
                "send_slots": st["send_slots"], "weights": st["weights"],
                "aux_loss": st["aux_loss"], "load": st["load"],
                "drops": st["drops_send"] + plan.drops}

    def stage_combine(st):
        """The return exchange, then the router-weighted combine."""
        back = st["back"]
        _, cap_send, _ = back.shape
        recv_back = _all_to_all(back, mesh)
        y = combine_rows(recv_back.reshape(peers * cap_send, d), st["send_slots"],
                         st["weights"])
        stats = {"aux_loss": _world_mean(st["aux_loss"], mesh),
                 "load": _world_sum(st["load"].float(), mesh),
                 "drops": _world_sum(st["drops"].float(), mesh)}
        return y, stats

    stages = ChunkStages(stage_dispatch, stage_compute, stage_combine)
    y, stats = chunked_pipeline(stages, x2, chunks, depth=pipeline, remat=remat)
    return y.reshape(B, S, d), stats
