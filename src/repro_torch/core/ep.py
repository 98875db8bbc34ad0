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
once: the router's gradient is the gradient of the mean.  Expert placement
is not ported yet.

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

import torch

from repro_torch.configs.base import MoEConfig
from repro_torch.core import dispatch as dsp
from repro_torch.core.chunking import ChunkStages, chunked_pipeline
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
    world and the chunks."""
    if placement is not None:
        raise NotImplementedError("expert placement is not ported yet")
    peers = _peers(mesh)
    E = moe_cfg.num_experts
    e_local = E // peers
    B, S, d = x.shape
    tokens = B * S
    x2 = x.reshape(tokens, d)
    k = moe_cfg.top_k
    t_c = tokens // chunks
    router = params["router"]
    w1, w3, w2 = params["w1"], params["w3"], params["w2"]
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
        if moe_cfg.capacity_mode == "dropless":
            # a token's k experts are distinct, so at most min(k, E_local)
            # of its slots target one peer: the exact worst case
            cap_send = t_c * min(k, e_local)
        else:
            cap_send = dsp.balanced_capacity(t_c, k, peers, moe_cfg.capacity_factor)
        uplan = dsp.make_unified_plan(r.expert_idx, E, peers, cap_send=cap_send)
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
