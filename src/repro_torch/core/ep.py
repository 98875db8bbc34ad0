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

The EP group is ``ctx.ep_group``.  This port runs one peer: with no group
the exchange of a one-peer group is the identity, exactly what
``lax.all_to_all`` over a size-1 mesh axis is in the JAX package.  The
exchange across ranks (``torch.distributed.all_to_all_single`` over NCCL)
is not ported yet, and neither is expert placement.

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


def _peers(ep_group) -> int:
    if ep_group is not None:
        raise NotImplementedError(
            "EP across ranks (all_to_all over an EP process group) is not "
            "ported yet; pass ep_group=None for EP at one peer")
    return 1


def _all_to_all(t: torch.Tensor, peers: int) -> torch.Tensor:
    """The exchange of dim 0's peer blocks; the identity at one peer."""
    assert peers == 1
    return t


def moe_ffn_ep(params: dict, x: torch.Tensor, moe_cfg: MoEConfig, *,
               ep_group=None, chunks: int = 1, remat: bool = True,
               ragged: bool = False, pipeline: int = 1,
               ragged_block: int = RAGGED_BLOCK, fused: bool = False,
               placement=None):
    """x: (B, S, d) -> (y, stats).  ``pipeline`` is the FCDA schedule depth:
    1 = sequential loop, >= 2 = waves of that many chunks.  Stats as the
    JAX package's EP path: aux_loss summed over chunks (the caller divides
    by the chunk count), load and drops summed."""
    if placement is not None:
        raise NotImplementedError("expert placement is not ported yet")
    peers = _peers(ep_group)
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
        recv = _all_to_all(send.reshape(peers, cap_send, d), peers)
        recv_cnt = _all_to_all(uplan.counts, peers)
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
        recv_back = _all_to_all(back, peers)
        y = combine_rows(recv_back.reshape(peers * cap_send, d), st["send_slots"],
                         st["weights"])
        stats = {"aux_loss": st["aux_loss"],
                 "load": st["load"].float(),
                 "drops": st["drops"].float()}
        return y, stats

    stages = ChunkStages(stage_dispatch, stage_compute, stage_combine)
    y, stats = chunked_pipeline(stages, x2, chunks, depth=pipeline, remat=remat)
    return y.reshape(B, S, d), stats
