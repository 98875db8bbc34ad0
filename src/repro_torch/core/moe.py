"""The MemFine MoE layer: router + FCDA chunking + a selectable strategy.

Strategies, as in the JAX package:

* ``tp_gspmd`` -- the local path: experts on the device, routing and
  dispatch planned per batch row (each row sorts only its own token-slots),
  the expert FFN on the grouped CUDA kernels.  Serving; the grouped kernels
  have no backward, so on the card it does not train.
* ``ep_shardmap`` -- the EP path (core/ep.py): per FCDA chunk, one plan,
  the dispatch exchange, the local expert leg, the return exchange and the
  combine, each chunk recomputed in the backward (Eq. 7).  With
  ``moe_fused`` the expert leg is the fused kernel, with ``moe_ragged`` the
  three-launch ragged leg over a real dispatch buffer; these are the paths
  that train.  Under a mesh (``DistContext.mesh``, ``launch/mesh.py``) each
  rank holds E / P experts and its own whole sequences, the exchange runs
  over its EP group, and the layer's stats are global (core/ep.py); with
  ``mesh=None`` it runs at one EP peer.  ``ctx.placement`` (expert
  placement, core/placement.py) reaches this path only, as in the JAX
  package.
* ``dense`` -- every expert on every token, masked combine: the tests'
  numerical oracle.

Under a multi-rank mesh only ``ep_shardmap`` runs: no rank holds all the
experts, and the port has no GSPMD to shard the others (a deliberate
difference from the JAX package, whose ``tp_gspmd`` runs under any mesh).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.configs.base import MoEConfig
from repro_torch.core import dispatch as dsp
from repro_torch.core.chunking import chunked_map
from repro_torch.core.ep import moe_ffn_ep
from repro_torch.core.router import route
from repro_torch.kernels.ops import expert_ffn
from repro_torch.kernels.ref import expert_ffn_ref


@dataclass(frozen=True)
class DistContext:
    """How the current step runs; plumbed through the model."""
    device: torch.device = torch.device("cuda")
    mesh: Optional[object] = None          # launch/mesh.py::Mesh; None = one peer
    moe_chunks: int = 1                    # FCDA chunk count (MACT-selected)
    pipeline_chunks: int = 1               # FCDA schedule depth: 1 = sequential
                                           # loop, >= 2 = waves of that many
                                           # chunks (EP path)
    remat_chunks: bool = True              # Eq. (7) per-chunk recomputation
    moe_strategy: str = "auto"             # overrides MoEConfig.strategy
    moe_ragged: bool = False               # MegaBlocks-style flat expert buffers
    moe_fused: bool = False                # the fused expert leg over the ragged
                                           # layout (kernels/fused_moe.py)
    ragged_block: int = 128                # ragged-layout row-block size
    layer_schedules: Optional[tuple] = None  # adaptive MACT: one ScheduleSpec
                                           # (chunks, depth) per MoE layer, in
                                           # layer order; overrides moe_chunks/
                                           # pipeline_chunks per layer
    placement: Optional[object] = None     # PlacementSpec of THIS layer's
                                           # experts over the EP group
                                           # (core/placement.py); None =
                                           # the contiguous identity layout
    placements: Optional[tuple] = None     # one PlacementSpec per MoE layer,
                                           # resolved to ``placement`` by
                                           # blocks.layer_ctx


_STRATEGIES = ("tp_gspmd", "ep_shardmap", "dense")


def _divides(cfg: MoEConfig, x_shape: tuple, ctx: DistContext) -> bool:
    """Whether this rank's (B, S) tokens and the experts split as the EP
    path needs: E over the EP group, the tokens into the FCDA chunks."""
    tokens = x_shape[0] * x_shape[1]
    return (cfg.num_experts % ctx.mesh.peers == 0
            and tokens % ctx.moe_chunks == 0 and tokens >= ctx.moe_chunks)


def resolve_strategy(cfg: MoEConfig, ctx: DistContext,
                     x_shape: Optional[tuple] = None) -> str:
    """The strategy asked for by the context (else the config), as the JAX
    package resolves it.  "auto" is the local per-row path without a mesh,
    and ``ep_shardmap`` under one when this rank's ``x_shape`` divides (or
    is not given).  An explicit ``ep_shardmap`` that does not divide raises,
    and so does any other strategy under a multi-rank mesh."""
    want = ctx.moe_strategy if ctx.moe_strategy != "auto" else cfg.strategy
    if want != "auto" and want not in _STRATEGIES:
        raise ValueError(f"unknown MoE strategy {want!r}; one of {_STRATEGIES}")
    mesh = ctx.mesh
    if mesh is None:
        return "tp_gspmd" if want == "auto" else want
    ok = x_shape is None or _divides(cfg, x_shape, ctx)
    if want == "auto":
        want = "ep_shardmap" if ok else "tp_gspmd"
    if want == "ep_shardmap" and not ok:
        raise ValueError(
            f"ep_shardmap requested but E={cfg.num_experts}, B={x_shape[0]}, "
            f"S={x_shape[1]} do not divide mesh axes "
            f"{dict(zip(mesh.axis_names, mesh.shape))}")
    if want != "ep_shardmap" and mesh.size > 1:
        raise ValueError(
            f"the {want} strategy does not run under a {mesh.shape[0]}x"
            f"{mesh.shape[1]} mesh: no rank holds all the experts; use "
            f"ep_shardmap")
    return want


def is_ep(cfg: Optional[MoEConfig], ctx: DistContext) -> bool:
    """Whether MoE layers run the EP strategy under ``ctx``."""
    return cfg is not None and resolve_strategy(cfg, ctx) == "ep_shardmap"


def _moe_ffn_rows(params: dict, x: torch.Tensor, cfg: MoEConfig,
                  ctx: DistContext):
    """x: (B, S, d).  Every batch row (and every FCDA chunk of a row) routes
    and plans its own dispatch; the rows' plans are made by one argsort over
    (row, expert) groups, which ranks each row's slots exactly as a
    separate sort per row would, and their buffers go through one expert
    FFN call."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.top_k
    row_group = torch.arange(B, device=x.device).view(B, 1, 1) * E

    def chunk_fn(xc):
        t_c = xc.shape[1]
        r = route(params["router"], xc, cfg)
        if cfg.capacity_mode == "dropless":
            cap = dsp.dropless_capacity(t_c)
        else:
            cap = dsp.balanced_capacity(t_c, k, E, cfg.capacity_factor)
        uplan = dsp.make_unified_plan((r.expert_idx + row_group).reshape(-1, k),
                                      B * E, cap_expert=cap)
        plan = dsp.DispatchPlan(uplan.expert_slots, uplan.expert_load,
                                uplan.drops_expert)
        buf = dsp.scatter_rows(xc.reshape(B * t_c, d), plan, B * E, cap)
        h = expert_ffn(buf.reshape(B, E, cap, d), params["w1"], params["w3"],
                       params["w2"])
        y = dsp.gather_rows(h.reshape(B * E, cap, d), plan,
                            r.weights.reshape(B * t_c, k))
        stats = {"aux_loss": r.aux_loss.sum(),
                 "load": r.load.float(),
                 "drops": plan.drops.float()}
        return y.reshape(B, t_c, d), stats

    y, stats = chunked_map(chunk_fn, x, ctx.moe_chunks, dim=1,
                           remat=ctx.remat_chunks)
    stats["aux_loss"] = stats["aux_loss"] / (B * ctx.moe_chunks)
    return y, stats


def _moe_ffn_dense(params: dict, x: torch.Tensor, cfg: MoEConfig,
                   ctx: DistContext):
    """Every expert on every token, masked combine (plain PyTorch): the
    tests' numerical oracle."""
    B, S, d = x.shape
    x2 = x.reshape(B * S, d)
    r = route(params["router"], x2, cfg)
    xe = x2[None].expand((cfg.num_experts,) + x2.shape)
    h = expert_ffn_ref(xe, params["w1"], params["w3"], params["w2"])   # (E, T, d)
    onehot = (r.expert_idx[..., None].long()
              == torch.arange(cfg.num_experts, device=x.device)).to(h.dtype)
    w = (onehot * r.weights[..., None].to(h.dtype)).sum(1)            # (T, E)
    y = torch.einsum("te,etd->td", w, h)
    stats = {"aux_loss": r.aux_loss, "load": r.load.float(),
             "drops": torch.zeros((), dtype=torch.float32, device=x.device)}
    return y.reshape(B, S, d), stats


def _shared_expert(params: dict, x: torch.Tensor) -> torch.Tensor:
    s = params["shared"]
    h = torch.nn.functional.silu(x @ s["w1"]) * (x @ s["w3"])
    return h @ s["w2"]


def moe_ffn(params: dict, x: torch.Tensor, cfg: MoEConfig, ctx: DistContext):
    """x: (B, S, d) -> (y, stats).

    Stats contract, as in the JAX package:

    * ``load``  -- (E,) float32, the total routed token-slot demand per
      expert (pre-capacity-clip), summed over batch rows, chunks and ranks.
    * ``drops`` -- float32 scalar, the total token-slots dropped; exactly
      0.0 under ``capacity_mode="dropless"``.
    * ``aux_loss`` -- float32 scalar, the mean per-chunk Switch auxiliary
      loss, averaged over chunks and batch rows (EP: over chunks and
      ranks, each rank's own aux on its own tokens).
    """
    strategy = resolve_strategy(cfg, ctx, x.shape)
    if strategy == "ep_shardmap":
        y, stats = moe_ffn_ep(params, x, cfg, mesh=ctx.mesh,
                              chunks=ctx.moe_chunks, remat=ctx.remat_chunks,
                              ragged=ctx.moe_ragged, pipeline=ctx.pipeline_chunks,
                              ragged_block=ctx.ragged_block, fused=ctx.moe_fused,
                              placement=ctx.placement)
        stats = dict(stats)
        stats["aux_loss"] = stats["aux_loss"] / ctx.moe_chunks
    elif strategy == "tp_gspmd":
        y, stats = _moe_ffn_rows(params, x, cfg, ctx)
    else:
        y, stats = _moe_ffn_dense(params, x, cfg, ctx)
    if "shared" in params:
        y = y + _shared_expert(params, x)
    return y, stats
