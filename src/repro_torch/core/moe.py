"""The MemFine MoE layer: router + FCDA chunking + the local expert path.

The port runs the JAX package's ``tp_gspmd`` / local strategy: experts on
the device, routing and dispatch planned per batch row (each row sorts only
its own token-slots), the expert FFN on the grouped CUDA kernels.  The EP
all-to-all strategy and the dense oracle are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import MoEConfig
from repro_torch.core import dispatch as dsp
from repro_torch.core.chunking import chunked_map
from repro_torch.core.router import route
from repro_torch.kernels.ops import expert_ffn


@dataclass(frozen=True)
class DistContext:
    """How the current step runs; plumbed through the model."""
    device: torch.device = torch.device("cuda")
    moe_chunks: int = 1                    # FCDA chunk count
    moe_strategy: str = "auto"             # overrides MoEConfig.strategy


def resolve_strategy(cfg: MoEConfig, ctx: DistContext) -> str:
    """The port has one device and no mesh, so "auto" resolves to the local
    per-row path, as the JAX package resolves it without a mesh."""
    want = ctx.moe_strategy if ctx.moe_strategy != "auto" else cfg.strategy
    if want in ("auto", "tp_gspmd"):
        return "tp_gspmd"
    raise NotImplementedError(f"MoE strategy {want!r} is not ported yet; "
                              "the port runs the local 'tp_gspmd' path")


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

    y, stats = chunked_map(chunk_fn, x, ctx.moe_chunks, dim=1)
    stats["aux_loss"] = stats["aux_loss"] / (B * ctx.moe_chunks)
    return y, stats


def _shared_expert(params: dict, x: torch.Tensor) -> torch.Tensor:
    s = params["shared"]
    h = torch.nn.functional.silu(x @ s["w1"]) * (x @ s["w3"])
    return h @ s["w2"]


def moe_ffn(params: dict, x: torch.Tensor, cfg: MoEConfig, ctx: DistContext):
    """x: (B, S, d) -> (y, stats).

    Stats contract, as in the JAX package:

    * ``load``  -- (E,) float32, the total routed token-slot demand per
      expert (pre-capacity-clip), summed over batch rows and chunks.
    * ``drops`` -- float32 scalar, the total token-slots dropped; exactly
      0.0 under ``capacity_mode="dropless"``.
    * ``aux_loss`` -- float32 scalar, the mean per-chunk Switch auxiliary
      loss, averaged over chunks and batch rows.
    """
    resolve_strategy(cfg, ctx)
    y, stats = _moe_ffn_rows(params, x, cfg, ctx)
    if "shared" in params:
        y = y + _shared_expert(params, x)
    return y, stats
