"""Top-k softmax router (Switch auxiliary loss, optional DeepSeek bias).

MemFine does not touch routing; it consumes the router's load statistics.
Router math is fp32 whatever the model's type, and the combine weights are
cast back to the input type, as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import MoEConfig


class RouterOut(NamedTuple):
    expert_idx: torch.Tensor  # (..., T, K) int32 -- chosen experts per token
    weights: torch.Tensor     # (..., T, K) combine weights (renormalised probs)
    aux_loss: torch.Tensor    # (...) -- Switch-style auxiliary loss per row
    load: torch.Tensor        # (E,) int32 -- tokens routed to each expert, all rows


def top_k(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest scores along the last dim, ties to the lower
    index -- the order ``jax.lax.top_k`` returns.  ``torch.topk`` breaks
    ties differently, so this is a stable descending sort."""
    return torch.sort(scores, dim=-1, descending=True, stable=True).indices[..., :k]


def route(params: dict, x: torch.Tensor, cfg: MoEConfig) -> RouterOut:
    """x: (..., T, d) -> top-k routing decisions.  Leading dims are
    independent rows: each gets its own auxiliary loss, as one call of the
    JAX ``route`` per row would, and ``load`` sums over all of them."""
    logits = x.float() @ params["w"].float()
    probs = torch.softmax(logits, dim=-1)                           # (..., T, E)
    scores = probs + params["bias"][None, :] if cfg.loss_free_bias else probs
    expert_idx = top_k(scores, cfg.top_k)                           # (..., T, K)
    gate = torch.gather(probs, -1, expert_idx)
    weights = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)

    E = cfg.num_experts
    # a comparison, not F.one_hot, which checks its range with a device sync
    onehot = (expert_idx[..., None]
              == torch.arange(E, device=x.device)).float()          # (..., T, K, E)
    load = onehot.reshape(-1, E).sum(0).to(torch.int32)
    f = onehot.sum(-2).mean(-2)                                     # fraction dispatched
    aux = E * torch.sum(f * probs.mean(-2), -1) * (1.0 / max(cfg.top_k, 1))
    return RouterOut(expert_idx.to(torch.int32), weights.to(x.dtype),
                     aux.float(), load)


def bias_step(load: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """DeepSeek loss-free balancing's step: +rate for under-loaded experts'
    bias, -rate for over-loaded ones (the JAX package's ``update_bias`` is
    bias + this).  Runs outside the gradient path."""
    load = load.float()
    err = load.mean() - load                                    # >0 if under-loaded
    return cfg.bias_update_rate * torch.sign(err)
