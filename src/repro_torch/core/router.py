"""Top-k router (Switch auxiliary loss, optional DeepSeek bias).

MemFine does not touch routing; it consumes the router's load statistics.
Router math is fp32 whatever the model's type, and the combine weights are
cast back to the input type, as in the JAX package.

Two scorings (``MoEConfig.scoring``):

* ``softmax`` -- the JAX package's: softmax probabilities (plus the bias,
  where the config balances loss-free) choose the top k; the weights are
  the chosen probabilities renormalised.
* ``sigmoid`` -- DeepSeek-V3's: sigmoid scores plus the correction bias
  choose; with ``n_group`` groups, each group is ranked by the sum of its
  top 2 choice scores and only the top ``topk_group`` groups' experts may
  be chosen; the weights are the chosen raw scores, normalised over the k
  and times ``routed_scaling_factor``.  The auxiliary loss reads the
  normalised affinities s / sum(s) where the softmax path reads the
  probabilities: DeepSeek-V3's sequence-wise balance loss in the per-chunk
  Switch form.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import MoEConfig
from repro_torch.runtime import spans


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


def group_limited(choice: torch.Tensor, n_group: int,
                  topk_group: int) -> torch.Tensor:
    """``choice`` (..., E) with every expert outside each row's top
    ``topk_group`` groups set to -inf: a group ranks by the sum of its two
    largest scores (of its one, for a group of one)."""
    E = choice.shape[-1]
    g = choice.unflatten(-1, (n_group, E // n_group))
    top2 = torch.topk(g, min(2, E // n_group), dim=-1).values.sum(-1)
    keep = torch.zeros_like(top2, dtype=torch.bool).scatter_(
        -1, top_k(top2, topk_group), True)
    return g.masked_fill(~keep[..., None], float("-inf")).flatten(-2)


def _scores(params: dict, x: torch.Tensor, cfg: MoEConfig):
    """(expert_idx, weights, affinities for the aux loss), fp32."""
    logits = x.float() @ params["w"].float()
    if cfg.scoring == "sigmoid":
        s = torch.sigmoid(logits)                                   # (..., T, E)
        choice = s + params["bias"] if cfg.loss_free_bias else s
        if cfg.n_group > 1:
            choice = group_limited(choice, cfg.n_group, cfg.topk_group)
        expert_idx = top_k(choice, cfg.top_k)
        gate = torch.gather(s, -1, expert_idx)
        weights = gate / (gate.sum(-1, keepdim=True) + 1e-20) * cfg.routed_scaling_factor
        return expert_idx, weights, s / s.sum(-1, keepdim=True)
    if cfg.scoring != "softmax":
        raise ValueError(f"unknown router scoring {cfg.scoring!r}")
    probs = torch.softmax(logits, dim=-1)                           # (..., T, E)
    scores = probs + params["bias"][None, :] if cfg.loss_free_bias else probs
    expert_idx = top_k(scores, cfg.top_k)                           # (..., T, K)
    gate = torch.gather(probs, -1, expert_idx)
    weights = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    return expert_idx, weights, probs


def route(params: dict, x: torch.Tensor, cfg: MoEConfig) -> RouterOut:
    """x: (..., T, d) -> top-k routing decisions.  Leading dims are
    independent rows: each gets its own auxiliary loss, as one call of the
    JAX ``route`` per row would, and ``load`` sums over all of them.  Runs
    under the device-timed span ``moe.route``."""
    with spans.span("moe.route", device=True):
        expert_idx, weights, probs = _scores(params, x, cfg)
        E = cfg.num_experts
        # a comparison, not F.one_hot, which checks its range with a device sync
        onehot = (expert_idx[..., None]
                  == torch.arange(E, device=x.device)).float()      # (..., T, K, E)
        load = onehot.reshape(-1, E).sum(0).to(torch.int32)
        f = onehot.sum(-2).mean(-2)                                 # fraction dispatched
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
