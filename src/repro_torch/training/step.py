"""Loss and the train step.

``make_train_step(cfg, ctx, lr=...)`` returns ``step(state, batch)``: the
forward under the FCDA schedule of ``ctx``, the loss (cross-entropy plus the
router's auxiliary loss), the backward, the in-place AdamW update and the
loss-free router-bias update.  PyTorch runs eagerly, so there is no compiled
step to cache: the trainer builds a context per schedule and calls this.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.moe import DistContext
from repro_torch.core.router import update_bias
from repro_torch.models import transformer
from repro_torch.optim.adamw import (AdamWState, adamw_init, adamw_update,
                                     named_params, param_list)


class TrainState(NamedTuple):
    params: dict
    opt: AdamWState
    step: int


def make_train_state(params: dict) -> TrainState:
    """A fresh state around ``params``: every tensor becomes a leaf that
    requires grad, the moments are fp32 zeros."""
    leaves = param_list(params)
    for p in leaves:
        p.requires_grad_(True)
    return TrainState(params=params, opt=adamw_init(leaves), step=0)


def init_train_state(cfg: ModelConfig, dtype=torch.float32, device="cuda",
                     seed: int = 0) -> TrainState:
    params = transformer.init_params(cfg, device=device, dtype=dtype, seed=seed)
    return make_train_state(params)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over valid positions (labels < 0 are masked out)."""
    valid = labels >= 0
    safe = labels.clamp_min(0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    ce = (logz - gold) * valid
    return ce.sum() / valid.sum().clamp_min(1)


def loss_fn(params: dict, cfg: ModelConfig, ctx: DistContext, batch: dict):
    logits, stats = transformer.forward(params, cfg, ctx, batch)
    ce = cross_entropy(logits, batch["labels"])
    aux_coef = cfg.moe.router_aux_coef if cfg.moe else 0.0
    n_moe = max(1, transformer.num_moe_layers(cfg))
    aux = stats["aux_loss"] / n_moe
    loss = ce + aux_coef * aux
    m = {"ce": ce, "aux": aux, "load": stats["load"], "drops": stats["drops"]}
    if "load_per_layer" in stats:
        m["load_per_layer"] = stats["load_per_layer"]
    return loss, m


def make_train_step(cfg: ModelConfig, ctx: DistContext, *, lr=3e-4):
    """Returns step(state, batch) -> (state, metrics); the parameters and
    moments are updated in place."""

    def train_step(state: TrainState, batch: dict):
        leaves = param_list(state.params)
        loss, m = loss_fn(state.params, cfg, ctx, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        lr_val = lr(state.step) if callable(lr) else lr
        opt, om = adamw_update(list(grads), state.opt, leaves, lr=lr_val)
        del grads
        # DeepSeek-style loss-free bias balancing runs outside the gradient
        if cfg.moe is not None and cfg.moe.loss_free_bias:
            _update_router_biases(state.params, m["load"], cfg)
        metrics = {"loss": loss.detach(),
                   **{k: v.detach() for k, v in m.items()},
                   **om, "lr": float(lr_val)}
        return TrainState(state.params, opt, state.step + 1), metrics

    return train_step


@torch.no_grad()
def _update_router_biases(params: dict, load: torch.Tensor, cfg: ModelConfig) -> None:
    """The loss-free bias update on every router bias of the tree, in place
    (the summed global load is the shared signal, as in the JAX package)."""
    for path, leaf in named_params(params):
        if "router" in path and "bias" in path:
            leaf.copy_(update_bias(leaf, load, cfg.moe))
