"""Loss and the train step.

``make_train_step(cfg, ctx, lr=...)`` returns ``step(state, batch)``: the
forward under the FCDA schedule of ``ctx``, the loss (cross-entropy plus the
router's auxiliary loss), the backward, the in-place AdamW update and the
loss-free router-bias update.  PyTorch runs eagerly, so there is no compiled
step to cache: the trainer builds a context per schedule and calls this.

The step is a transaction: the forward, the backward, the gradient
all-reduces, the clipping norm and the router-bias steps write nothing of
the state, and AdamW makes every allocation of its own before its first
write (``optim/adamw.py``).  So an out-of-memory error anywhere in the step
leaves the ``TrainState`` bit for bit as it was, and the OOM ladder
(``runtime/guard.py``) retries from it.

Under a mesh (``ctx.mesh``) each rank backpropagates its share of the one
global loss: its cross-entropy sum over the global count of valid labels,
plus ``aux_coef / n_moe`` times the replicated aux (core/ep.py: the world's
mean, whose backward is the identity).  Then the dense parameters'
gradients (embedding, head, attention, norms, router) are summed over the
whole world and the expert weights' over the data-parallel group only; no
mean is taken anywhere else.  The metrics are global and equal on every
rank, and the gradient norm is the whole model's (``optim/adamw.py``), so
clipping scales every rank alike and the dense weights stay equal.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.moe import DistContext
from repro_torch.core.router import bias_step
from repro_torch.models import transformer
from repro_torch.optim.adamw import (AdamWState, adamw_init, adamw_update,
                                     named_params, param_list)
from repro_torch.runtime import spans


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
                     seed: int = 0, mesh=None) -> TrainState:
    params = transformer.init_params(cfg, device=device, dtype=dtype, seed=seed,
                                     mesh=mesh)
    return make_train_state(params)


def _ce_terms(logits: torch.Tensor, labels: torch.Tensor):
    """(sum of CE over valid positions, count of valid positions)."""
    valid = labels >= 0
    safe = labels.clamp_min(0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    return ((logz - gold) * valid).sum(), valid.sum()


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over valid positions (labels < 0 are masked out)."""
    total, count = _ce_terms(logits, labels)
    return total / count.clamp_min(1)


def loss_fn(params: dict, cfg: ModelConfig, ctx: DistContext, batch: dict):
    """(the loss this rank backpropagates, global metrics).  At one peer the
    loss is the metrics' ``loss``; under a mesh it is this rank's share."""
    logits, stats = transformer.forward(params, cfg, ctx, batch)
    total, count = _ce_terms(logits, batch["labels"])
    mesh = ctx.mesh
    if mesh is not None:
        count = mesh.all_reduce_(count)          # the global count of labels
    ce = total / count.clamp_min(1)
    aux_coef = cfg.moe.router_aux_coef if cfg.moe else 0.0
    n_moe = max(1, transformer.num_moe_layers(cfg))
    aux = stats["aux_loss"] / n_moe
    loss = ce + aux_coef * aux
    m = {"ce": ce, "aux": aux, "load": stats["load"], "drops": stats["drops"],
         "loss": loss}
    if mesh is not None:
        m["ce"] = mesh.all_reduce_(ce.detach().clone())
        m["loss"] = m["ce"] + aux_coef * aux.detach()
    if "load_per_layer" in stats:
        m["load_per_layer"] = stats["load_per_layer"]
    return loss, m


def expert_flags(params: dict, cfg: ModelConfig) -> list:
    """For each tensor of ``param_list(params)``: whether it is an expert
    weight (an MoE layer's w1, w3, w2), which an EP rank holds a slice of."""
    specs = cfg.layer_specs()
    flags = []
    for path, _ in named_params(params):
        parts = path.strip("/").split("/")
        flags.append(len(parts) == 4 and parts[0] == "layers"
                     and specs[int(parts[1])].ffn == "moe" and parts[2] == "ffn"
                     and parts[3] in ("w1", "w3", "w2"))
    return flags


def _reduce_grads(grads: list, flags: list, mesh) -> None:
    """Sum the gradients in place: the dense ones over the world, the
    expert slices over the data-parallel group."""
    for g, expert in zip(grads, flags):
        if g is not None:
            mesh.all_reduce_(g, "dp" if expert else "world")


def make_train_step(cfg: ModelConfig, ctx: DistContext, *, lr=3e-4):
    """Returns step(state, batch) -> (state, metrics); the parameters and
    moments are updated in place."""
    mesh = ctx.mesh

    def train_step(state: TrainState, batch: dict):
        leaves = param_list(state.params)
        with spans.span("train.forward"):
            loss, m = loss_fn(state.params, cfg, ctx, batch)
        with spans.span("train.backward"):
            grads = list(torch.autograd.grad(loss, leaves, allow_unused=True))
        with spans.span("train.optimizer", device=True):
            lr_val = lr(state.step) if callable(lr) else lr
            norm = {}
            if mesh is not None:
                flags = expert_flags(state.params, cfg)
                _reduce_grads(grads, flags, mesh)
                norm = {"sharded": flags,
                        "reduce": lambda t: mesh.all_reduce_(t, "ep")}
            # DeepSeek-style loss-free bias balancing runs outside the
            # gradient; its steps are made here, before AdamW's first write
            bias_steps = (_router_bias_steps(state.params, m["load"], cfg)
                          if cfg.moe is not None and cfg.moe.loss_free_bias else [])
            opt, om = adamw_update(grads, state.opt, leaves, lr=lr_val, **norm)
            del grads
            _apply_bias_steps(bias_steps)
        metrics = {**{k: v.detach() for k, v in m.items()},
                   **om, "lr": float(lr_val)}
        return TrainState(state.params, opt, state.step + 1), metrics

    return train_step


@torch.no_grad()
def _router_bias_steps(params: dict, load: torch.Tensor, cfg: ModelConfig) -> list:
    """(router bias, its loss-free step) for every router bias of the tree
    (the summed global load is the shared signal, as in the JAX package)."""
    step = bias_step(load, cfg.moe)
    return [(leaf, step) for path, leaf in named_params(params)
            if "router" in path and "bias" in path]


@torch.no_grad()
def _apply_bias_steps(bias_steps: list) -> None:
    """bias + step in place (the JAX package's ``update_bias``), on the
    bias AdamW has just updated."""
    for leaf, step in bias_steps:
        leaf.add_(step)
