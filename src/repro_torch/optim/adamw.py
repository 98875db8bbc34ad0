"""AdamW with global-norm gradient clipping, in place.

The same update as the JAX package's ``optim/adamw.py``: the gradients
clipped to a global norm, fp32 moments whatever the parameters' type, bias
correction, decoupled weight decay.  The JAX version maps over the whole
tree at once and writes new arrays; at full width that would add an fp32
copy of every gradient plus new moment tensors (about 38 GB for two
Mixtral-8x7B layers), so this one updates the moments and the parameters in
place, one tensor at a time, with one tensor's fp32 temporaries live.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class AdamWState(NamedTuple):
    step: int
    mu: list              # fp32 first moments, one per parameter
    nu: list              # fp32 second moments


def adamw_init(params: list) -> AdamWState:
    """Zero fp32 moments for a list of parameter tensors."""
    zeros = lambda: [torch.zeros_like(p, dtype=torch.float32) for p in params]  # noqa: E731
    return AdamWState(step=0, mu=zeros(), nu=zeros())


def global_norm(tensors, sharded=None, reduce=None) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor, in fp32 (a 0-d tensor on
    the tensors' device; a missing gradient counts as zeros).

    Across EP ranks (``sharded`` flags the tensors each rank holds a slice
    of, ``reduce`` sums a 0-d tensor over the EP group) the norm is the
    whole model's: the replicated tensors' squares once, plus the slices'
    squares summed over the group."""
    if sharded is None:
        sharded = [False] * len(tensors)
    total, split = None, None
    for t, part in zip(tensors, sharded):
        if t is None:
            continue
        sq = t.float().square().sum()
        if part:
            split = sq if split is None else split + sq
        else:
            total = sq if total is None else total + sq
    if reduce is not None:
        split = reduce(split if split is not None
                       else torch.zeros((), device=total.device))
    if split is not None:
        total = split if total is None else total + split
    return torch.sqrt(total) if total is not None else torch.zeros(())


@torch.no_grad()
def adamw_update(grads: list, state: AdamWState, params: list, *, lr: float,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, clip_norm: float = 1.0,
                 sharded=None, reduce=None):
    """Update ``params`` and the moments in place; returns (state, metrics).
    A gradient of None is a zero gradient (weight decay still applies).
    ``sharded`` and ``reduce`` make the clipping norm the whole model's
    across EP ranks (``global_norm``)."""
    gnorm = global_norm(grads, sharded, reduce)
    scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = state.step + 1
    f32 = torch.float32
    bc1 = 1 - torch.tensor(b1, dtype=f32) ** step
    bc2 = 1 - torch.tensor(b2, dtype=f32) ** step
    for p, g, m, v in zip(params, grads, state.mu, state.nu):
        gf = (torch.zeros_like(m) if g is None
              else g.to(f32) * scale.to(g.device))
        m.mul_(b1).add_(gf, alpha=1 - b1)
        v.mul_(b2).addcmul_(gf, gf, value=1 - b2)
        del gf
        u = (v / bc2.to(v.device)).sqrt_().add_(eps)
        u = (m / bc1.to(m.device)).div_(u)
        pf = p.to(f32)
        u.add_(pf, alpha=weight_decay)
        p.copy_(pf.add_(u, alpha=-lr))
    return AdamWState(step, state.mu, state.nu), {"grad_norm": gnorm}


def param_list(tree) -> list:
    """The tensors of a nested dict/list parameter tree, in a fixed order."""
    if isinstance(tree, dict):
        return [t for k in tree for t in param_list(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in param_list(v)]
    return [tree]


def named_params(tree, prefix: Optional[str] = "") -> list:
    """(path, tensor) pairs of a parameter tree, in ``param_list`` order."""
    if isinstance(tree, dict):
        return [nt for k in tree for nt in named_params(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [nt for i, v in enumerate(tree) for nt in named_params(v, f"{prefix}/{i}")]
    return [(prefix, tree)]
