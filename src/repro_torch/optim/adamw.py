"""AdamW with global-norm gradient clipping, in place.

The same update as the JAX package's ``optim/adamw.py``: the gradients
clipped to a global norm, fp32 moments whatever the parameters' type, bias
correction, decoupled weight decay.  The JAX version maps over the whole
tree at once and writes new arrays; at full width that would add an fp32
copy of every gradient plus new moment tensors (about 38 GB for two
Mixtral-8x7B layers), so this one updates the moments and the parameters in
place, one tensor at a time, through two fp32 working slices.  On the card
the kernels of ``kernels/adamw_cuda.py`` do the same arithmetic in one pass
over each element (``csrc/adamw.cu``), with no working slices; the sliced
loop stays the CPU's path and the kernels' oracle.

The update is the second half of the train step's transaction
(``training/step.py``): every allocation it makes (contiguous copies of
the gradients, the norm, the clipping scale and, on the plain path, the
bias corrections on each device and the working slices) comes before its
first write, so an out-of-memory error leaves the parameters and moments
as they were, and the OOM ladder (``runtime/guard.py``) can retry the step.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.runtime import spans


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


#: the update runs each tensor through two fp32 working slices of at most
#: this many elements (256 MB each), made before its first write; the old
#: per-tensor temporaries, four fp32 copies of the largest weight (7.5 GB
#: for one Mixtral-8x7B layer's w1), set the training run's peak
_SLICE_ELEMS = 1 << 26


def _workspace(n: int, device) -> torch.Tensor:
    """The update's two fp32 working slices of ``n`` elements: the last
    allocation before its first write."""
    return torch.empty((2, n), dtype=torch.float32, device=device)


def bias_corrections(b1: float, b2: float, step: int) -> tuple:
    """1 - b1**step and 1 - b2**step, as 0-d fp32 tensors on the CPU."""
    f32 = torch.float32
    return 1 - torch.tensor(b1, dtype=f32) ** step, 1 - torch.tensor(b2, dtype=f32) ** step


@torch.no_grad()
def apply_update(grads: list, mu: list, nu: list, params: list, scale: torch.Tensor,
                 bc1: torch.Tensor, bc2: torch.Tensor, *, lr: float, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8, weight_decay: float = 0.1) -> None:
    """The plain update, given the clipping ``scale`` and the bias
    corrections ``bc1``, ``bc2`` (0-d fp32 tensors): ``params``, ``mu`` and
    ``nu`` in place, slice by slice, through two fp32 working slices made
    before the first write.  It runs on any device; ``adamw_update`` gives
    it the CPU's tensors, and on the card it is the kernel's oracle."""
    for p in params:
        if not p.is_contiguous():
            raise ValueError("adamw_update updates contiguous parameters in place")
    grads = [g if g is None or g.is_contiguous() else g.contiguous() for g in grads]
    devices = {p.device for p in params}
    consts = {d: (scale.to(d), bc1.to(d), bc2.to(d)) for d in devices}
    n = min(_SLICE_ELEMS, max((p.numel() for p in params), default=1))
    work = {d: _workspace(n, d) for d in devices}
    # -- the first write: from here to the return nothing is allocated
    for p, g, m, v in zip(params, grads, mu, nu):
        s, c1, c2 = consts[p.device]
        buf_a, buf_b = work[p.device]
        pv, mv, vv = p.view(-1), m.view(-1), v.view(-1)
        gv = None if g is None else g.view(-1)
        for i in range(0, p.numel(), n):
            j = min(i + n, p.numel())
            a, b = buf_a[:j - i], buf_b[:j - i]
            if gv is None:
                a.zero_()
            else:
                a.copy_(gv[i:j]).mul_(s)                 # gf = g * scale
            mv[i:j].mul_(b1).add_(a, alpha=1 - b1)
            vv[i:j].mul_(b2).addcmul_(a, a, value=1 - b2)
            torch.div(vv[i:j], c2, out=b).sqrt_().add_(eps)
            torch.div(mv[i:j], c1, out=a).div_(b)        # u = m^ / (sqrt(v^) + eps)
            b.copy_(pv[i:j])                             # pf
            a.add_(b, alpha=weight_decay)
            pv[i:j].copy_(b.add_(a, alpha=-lr))


def _card(tensors) -> Optional[torch.device]:
    """The first CUDA device among ``tensors``, or None."""
    return next((t.device for t in tensors if t is not None and t.is_cuda), None)


def _card_norm(grads, sharded, reduce, device) -> torch.Tensor:
    """``global_norm`` by the kernels of ``kernels/adamw_cuda.py``: the
    squares summed on the device in one pass over each gradient, the
    sharded part summed over the EP group between the two kernels."""
    from repro_torch.kernels import adamw_cuda
    total, split = adamw_cuda.sumsq(grads, sharded, device=device)
    if reduce is not None:
        split = reduce(split)
    return torch.sqrt(total + split)


@torch.no_grad()
def adamw_update(grads: list, state: AdamWState, params: list, *, lr: float,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, clip_norm: float = 1.0,
                 sharded=None, reduce=None):
    """Update ``params`` and the moments in place; returns (state, metrics).
    A gradient of None is a zero gradient (weight decay still applies).
    ``sharded`` and ``reduce`` make the clipping norm the whole model's
    across EP ranks (``global_norm``).  Nothing is written until every
    allocation has succeeded; from the first write to the return nothing is
    allocated.  On the CPU the update is ``apply_update``, the JAX
    package's per-element arithmetic and rounding points, slice by slice;
    CUDA tensors go to the kernels of ``kernels/adamw_cuda.py`` (the same
    operations, each element read and written once), or raise."""
    card = _card([*params, *grads])
    if card is not None:
        grads = [g if g is None or g.is_contiguous() else g.contiguous() for g in grads]
    gnorm = (_card_norm(grads, sharded, reduce, card) if card is not None
             else global_norm(grads, sharded, reduce))
    scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = state.step + 1
    bc1, bc2 = bias_corrections(b1, b2, step)
    hyper = dict(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)
    if card is not None:
        from repro_torch.kernels import adamw_cuda
        adamw_cuda.adamw_step(grads, state.mu, state.nu, params, scale, bc1.item(),
                              bc2.item(), **hyper)
    else:
        apply_update(grads, state.mu, state.nu, params, scale, bc1, bc2, **hyper)
    spans.count("adamw.elems", sum(p.numel() for p in params))
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
