"""Plain fp32 reference of Mixtral's training step: the loss, its gradients
and the AdamW update, for a stack of attention + FFN layers (Mixtral's
GQA attention with RoPE (banded when ``window`` is set), a top-k softmax router over SwiGLU
experts, RMSNorm, an untied LM head).

It follows the published architecture (arXiv:2401.04088) and the loss the
program trains on: the mean next-token cross-entropy over every position
of the batch, plus ``aux_coef`` times the Switch load-balancing loss,
averaged over the MoE layers.  The balancing loss of a layer is taken per
FCDA chunk of the step's flattened tokens and averaged over the chunks
(``chunks``, the schedule the step ran under: the loss the program
defines depends on it).  Its token fractions carry no gradient.

The step runs one sequence at a time, so that the full widths fit beside
the fp32 weights, gradients and moments; the gradients are summed over the
sequences.  Where a chunk spans several sequences, a first pass without
gradients counts each chunk's routing.

Nothing here imports the program.  The weights are the benchmark's
(``perfbench/weights.py``), upcast to fp32.
"""

from __future__ import annotations

import torch

from perfbench.reference.common import Prec, causal_attention, moe, rmsnorm, rope

ADAMW = {"b1": 0.9, "b2": 0.95, "eps": 1e-8, "weight_decay": 0.1, "clip_norm": 1.0}


def _layer(x, lp, spec, prec, pos):
    S = x.shape[0]
    H, KH, hd = spec["n_heads"], spec["n_kv_heads"], spec["head_dim"]
    h = rmsnorm(x, lp["norm1"]["scale"], spec["eps"])
    m = lp["mixer"]
    q = prec.mm(h, m["wq"]).view(S, H, hd)
    k = prec.mm(h, m["wk"]).view(S, KH, hd)
    v = prec.mm(h, m["wv"]).view(S, KH, hd)
    q, k = rope(q, pos, spec["rope_theta"]), rope(k, pos, spec["rope_theta"])
    a = causal_attention(q, k, v, prec, window=spec["window"])
    x = x + prec.mm(a.reshape(S, H * hd), m["wo"])
    h = rmsnorm(x, lp["norm2"]["scale"], spec["eps"])
    y, probs, chosen = moe(h, lp["ffn"], spec["top_k"], prec)
    return x + y, probs, chosen


def _row(params, tokens, spec, prec):
    """Forward of one sequence: (logits (S, V), [(probs, chosen)] per MoE layer)."""
    pos = torch.arange(tokens.shape[0], device=tokens.device)
    x = params["embed"][tokens].float()
    routed = []
    for lp in params["layers"]:
        x, probs, chosen = _layer(x, lp, spec, prec, pos)
        routed.append((probs, chosen))
    x = rmsnorm(x, params["final_norm"]["scale"], spec["eps"])
    return prec.mm(x, params["head"]), routed


def _fractions(chosen: torch.Tensor, E: int, tc: int) -> torch.Tensor:
    """(n_chunks, E): the share of each chunk's tokens that chose each
    expert, for tokens laid out in whole chunks of ``tc``."""
    one = (chosen[..., None] == torch.arange(E, device=chosen.device)).float().sum(-2)
    return one.view(-1, tc, E).mean(1)


def loss_and_grads(params: dict, leaves: list, batch: dict, spec: dict,
                   chunks: int, prec: Prec, rows=None):
    """(loss, ce, aux, grads) of one step.  ``rows``: the batch rows taken
    (default all); the loss is the mean over the positions of those rows."""
    tokens, labels = batch["tokens"], batch["labels"]
    if rows is not None:
        tokens, labels = tokens[rows], labels[rows]
    B, S = tokens.shape
    T = B * S
    tc = T // chunks
    E, k = spec["n_experts"], spec["top_k"]
    n_moe = len(spec["layers"])
    unit = E / k / tc / chunks / n_moe      # one token's share of aux
    counts = None
    if tc > S:                      # a chunk spans sequences: count first
        with torch.no_grad():
            per_layer = [[] for _ in range(n_moe)]
            for b in range(B):
                _, routed = _row(params, tokens[b], spec, prec)
                for j, (_, chosen) in enumerate(routed):
                    per_layer[j].append(chosen)
            counts = [_fractions(torch.cat(c), E, tc) for c in per_layer]
    for p in leaves:
        p.grad = None
    ce_val = aux_val = 0.0
    for b in range(B):
        logits, routed = _row(params, tokens[b], spec, prec)
        ce = (torch.logsumexp(logits, -1)
              - logits.gather(-1, labels[b].long()[:, None])[:, 0]).sum()
        aux = logits.new_zeros(())
        for j, (probs, chosen) in enumerate(routed):
            if counts is None:
                f = _fractions(chosen, E, tc).repeat_interleave(tc, 0)
            else:
                f = counts[j][(b * S + torch.arange(S, device=probs.device)) // tc]
            aux = aux + (f * probs).sum()
        row_loss = ce / T + spec["aux_coef"] * unit * aux
        row_loss.backward()            # summed into each leaf's .grad in place
        ce_val += float(ce.detach()) / T
        aux_val += float(aux.detach()) * unit
        del logits, routed, ce, aux, row_loss
    grads = [p.grad for p in leaves]
    for p in leaves:
        p.grad = None
    return ce_val + spec["aux_coef"] * aux_val, ce_val, aux_val, grads


@torch.no_grad()
def adamw(leaves: list, grads: list, mu: list, nu: list, step: int, lr: float) -> float:
    """One AdamW step with global-norm clipping, in place; returns the
    gradients' global norm before clipping."""
    c = ADAMW
    sq = sum(float(g.double().pow(2).sum()) for g in grads if g is not None)
    gnorm = sq ** 0.5
    scale = min(1.0, c["clip_norm"] / max(gnorm, 1e-9))
    bc1, bc2 = 1 - c["b1"] ** step, 1 - c["b2"] ** step
    for p, g, m, v in zip(leaves, grads, mu, nu):
        gs = torch.zeros_like(p) if g is None else g * scale
        m.mul_(c["b1"]).add_(gs, alpha=1 - c["b1"])
        v.mul_(c["b2"]).addcmul_(gs, gs, value=1 - c["b2"])
        u = (m / bc1) / ((v / bc2).sqrt() + c["eps"])
        p.sub_(lr * (u + c["weight_decay"] * p))
    return gnorm


def train(params: dict, batches: list, spec: dict, chunks: list, lr: float,
          prec: Prec, rows=None, sample=None) -> dict:
    """``len(batches)`` steps from ``params`` (fp32 leaves, updated in
    place), step i under ``chunks[i]``.  Returns {"loss", "ce", "gnorm": per
    step; "grad_norms": the per-leaf norm of the first step's gradient,
    before clipping; "grad_sample": ``sample(grads)`` of that gradient,
    when given}; the caller reads the parameters' change itself."""
    from perfbench.weights import flat
    leaves = flat(params)
    for p in leaves:
        p.requires_grad_(True)
    mu = [torch.zeros_like(p) for p in leaves]
    nu = [torch.zeros_like(p) for p in leaves]
    out = {"loss": [], "ce": [], "grad_norms": None, "gnorm": []}
    for i, batch in enumerate(batches):
        loss, ce, _, grads = loss_and_grads(params, leaves, batch, spec, chunks[i],
                                            prec, rows=rows)
        if out["grad_norms"] is None:
            out["grad_norms"] = [0.0 if g is None else float(g.norm())
                                 for g in grads]
            if sample is not None:
                out["grad_sample"] = sample(grads)
        out["loss"].append(loss)
        out["ce"].append(ce)
        out["gnorm"].append(adamw(leaves, grads, mu, nu, i + 1, lr))
        del grads
    del mu, nu
    for p in leaves:
        p.requires_grad_(False)
    return out

