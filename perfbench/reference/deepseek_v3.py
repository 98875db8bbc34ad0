"""Plain fp32 reference of DeepSeek-V3's training step on one chip of a
32-way expert-parallel group: the loss, its gradients, the AdamW update and
the loss-free bias step, for a stack of MLA + FFN layers (arXiv:2412.19437
and ``modeling_deepseek.py`` of the published checkpoint).

* MLA: q = wq_b(RMSNorm(x wq_a)); x wkv_a gives the key/value latent and
  the one RoPE key part the heads share; wkv_b(RMSNorm(latent)) gives each
  head's non-RoPE key part and value.  RoPE at YaRN's frequencies
  (rotate-half on the columns as stored), softmax scale
  (qk_nope + qk_rope)^-0.5 x (0.1 ln(factor) + 1)^2.
* The leading layers' dense SwiGLU FFN; then MoE layers: sigmoid scores s,
  the choice score s + bias (no gradient), groups ranked by the sum of
  their top 2 choice scores, the top ``topk_group`` groups' experts
  eligible, the top k of those chosen; weights the chosen s normalised over
  the k and scaled by ``routed_scaling``.  The chip's share: only the
  experts [0, held) it holds are computed, each token's weights being
  those normalised over all k; the shared expert runs on every token.
* The loss: the mean next-token cross-entropy over every position, plus
  ``aux_coef`` times the balance loss averaged over the MoE layers.  A
  layer's balance loss is the Switch form over each FCDA chunk of the
  step's flattened tokens (``chunks``: the schedule the step ran under),
  averaged over the chunks, with the normalised affinities s / sum(s)
  where Switch has probabilities; its token fractions carry no gradient.
* After AdamW, every router bias moves by ``bias_rate`` times the sign of
  (the mean load - each expert's load), the load summed over the MoE layers
  and the step's tokens.

The step runs one sequence at a time and recomputes each layer in the
backward (``torch.utils.checkpoint``), so that one layer's 128-head scores
are held at a time beside the fp32 weights, gradients and moments; the
gradients are summed over the sequences.  Where a chunk spans several
sequences, a first pass without gradients counts each chunk's routing.

Nothing here imports the program.  The weights are the benchmark's
(``perfbench/weights.py``), upcast to fp32.  The optimizer is Mixtral's
reference's, the same AdamW the program runs.
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from perfbench.reference.common import Prec, causal_attention, no_tf32, rmsnorm, swiglu
from perfbench.reference.mixtral import ADAMW, adamw  # noqa: F401  (ADAMW: read by drivers/train.py)


def _yarn_mscale(factor: float, mscale: float) -> float:
    return 0.1 * mscale * math.log(factor) + 1.0 if factor > 1 else 1.0


def yarn_inv_freq(dim: int, theta: float, y: dict, device=None) -> torch.Tensor:
    """DeepSeek-V3's ``DeepseekV3YarnRotaryEmbedding`` frequencies: the
    interpolated ones (divided by ``factor``) below the correction range of
    ``beta_slow`` rotations over the original context, the original ones
    above that of ``beta_fast``, a linear ramp between."""
    def correction_dim(rot):
        return (dim * math.log(y["original_max_position"] / (rot * 2 * math.pi))
                / (2 * math.log(theta)))

    low = max(math.floor(correction_dim(y["beta_fast"])), 0)
    high = min(math.ceil(correction_dim(y["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    idx = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    extra = 1.0 / theta ** idx
    inter = 1.0 / (y["factor"] * theta ** idx)
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device) - low)
            / (high - low)).clamp(0, 1)
    keep = 1.0 - ramp
    return inter * (1 - keep) + extra * keep


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate-half RoPE. x: (S, H, r); cos, sin: (S, 1, r/2)."""
    a, b = x[..., : x.shape[-1] // 2], x[..., x.shape[-1] // 2:]
    return torch.cat([a * cos - b * sin, a * sin + b * cos], dim=-1)


def rope_tables(spec: dict, S: int, device):
    """(cos, sin) of positions 0..S-1 at YaRN's frequencies, times YaRN's
    mscale ratio."""
    y = spec["yarn"]
    inv = yarn_inv_freq(spec["qk_rope"], spec["rope_theta"], y, device)
    ang = torch.arange(S, device=device).float()[:, None] * inv
    ratio = _yarn_mscale(y["factor"], y["mscale"]) / _yarn_mscale(y["factor"], y["mscale_all_dim"])
    return (torch.cos(ang) * ratio)[:, None], (torch.sin(ang) * ratio)[:, None]


def softmax_scale(spec: dict) -> float:
    y = spec["yarn"]
    m = _yarn_mscale(y["factor"], y["mscale_all_dim"]) if y["mscale_all_dim"] else 1.0
    return (spec["qk_nope"] + spec["qk_rope"]) ** -0.5 * m * m


def mla(x: torch.Tensor, m: dict, spec: dict, prec: Prec, tables) -> torch.Tensor:
    """The attention mixer of one sequence: x (S, d) fp32 -> (S, H * v_head),
    before the output projection."""
    S, H = x.shape[0], spec["n_heads"]
    nope, rope, dv, kvr = spec["qk_nope"], spec["qk_rope"], spec["v_head"], spec["kv_lora_rank"]
    q = prec.mm(rmsnorm(prec.mm(x, m["wq_a"]), m["q_a_norm"]["scale"], spec["eps"]), m["wq_b"])
    q = q.view(S, H, nope + rope)
    kv_a = prec.mm(x, m["wkv_a"])
    kv = prec.mm(rmsnorm(kv_a[:, :kvr], m["kv_a_norm"]["scale"], spec["eps"]), m["wkv_b"])
    kv = kv.view(S, H, nope + dv)
    cos, sin = tables
    k_pe = _rope(kv_a[:, kvr:].reshape(S, 1, rope), cos, sin)
    q = torch.cat([q[..., :nope], _rope(q[..., nope:], cos, sin)], dim=-1)
    k = torch.cat([kv[..., :nope], k_pe.expand(S, H, rope)], dim=-1)
    # causal_attention scales by (nope + rope)^-0.5: YaRN's temperature
    # goes on the queries
    q = q * (softmax_scale(spec) * (nope + rope) ** 0.5)
    return causal_attention(q, k, kv[..., nope:], prec).reshape(S, H * dv)


def route(x: torch.Tensor, router: dict, spec: dict, prec: Prec):
    """(chosen (T, k), weights (T, k), affinities s / sum(s) (T, E))."""
    s = torch.sigmoid(prec.mm(x, router["w"]))
    choice = (s + router["bias"]).detach()
    E, G = s.shape[-1], spec["n_group"]
    if G > 1:
        g = choice.view(-1, G, E // G)
        top2 = torch.sort(g, dim=-1, descending=True).values[..., :min(2, E // G)].sum(-1)
        keep_g = torch.sort(top2, dim=-1, descending=True, stable=True).indices[:, :spec["topk_group"]]
        mask = torch.zeros_like(top2, dtype=torch.bool).scatter_(-1, keep_g, True)
        choice = g.masked_fill(~mask[..., None], float("-inf")).view(-1, E)
    chosen = torch.sort(choice, dim=-1, descending=True, stable=True).indices[:, :spec["top_k"]]
    gate = torch.gather(s, -1, chosen)
    weights = gate / (gate.sum(-1, keepdim=True) + 1e-20) * spec["routed_scaling"]
    return chosen, weights, s / s.sum(-1, keepdim=True)


def moe(x: torch.Tensor, ffn: dict, spec: dict, prec: Prec):
    """The chip's part of one MoE layer: (y, affinities, chosen).  Each
    held expert's weights are cast to fp32 when it runs."""
    chosen, weights, aff = route(x, ffn["router"], spec, prec)
    y = swiglu(x, ffn["shared"]["w1"], ffn["shared"]["w3"], ffn["shared"]["w2"], prec)
    for e in range(spec["experts_held"]):
        tok, slot = torch.nonzero(chosen == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        h = swiglu(x[tok], ffn["w1"][e], ffn["w3"][e], ffn["w2"][e], prec)
        y = y.index_add(0, tok, h * weights[tok, slot][:, None])
    return y, aff, chosen


def _layer(x, lp, dense, spec, prec, tables):
    h = rmsnorm(x, lp["norm1"]["scale"], spec["eps"])
    x = x + prec.mm(mla(h, lp["mixer"], spec, prec, tables), lp["mixer"]["wo"])
    h = rmsnorm(x, lp["norm2"]["scale"], spec["eps"])
    if dense:
        f = lp["ffn"]
        return x + swiglu(h, f["w1"], f["w3"], f["w2"], prec), None, None
    y, aff, chosen = moe(h, lp["ffn"], spec, prec)
    return x + y, aff, chosen


def _row(params, tokens, spec, prec, remat: bool):
    """Forward of one sequence: (logits (S, V), [(affinities, chosen)] per
    MoE layer); with ``remat`` each layer is recomputed in the backward."""
    x = params["embed"][tokens].float()
    tables = rope_tables(spec, tokens.shape[0], tokens.device)
    routed = []
    for lp, lay in zip(params["layers"], spec["layers"]):
        dense = lay["ffn"] == "dense"
        if remat:
            x, aff, chosen = checkpoint(_layer, x, lp, dense, spec, prec, tables,
                                        use_reentrant=False)
        else:
            x, aff, chosen = _layer(x, lp, dense, spec, prec, tables)
        if not dense:
            routed.append((aff, chosen))
    x = rmsnorm(x, params["final_norm"]["scale"], spec["eps"])
    return prec.mm(x, params["head"]), routed


def _fractions(chosen: torch.Tensor, E: int, tc: int) -> torch.Tensor:
    """(n_chunks, E): the share of each chunk's tokens that chose each
    expert, for tokens laid out in whole chunks of ``tc``."""
    one = (chosen[..., None] == torch.arange(E, device=chosen.device)).float().sum(-2)
    return one.view(-1, tc, E).mean(1)


def loss_and_grads(params: dict, leaves: list, batch: dict, spec: dict,
                   chunks: int, prec: Prec, rows=None):
    """(loss, ce, aux, grads, load) of one step; ``load`` is the (E,) count
    of slots routed to each expert, summed over the MoE layers.  ``rows``:
    the batch rows taken (default all); the loss is the mean over the
    positions of those rows."""
    tokens, labels = batch["tokens"], batch["labels"]
    if rows is not None:
        tokens, labels = tokens[rows], labels[rows]
    B, S = tokens.shape
    T = B * S
    tc = T // chunks
    E, k = spec["n_experts"], spec["top_k"]
    n_moe = sum(1 for lay in spec["layers"] if lay["ffn"] == "moe")
    unit = E / k / tc / chunks / n_moe      # one token's share of aux
    counts = None
    if tc > S:                      # a chunk spans sequences: count first
        with torch.no_grad():
            per_layer = [[] for _ in range(n_moe)]
            for b in range(B):
                _, routed = _row(params, tokens[b], spec, prec, remat=False)
                for j, (_, chosen) in enumerate(routed):
                    per_layer[j].append(chosen)
                del routed
            counts = [_fractions(torch.cat(c), E, tc) for c in per_layer]
    for p in leaves:
        p.grad = None
    ce_val = aux_val = 0.0
    load = torch.zeros(E, dtype=torch.float32, device=tokens.device)
    for b in range(B):
        logits, routed = _row(params, tokens[b], spec, prec, remat=True)
        ce = (torch.logsumexp(logits, -1)
              - logits.gather(-1, labels[b].long()[:, None])[:, 0]).sum()
        aux = logits.new_zeros(())
        for j, (aff, chosen) in enumerate(routed):
            if counts is None:
                f = _fractions(chosen, E, tc).repeat_interleave(tc, 0)
            else:
                f = counts[j][(b * S + torch.arange(S, device=aff.device)) // tc]
            aux = aux + (f * aff).sum()
            load += (chosen[..., None] == torch.arange(E, device=chosen.device)).float().sum((0, 1))
        row_loss = ce / T + spec["aux_coef"] * unit * aux
        row_loss.backward()            # summed into each leaf's .grad in place
        ce_val += float(ce.detach()) / T
        aux_val += float(aux.detach()) * unit
        del logits, routed, ce, aux, row_loss
    grads = [p.grad for p in leaves]
    for p in leaves:
        p.grad = None
    return ce_val + spec["aux_coef"] * aux_val, ce_val, aux_val, grads, load


def train(params: dict, batches: list, spec: dict, chunks: list, lr: float,
          prec: Prec, rows=None, sample=None) -> dict:
    """``len(batches)`` steps from ``params`` (fp32 leaves, updated in
    place), step i under ``chunks[i]``.  Returns {"loss", "ce", "gnorm": per
    step; "grad_norms": the per-leaf norm of the first step's gradient,
    before clipping; "grad_sample": ``sample(grads)`` of that gradient,
    when given}; the caller reads the parameters' change itself.  fp32
    products run in fp32 (TF32 off)."""
    from perfbench.weights import flat
    no_tf32()
    leaves = flat(params)
    for p in leaves:
        p.requires_grad_(True)
    biases = [lp["ffn"]["router"]["bias"] for lp, lay in zip(params["layers"], spec["layers"])
              if lay["ffn"] == "moe"]
    mu = [torch.zeros_like(p) for p in leaves]
    nu = [torch.zeros_like(p) for p in leaves]
    out = {"loss": [], "ce": [], "grad_norms": None, "gnorm": []}
    for i, batch in enumerate(batches):
        loss, ce, _, grads, load = loss_and_grads(params, leaves, batch, spec, chunks[i],
                                                  prec, rows=rows)
        if out["grad_norms"] is None:
            out["grad_norms"] = [0.0 if g is None else float(g.norm())
                                 for g in grads]
            if sample is not None:
                out["grad_sample"] = sample(grads)
        out["loss"].append(loss)
        out["ce"].append(ce)
        out["gnorm"].append(adamw(leaves, grads, mu, nu, i + 1, lr))
        with torch.no_grad():
            step = spec["bias_rate"] * torch.sign(load.mean() - load)
            for bias in biases:
                bias.add_(step)
        del grads
    del mu, nu
    for p in leaves:
        p.requires_grad_(False)
    return out
