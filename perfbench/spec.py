"""Model shapes as the benchmark reads them.

A configuration file (``configs/<name>.json``) states the published keys of
the model's own ``config.json`` as the cell runs them, and a ``port`` block
naming the program's registry entry and the depth it is cut to.  ``spec``
turns either side into one plain dict of shapes, so that the harness can
hold the program's configuration against the file before it builds
anything, and so that the weights, the references and the work counts all
read the same numbers.

The plain dict (``spec``) has these keys: ``d_model``, ``n_heads``,
``n_kv_heads``, ``head_dim``, ``vocab`` (the embedding's rows, padded to a
multiple of 256), ``vocab_size`` (the label space), ``n_experts``,
``top_k``, ``d_ff_expert``, ``aux_coef``, ``rope_theta``, ``eps``,
``window`` (0 = full causal) and ``layers``, one {"mixer": "attn", "ffn":
"moe"} per layer: the stack of attention and MoE layers that every
configuration here has.  A configuration with other layers brings its
keys with it.
"""

from __future__ import annotations

import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load_config_file(name: str, root: Path = HERE) -> dict:
    """The configuration file ``configs/<name>.json``."""
    return json.loads((root / "configs" / f"{name}.json").read_text())


def _pad256(v: int) -> int:
    return -(-v // 256) * 256


def spec_from_file(cfg: dict) -> dict:
    """The shapes a configuration file states, as run."""
    n_heads = int(cfg["num_attention_heads"])
    d = int(cfg["hidden_size"])
    return {
        "d_model": d, "n_heads": n_heads,
        "n_kv_heads": int(cfg["num_key_value_heads"]),
        "head_dim": int(cfg.get("head_dim") or d // n_heads),
        "vocab": _pad256(int(cfg["vocab_size"])), "vocab_size": int(cfg["vocab_size"]),
        "n_experts": int(cfg["num_local_experts"]), "top_k": int(cfg["num_experts_per_tok"]),
        "d_ff_expert": int(cfg["intermediate_size"]),
        "aux_coef": float(cfg["router_aux_loss_coef"]),
        "rope_theta": float(cfg["rope_theta"]),
        "eps": float(cfg["rms_norm_eps"]),
        "window": int(cfg.get("sliding_window") or 0),
        "layers": [{"mixer": "attn", "ffn": "moe"}] * int(cfg["num_hidden_layers"]),
    }


def spec_from_port(pcfg) -> dict:
    """The same dict from one of the program's ``ModelConfig`` objects."""
    specs = pcfg.layer_specs()
    attn = next((s.attn for s in specs if s.mixer == "attn"), None)
    moe = pcfg.moe
    return {
        "d_model": pcfg.d_model, "n_heads": pcfg.num_heads,
        "n_kv_heads": pcfg.num_kv_heads, "head_dim": pcfg.resolved_head_dim,
        "vocab": pcfg.padded_vocab, "vocab_size": pcfg.vocab_size,
        "n_experts": moe.num_experts if moe else 0, "top_k": moe.top_k if moe else 0,
        "d_ff_expert": moe.d_ff_expert if moe else 0,
        "aux_coef": moe.router_aux_coef if moe else 0.0,
        "rope_theta": pcfg.rope_theta if attn is not None and attn.rope else 0.0,
        "eps": 1e-6,                       # models/layers.py::apply_norm
        "window": attn.window if attn is not None and attn.kind == "window" else 0,
        "layers": [{"mixer": s.mixer, "ffn": s.ffn} for s in specs],
    }


def mismatches(a: dict, b: dict) -> list:
    """The keys on which two shape dicts differ."""
    return [k for k in sorted(set(a) | set(b)) if a.get(k) != b.get(k)]
