"""Carry the JAX package's parameter and cache trees into the port.

The JAX package keeps layers in three places: an unrolled prefix
(``pre``), the scanned periods (``periods``: one entry per pattern position,
each leaf stacked over periods on a leading axis, or None) and the
remainder (``rem``), and an encoder's layers stacked on a leading axis.
The port keeps one list in layer order for each.  The trees
arrive as numpy arrays (``jax.tree.map(np.asarray, tree)``), so this module
needs no JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def layers_in_order(tree: dict, cfg: ModelConfig) -> list:
    """The per-layer subtrees of a JAX params or cache tree, in layer order
    (prefix, periods period-major, remainder)."""
    out = list(tree.get("pre") or [])
    periods = tree.get("periods")
    if periods is not None:
        for p in range(cfg.num_periods):
            out += [_tree_map(lambda a, p=p: a[p], periods[i])
                    for i in range(len(cfg.pattern))]
    out += list(tree.get("rem") or [])
    if len(out) != cfg.num_layers:
        raise ValueError(f"tree holds {len(out)} layers, {cfg.name!r} has "
                         f"{cfg.num_layers}")
    return out


def _to_torch(device):
    return lambda a: torch.from_numpy(np.array(a)).to(device)


def params_from_jax(np_tree: dict, cfg: ModelConfig, device, mesh=None) -> dict:
    """The JAX package's ``init_params`` tree (as numpy) -> the port's params.
    Under a mesh (``launch/mesh.py``) each MoE layer's expert weights are cut
    to this rank's E / P experts, as ``P(ep_axis, None, None)`` cuts them;
    the dense weights are copied whole."""
    conv = _to_torch(device)
    params = {k: _tree_map(conv, np_tree[k])
              for k in ("embed", "final_norm", "head", "pos_embed") if k in np_tree}
    params["layers"] = [_tree_map(conv, layer)
                        for layer in layers_in_order(np_tree, cfg)]
    if "encoder" in np_tree:
        enc = np_tree["encoder"]
        params["encoder"] = {
            "layers": [_tree_map(lambda a, i=i: conv(a[i]), enc["layers"])
                       for i in range(cfg.encoder_layers)],
            "final_norm": _tree_map(conv, enc["final_norm"]),
            "pos_embed": conv(enc["pos_embed"])}
    if mesh is not None:
        for layer in params["layers"]:
            ffn = layer.get("ffn", {})
            if "router" in ffn:
                for name in ("w1", "w3", "w2"):
                    ffn[name] = mesh.local_experts(ffn[name]).clone()
    return params


def cache_from_jax(np_cache: dict, cfg: ModelConfig, batch: int, device) -> dict:
    """A JAX decode cache (as numpy; one scalar ``pos`` for the batch) ->
    the port's cache (one position per row)."""
    conv = _to_torch(device)
    pos = torch.full((batch,), int(np_cache["pos"]), dtype=torch.long,
                     device=device)
    return {"pos": pos,
            "layers": [_tree_map(conv, layer)
                       for layer in layers_in_order(np_cache, cfg)]}
