"""Random weights made by the benchmark from ``--seed``.

The benchmark, not the program, makes the weights, so that the plain
reference can be handed the same numbers.  What the leaves are comes from
the cell's architecture file (``arch/<arch>.py``): its ``plan(spec)`` lists
every leaf as (path, shape, kind, scale), in the order and with the
scales of the program's own tree (``init_params``'s: ``embed``,
``final_norm``, ``head``, and one dict per layer).  A path's parts are
dict keys, ``layers/<i>`` a list entry.  ``kind`` is "normal" (a scaled
normal in the trained type), "normal32" (the same in fp32), "ones32" or
"zeros32".

Every leaf comes from a generator of its own, seeded from ``--seed`` and
the leaf's place in the plan, in one call on the target device.  So the
weights of a seed are the same on every run, and any one leaf can be made
again alone (``leaf``), which the training check uses to read the
parameters' change without keeping a copy of the initial weights.
"""

from __future__ import annotations

import torch

_MASK = (1 << 63) - 1


def leaf_seed(seed: int, index: int) -> int:
    """A 63-bit generator seed for leaf ``index`` of run seed ``seed``
    (splitmix64's finaliser)."""
    z = (seed * 0x9E3779B97F4A7C15 + (index + 1) * 0xBF58476D1CE4E5B9) & ((1 << 64) - 1)
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & ((1 << 64) - 1)
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & ((1 << 64) - 1)
    return (z ^ (z >> 31)) & _MASK


def leaf(plan: list, seed: int, index: int, device, dtype) -> torch.Tensor:
    """Leaf ``index`` of ``plan``, made alone."""
    _, shape, kind, scale = plan[index]
    return _make(shape, kind, scale, leaf_seed(seed, index), device, dtype)


def _make(shape, kind, scale, gseed, device, dtype) -> torch.Tensor:
    f32 = torch.float32
    if kind in ("normal", "normal32"):
        gen = torch.Generator(device=device).manual_seed(gseed)
        t = torch.randn(shape, generator=gen, device=device,
                        dtype=dtype if kind == "normal" else f32)
        return t.mul_(scale)
    if kind == "ones32":
        return torch.ones(shape, dtype=f32, device=device)
    if kind == "zeros32":
        return torch.zeros(shape, dtype=f32, device=device)
    raise ValueError(f"unknown leaf kind {kind!r}")


def make(plan: list, seed: int, device, dtype) -> dict:
    """The whole tree of ``plan``, every leaf from its own seeded generator."""
    tree: dict = {}
    for i, (path, shape, kind, scale) in enumerate(plan):
        parts, node, j = path.split("/"), tree, 0
        while j < len(parts) - 1:
            if parts[j] == "layers":              # "layers/<i>": a list entry
                rows = node.setdefault("layers", [])
                while len(rows) <= int(parts[j + 1]):
                    rows.append({})
                node, j = rows[int(parts[j + 1])], j + 2
            else:
                node, j = node.setdefault(parts[j], {}), j + 1
        node[parts[-1]] = _make(shape, kind, scale, leaf_seed(seed, i), device, dtype)
    return tree


def flat(tree) -> list:
    """The leaves of a tree in ``plan`` order (dict insertion order)."""
    if isinstance(tree, dict):
        return [t for k in tree for t in flat(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in flat(v)]
    return [tree]

