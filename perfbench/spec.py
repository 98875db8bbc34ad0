"""Model shapes as the benchmark reads them.

A configuration file (``configs/<name>.json``) states the published keys of
the model's own ``config.json`` as the cell runs them, a ``port`` block
naming the program's registry entry and the depth it is cut to, and the
files the harness reads it with: ``"arch"`` (``arch/<arch>.py``, the
architecture file), ``"reference"`` (the plain reference, a path under
``perfbench/``) and ``"driver"`` (``drivers/<driver>.py``).  The
architecture file turns either side, the file or the program's
configuration, into one plain dict of shapes (the spec), so that the
harness can hold the program against the file before it builds anything,
and so that the weights, the reference and the work counts all read the
same numbers.

Code outside an architecture file and its reference reads only these keys
of the spec:

* ``vocab_size``: the label space;
* ``top_k``: experts a token is routed to;
* ``n_experts``: the router's width;
* ``experts_held``: the experts this chip computes (``n_experts`` where one
  chip holds them all);
* ``layers``: one dict per layer, whose ``ffn`` is ``"moe"`` or ``"dense"``.

Every other key belongs to the architecture file that makes the spec.
"""

from __future__ import annotations

import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load_config_file(name: str, root: Path = HERE) -> dict:
    """The configuration file ``configs/<name>.json``."""
    return json.loads((root / "configs" / f"{name}.json").read_text())


def pad256(v: int) -> int:
    """``v`` rounded up to a multiple of 256 (the program's padded vocabulary)."""
    return -(-v // 256) * 256


def mismatches(a: dict, b: dict) -> list:
    """The keys on which two shape dicts differ."""
    return [k for k in sorted(set(a) | set(b)) if a.get(k) != b.get(k)]
