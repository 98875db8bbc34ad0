"""Crash-consistent checkpoints of a ``TrainState``: npz payload + json
manifest.  The port's counterpart of the JAX package's
``checkpointing/io.py``, with the same API and the same crash consistency.

A checkpoint is *committed* by its manifest.  ``save`` writes the npz
payload to a temp file, fsyncs, ``os.replace``s it into place, then writes
the manifest (the payload's sha256, the leaf count, the structure string and
``extra``) the same way.  Readers (``latest_step``/``valid_steps``) trust
only steps whose manifest exists AND whose payload hashes to the recorded
checksum, so a write torn by a crash (or by the fault injector's
``ckpt_truncate``) is skipped, never returned.  ``restore`` refuses a
checkpoint whose structure differs from the state it restores into.

What is the port's own:

* **Tensor types.**  numpy has no bfloat16, so a bf16 tensor is stored as
  its raw ``uint16`` bits and the manifest keeps each leaf's torch dtype: a
  round trip is bit for bit.  The structure string lists each leaf's path
  (``named_params`` paths under ``params``, ``opt.mu`` and ``opt.nu``),
  shape and dtype, then ``opt.step`` and ``step``.
* **Streaming.**  The payload is written one tensor at a time (one
  tensor's host copy live), and restored into the tensors of a state of
  the same structure, in place.
* **Under a mesh** (``world`` > 1) each rank writes
  ``step_XXXXXXXX.rank<r>.{npz,json}``, because its expert slices differ.
  A step is valid only when every rank's payload verifies; every rank
  reads all the ranks' manifests from the shared directory, so all ranks
  pick the same step without a collective.  At one peer the file names are
  the JAX package's.

The manifest's ``extra`` dict carries the small host-side planner state a
resumed run needs to plan as the uninterrupted one did
(``training/trainer.py``), as plain JSON.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import zipfile
from typing import Optional

import numpy as np
import torch

from repro_torch.optim.adamw import AdamWState, named_params


def _base(path: str, step: int, rank: int = 0, world: int = 1) -> str:
    name = f"step_{step:08d}" if world == 1 else f"step_{step:08d}.rank{rank}"
    return os.path.join(path, name)


def payload(path: str, step: int, rank: int = 0, world: int = 1) -> str:
    """The payload file of checkpoint ``step`` (this rank's under a mesh)."""
    return _base(path, step, rank, world) + ".npz"


def _leaves(state) -> list:
    """(name, tensor or int) of every leaf of a TrainState, in a fixed
    order: the parameters, the two moments, then the two step counters."""
    named = named_params(state.params)
    return ([(f"params{p}", t) for p, t in named]
            + [(f"opt.mu{p}", m) for (p, _), m in zip(named, state.opt.mu)]
            + [(f"opt.nu{p}", v) for (p, _), v in zip(named, state.opt.nu)]
            + [("opt.step", int(state.opt.step)), ("step", int(state.step))])


def _dtype(leaf) -> str:
    return str(leaf.dtype) if isinstance(leaf, torch.Tensor) else "int64"


def structure(state) -> str:
    """The manifest's structure string of a TrainState: one line per leaf,
    its name, shape and dtype."""
    return "\n".join(
        f"{name} {tuple(leaf.shape) if isinstance(leaf, torch.Tensor) else ()} "
        f"{_dtype(leaf)}" for name, leaf in _leaves(state))


def _to_numpy(leaf) -> np.ndarray:
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf, dtype=np.int64)
    t = leaf.detach()
    if t.dtype == torch.bfloat16:                # numpy has no bfloat16: its bits
        return t.view(torch.int16).cpu().numpy().view(np.uint16)
    return t.cpu().numpy()


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 24), b""):
            h.update(block)
    return h.hexdigest()


def _replace_into(tmp: str, dst: str) -> None:
    with open(tmp, "rb") as f:
        os.fsync(f.fileno())
    os.replace(tmp, dst)


def save(path: str, step: int, state, extra: Optional[dict] = None,
         rank: int = 0, world: int = 1) -> str:
    """Write a committed checkpoint of ``state``; returns the payload path.

    ``extra`` is a small JSON-serialisable dict stored in the manifest
    (``load_extra`` hands it back).  Under a mesh each of the ``world``
    ranks saves its own state with its ``rank``."""
    os.makedirs(path, exist_ok=True)
    leaves = _leaves(state)
    if any(isinstance(t, torch.Tensor) and t.is_cuda for _, t in leaves):
        torch.cuda.synchronize()                 # the step's writes land first
    out = _base(path, step, rank, world)
    tmp = out + ".npz.tmp"
    # np.savez's layout (stored, zip64), one tensor's host copy at a time
    with zipfile.ZipFile(tmp, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for i, (_, leaf) in enumerate(leaves):
            with zf.open(f"leaf_{i}.npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, _to_numpy(leaf), allow_pickle=False)
    checksum = _sha256(tmp)
    _replace_into(tmp, out + ".npz")
    manifest = {"step": step, "structure": structure(state),
                "n_leaves": len(leaves), "sha256": checksum,
                "rank": rank, "world": world, "extra": _jsonable(extra or {})}
    with open(out + ".json.tmp", "w") as f:
        json.dump(manifest, f)
    _replace_into(out + ".json.tmp", out + ".json")
    return out + ".npz"


def _jsonable(obj):
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (np.integer, np.floating)):
        return obj.item()
    return obj


def _manifest(path: str, step: int, rank: int = 0, world: int = 1) -> Optional[dict]:
    try:
        with open(_base(path, step, rank, world) + ".json") as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def verify(path: str, step: int, world: int = 1) -> tuple[bool, str]:
    """Is checkpoint ``step`` committed and intact, for every one of the
    ``world`` ranks?  (ok, reason)."""
    for rank in range(world):
        who = "" if world == 1 else f"rank {rank}: "
        man = _manifest(path, step, rank, world)
        if man is None:
            return False, f"{who}manifest missing or unreadable"
        if man.get("world", 1) != world:
            return False, f"{who}saved by {man.get('world')} ranks, not {world}"
        npz = payload(path, step, rank, world)
        if not os.path.exists(npz):
            return False, f"{who}payload missing"
        if _sha256(npz) != man.get("sha256"):
            return False, f"{who}payload checksum mismatch (torn write?)"
    return True, "ok"


def _steps(path: str) -> list[int]:
    if not os.path.isdir(path):
        return []
    return sorted({int(m.group(1)) for f in os.listdir(path)
                   if (m := re.match(r"step_(\d+)(?:\.rank\d+)?\.(?:npz|json)$", f))})


def valid_steps(path: str, world: int = 1) -> list[int]:
    """All committed-and-intact checkpoint steps, ascending."""
    return [s for s in _steps(path) if verify(path, s, world)[0]]


def latest_step(path: str, world: int = 1) -> Optional[int]:
    """Newest *valid* checkpoint step: partial or corrupt saves are
    skipped, so a resume after a torn write replays from the last good one.
    Hashes from the newest step down, and stops at the first valid one."""
    for s in reversed(_steps(path)):
        if verify(path, s, world)[0]:
            return s
    return None


def restore(path: str, step: int, like, rank: int = 0, world: int = 1):
    """Restore checkpoint ``step`` into the tensors of ``like`` (a
    ``TrainState`` of the saved structure), in place; returns the state
    with the saved step counters.

    The manifest's structure (leaf count, each leaf's path, shape and
    dtype) must match ``like``'s: a stale state fails loudly instead of
    loading into the wrong tensors."""
    leaves = _leaves(like)
    man = _manifest(path, step, rank, world)
    if man is None:
        raise FileNotFoundError(f"checkpoint step {step} has no manifest in {path}")
    if man["n_leaves"] != len(leaves):
        raise ValueError(
            f"checkpoint step {step} holds {man['n_leaves']} leaves but the "
            f"state has {len(leaves)}: restoring into a different structure "
            f"than was saved")
    if man["structure"] != structure(like):
        raise ValueError(f"checkpoint step {step}'s structure does not match the "
                         f"state's:\n  saved: {man['structure']!r}\n  state: "
                         f"{structure(like)!r}")
    counters = {}
    with np.load(payload(path, step, rank, world)) as data:
        for i, (name, leaf) in enumerate(leaves):
            arr = data[f"leaf_{i}"]
            if not isinstance(leaf, torch.Tensor):
                counters[name] = int(arr)
                continue
            if leaf.dtype == torch.bfloat16:
                src = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                src = torch.from_numpy(arr)
            with torch.no_grad():
                leaf.copy_(src)
    return type(like)(params=like.params,
                      opt=AdamWState(counters["opt.step"], like.opt.mu, like.opt.nu),
                      step=counters["step"])


def load_extra(path: str, step: int, rank: int = 0, world: int = 1) -> dict:
    """The manifest's ``extra`` dict."""
    man = _manifest(path, step, rank, world)
    return (man or {}).get("extra", {})
