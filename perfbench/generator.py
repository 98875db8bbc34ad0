"""The one traffic generator: every traffic mix is a data file it reads.

A mix (``traffic/<name>.json``) is a training feed (``"kind": "train"``):
``batch``, ``seq_len``, ``tokens`` ({"dist": "zipf", "exponent": a} or
{"dist": "uniform"}) and ``steps_per_s_cap`` (the batches made in set-up
are ``warm_steps + ceil(seconds * cap) + 1``).  Every step's rows are drawn
afresh from (``--seed``, step), so the sizes of the work are the file's and
the seed draws only the token ids (and the weights).
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent


def load_traffic_file(name: str, root: Path = HERE) -> dict:
    """The traffic mix ``traffic/<name>.json``."""
    return json.loads((root / "traffic" / f"{name}.json").read_text())


def _rng(*key) -> np.random.Generator:
    return np.random.default_rng([int(k) & ((1 << 63) - 1) for k in key])


class TokenLaw:
    """Token ids over ``vocab``: Zipf over ranks (a seeded permutation maps
    ranks to ids) or uniform."""

    def __init__(self, law: dict, vocab: int, seed: int):
        self.vocab = vocab
        self.dist = law.get("dist", "uniform")
        if self.dist == "zipf":
            ranks = np.arange(1, vocab + 1, dtype=np.float64)
            w = ranks ** -float(law["exponent"])
            self.cdf = np.cumsum(w / w.sum())
            self.ids = _rng(seed, 1).permutation(vocab).astype(np.int32)
        elif self.dist != "uniform":
            raise ValueError(f"unknown token law {self.dist!r}")

    def draw(self, rng: np.random.Generator, n: int) -> np.ndarray:
        if self.dist == "uniform":
            return rng.integers(0, self.vocab, n, dtype=np.int32)
        rank = np.searchsorted(self.cdf, rng.random(n), side="right")
        return self.ids[np.minimum(rank, self.vocab - 1)]


class TrainFeed:
    """The training feed: the batch of any step, {"tokens", "labels"} as
    (B, S) int32 arrays, every row drawn afresh from (seed, step), the
    labels the next token.  ``ahead(n)`` makes the first n in set-up."""

    def __init__(self, mix: dict, vocab: int, seed: int):
        self.law = TokenLaw(mix["tokens"], vocab, seed)
        self.B, self.S, self.seed = int(mix["batch"]), int(mix["seq_len"]), seed
        self.made: list = []

    def batch(self, step: int) -> dict:
        if step < len(self.made):
            return self.made[step]
        t = self.law.draw(_rng(self.seed, 2, step), self.B * (self.S + 1))
        t = t.reshape(self.B, self.S + 1)
        return {"tokens": t[:, :-1], "labels": t[:, 1:]}

    def ahead(self, n: int) -> "TrainFeed":
        self.made = [self.batch(i) for i in range(n)]
        return self


def train_feed(mix: dict, vocab: int, seed: int, seconds: float,
               warm_steps: int) -> TrainFeed:
    """The feed with ``warm_steps + ceil(seconds * steps_per_s_cap) + 1``
    batches made ahead (a faster program draws the rest as it goes)."""
    n = warm_steps + math.ceil(seconds * float(mix["steps_per_s_cap"])) + 1
    return TrainFeed(mix, vocab, seed).ahead(n)

