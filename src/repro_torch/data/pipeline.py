"""Deterministic synthetic LM data (host-side, numpy).

The port's copy of the JAX package's ``SyntheticLMData`` for text-only
models: sequences follow a noisy affine recurrence over the vocab
(token_{t+1} = (a * token_t + 7) mod V, replaced by a random token with
probability ``noise``), so the LM loss has real signal.  Each batch comes
from a counter-derived seed: the same step gives the same batch in both
packages.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np

from repro_torch.configs.base import ModelConfig


@dataclass
class SyntheticLMData:
    cfg: ModelConfig
    seq_len: int
    global_batch: int
    seed: int = 0
    noise: float = 0.1

    def __post_init__(self):
        if self.cfg.num_patch_tokens or self.cfg.encoder_layers:
            raise NotImplementedError(f"{self.cfg.name!r}: patch and encoder "
                                      "inputs are not ported yet")

    def batch_at(self, step: int) -> dict:
        """{"tokens": (B, S) int32, "labels": (B, S) int32} for ``step``."""
        rng = np.random.default_rng((self.seed, step))
        V, B, S = self.cfg.vocab_size, self.global_batch, self.seq_len
        a = 31 if V > 31 else 3
        toks = np.empty((B, S + 1), np.int32)
        toks[:, 0] = rng.integers(0, V, B)
        noise_mask = rng.random((B, S)) < self.noise
        noise_tok = rng.integers(0, V, (B, S))
        for t in range(S):
            nxt = (toks[:, t] * a + 7) % V
            toks[:, t + 1] = np.where(noise_mask[:, t], noise_tok[:, t], nxt)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
