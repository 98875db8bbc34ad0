"""Deterministic synthetic LM data (host-side, numpy).

The port's copy of the JAX package's ``SyntheticLMData``: sequences follow
a noisy affine recurrence over the vocab (token_{t+1} = (a * token_t + 7)
mod V, replaced by a random token with probability ``noise``), so the LM
loss has real signal.  Each batch comes
from a counter-derived seed: the same step gives the same batch in both
packages.

Modality stubs, as in the JAX package: a VLM's projected patch embeddings
and an audio model's conv-frontend frame embeddings are seeded normals of
the right shape, drawn after the tokens from the same generator.
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

    def batch_at(self, step: int) -> dict:
        """The batch of ``step``: "tokens" (B, S - n_patch) and "labels"
        (B, S) int32, the labels -1 over the patch positions; "patches"
        (B, n_patch, d) float32 with patch inputs, "frames" (B,
        encoder_seq, d) float32 with an encoder."""
        rng = np.random.default_rng((self.seed, step))
        V, B = self.cfg.vocab_size, self.global_batch
        n_patch = self.cfg.num_patch_tokens
        S = self.seq_len - n_patch
        a = 31 if V > 31 else 3
        toks = np.empty((B, S + 1), np.int32)
        toks[:, 0] = rng.integers(0, V, B)
        noise_mask = rng.random((B, S)) < self.noise
        noise_tok = rng.integers(0, V, (B, S))
        for t in range(S):
            nxt = (toks[:, t] * a + 7) % V
            toks[:, t + 1] = np.where(noise_mask[:, t], noise_tok[:, t], nxt)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        d = self.cfg.d_model
        if n_patch:
            batch["patches"] = rng.standard_normal((B, n_patch, d)).astype(np.float32)
            pad = np.full((B, n_patch), -1, np.int32)   # no LM loss on patches
            batch["labels"] = np.concatenate([pad, batch["labels"]], axis=1)
        if self.cfg.encoder_layers:
            batch["frames"] = rng.standard_normal(
                (B, self.cfg.encoder_seq, d)).astype(np.float32)
        return batch

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
