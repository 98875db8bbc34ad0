"""Serving engine: single-pass batched prefill, chunked prefill, generation.

Prefill is one ``transformer.forward`` pass that writes every layer's decode
cache as it goes; later prefill chunks extend the cache with
``transformer.extend_step``.  PyTorch runs eagerly, so there is no compiled-
step cache to keep; nothing here records autograd state.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.chunking import chunk_spans
from repro_torch.core.moe import DistContext
from repro_torch.models import transformer


@torch.no_grad()
def prefill(params: dict, cfg: ModelConfig, ctx: DistContext, batch: dict,
            cache_len: int, dtype=torch.float32):
    """Single-pass batched prefill.  Returns (next_token_logits (B, 1, V),
    cache)."""
    logits, _stats, cache = transformer.forward(
        params, cfg, ctx, batch, return_cache=True, cache_len=cache_len,
        cache_dtype=dtype)
    return logits[:, -1:], cache


@torch.no_grad()
def prefill_chunk(params: dict, cfg: ModelConfig, ctx: DistContext, cache,
                  seg: torch.Tensor, cache_len: int, dtype=torch.float32):
    """One chunked-prefill span: the first (``cache is None``) runs the
    single-pass prefill, later spans extend the cache.  Returns
    (next_token_logits (B, 1, V), cache)."""
    if cache is None:
        return prefill(params, cfg, ctx, {"tokens": seg}, cache_len, dtype)
    full, cache = transformer.extend_step(params, cfg, ctx, cache, seg)
    return full[:, -1:], cache


def prefill_chunked(params: dict, cfg: ModelConfig, ctx: DistContext,
                    tokens: torch.Tensor, cache_len: int, chunk: int,
                    dtype=torch.float32):
    """Prefill a (B, S) prompt in <= ``chunk``-token pieces.  Returns
    (next_token_logits (B, 1, V), cache)."""
    S = tokens.shape[1]
    if S > cache_len:
        raise ValueError(f"prompt length {S} exceeds cache_len {cache_len}")
    logits = cache = None
    for start, stop in chunk_spans(S, chunk):
        logits, cache = prefill_chunk(params, cfg, ctx, cache,
                                      tokens[:, start:stop], cache_len, dtype)
    return logits, cache


@torch.no_grad()
def generate(params: dict, cfg: ModelConfig, ctx: DistContext, batch: dict,
             steps: int, cache_len: int, temperature: float = 0.0,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Greedy (``temperature == 0``) or sampled batched generation;
    returns (B, steps) token ids."""
    logits, cache = prefill(params, cfg, ctx, batch, cache_len)
    if temperature > 0 and generator is None:
        generator = torch.Generator(device=logits.device).manual_seed(0)
    out = []
    for _ in range(steps):
        if temperature > 0:
            probs = torch.softmax(logits[:, -1] / temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
        else:
            nxt = torch.argmax(logits[:, -1], dim=-1)
        out.append(nxt)
        logits, cache = transformer.decode_step(params, cfg, ctx, cache,
                                                nxt[:, None])
    return torch.stack(out, dim=1)
