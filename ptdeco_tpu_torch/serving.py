"""KV-cached autoregressive decoding of the port's causal LM.

Counterpart of the standard-attention part of ``ptdeco_tpu/serving.py``,
for uniform-length prompt batches:

  * a KV cache of ``(b, max_len, n_kv_heads, head_dim)`` per layer, written
    in place (the JAX package returns updated copies; here the tensors given
    to ``forward_with_cache`` are updated and returned);
  * one code path for prefill and decode: a prefill is a multi-token step at
    ``cache_pos=0``, a decode step a one-token step;
  * the projections, rope and output projection are the model's own
    (``Attention.project_qkv`` / ``Attention.finish``), so the cached path
    cannot drift from the uncached forward;
  * the prefill from an empty cache launches the flash kernel on the
    un-repeated GQA k/v; decode attends against the cache in plain PyTorch,
    grouped as ``(kv_heads, rep)`` so the cache is never repeated;
  * ``generate`` is a Python loop of decode steps (the JAX package's
    ``lax.scan``); it never waits for the card between steps.

Ragged prompts, end-of-sequence handling, top-p / top-k / min-p /
repetition penalty, beam search, speculative decoding and the batcher are
not ported.
"""

from __future__ import annotations

from typing import Optional

import torch

from .models.transformer import Attention, CausalLM, _positions
from .ops.flash_attention import KERNEL_HEAD_DIMS, flash_attention

__all__ = ["KVCache", "init_cache", "forward_with_cache", "generate"]

# per layer: (k_cache, v_cache), each (b, max_len, n_kv_heads, head_dim)
KVCache = tuple


def _valid_keys(positions: torch.Tensor, max_len: int, cache_pos: int, s: int) -> torch.Tensor:
    """(b, s, max_len) bool: keys at or before each query's absolute
    position, and inside the cache's fill."""
    key_idx = torch.arange(max_len, device=positions.device)
    valid = key_idx[None, None, :] <= positions[:, :, None]
    return valid & (key_idx < cache_pos + s)[None, None, :]


def _cache_write(cache: torch.Tensor, new: torch.Tensor, cache_pos: int) -> torch.Tensor:
    """Write ``new`` (b, s, ...) into ``cache`` (b, max_len, ...) at
    ``cache_pos``, in place."""
    cache[:, cache_pos : cache_pos + new.shape[1]] = new.to(cache.dtype)
    return cache


def _flash_prefill_ok(s: int, hd: int, q: torch.Tensor) -> bool:
    """The gates of the flash-kernel cached prefill, those of the uncached
    ``Attention.forward`` (the TPU's ``s % 128`` rule is dropped: the kernel
    masks its ragged edge)."""
    return s > 1 and q.is_cuda and q.dtype == torch.bfloat16 and hd in KERNEL_HEAD_DIMS


class CachedAttention:
    """Stands in for a block's ``Attention`` for one cached step: writes the
    step's k/v into the cache at ``cache_pos`` and attends against it.
    ``prefill_causal`` says the cache was empty before this step."""

    def __init__(
        self,
        inner: Attention,
        k_cache: torch.Tensor,
        v_cache: torch.Tensor,
        cache_pos: int,
        prefill_causal: bool = False,
    ) -> None:
        self.inner = inner
        self.k_cache = k_cache
        self.v_cache = v_cache
        self.cache_pos = cache_pos
        self.prefill_causal = prefill_causal

    def __call__(
        self, x: torch.Tensor, attn_mask: Optional[torch.Tensor], positions: torch.Tensor
    ) -> torch.Tensor:
        """``Attention.forward``'s signature; ``attn_mask`` is None here (the
        cached path takes uniform-length prompts)."""
        a = self.inner
        b, s, _ = x.shape
        max_len = self.k_cache.shape[1]
        q, k_new, v_new = a.project_qkv(x, positions)
        hd = q.shape[-1]
        _cache_write(self.k_cache, k_new, self.cache_pos)
        _cache_write(self.v_cache, v_new, self.cache_pos)
        g = a.n_kv_heads
        rep = a.n_heads // g
        scale = hd ** -0.5
        if self.prefill_causal and _flash_prefill_ok(s, hd, q):
            # the cache beyond the s new tokens is empty, so attention is
            # plain causal attention over the new tokens
            out = flash_attention(
                q.transpose(1, 2), k_new.transpose(1, 2), v_new.transpose(1, 2), scale
            ).transpose(1, 2)
            return a.finish(out.reshape(b, s, -1))
        qg = q.reshape(b, s, g, rep, hd).to(torch.float32)
        logits = torch.einsum("bqgrd,bkgd->bgrqk", qg, self.k_cache.to(torch.float32)) * scale
        valid = _valid_keys(positions, max_len, self.cache_pos, s)
        logits = logits.masked_fill(~valid[:, None, None], torch.finfo(torch.float32).min)
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        out = torch.einsum(
            "bgrqk,bkgd->bqgrd", probs.to(torch.float32), self.v_cache.to(torch.float32)
        ).to(x.dtype)
        return a.finish(out.reshape(b, s, -1))


def init_cache(lm: CausalLM, batch_size: int, max_len: int) -> KVCache:
    """Zero-filled per-layer KV cache on the model's device, in its dtype."""
    emb = lm.model.embed_tokens.weight
    caches = []
    for layer in lm.model.layers:
        a = layer.self_attn
        shape = (batch_size, max_len, a.n_kv_heads, a.head_dim)
        caches.append(
            (torch.zeros(shape, dtype=emb.dtype, device=emb.device),
             torch.zeros(shape, dtype=emb.dtype, device=emb.device))
        )
    return tuple(caches)


@torch.no_grad()
def forward_with_cache(
    lm: CausalLM,
    input_ids: torch.Tensor,
    caches: KVCache,
    cache_pos: int,
    *,
    last_pos: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, KVCache]:
    """One cached step at absolute positions ``cache_pos + arange(s)``:
    returns ``(logits, caches)``, the caches updated in place.
    ``last_pos`` (b,): compute the final norm and vocab head on only that
    position of each row, returning (b, 1, vocab) logits."""
    b, s = input_ids.shape
    positions = _positions(b, s, cache_pos, input_ids.device)
    x = lm.model.embed_tokens(input_ids)
    for layer, (k_cache, v_cache) in zip(lm.model.layers, caches):
        cached = CachedAttention(
            layer.self_attn, k_cache, v_cache, cache_pos, prefill_causal=cache_pos == 0
        )
        x = layer(x, positions=positions, self_attn=cached)
    if last_pos is not None:
        x = torch.gather(x, 1, last_pos.to(torch.int64)[:, None, None].expand(b, 1, x.shape[-1]))
    return lm.head(lm.model.norm(x)), caches


def _sample(
    logits: torch.Tensor,
    greedy: bool,
    temperature: float,
    generator: Optional[torch.Generator],
) -> torch.Tensor:
    if greedy:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits.to(torch.float32) / max(temperature, 1e-6), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


@torch.no_grad()
def generate(
    lm: CausalLM,
    prompt_ids: torch.Tensor,
    max_new_tokens: int,
    *,
    temperature: float = 0.0,
    generator: Optional[torch.Generator] = None,
    return_logits: bool = False,
):
    """``max_new_tokens`` continuation tokens (b, max_new_tokens) for a
    uniform-length prompt batch (b, s_p).  ``temperature=0`` is greedy
    argmax; otherwise categorical sampling drawn from ``generator``.  With
    ``return_logits`` the logits each token was chosen from come back too,
    (b, max_new_tokens, vocab)."""
    b, s_p = prompt_ids.shape
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    if temperature < 0.0:
        raise ValueError(f"temperature must be >= 0, got {temperature}")
    greedy = temperature == 0.0
    caches = init_cache(lm, b, s_p + max_new_tokens)
    last_pos = torch.full((b,), s_p - 1, dtype=torch.int64, device=prompt_ids.device)
    logits, caches = forward_with_cache(lm, prompt_ids, caches, 0, last_pos=last_pos)
    last = logits[:, 0]
    tok = _sample(last, greedy, temperature, generator)
    tokens, step_logits = [tok], [last]
    for pos in range(s_p, s_p + max_new_tokens - 1):
        logits, caches = forward_with_cache(lm, tok[:, None], caches, pos)
        last = logits[:, -1]
        tok = _sample(last, greedy, temperature, generator)
        tokens.append(tok)
        step_logits.append(last)
    out = torch.stack(tokens, dim=1)
    if return_logits:
        return out, torch.stack(step_logits, dim=1)
    return out
