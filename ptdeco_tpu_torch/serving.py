"""KV-cached autoregressive decoding of the port's causal LM.

Counterpart of the llama-family part of ``ptdeco_tpu/serving.py``:

  * a KV cache of ``(b, max_len, n_kv_heads, head_dim)`` per layer, written
    in place (the JAX package returns updated copies; here the tensors given
    to ``forward_with_cache`` are updated and returned);
  * one code path for prefill and decode: a prefill is a multi-token step at
    ``cache_pos=0``, a decode step a one-token step.  ``cache_pos`` is an int
    or a per-row (b,) tensor: ragged decode over right-padded prompts, where
    each row's cache slot equals its token position, so the pad tail that a
    prefill writes is causally invisible and overwritten as the row decodes.
    ``kv_mask`` (b, max_len) marks the valid key slots of left-padded rows;
  * the embedding step (learned positions and computed sinusoids at each
    row's absolute positions included), the projections (biases and q/k
    norms included), rope and the output projection (BitNet's sub-norm
    before it) are the model's own
    (``Decoder.embed_inputs``, ``Attention.project_qkv`` /
    ``Attention.finish``), so the cached path cannot drift from the
    uncached forward, for every family ``TransformerConfig`` builds (phi,
    whose JAX serving path does not exist, is not served from the cache);
  * a prefill from an empty cache (a host ``0`` for ``cache_pos``, no
    ``kv_mask``) launches the flash kernel on the un-repeated GQA k/v, a
    right-padded ragged prefill included (its pad tail is causally later
    than every real token), but for ALiBi layers, which the kernel cannot
    bias; decode and per-row steps attend against the cache in plain
    PyTorch, grouped as ``(kv_heads, rep)`` so the cache is never
    repeated, ALiBi added at each key's cache slot;
  * ``generate`` (eos, ragged prompts, top-k / top-p / min-p, repetition
    penalty), ``generate_beam`` and the batcher (``serving_batcher.py``) are
    Python loops of cached steps (the JAX package's ``lax.scan``); they never
    wait for the card between steps: finished rows are filled with eos on
    the card;
  * ``generate_speculative`` reads one flag from the card a round, the loop's
    condition that some row is still live (the JAX ``lax.while_loop``'s
    ``cond``); its gate (``measure_speculative_speedup_probe`` and the
    analytic ``estimate_speculative_speedup``) times the loops the port
    runs, each timed window ending in ``torch.cuda.synchronize``.

  * doge's layers cache their keys' f32 bias beside k and v, diffllama's
    differential attention has a cached form of its own
    (``CachedDiffAttention``), DeepSeek's latent attention caches its normed
    latent and its shared rope head (``CachedMLAttention``, the absorbed
    form), and mllama's skipped layers have no entry:
    ``layer_cache_tensors`` is the one place that reads an entry's layout.
    None of doge, diffllama and DeepSeek takes flash, as in the JAX package;
    a block-pruned attention is refused, as there.

Not ported: the cached mixers of the other model families (state-space and
mixture-of-attention layers, which the port does not have), serving on a
device mesh, and capturing the decode step in a CUDA graph.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Optional

import numpy as np
import torch

from .models.transformer import (
    Attention,
    Block,
    CausalLM,
    DiffAttention,
    MLAttention,
    SkipBlock,
    _positions,
)
from .ops.flash_attention import KERNEL_HEAD_DIMS, flash_attention

__all__ = [
    "KVCache",
    "layer_cache_tensors",
    "map_caches",
    "init_cache",
    "check_decode_supported",
    "forward_with_cache",
    "generate",
    "generate_beam",
    "generate_speculative",
    "measure_decode_step_costs",
    "estimate_speculative_speedup",
    "measure_draft_acceptance",
    "measure_speculative_speedup_probe",
]

logger = logging.getLogger(__name__)

# per layer: (k_cache, v_cache), each (b, max_len, n_kv_heads, head_dim);
# doge's layers add their keys' f32 bias (b, max_len, n_kv_heads) as a third
# tensor; an MLA layer's is (latent, rope head), (b, max_len, kv_lora_rank)
# and (b, max_len, qk_rope_head_dim); a SkipBlock's entry is None
KVCache = tuple

# an entry's layout by its tensors' ranks
_LAYOUTS = {(4, 4): "kv", (4, 4, 3): "doge", (3, 3): "mla"}


def _cache_layout(entry: Any, idx: int) -> str:
    """Layer ``idx``'s cache layout: "skip" (a SkipBlock's None), "kv",
    "doge" or "mla" by its tensors' ranks; any other is refused."""
    layout = "skip" if entry is None else (
        _LAYOUTS.get(tuple(t.ndim for t in entry))
        if isinstance(entry, tuple) and all(isinstance(t, torch.Tensor) for t in entry) else None)
    if layout is None:
        raise ValueError(
            f"layer {idx}'s cache entry is not (k, v), doge's (k, v, key bias), MLA's (latent, "
            "rope head) or None: the port wires no other cache layout (ROADMAP.md)"
        )
    return layout


def layer_cache_tensors(entry: Any, idx: int) -> tuple:
    """The tensors of one layer's cache entry: () for a SkipBlock's None,
    else its (k, v), doge's (k, v, key bias) or MLA's (latent, rope head).
    Every copy or reorder of the caches (beams, the batcher's slots) goes
    through this, so a layout the port does not wire is refused here, not
    mis-indexed."""
    return () if _cache_layout(entry, idx) == "skip" else entry


def map_caches(caches: KVCache, fn: Any) -> KVCache:
    """``caches`` with ``fn`` applied to every tensor, None entries kept."""
    return tuple(
        None if entry is None else tuple(fn(t) for t in layer_cache_tensors(entry, i))
        for i, entry in enumerate(caches)
    )


def _valid_keys(
    positions: torch.Tensor,
    max_len: int,
    cache_pos: Any,
    s: int,
    kv_mask: Optional[torch.Tensor] = None,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """(b, s, max_len) bool: keys at or before each query's absolute
    position, inside the cache's fill (``cache_pos`` an int or per-row
    (b,)), within the layer's ``sliding_window`` (query - key < window) and
    marked valid by the caller's left-padding ``kv_mask``."""
    key_idx = torch.arange(max_len, device=positions.device)
    q_pos = positions[:, :, None]
    valid = key_idx[None, None, :] <= q_pos
    if isinstance(cache_pos, torch.Tensor):
        fill = (cache_pos.to(positions.device) + s)[:, None, None]
    else:
        fill = cache_pos + s
    valid = valid & (key_idx[None, None, :] < fill)
    if sliding_window is not None:
        valid = valid & (q_pos - key_idx[None, None, :] < sliding_window)
    if kv_mask is not None:
        valid = valid & kv_mask.to(device=positions.device, dtype=torch.bool)[:, None, :]
    return valid


def _cache_write(cache: torch.Tensor, new: torch.Tensor, cache_pos: Any) -> torch.Tensor:
    """Write ``new`` (b, s, ...) into ``cache`` (b, max_len, ...) at
    ``cache_pos``, in place.  An int start writes one slice; a per-row (b,)
    start writes every row's s tokens at its own slots in one ``index_put_``.

    Slots at or past ``max_len`` are dropped, as the JAX scatter drops them
    (retired batcher rows ride along past the end of the cache).  Such a
    write becomes a copy of the row's last in-range write (the same slot and
    the same value), or, for a row wholly past the end, a rewrite of its
    last slot with the value it holds: no slot takes a value it should not,
    and the order of ``index_put_``'s duplicate writes does not matter."""
    new = new.to(cache.dtype)
    if not isinstance(cache_pos, torch.Tensor):
        cache[:, cache_pos : cache_pos + new.shape[1]] = new
        return cache
    b, s = new.shape[:2]
    last = cache.shape[1] - 1
    tail = (1,) * (new.ndim - 2)
    start = cache_pos.to(device=cache.device, dtype=torch.int64)
    steps = torch.arange(s, device=cache.device)
    slots = torch.clamp(start[:, None] + steps[None, :], max=last)
    src = torch.clamp(torch.minimum(steps[None, :], (last - start)[:, None]), min=0)
    vals = torch.gather(new, 1, src.reshape(b, s, *tail).expand_as(new))
    inside = (start <= last).reshape(b, 1, *tail)
    vals = torch.where(inside, vals, cache[:, last:].expand_as(new))
    rows = torch.arange(b, device=cache.device)[:, None].expand(b, s)
    cache.index_put_((rows, slots), vals)
    return cache


def _is_static_zero(cache_pos: Any) -> bool:
    """True when the caller passed a host scalar zero (a Python or numpy
    int), never for a tensor: a per-row start is no prefill from an empty
    cache, and reading a tensor's value would wait for the card."""
    return (
        isinstance(cache_pos, (int, np.integer))
        and not isinstance(cache_pos, bool)
        and int(cache_pos) == 0
    )


def _flash_prefill_ok(
    a: Attention, s: int, hd: int, q: torch.Tensor, kv_mask: Optional[torch.Tensor]
) -> bool:
    """The gates of the flash-kernel cached prefill, with
    ``CachedAttention.prefill_causal`` (a static zero ``cache_pos``): those
    of the uncached ``Attention.forward`` (no soft-cap, no window, no ALiBi
    and no doge key bias, JAX serving.py:270-271), a multi-token step, and
    no left-padding mask.  The TPU's ``s % 128`` rule is dropped: the
    kernel masks its ragged edge."""
    return (
        s > 1
        and a.logit_softcap is None
        and a.sliding_window is None
        and not a.use_alibi
        and getattr(a, "dt_proj", None) is None
        and kv_mask is None
        and q.is_cuda
        and q.dtype == torch.bfloat16
        and hd in KERNEL_HEAD_DIMS
    )


class CachedAttention:
    """Stands in for a block's ``Attention`` for one cached step: writes the
    step's k/v into the cache at ``cache_pos`` (int or per-row (b,)) and
    attends against it.  ``prefill_causal`` says the cache was empty before
    this step (the caller's ``cache_pos`` was a static zero).  A doge layer
    writes its new keys' bias into ``dyn_cache`` (b, max_len, kv_heads) and
    adds it per kv head (JAX serving.py:250-256, :298-301)."""

    def __init__(
        self,
        inner: Attention,
        k_cache: torch.Tensor,
        v_cache: torch.Tensor,
        cache_pos: Any,
        kv_mask: Optional[torch.Tensor] = None,
        prefill_causal: bool = False,
        dyn_cache: Optional[torch.Tensor] = None,
    ) -> None:
        self.inner = inner
        self.k_cache = k_cache
        self.v_cache = v_cache
        self.cache_pos = cache_pos
        self.kv_mask = kv_mask
        self.prefill_causal = prefill_causal
        self.dyn_cache = dyn_cache

    def __call__(
        self, x: torch.Tensor, attn_mask: Optional[torch.Tensor], positions: torch.Tensor
    ) -> torch.Tensor:
        """``Attention.forward``'s signature; ``attn_mask`` is None here
        (padding is ``kv_mask`` or ragged positions)."""
        a = self.inner
        b, s, _ = x.shape
        max_len = self.k_cache.shape[1]
        q, k_new, v_new = a.project_qkv(x, positions)
        hd = q.shape[-1]
        _cache_write(self.k_cache, k_new, self.cache_pos)
        _cache_write(self.v_cache, v_new, self.cache_pos)
        if self.dyn_cache is not None:
            _cache_write(self.dyn_cache, a.dyn_mask_bias(v_new), self.cache_pos)
        g = a.n_kv_heads
        rep = a.n_heads // g
        scale = a.scale(hd)
        if self.prefill_causal and _flash_prefill_ok(a, s, hd, q, self.kv_mask):
            # the cache beyond the s new tokens is empty, so attention is
            # plain causal attention over the new tokens
            out = flash_attention(
                q.transpose(1, 2), k_new.transpose(1, 2), v_new.transpose(1, 2), scale
            ).transpose(1, 2)
            return a.finish(out.reshape(b, s, -1))
        qg = q.reshape(b, s, g, rep, hd).to(torch.float32)
        logits = torch.einsum("bqgrd,bkgd->bgrqk", qg, self.k_cache.to(torch.float32)) * scale
        if self.dyn_cache is not None:  # doge: each key's bias, per kv head
            logits = logits + self.dyn_cache.transpose(1, 2)[:, :, None, None, :]
        if a.use_alibi:
            # slope * the absolute cache index (JAX serving.py:302-310): a
            # key's slot, which equals its position, or differs from it by
            # a constant of the row that the softmax drops (left padding)
            slopes = a.alibi_slopes(x.device).reshape(g, rep)
            key_idx = torch.arange(max_len, device=x.device, dtype=torch.float32)
            logits = logits + slopes[None, :, :, None, None] * key_idx
        if a.logit_softcap is not None:
            logits = a.logit_softcap * torch.tanh(logits / a.logit_softcap)
        valid = _valid_keys(positions, max_len, self.cache_pos, s, self.kv_mask, a.sliding_window)
        logits = logits.masked_fill(~valid[:, None, None], torch.finfo(torch.float32).min)
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        out = torch.einsum(
            "bgrqk,bkgd->bqgrd", probs.to(torch.float32), self.v_cache.to(torch.float32)
        ).to(x.dtype)
        return a.finish(out.reshape(b, s, -1))


class CachedDiffAttention:
    """Stands in for a block's ``DiffAttention`` for one cached step (JAX
    serving.py:494-571): writes the step's k/v into the cache at
    ``cache_pos`` and runs the differential attention against the cache,
    the causal mask replaced by the absolute-slot validity mask.  It never
    takes flash, as in the JAX package."""

    def __init__(
        self,
        inner: DiffAttention,
        k_cache: torch.Tensor,
        v_cache: torch.Tensor,
        cache_pos: Any,
        kv_mask: Optional[torch.Tensor] = None,
    ) -> None:
        self.inner = inner
        self.k_cache = k_cache
        self.v_cache = v_cache
        self.cache_pos = cache_pos
        self.kv_mask = kv_mask

    def __call__(
        self, x: torch.Tensor, attn_mask: Optional[torch.Tensor], positions: torch.Tensor
    ) -> torch.Tensor:
        a = self.inner
        s = x.shape[1]
        q, k_new, v_new = a.project_qkv(x, positions)
        _cache_write(self.k_cache, k_new, self.cache_pos)
        _cache_write(self.v_cache, v_new, self.cache_pos)
        valid = _valid_keys(positions, self.k_cache.shape[1], self.cache_pos, s, self.kv_mask)
        return a.o_proj(a.attend(q, self.k_cache, self.v_cache, valid))


def _check_absorbable(m: torch.nn.Module, what: str) -> None:
    """Refuse a projection that cannot be absorbed into the latent
    contraction (JAX serving.py:345-366): a biased Linear, a biased factor
    pair and every other module (a fused pair, an int8 ``QuantLinear``).
    A plain ``nn.Linear`` or a bias-free pair of them passes; nothing is
    multiplied."""
    if type(m) is torch.nn.Linear:
        if m.bias is not None:
            raise ValueError(f"{what}: cannot absorb a biased Linear")
        return
    if (type(m) is torch.nn.Sequential and len(m) == 2
            and all(type(f) is torch.nn.Linear for f in m)):
        if any(f.bias is not None for f in m):
            raise ValueError(f"{what}: cannot absorb a biased factor pair")
        return
    raise ValueError(f"{what}: cannot absorb a {type(m).__name__} into the MLA cache contraction")


def _dense_linear_kernel(m: torch.nn.Module, what: str) -> torch.Tensor:
    """The bias-free (in, out) kernel of a projection that
    ``_check_absorbable`` passes: a Linear's weight, or a decomposed factor
    pair's product, computed at each call."""
    _check_absorbable(m, what)
    if type(m) is torch.nn.Linear:
        return m.weight.t()
    return (m[1].weight @ m[0].weight).t()


class CachedMLAttention:
    """Stands in for a block's ``MLAttention`` for one cached step, the
    absorbed form (JAX serving.py:369-462): the cache holds the normed
    latent (b, max_len, kv_lora_rank) and the rotated shared rope head (b,
    max_len, qk_rope_head_dim), nothing per head.  ``kv_b_proj``'s key half
    is folded into the query (q_nope @ W_k per head) and its value half
    applied after the probability-weighted latent sum; the scores equal the
    expanded form's up to rounding order.  It never takes flash."""

    def __init__(
        self,
        inner: MLAttention,
        lat_cache: torch.Tensor,
        pe_cache: torch.Tensor,
        cache_pos: Any,
        kv_mask: Optional[torch.Tensor] = None,
    ) -> None:
        self.inner = inner
        self.lat_cache = lat_cache
        self.pe_cache = pe_cache
        self.cache_pos = cache_pos
        self.kv_mask = kv_mask

    def __call__(
        self, x: torch.Tensor, attn_mask: Optional[torch.Tensor], positions: torch.Tensor
    ) -> torch.Tensor:
        a = self.inner
        b, s, _ = x.shape
        f32 = torch.float32
        q_nope, q_pe, lat, k_pe = a.project(x, positions)
        _cache_write(self.lat_cache, lat, self.cache_pos)
        _cache_write(self.pe_cache, k_pe, self.cache_pos)
        w = _dense_linear_kernel(a.kv_b_proj, "kv_b_proj").reshape(
            a.kv_lora_rank, a.n_heads, a.qk_nope_head_dim + a.v_head_dim)
        w_k, w_v = w[..., : a.qk_nope_head_dim], w[..., a.qk_nope_head_dim:]
        q_eff = torch.einsum("bqhn,lhn->bqhl", q_nope.to(f32), w_k.to(f32)).to(x.dtype)
        lat_cache, pe_cache = self.lat_cache.to(f32), self.pe_cache.to(f32)
        logits = (torch.einsum("bqhl,bkl->bhqk", q_eff.to(f32), lat_cache)
                  + torch.einsum("bqhr,bkr->bhqk", q_pe.to(f32), pe_cache)) * a.scale()
        valid = _valid_keys(positions, self.lat_cache.shape[1], self.cache_pos, s, self.kv_mask)
        logits = logits.masked_fill(~valid[:, None], torch.finfo(f32).min)
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        out_lat = torch.einsum("bhqk,bkl->bqhl", probs.to(f32), lat_cache).to(x.dtype)
        out = torch.einsum("bqhl,lhv->bqhv", out_lat.to(f32), w_v.to(f32)).to(x.dtype)
        return a.o_proj(out.reshape(b, s, -1))


def _model_layers(lm: CausalLM) -> Any:
    return lm.model.layers


def _layer_attention(layer: Any, idx: int) -> Optional[Any]:
    """The layer's cached mixer (``Attention``, ``DiffAttention`` or
    ``MLAttention``), or None for a ``SkipBlock``, which has no cache entry
    (JAX serving.py:644-689).  Raises for anything else, a
    ``PrunedSublayer`` attention included, and for an MLA layer whose
    ``kv_b_proj`` cannot be absorbed, as the JAX package does."""
    if isinstance(layer, SkipBlock):
        return None
    if not isinstance(layer, Block):
        raise ValueError(
            f"KV-cache decoding supports Block layer stacks; layer {idx} is "
            f"{type(layer).__name__}"
        )
    if isinstance(layer.self_attn, MLAttention):
        # refused here, before any step, where kv_b_proj cannot be absorbed
        _check_absorbable(layer.self_attn.kv_b_proj, f"layer {idx} kv_b_proj")
        return layer.self_attn
    if not isinstance(layer.self_attn, (Attention, DiffAttention)):
        raise ValueError(
            f"KV-cache decoding supports Attention, DiffAttention and MLAttention; layer {idx} uses "
            f"{type(layer.self_attn).__name__} (its state caching is not implemented, as in the "
            "JAX package; ROADMAP.md)"
        )
    return layer.self_attn


def check_decode_supported(lm: CausalLM) -> None:
    """Raise with a clear message if ``lm``'s graph cannot be KV-cached."""
    for i, layer in enumerate(_model_layers(lm)):
        _layer_attention(layer, i)


def init_cache(
    lm: CausalLM, batch_size: int, max_len: int, dtype: Optional[torch.dtype] = None
) -> KVCache:
    """Zero-filled per-layer KV cache on the model's device, in ``dtype``
    (the embedding's when None); doge's key-bias tensor is f32, and a cache
    longer than its ``keep_window_size`` is refused (JAX
    serving.py:861-870); an MLA layer's entry is its latent and rope head
    (JAX serving.py:839-845)."""
    emb = lm.model.embed_tokens.weight
    dtype = emb.dtype if dtype is None else dtype
    caches = []
    for i, layer in enumerate(_model_layers(lm)):
        a = _layer_attention(layer, i)
        if a is None:
            caches.append(None)
            continue
        if isinstance(a, MLAttention):
            caches.append(tuple(
                torch.zeros((batch_size, max_len, n), dtype=dtype, device=emb.device)
                for n in (a.kv_lora_rank, a.qk_rope_head_dim)))
            continue
        shape = (batch_size, max_len, a.n_kv_heads, a.head_dim)
        entry = (torch.zeros(shape, dtype=dtype, device=emb.device),
                 torch.zeros(shape, dtype=dtype, device=emb.device))
        if getattr(a, "dt_proj", None) is not None:
            win = a.dyn_mask_keep_window
            if win is not None and max_len > win:
                raise ValueError(
                    f"doge top-k dynamic masking beyond keep_window_size ({win}) is not "
                    f"implemented; cache length {max_len} exceeds it"
                )
            entry += (torch.zeros(shape[:3], dtype=torch.float32, device=emb.device),)
        caches.append(entry)
    return tuple(caches)


def _cached_mixer(mixer: Any, entry: tuple, cache_pos: Any, kv_mask: Optional[torch.Tensor],
                  prefill_causal: bool) -> Any:
    """The cached stand-in of a layer's mixer over its cache entry."""
    if isinstance(mixer, DiffAttention):
        return CachedDiffAttention(mixer, *entry, cache_pos, kv_mask=kv_mask)
    if isinstance(mixer, MLAttention):
        return CachedMLAttention(mixer, *entry, cache_pos, kv_mask=kv_mask)
    k_cache, v_cache, *dyn = entry
    return CachedAttention(mixer, k_cache, v_cache, cache_pos, kv_mask=kv_mask,
                           prefill_causal=prefill_causal, dyn_cache=dyn[0] if dyn else None)


@torch.no_grad()
def forward_with_cache(
    lm: CausalLM,
    input_ids: torch.Tensor,
    caches: KVCache,
    cache_pos: Any,
    *,
    kv_mask: Optional[torch.Tensor] = None,
    last_pos: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, KVCache]:
    """One cached step at absolute positions ``cache_pos + arange(s)``:
    returns ``(logits, caches)``, the caches updated in place.
    ``cache_pos`` is an int or a per-row (b,) tensor (ragged decode);
    ``kv_mask`` (b, max_len) marks valid key slots for left-padded prompts.
    ``last_pos`` (b,): compute the final norm and vocab head on only that
    position of each row, returning (b, 1, vocab) logits."""
    b, s = input_ids.shape
    prefill0 = _is_static_zero(cache_pos)
    positions = _positions(b, s, cache_pos, input_ids.device)
    x = lm.model.embed_inputs(input_ids, positions)
    for i, (layer, entry) in enumerate(zip(_model_layers(lm), caches)):
        mixer = _layer_attention(layer, i)
        want = ("skip" if mixer is None else "mla" if isinstance(mixer, MLAttention)
                else "doge" if getattr(mixer, "dt_proj", None) is not None else "kv")
        if _cache_layout(entry, i) != want:
            raise ValueError(f"layer {i}'s cache entry does not fit its mixer (see init_cache)")
        if mixer is None:  # a SkipBlock
            continue
        x = layer(x, positions=positions,
                  self_attn=_cached_mixer(mixer, entry, cache_pos, kv_mask, prefill0))
    if last_pos is not None:
        idx = torch.as_tensor(last_pos, device=x.device).to(torch.int64)
        x = torch.gather(x, 1, idx[:, None, None].expand(b, 1, x.shape[-1]))
    return lm.head(lm.model.norm(x)), caches


def _sample(
    logits: torch.Tensor,
    greedy: bool,
    temperature: float,
    generator: Optional[torch.Generator],
    top_p: Optional[float] = None,
    top_k: Optional[int] = None,
    min_p: Optional[float] = None,
) -> torch.Tensor:
    """Greedy argmax, or a categorical draw from ``generator`` of the
    temperature-scaled logits filtered by top-k, then top-p, then min-p (HF's
    warper order)."""
    if greedy:
        return torch.argmax(logits, dim=-1)
    scaled = logits.to(torch.float32) / max(temperature, 1e-6)
    neg_inf = torch.tensor(-torch.inf, device=scaled.device)
    if top_k is not None and top_k < scaled.shape[-1]:
        # keep the k largest logits (exact ties with the k-th all survive)
        kth = torch.topk(scaled, top_k, dim=-1).values[..., -1:]
        scaled = torch.where(scaled < kth, neg_inf, scaled)
    if top_p is not None:
        # nucleus: the smallest prefix of the probability-sorted vocab whose
        # mass reaches top_p (the top token always survives); a stable sort,
        # as jnp.argsort, so ties take the same order
        order = torch.argsort(-scaled, dim=-1, stable=True)
        probs = torch.softmax(torch.gather(scaled, -1, order), dim=-1)
        keep_sorted = (torch.cumsum(probs, dim=-1) - probs) < top_p
        keep = torch.empty_like(keep_sorted).scatter_(-1, order, keep_sorted)
        scaled = torch.where(keep, scaled, neg_inf)
    if min_p is not None:
        # tokens at or above min_p times the largest probability
        probs = torch.softmax(scaled, dim=-1)
        keep = probs >= min_p * torch.amax(probs, dim=-1, keepdim=True)
        scaled = torch.where(keep, scaled, neg_inf)
    probs = torch.softmax(scaled, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def _apply_repetition_penalty(
    logits: torch.Tensor, seen: torch.Tensor, penalty: float
) -> torch.Tensor:
    """HF RepetitionPenaltyLogitsProcessor on already-seen tokens (prompt +
    generated): positive scores divide by the penalty, negative multiply."""
    x = logits.to(torch.float32)
    penalized = torch.where(x > 0, x / penalty, x * penalty)
    return torch.where(seen, penalized, x)


def _prompt_lens(prompt_ids: torch.Tensor, prompt_lens: Any) -> torch.Tensor:
    b, s_p = prompt_ids.shape
    if prompt_lens is None:
        return torch.full((b,), s_p, dtype=torch.int64, device=prompt_ids.device)
    return torch.as_tensor(prompt_lens, device=prompt_ids.device).to(torch.int64)


def _check_total(s_p: int, max_new_tokens: int, max_len: Optional[int]) -> int:
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    total = max_len if max_len is not None else s_p + max_new_tokens
    if total < s_p + max_new_tokens:
        raise ValueError(f"max_len {total} < prompt {s_p} + max_new_tokens {max_new_tokens}")
    return total


def _generate_impl(
    lm: CausalLM,
    prompt_ids: torch.Tensor,
    prompt_lens: torch.Tensor,
    caches: KVCache,
    generator: Optional[torch.Generator],
    temperature: float,
    top_p: Optional[float],
    min_p: Optional[float],
    rep_penalty: Optional[float],
    *,
    max_new_tokens: int,
    greedy: bool,
    eos_id: Optional[int],
    ragged: bool,
    top_k: Optional[int] = None,
    keep_logits: bool = False,
) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Tokens (b, max_new_tokens), and with ``keep_logits`` the logits each
    was chosen from (after the repetition penalty, before the temperature).
    Without it no step's logits outlive the step, so memory does not grow
    with the number of new tokens."""
    b, s_p = prompt_ids.shape
    dev = prompt_ids.device
    rows = torch.arange(b, device=dev)
    # prefill computes norm + vocab head on each row's last real position
    logits, caches = forward_with_cache(lm, prompt_ids, caches, 0, last_pos=prompt_lens - 1)
    last = logits[:, 0]
    seen = None
    if rep_penalty is not None:
        # tokens already consumed, per row (the ragged pad tail excluded)
        vocab = last.shape[-1]
        valid = torch.arange(s_p, device=dev)[None, :] < prompt_lens[:, None]
        ids = torch.where(valid, prompt_ids.to(torch.int64), vocab)
        seen = torch.zeros((b, vocab + 1), dtype=torch.bool, device=dev)
        seen = seen.scatter_(1, ids, True)[:, :vocab].contiguous()
        last = _apply_repetition_penalty(last, seen, rep_penalty)
    pos: Any = prompt_lens if ragged else s_p
    tok = _sample(last, greedy, temperature, generator, top_p, top_k, min_p)
    if seen is not None:
        seen[rows, tok] = True
    done = None if eos_id is None else tok == eos_id
    tokens, step_logits = [tok], [last] if keep_logits else None
    for _ in range(max_new_tokens - 1):
        logits, caches = forward_with_cache(lm, tok[:, None], caches, pos)
        last = logits[:, -1]
        if seen is not None:
            last = _apply_repetition_penalty(last, seen, rep_penalty)
        tok = _sample(last, greedy, temperature, generator, top_p, top_k, min_p)
        if done is not None:
            tok = torch.where(done, eos_id, tok)
            done = done | (tok == eos_id)
        if seen is not None:
            seen[rows, tok] = True
        tokens.append(tok)
        if keep_logits:
            step_logits.append(last)
        pos = pos + 1
    return torch.stack(tokens, dim=1), torch.stack(step_logits, dim=1) if keep_logits else None


@torch.no_grad()
def generate(
    lm: CausalLM,
    prompt_ids: torch.Tensor,
    max_new_tokens: int,
    *,
    temperature: float = 0.0,
    generator: Optional[torch.Generator] = None,
    eos_id: Optional[int] = None,
    max_len: Optional[int] = None,
    prompt_lens: Any = None,
    top_p: Optional[float] = None,
    top_k: Optional[int] = None,
    min_p: Optional[float] = None,
    repetition_penalty: Optional[float] = None,
    return_logits: bool = False,
):
    """``max_new_tokens`` continuation tokens (b, max_new_tokens) of a
    prompt batch (b, s_p).  ``temperature=0`` is greedy argmax; otherwise a
    categorical draw from ``generator``, filtered to the ``top_k`` largest
    logits, the ``top_p`` nucleus and/or the tokens at or above ``min_p``
    times the largest probability (HF's warper order).
    ``repetition_penalty`` applies HF's processor to every consumed token
    (prompt + generated, the ragged pad tail excluded) before the argmax or
    the draw.  After a row emits ``eos_id`` the rest of it is ``eos_id``.
    ``max_len`` sizes the cache (at least ``s_p + max_new_tokens``).

    Ragged batches: RIGHT-padded prompts and ``prompt_lens`` (b,).  Each
    row's cache slot equals its token position, so its pad tail is causally
    invisible and overwritten as the row decodes; row i's j-th new token is
    ``out[i, j]`` whatever its prompt's length.  With ``return_logits`` the
    logits each token was chosen from come back too, (b, max_new_tokens,
    vocab): the model's, after the repetition penalty."""
    b, s_p = prompt_ids.shape
    total = _check_total(s_p, max_new_tokens, max_len)
    if temperature < 0.0:
        raise ValueError(f"temperature must be >= 0, got {temperature}")
    if top_k is not None and top_k < 1:
        raise ValueError(f"top_k must be >= 1, got {top_k}")
    if top_p is not None and not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    if min_p is not None and not 0.0 <= min_p <= 1.0:
        raise ValueError(f"min_p must be in [0, 1], got {min_p}")
    if repetition_penalty is not None and repetition_penalty <= 0:
        raise ValueError(f"repetition_penalty must be > 0, got {repetition_penalty}")
    use_rep = repetition_penalty is not None and repetition_penalty != 1.0
    caches = init_cache(lm, b, total)
    out, step_logits = _generate_impl(
        lm, prompt_ids, _prompt_lens(prompt_ids, prompt_lens), caches, generator,
        float(temperature), top_p, min_p, repetition_penalty if use_rep else None,
        max_new_tokens=int(max_new_tokens), greedy=temperature == 0.0, eos_id=eos_id,
        ragged=prompt_lens is not None, top_k=None if top_k is None else int(top_k),
        keep_logits=return_logits,
    )
    if return_logits:
        return out, step_logits
    return out


def _beam_impl(
    lm: CausalLM,
    prompt_ids: torch.Tensor,
    prompt_lens: torch.Tensor,
    caches: KVCache,
    length_penalty: float,
    *,
    max_new_tokens: int,
    num_beams: int,
    eos_id: Optional[int],
    ragged: bool,
) -> tuple[torch.Tensor, torch.Tensor]:
    b, s_p = prompt_ids.shape
    m = num_beams
    dev = prompt_ids.device
    logits, caches = forward_with_cache(lm, prompt_ids, caches, 0, last_pos=prompt_lens - 1)
    last = logits[:, 0]
    pos: Any = prompt_lens.repeat_interleave(m) if ragged else s_p
    vocab = last.shape[-1]
    scores, tok = torch.topk(torch.log_softmax(last.to(torch.float32), dim=-1), m, dim=-1)
    # fan the prefilled caches out over beams, row-major (row i's beams at
    # rows i*m .. i*m+m-1)
    caches = map_caches(caches, lambda c: c.repeat_interleave(m, dim=0))
    done = tok == eos_id if eos_id is not None else torch.zeros_like(tok, dtype=torch.bool)
    hist = torch.zeros((b, m, max_new_tokens), dtype=torch.int64, device=dev)
    hist[:, :, 0] = tok
    row = torch.arange(b, device=dev)[:, None]
    if eos_id is not None:
        # a finished beam survives with its score frozen: its only
        # candidate is another eos at +0 logprob
        frozen = torch.full((vocab,), -torch.inf, device=dev)
        frozen[eos_id] = 0.0
    for t in range(1, max_new_tokens):
        logits, caches = forward_with_cache(lm, tok.reshape(b * m, 1), caches, pos)
        lp = torch.log_softmax(logits[:, -1].to(torch.float32), dim=-1).reshape(b, m, vocab)
        if eos_id is not None:
            lp = torch.where(done[:, :, None], frozen, lp)
        scores, idx = torch.topk((scores[:, :, None] + lp).reshape(b, m * vocab), m, dim=-1)
        beam = idx // vocab
        tok = idx % vocab
        # reorder every beam-indexed carry to the surviving parents: a
        # gather of the batch axis into the cache tensors
        src = (row * m + beam).reshape(-1)
        for i, entry in enumerate(caches):
            for c in layer_cache_tensors(entry, i):
                c.copy_(c.index_select(0, src))
        hist = hist[row, beam]
        hist[:, :, t] = tok
        if eos_id is not None:
            done = done[row, beam] | (tok == eos_id)
        pos = pos + 1
    # rank by length-penalized score: score / len**penalty, len counting
    # tokens up to and including the first eos (max_new_tokens when none)
    if eos_id is not None:
        is_eos = hist == eos_id
        first = torch.argmax(is_eos.to(torch.int32), dim=-1) + 1
        n_new = torch.where(is_eos.any(dim=-1), first, max_new_tokens).to(torch.float32)
    else:
        n_new = torch.full((b, m), float(max_new_tokens), device=dev)
    ranked = scores / n_new ** length_penalty
    best = torch.argmax(ranked, dim=-1)
    rows = torch.arange(b, device=dev)
    return hist[rows, best], ranked[rows, best]


@torch.no_grad()
def generate_beam(
    lm: CausalLM,
    prompt_ids: torch.Tensor,
    max_new_tokens: int,
    *,
    num_beams: int = 4,
    eos_id: Optional[int] = None,
    length_penalty: float = 1.0,
    max_len: Optional[int] = None,
    prompt_lens: Any = None,
    return_scores: bool = False,
):
    """Deterministic beam search: keep the ``num_beams`` highest
    cumulative-logprob continuations per row, decode them as one batch of
    ``b * num_beams`` rows through the KV cache, and return each row's best
    beam, (b, max_new_tokens).  Each step is one cached forward, a
    ``(b, m * vocab)`` top-k, and a batch-axis gather that reorders the
    caches to the surviving parent beams.

    A beam that emits ``eos_id`` is finished: its score freezes and it keeps
    competing at that score while emitting eos.  The final ranking divides
    each beam's cumulative logprob by ``len ** length_penalty`` (len: tokens
    up to and including the first eos).  ``return_scores`` also returns the
    winning length-penalized scores (b,) f32.  Ragged batches as in
    ``generate``.  ``torch.topk``'s order on exact ties is not
    ``lax.top_k``'s."""
    b, s_p = prompt_ids.shape
    if num_beams < 1:
        raise ValueError(f"num_beams must be >= 1, got {num_beams}")
    total = _check_total(s_p, max_new_tokens, max_len)
    caches = init_cache(lm, b, total)
    out, scores = _beam_impl(
        lm, prompt_ids, _prompt_lens(prompt_ids, prompt_lens), caches, float(length_penalty),
        max_new_tokens=int(max_new_tokens), num_beams=int(num_beams), eos_id=eos_id,
        ragged=prompt_lens is not None,
    )
    if return_scores:
        return out, scores
    return out


# ---------------------------------------------------------------------------
# Speculative decoding: the decomposed model drafts, the original verifies.
# ---------------------------------------------------------------------------


def _speculative_impl(
    target: CausalLM,
    draft: CausalLM,
    prompt_ids: torch.Tensor,
    prompt_lens: torch.Tensor,
    t_caches: KVCache,
    d_caches: KVCache,
    *,
    max_new_tokens: int,
    k: int,
    eos_id: Optional[int],
) -> tuple[torch.Tensor, dict]:
    b = prompt_ids.shape[0]
    dev = prompt_ids.device
    pad = eos_id if eos_id is not None else 0
    j_idx = torch.arange(k + 1, device=dev)[None, :]
    out_cols = torch.arange(max_new_tokens, device=dev)[None, None, :]

    # prefill both models on the prompt; the first emitted token is the
    # target's greedy pick (so output == target-only greedy from token 0)
    logits, t_caches = forward_with_cache(target, prompt_ids, t_caches, 0, last_pos=prompt_lens - 1)
    # the draft's prefill logits are never read: head on one row only
    forward_with_cache(draft, prompt_ids, d_caches, 0, last_pos=prompt_lens - 1)
    cur = torch.argmax(logits[:, 0], dim=-1)
    out = torch.full((b, max_new_tokens), pad, dtype=torch.int64, device=dev)
    out[:, 0] = cur
    n_out = torch.ones((b,), dtype=torch.int64, device=dev)
    done = n_out >= max_new_tokens
    if eos_id is not None:
        done = done | (cur == eos_id)
    # invariant: ``cur`` is the row's last emitted token, at position pos-1,
    # not yet written to either cache; each round's chunk starts with cur,
    # so slot pos-1 (and any stale slots beyond, from rejected drafts) is
    # rewritten before it is ever read
    pos = prompt_lens + 1
    rounds = 0
    drafted = torch.zeros((), dtype=torch.int64, device=dev)
    accepted = torch.zeros((), dtype=torch.int64, device=dev)
    # the loop's condition is the one host read of a round
    while bool((~done).any()):
        rounds += 1
        # the draft proposes k greedy tokens from cur; it runs k+1 steps so
        # that its own cache also receives d_k (on full acceptance the next
        # round starts past it); the k+1-th proposal is discarded
        tok, p, proposals = cur, pos - 1, []
        for _ in range(k + 1):
            lg, _ = forward_with_cache(draft, tok[:, None], d_caches, p)
            tok = torch.argmax(lg[:, -1], dim=-1)
            proposals.append(tok)
            p = p + 1
        drafts = torch.stack(proposals[:k], dim=1)  # (b, k)
        # one target pass verifies all k drafts and yields the bonus token
        chunk = torch.cat([cur[:, None], drafts], dim=1)
        lg, _ = forward_with_cache(target, chunk, t_caches, pos - 1)
        t_pred = torch.argmax(lg, dim=-1)  # (b, k+1)
        # longest accepted prefix; emit n drafts + the target's pick at the
        # first divergence (or after all k if none diverged)
        n = torch.cumprod((drafts == t_pred[:, :k]).to(torch.int64), dim=1).sum(dim=1)
        bonus = torch.gather(t_pred, 1, n[:, None])[:, 0]
        drafts_pad = torch.cat([drafts, torch.zeros_like(drafts[:, :1])], dim=1)
        emit = torch.where(j_idx < n[:, None], drafts_pad, bonus[:, None])
        m = n + 1
        if eos_id is not None:  # cut at the first emitted eos
            hit = (emit == eos_id) & (j_idx < m[:, None])
            first = torch.where(hit, j_idx, k + 1).amin(dim=1)
            m = torch.where(hit.any(dim=1), first + 1, m)
        m = torch.minimum(m, max_new_tokens - n_out)
        m = torch.where(done, 0, m)
        cols = n_out[:, None] + j_idx  # (b, k+1) output columns
        write = (j_idx < m[:, None]) & (cols < max_new_tokens)
        onehot = (cols[:, :, None] == out_cols) & write[:, :, None]
        written = (onehot.to(torch.int64) * emit[:, :, None]).sum(dim=1)
        out = torch.where(onehot.any(dim=1), written, out)
        last_emit = torch.gather(emit, 1, torch.clamp(m - 1, min=0)[:, None])[:, 0]
        cur = torch.where(m > 0, last_emit, cur)
        pos = pos + m
        n_out = n_out + m
        done = done | (n_out >= max_new_tokens)
        if eos_id is not None:
            done = done | ((emit == eos_id) & (j_idx < m[:, None])).any(dim=1)
        drafted += (m > 0).sum() * k
        # count only drafts actually emitted: an eos cut or the budget
        # truncates the n accepted drafts to min(n, m)
        accepted += torch.minimum(n, m).sum()
    return out, {"rounds": rounds, "drafted": drafted, "accepted": accepted}


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _device_of(lm: CausalLM) -> torch.device:
    return lm.model.embed_tokens.weight.device


@torch.no_grad()
def measure_decode_step_costs(
    target: CausalLM,
    draft: CausalLM,
    batch_size: int,
    *,
    k: int = 4,
    max_len: int = 256,
    iters: int = 32,
) -> dict:
    """The three step costs a speculative round is made of, on the model's
    device at the deployment's batch size: the target's width-1 decode
    step, its width-(k+1) verify step, and the draft's width-1 step.  Each
    is the best of two timed runs of ``iters`` cached steps (the Python
    loop ``generate`` runs) after a warm-up run, each run ending in
    ``torch.cuda.synchronize`` on the card."""

    def timed(lm: CausalLM, width: int) -> float:
        dev = _device_of(lm)
        caches = init_cache(lm, batch_size, max_len)
        tok = torch.zeros((batch_size, width), dtype=torch.int64, device=dev)
        n = min(iters, max(max_len // width - 1, 1))

        def run() -> None:
            for i in range(n):
                forward_with_cache(lm, tok, caches, i * width)
            _synchronize(dev)

        run()
        best = float("inf")
        for _ in range(2):
            t0 = time.perf_counter()
            run()
            best = min(best, time.perf_counter() - t0)
        return best / n

    return {
        "target_step_s": timed(target, 1),
        "target_verify_s": timed(target, k + 1),
        "draft_step_s": timed(draft, 1),
    }


def estimate_speculative_speedup(
    target: CausalLM,
    draft: CausalLM,
    batch_size: int,
    *,
    k: int = 4,
    acceptance: float = 0.9,
    max_len: int = 256,
    costs: Optional[dict] = None,
) -> dict:
    """Expected speculative-vs-dense throughput ratio from measured step
    costs (``measure_decode_step_costs``, or ``costs``) and a per-token
    acceptance rate.  One round costs ``(k+1) * draft_step + verify_step``
    and emits ``1 + sum_{i=1..k} a^i`` expected tokens against
    ``target_step`` a token for plain decode.  Pass a measured acceptance
    (``measure_draft_acceptance``): it depends on the batch and prompts."""
    if costs is None:
        costs = measure_decode_step_costs(target, draft, batch_size, k=k, max_len=max_len)
    exp_tokens = 1.0 + sum(acceptance ** i for i in range(1, k + 1))
    round_s = (k + 1) * costs["draft_step_s"] + costs["target_verify_s"]
    dense_s = exp_tokens * costs["target_step_s"]
    return {
        **{kk: round(v, 6) for kk, v in costs.items()},
        "k": k,
        "assumed_acceptance": acceptance,
        "expected_tokens_per_round": round(exp_tokens, 3),
        "expected_speedup": round(dense_s / round_s, 3),
    }


def measure_draft_acceptance(
    target: CausalLM,
    draft: CausalLM,
    prompt_ids: torch.Tensor,
    *,
    k: int = 4,
    probe_tokens: int = 32,
    eos_id: Optional[int] = None,
    prompt_lens: Any = None,
) -> dict:
    """The per-token draft acceptance rate, measured by a short run of the
    real speculative loop on the actual prompts: ``{"acceptance",
    "drafted", "accepted", "probe_tokens"}``; ``acceptance`` is 0.0 when
    nothing was drafted (the conservative reading)."""
    _, stats = generate_speculative(
        target, draft, prompt_ids, max(int(probe_tokens), k + 1), k=k, eos_id=eos_id,
        prompt_lens=prompt_lens, return_stats=True,
    )
    drafted, accepted = stats["drafted"], stats["accepted"]
    return {
        "acceptance": round(accepted / drafted, 4) if drafted else 0.0,
        "drafted": drafted,
        "accepted": accepted,
        "probe_tokens": int(probe_tokens),
    }


def measure_speculative_speedup_probe(
    target: CausalLM,
    draft: CausalLM,
    prompt_ids: torch.Tensor,
    *,
    k: int = 4,
    probe_tokens: int = 32,
    eos_id: Optional[int] = None,
    prompt_lens: Any = None,
) -> dict:
    """The speculative-vs-dense throughput ratio, measured: the real
    speculative loop and plain ``generate`` on the actual prompts, each at
    two probe lengths, each length the best of two timed runs after a warm
    one (every window ends in ``torch.cuda.synchronize`` on the card).

    The gate ratio is ``min(slope_ratio, full_time_ratio)``: the slope
    ``dt / dtokens`` cancels fixed costs (the speculative arm prefills two
    caches), but differencing amplifies timing noise; the full-time ratio
    is biased conservative by the double prefill.  The minimum keeps the
    gate's failure mode "refused a marginal win", never "steered into a
    loss"."""
    dev = prompt_ids.device
    pt_hi = max(int(probe_tokens), 2 * (k + 1))
    pt_lo = max(pt_hi // 4, k + 1)

    def timed(fn):
        fn()
        best, out = float("inf"), None
        for _ in range(2):
            t0 = time.perf_counter()
            out = fn()
            _synchronize(dev)
            best = min(best, time.perf_counter() - t0)
        return best, out

    def spec_arm(n):
        def run():
            return generate_speculative(
                target, draft, prompt_ids, n, k=k, eos_id=eos_id, prompt_lens=prompt_lens,
                return_stats=True,
            )[1]

        return run

    def dense_arm(n):
        def run():
            generate(target, prompt_ids, n, eos_id=eos_id, prompt_lens=prompt_lens)

        return run

    spec_hi_s, st = timed(spec_arm(pt_hi))
    spec_lo_s, _ = timed(spec_arm(pt_lo))
    dense_hi_s, _ = timed(dense_arm(pt_hi))
    dense_lo_s, _ = timed(dense_arm(pt_lo))

    dn = pt_hi - pt_lo
    spec_slope = (spec_hi_s - spec_lo_s) / dn
    dense_slope = (dense_hi_s - dense_lo_s) / dn
    full_ratio = dense_hi_s / spec_hi_s
    if spec_slope > 0 and dense_slope > 0:
        slope_ratio = dense_slope / spec_slope
    else:  # timing noise produced a non-positive slope
        slope_ratio = full_ratio
    drafted, accepted = st["drafted"], st["accepted"]
    return {
        "measured_speedup": round(min(slope_ratio, full_ratio), 3),
        "slope_speedup": round(slope_ratio, 3),
        "full_time_speedup": round(full_ratio, 3),
        "acceptance": round(accepted / drafted, 4) if drafted else 0.0,
        "probe_tokens": pt_hi,
        "speculative_tok_slope_s": round(max(spec_slope, 0.0), 6),
        "dense_tok_slope_s": round(max(dense_slope, 0.0), 6),
        "speculative_probe_s": round(spec_hi_s, 4),
        "dense_probe_s": round(dense_hi_s, 4),
    }


@torch.no_grad()
def generate_speculative(
    target: CausalLM,
    draft: CausalLM,
    prompt_ids: torch.Tensor,
    max_new_tokens: int,
    *,
    k: int = 4,
    eos_id: Optional[int] = None,
    prompt_lens: Any = None,
    return_stats: bool = False,
    auto_gate: bool = False,
    min_estimated_speedup: float = 1.0,
    costs: Optional[dict] = None,
    acceptance: Optional[float] = None,
    probe_tokens: int = 32,
):
    """Greedy speculative decoding: ``draft`` (typically the decomposed
    model) proposes ``k`` tokens a round; ``target`` (the original) verifies
    them in one cached forward and contributes the token at the first
    divergence.  The output is exactly ``generate(target, ...)``'s greedy
    continuation (eos-filled after a row's eos).  Per-row positions reuse
    ragged decode's slot == position rule, so rejected drafts' slots are
    rewritten before they are read; ragged prompts via ``prompt_lens``.
    ``return_stats`` also returns rounds / drafted / accepted.

    ``auto_gate`` measures whether drafting pays before committing: by
    default it times the real loop against plain decode
    (``measure_speculative_speedup_probe``) and falls back to plain
    ``generate(target, ...)`` when the ratio is below
    ``min_estimated_speedup``; with ``costs`` and/or ``acceptance`` given it
    uses the analytic ``estimate_speculative_speedup`` instead (a missing
    acceptance is measured by ``measure_draft_acceptance``).  The stats then
    carry a ``"gate"`` entry recording the decision and its numbers."""
    b, s_p = prompt_ids.shape
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    if auto_gate:
        probe_n = min(int(probe_tokens), int(max_new_tokens))
        if costs is None and acceptance is None:
            probe = measure_speculative_speedup_probe(
                target, draft, prompt_ids, k=k, probe_tokens=probe_n, eos_id=eos_id,
                prompt_lens=prompt_lens,
            )
            est = {
                "expected_speedup": probe["measured_speedup"],
                "basis": "measured_probe_throughput",
                "acceptance_source": "measured_probe",
                "probe": probe,
                "k": k,
            }
        else:
            if acceptance is None:
                dprobe = measure_draft_acceptance(
                    target, draft, prompt_ids, k=k, probe_tokens=probe_n, eos_id=eos_id,
                    prompt_lens=prompt_lens,
                )
                acc_val, acc_source = dprobe["acceptance"], "measured_probe"
            else:
                dprobe, acc_val, acc_source = None, float(acceptance), "caller"
            est = estimate_speculative_speedup(
                target, draft, b, k=k, acceptance=acc_val, costs=costs
            )
            est["basis"] = "analytic_step_costs"
            est["acceptance_source"] = acc_source
            if dprobe is not None:
                est["probe"] = dprobe
        if est["expected_speedup"] < min_estimated_speedup:
            logger.warning(
                "speculative auto-gate: expected speedup %.2fx < %.2fx (basis=%s, batch %d) "
                "- falling back to plain generate(target)",
                est["expected_speedup"], min_estimated_speedup, est["basis"], b,
            )
            out = generate(target, prompt_ids, max_new_tokens, eos_id=eos_id,
                           prompt_lens=prompt_lens)
            if return_stats:
                return out, {"rounds": 0, "drafted": 0, "accepted": 0,
                             "gate": {"used_speculative": False, **est}}
            return out
    total = s_p + max_new_tokens + k + 1  # rounds may overshoot by < k
    t_caches = init_cache(target, b, total)
    d_caches = init_cache(draft, b, total)
    out, stats = _speculative_impl(
        target, draft, prompt_ids, _prompt_lens(prompt_ids, prompt_lens), t_caches, d_caches,
        max_new_tokens=int(max_new_tokens), k=int(k), eos_id=eos_id,
    )
    if return_stats:
        host_stats = {kk: int(v) for kk, v in stats.items()}
        if auto_gate:
            host_stats["gate"] = {"used_speculative": True, **est}
        return out, host_stats
    return out
