"""Continuous batching over a fixed slot pool.

Counterpart of ``ptdeco_tpu/serving_batcher.py``, built out of the cached
forward of ``serving.py``:

* a fixed pool of ``n_slots`` batch rows, each owning one row of a KV cache
  ``(n_slots, max_len, ...)``: "continuous" means slot reuse, not a growing
  batch;
* admission is a batched prefill per bucket size: every request admitted
  this round whose prompt pads to the same bucket runs as one
  ``forward_with_cache`` into a fresh bucket-length cache at ``cache_pos=0``
  (so it takes the flash kernel on the card), and the new cache rows are
  copied into their pool slots.  A freed slot needs no clearing: the
  per-row position mask (``serving._valid_keys``) hides every slot beyond
  the new request's fill;
* decode is ``decode_chunk`` ragged per-row-position steps over the whole
  pool (cache slot == token position per row).  Retired and empty rows ride
  along frozen; writes past ``max_len`` are dropped (``serving._cache_write``);
* the host reads the card once per admission round (the first tokens of
  every group together) and once per decode chunk (positions, last tokens
  and the chunk's tokens together).

Unlike the JAX engine, an admission group is prefilled at its own row count
rather than padded to ``n_slots`` rows: PyTorch compiles nothing per shape.

Per-request exactness: each pool row's attention is masked to its own
tokens, so a request's greedy continuation equals ``serving.generate`` on
that prompt alone.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Optional

import numpy as np
import torch

from .serving import (
    KVCache,
    _sample,
    check_decode_supported,
    forward_with_cache,
    init_cache,
    layer_cache_tensors,
    map_caches,
)

__all__ = ["ContinuousBatcher", "FinishedRequest"]


@dataclasses.dataclass(frozen=True)
class FinishedRequest:
    """One completed request: generated ids (eos included if hit) and why
    it stopped ('eos' or 'length')."""

    req_id: int
    tokens: np.ndarray  # (n_generated,) int32
    finish_reason: str


@dataclasses.dataclass
class _Slot:
    req_id: int
    budget: int  # max_new_tokens for this request
    generated: list  # python ints accumulated so far
    done: bool = False


def _prefill_impl(
    lm: Any,
    rows: torch.Tensor,
    lens: torch.Tensor,
    slots: torch.Tensor,
    caches: KVCache,
    generator: Optional[torch.Generator],
    temperature: float,
    top_p: Optional[float],
    min_p: Optional[float],
    *,
    bucket: int,
    greedy: bool,
    top_k: Optional[int],
) -> torch.Tensor:
    """Prefill one admission group (``rows`` (g, bucket), right-padded) into
    a fresh bucket-length cache, sample each row's first token from its last
    real position, and copy the new cache rows into pool rows ``slots``
    (g,).  Only the first ``bucket`` slots of a pool row are written; its
    tail keeps stale values, which the per-row position mask hides."""
    fresh = map_caches(caches, lambda c: torch.zeros(
        (rows.shape[0], bucket) + c.shape[2:], dtype=c.dtype, device=c.device))
    logits, fresh = forward_with_cache(lm, rows, fresh, 0, last_pos=lens - 1)
    toks = _sample(logits[:, 0], greedy, temperature, generator, top_p, top_k, min_p)
    for i, (pool_layer, new_layer) in enumerate(zip(caches, fresh)):
        for pool, new in zip(layer_cache_tensors(pool_layer, i), layer_cache_tensors(new_layer, i)):
            pool[slots, :bucket] = new
    return toks


def _decode_chunk_impl(
    lm: Any,
    caches: KVCache,
    pos: torch.Tensor,
    tok: torch.Tensor,
    frozen: torch.Tensor,
    generator: Optional[torch.Generator],
    temperature: float,
    top_p: Optional[float],
    min_p: Optional[float],
    *,
    chunk: int,
    greedy: bool,
    eos_id: Optional[int],
    top_k: Optional[int],
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``chunk`` ragged decode steps over the whole pool.  Frozen rows keep
    feeding their last token and never advance their position; rows that
    hit ``eos_id`` mid-chunk freeze, as ``serving.generate``'s eos fill.
    Returns (pos, tok, frozen, tokens (n_slots, chunk))."""
    toks = []
    for _ in range(chunk):
        logits, caches = forward_with_cache(lm, tok[:, None], caches, pos)
        nxt = _sample(logits[:, -1], greedy, temperature, generator, top_p, top_k, min_p)
        nxt = torch.where(frozen, tok, nxt)
        pos = torch.where(frozen, pos, pos + 1)
        if eos_id is not None:
            frozen = frozen | (nxt == eos_id)
        toks.append(nxt)
        tok = nxt
    return pos, tok, frozen, torch.stack(toks, dim=1)


class ContinuousBatcher:
    """Slot-pool continuous batching engine (see the module docstring).

    Parameters
    ----------
    lm: the (possibly decomposed / int8-quantized) causal LM.
    n_slots: pool size, the decode batch, fixed for the engine's life.
    max_len: cache length per slot; every request must satisfy
        ``prompt_len + max_new_tokens <= max_len``.
    eos_id: stop token (optional).
    temperature/top_p/top_k/min_p: sampling knobs, engine-wide
        (``serving.generate`` semantics; 0 temperature = greedy).
    generator: the ``torch.Generator`` samples are drawn from (on the
        model's device); a fresh one seeded 0 when None.
    decode_chunk: decode steps per host round-trip.  A finished request
        retires at the end of its chunk, so up to ``decode_chunk - 1`` steps
        of pool work are wasted past an eos.
    prefill_buckets: ascending prompt-padding sizes; defaults to powers of
        two from 16 up to ``max_len``.
    """

    def __init__(
        self,
        lm: Any,
        n_slots: int,
        max_len: int,
        *,
        eos_id: Optional[int] = None,
        temperature: float = 0.0,
        top_p: Optional[float] = None,
        top_k: Optional[int] = None,
        min_p: Optional[float] = None,
        generator: Optional[torch.Generator] = None,
        decode_chunk: int = 8,
        prefill_buckets: Optional[tuple] = None,
    ) -> None:
        check_decode_supported(lm)
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        if decode_chunk < 1:
            raise ValueError(f"decode_chunk must be >= 1, got {decode_chunk}")
        if temperature < 0.0:
            raise ValueError(f"temperature must be >= 0, got {temperature}")
        if top_p is not None and not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        if top_k is not None and top_k < 1:
            raise ValueError(f"top_k must be >= 1, got {top_k}")
        if min_p is not None and not 0.0 <= min_p <= 1.0:
            raise ValueError(f"min_p must be in [0, 1], got {min_p}")
        self._lm = lm
        self._n_slots = n_slots
        self._max_len = max_len
        self._eos_id = eos_id
        self._chunk = int(decode_chunk)
        if prefill_buckets is None:
            buckets = []
            b = 16
            while b < max_len:
                buckets.append(b)
                b *= 2
            buckets.append(max_len)
            prefill_buckets = tuple(buckets)
        self._buckets = tuple(sorted(set(int(b) for b in prefill_buckets)))
        if self._buckets[-1] > max_len:
            raise ValueError(f"prefill bucket {self._buckets[-1]} exceeds max_len {max_len}")
        self._greedy = temperature == 0.0
        self._sampling = (float(temperature), top_p, min_p)
        self._top_k = None if top_k is None else int(top_k)
        self._device = lm.model.embed_tokens.weight.device
        if generator is None:
            generator = torch.Generator(device=self._device).manual_seed(0)
        self._generator = generator
        # only the cache pool lives on the card between calls; pos / tok
        # are host numpy, sent with each chunk
        self._caches = init_cache(lm, n_slots, max_len)
        self._pos = np.zeros((n_slots,), np.int64)
        self._tok = np.zeros((n_slots,), np.int64)
        self._slots: list[Optional[_Slot]] = [None] * n_slots
        self._queue: list[tuple[int, np.ndarray, int]] = []
        self._finished: list[FinishedRequest] = []
        self._ids = itertools.count()

    # ------------------------------------------------------------------
    @property
    def has_work(self) -> bool:
        return bool(self._queue) or any(s is not None for s in self._slots)

    @property
    def n_active(self) -> int:
        return sum(s is not None for s in self._slots)

    def submit(self, prompt_ids: Any, max_new_tokens: int, req_id: Optional[int] = None) -> int:
        """Queue one request (1-D prompt of token ids).  Returns its id."""
        prompt = np.asarray(prompt_ids, np.int64).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if prompt.size + max_new_tokens > self._max_len:
            raise ValueError(
                f"prompt {prompt.size} + max_new_tokens {max_new_tokens} exceeds max_len "
                f"{self._max_len}"
            )
        if prompt.size > self._buckets[-1]:
            # fail at submission: a later bucket lookup would raise after the
            # request left the queue
            raise ValueError(
                f"prompt length {prompt.size} exceeds largest prefill bucket {self._buckets[-1]}"
            )
        if req_id is None:
            rid = next(self._ids)
        else:
            rid = req_id
            live = {s.req_id for s in self._slots if s is not None}
            queued = {q[0] for q in self._queue}
            if rid in live or rid in queued:
                raise ValueError(f"req_id {rid} duplicates a live/queued request")
            # keep auto-generated ids from colliding with this one later
            if isinstance(rid, int):
                self._ids = itertools.count(max(rid + 1, next(self._ids)))
        self._queue.append((rid, prompt, int(max_new_tokens)))
        return rid

    # ------------------------------------------------------------------
    def _bucket_for(self, n: int) -> int:
        for b in self._buckets:
            if b >= n:
                return b
        raise ValueError(f"prompt length {n} exceeds largest bucket {self._buckets[-1]}")

    def _admit(self) -> None:
        """Prefill queued requests into free slots, one batched prefill per
        bucket size; the first tokens of all groups are read together."""
        by_bucket: dict[int, list[tuple[int, np.ndarray]]] = {}
        for i in range(self._n_slots):
            if self._slots[i] is not None or not self._queue:
                continue
            rid, prompt, budget = self._queue.pop(0)
            by_bucket.setdefault(self._bucket_for(prompt.size), []).append((i, prompt))
            self._pos[i] = prompt.size
            self._slots[i] = _Slot(req_id=rid, budget=budget, generated=[])
        if not by_bucket:
            return
        pending: list[tuple[list[int], torch.Tensor]] = []
        for bucket, group in by_bucket.items():
            rows = np.zeros((len(group), bucket), np.int64)
            lens = np.zeros((len(group),), np.int64)
            for r, (_, prompt) in enumerate(group):
                rows[r, : prompt.size] = prompt
                lens[r] = prompt.size
            slot_ids = [i for i, _ in group]
            toks = _prefill_impl(
                self._lm,
                torch.from_numpy(rows).to(self._device),
                torch.from_numpy(lens).to(self._device),
                torch.tensor(slot_ids, device=self._device),
                self._caches,
                self._generator,
                *self._sampling,
                bucket=bucket,
                greedy=self._greedy,
                top_k=self._top_k,
            )
            pending.append((slot_ids, toks))
        firsts = torch.cat([t for _, t in pending]).cpu().numpy()
        at = 0
        for slot_ids, _ in pending:
            for i in slot_ids:
                first = int(firsts[at])
                at += 1
                self._tok[i] = first
                s = self._slots[i]
                s.generated.append(first)
                if self._eos_id is not None and first == self._eos_id:
                    s.done = True
                self._maybe_retire(i)

    def _maybe_retire(self, i: int) -> None:
        s = self._slots[i]
        if s is None:
            return
        if s.done or len(s.generated) >= s.budget:
            self._finished.append(
                FinishedRequest(
                    req_id=s.req_id,
                    tokens=np.asarray(s.generated, np.int32),
                    finish_reason="eos" if s.done else "length",
                )
            )
            self._slots[i] = None

    @torch.no_grad()
    def step(self) -> list[FinishedRequest]:
        """Admit waiting requests, run one decode chunk over the pool, and
        return the requests that finished this round."""
        self._admit()
        if all(s is None for s in self._slots):
            out, self._finished = self._finished, []
            return out
        frozen = torch.tensor([s is None or s.done for s in self._slots], device=self._device)
        pos, tok, _, toks = _decode_chunk_impl(
            self._lm,
            self._caches,
            torch.from_numpy(self._pos).to(self._device),
            torch.from_numpy(self._tok).to(self._device),
            frozen,
            self._generator,
            *self._sampling,
            chunk=self._chunk,
            greedy=self._greedy,
            eos_id=self._eos_id,
            top_k=self._top_k,
        )
        # the one host read of a chunk: positions, last tokens and tokens
        both = torch.cat([pos[:, None], tok[:, None], toks], dim=1).cpu().numpy()
        self._pos, self._tok, toks_np = both[:, 0].copy(), both[:, 1].copy(), both[:, 2:]
        for i, s in enumerate(self._slots):
            if s is None or s.done:
                continue
            for t in toks_np[i]:
                if len(s.generated) >= s.budget:
                    break
                s.generated.append(int(t))
                if self._eos_id is not None and t == self._eos_id:
                    s.done = True
                    break
            self._maybe_retire(i)
        out, self._finished = self._finished, []
        return out

    def run(self) -> list[FinishedRequest]:
        """Drive ``step`` until every queued request has finished."""
        done: list[FinishedRequest] = []
        while self.has_work:
            done.extend(self.step())
        return done
