"""LLM calibration and evaluation data pipelines.

Counterpart of ``apps/trainer_llm/datasets_hf.py``, row for row:

  * ``prepare_dataloader_v1``: sample-then-concatenate to max_seqlen; used
    for perplexity, training and test data;
  * ``prepare_dataloader_v2``: greedy token-buffer packing with separator
    tokens (the native packer, ``ptdeco_tpu_torch/data/packer.cc``, or its
    Python loop); used for decomposition calibration.

Both draw from ``numpy.random.RandomState`` with the JAX trainer's seeds,
so the rows and their order are the JAX loaders'; batches are dicts of
torch tensors ``{"input_ids", "attention_mask", "labels"}`` (int64) made
from those numpy rows.  A local ``.json``/``.jsonl`` (optionally ``.gz``)
file is read with ``json`` and ``gzip``; a named HF dataset needs the
``datasets`` package.
"""

from __future__ import annotations

import gzip
import json
import logging
import subprocess
from typing import Any, Iterator, Sequence

import numpy as np
import torch

__all__ = [
    "BatchIterator",
    "get_dataset",
    "make_synthetic_loader",
    "normalize_separator",
    "prepare_dataloader_v1",
    "prepare_dataloader_v2",
]

logger = logging.getLogger(__name__)

_DS_PROPERTIES: dict[str, dict[str, Any]] = {
    "wikitext2": {"path": "wikitext", "config_name": "wikitext-2-raw-v1"},
    "alpaca": {"path": "tatsu-lab/alpaca", "data_column": "text"},
}


def _is_json_fname(fname: str) -> bool:
    return fname.endswith((".json", ".json.gz", ".jsonl", ".jsonl.gz"))


def _read_json_records(path: str) -> list[dict[str, Any]]:
    """The records of a JSON file: a list of objects, or JSON lines (one
    object a line, blank lines skipped)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt", encoding="utf-8") as f:
        text = f.read()
    try:
        doc = json.loads(text)
    except json.JSONDecodeError:
        return [json.loads(line) for line in text.splitlines() if line.strip()]
    return doc if isinstance(doc, list) else [doc]


def get_dataset(dataset_and_split_name: str) -> list[str]:
    """The non-empty texts of a JSON file's ``text`` field, in file order,
    or of a named ``name.split`` HF dataset (through ``datasets``)."""
    if _is_json_fname(dataset_and_split_name):
        return [t for t in (r.get("text") for r in _read_json_records(dataset_and_split_name)) if t]

    dataset_name, split_name = dataset_and_split_name.split(".")
    if dataset_name not in _DS_PROPERTIES:
        raise ValueError(f"Unknown dataset {dataset_name}, available: {set(_DS_PROPERTIES)}")
    try:
        import datasets
    except ImportError as e:
        raise ImportError(
            f"{dataset_and_split_name!r} is a named HF dataset and needs the `datasets` package "
            "(and its files); give a local .json/.jsonl file of {{\"text\": ...}} records instead"
        ) from e
    props = _DS_PROPERTIES[dataset_name]
    ds = datasets.load_dataset(props["path"], name=props.get("config_name"))
    if dataset_name == "alpaca":
        if split_name == "full":
            split_name = "train"
        else:
            ds = ds["train"].train_test_split(test_size=0.2, seed=42)
            temp = ds.pop("test").train_test_split(test_size=0.5, seed=42)
            ds["test"] = temp["train"]
            ds["validation"] = temp["test"]
    col = props.get("data_column", "text")
    return [t for t in ds[split_name][col] if t]


def normalize_separator(separator: str, tokenizer: Any) -> str:
    allowed = {"\n\n", " ", "", "eos"}
    if separator not in allowed:
        raise ValueError(f"{separator=} not in {allowed=}")
    if separator == "eos":
        return tokenizer.eos_token
    return separator


def _batch(ids: np.ndarray, mask: np.ndarray) -> dict[str, torch.Tensor]:
    ids_t = torch.from_numpy(ids.astype(np.int64))
    return {
        "input_ids": ids_t,
        "attention_mask": torch.from_numpy(mask.astype(np.int64)),
        "labels": ids_t.clone(),
    }


class BatchIterator:
    """Infinite shuffling iterator over fixed-size batches."""

    def __init__(
        self,
        sequences: np.ndarray,  # (n, max_seqlen) int32
        masks: np.ndarray,
        batch_size: int,
        seed: int = 42,
        loop: bool = True,
    ) -> None:
        self.sequences = sequences
        self.masks = masks
        self.batch_size = batch_size
        self.rng = np.random.RandomState(seed)
        self.loop = loop
        if batch_size > len(sequences):
            raise ValueError(
                f"batch_size {batch_size} > {len(sequences)} available "
                "sequences — raise nsamples or lower batch_size"
            )
        self._order = self.rng.permutation(len(sequences))
        self._pos = 0

    def __len__(self) -> int:
        return len(self.sequences) // self.batch_size

    def __iter__(self) -> Iterator[dict[str, torch.Tensor]]:
        return self

    def __next__(self) -> dict[str, torch.Tensor]:
        if self._pos + self.batch_size > len(self._order):
            if not self.loop:
                raise StopIteration
            self._order = self.rng.permutation(len(self.sequences))
            self._pos = 0
        idx = self._order[self._pos : self._pos + self.batch_size]
        self._pos += self.batch_size
        return _batch(self.sequences[idx], self.masks[idx])

    def one_epoch(self, shuffle: bool = False) -> Iterator[dict[str, torch.Tensor]]:
        """Deterministic order by default (evals); ``shuffle=True`` draws a
        fresh permutation per call (training epochs)."""
        if shuffle:
            order = self.rng.permutation(len(self.sequences))
        else:
            order = np.arange(len(self.sequences))
        for i in range(0, len(order) - self.batch_size + 1, self.batch_size):
            idx = order[i : i + self.batch_size]
            yield _batch(self.sequences[idx], self.masks[idx])


def prepare_dataloader_v1(
    *,
    dataset: Sequence[str],
    tokenizer: Any,
    separator: str,
    max_seqlen: int = 2048,
    batch_size: int = 1,
    nsamples: int = 128,
    seed: int = 42,
) -> BatchIterator:
    """Sample-then-concatenate loader: draw random starting texts,
    concatenate with the separator until max_seqlen tokens, truncate."""
    separator = normalize_separator(separator, tokenizer)
    texts = [t for t in dataset if len(t) > 0]
    rng = np.random.RandomState(seed)
    sep_ids = tokenizer(separator, add_special_tokens=False)["input_ids"]

    indices = list(range(len(texts)))
    rows = []
    while len(rows) < nsamples and indices:
        start = int(rng.randint(0, len(indices)))
        idx = start
        toks: list[int] = []
        while len(toks) < max_seqlen and idx < len(indices):
            ids = tokenizer(texts[indices[idx]], add_special_tokens=False)["input_ids"]
            toks += (sep_ids if toks else []) + ids
            idx += 1
        indices = indices[:start] + indices[idx:]
        if len(toks) >= max_seqlen:
            rows.append(toks[:max_seqlen])
    logger.info(f"v1 dataloader - created dataset of size {len(rows)}")
    seqs = np.asarray(rows, np.int32)
    masks = np.ones_like(seqs)
    return BatchIterator(seqs, masks, batch_size, seed)


def _pack_greedy_python(token_lists: list[list[int]], sep_ids: list[int], max_seqlen: int) -> list:
    rows = []
    buffer: list[int] = []
    idx = 0
    while idx < len(token_lists) - 1:
        while len(buffer) <= max_seqlen and idx < len(token_lists) - 1:
            buffer += token_lists[idx] + list(sep_ids)
            idx += 1
        rows.append(buffer[:max_seqlen])
        buffer = []
    return [r for r in rows if len(r) == max_seqlen]


def prepare_dataloader_v2(
    *,
    dataset: Sequence[str],
    tokenizer: Any,
    max_seqlen: int = 2048,
    batch_size: int = 1,
    seed: int = 42,
    separator: str,
) -> BatchIterator:
    """Greedy token-buffer packing: tokenize texts in order, join with
    separator tokens, cut into max_seqlen chunks."""
    from ...data import native_packer

    separator = normalize_separator(separator, tokenizer)
    sep_ids = tokenizer(separator, add_special_tokens=False)["input_ids"]
    texts = [t for t in dataset if len(t) > 0]
    token_lists = [tokenizer(t, add_special_tokens=False)["input_ids"] for t in texts]
    try:
        rows = native_packer.pack_greedy(token_lists, sep_ids, max_seqlen)
    except (OSError, RuntimeError, subprocess.SubprocessError):
        rows = _pack_greedy_python(token_lists, sep_ids, max_seqlen)

    logger.info(f"v2 dataloader - created dataset of size {len(rows)}")
    if len(rows) == 0:
        raise ValueError(
            "v2 packing produced no full-length rows — the dataset is too "
            "small for max_seqlen (the last document and any final partial "
            "chunk are not emitted)"
        )
    seqs = np.asarray(rows, np.int32)
    masks = np.ones_like(seqs)
    return BatchIterator(seqs, masks, batch_size, seed)


def make_synthetic_loader(
    vocab_size: int,
    max_seqlen: int,
    batch_size: int,
    nsamples: int = 64,
    seed: int = 0,
) -> BatchIterator:
    """Offline fallback: uniform random token sequences (testing/benching)."""
    rng = np.random.RandomState(seed)
    seqs = rng.randint(0, vocab_size, (nsamples, max_seqlen)).astype(np.int32)
    masks = np.ones_like(seqs)
    return BatchIterator(seqs, masks, batch_size, seed)
