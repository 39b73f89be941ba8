"""Calibration and evaluation token streams (port of
``sleekit_tpu/models/data.py``; the port keeps its own copy).

:func:`load_token_stream` resolves, as the JAX package does:

  1. a pre-tokenized ``.npy`` int32 stream;
  2. an ``.skt`` token shard (the "SKT1" format of
     ``sleekit_tpu/native/dataio.py``: magic, u32 dtype size, u64 count,
     then a u16 or u32 payload), read through a numpy memmap;
  3. ``wikitext2`` through HF ``datasets`` and a tokenizer, where both are
     installed and the dataset is cached or reachable;
  4. a deterministic synthetic stream for ``None``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

_SKT_MAGIC = b"SKT1"


def synthetic_stream(vocab_size: int, n_tokens: int,
                     seed: int = 0) -> np.ndarray:
    """Deterministic Zipf-ish synthetic token stream (smoke/benchmarks):
    the JAX package's tokens for the same arguments."""
    rng = np.random.default_rng(seed)
    # Zipfian marginal roughly matches natural-text token statistics,
    # exercising the same embedding-gather patterns.
    ranks = rng.zipf(1.3, size=n_tokens)
    return ((ranks - 1) % vocab_size).astype(np.int32)


def read_token_shard(path: str, n_tokens: int) -> np.ndarray:
    """The first ``n_tokens`` tokens (at most the shard's) of an SKT1 shard,
    as int32."""
    with open(path, "rb") as f:
        head = f.read(16)
    if head[:4] != _SKT_MAGIC:
        raise ValueError(f"{path}: not an SKT1 shard")
    dtype_size = int(np.frombuffer(head[4:8], "<u4")[0])
    count = int(np.frombuffer(head[8:16], "<u8")[0])
    if dtype_size not in (2, 4):
        raise ValueError(f"{path}: token size {dtype_size}, not 2 or 4")
    dt = "<u2" if dtype_size == 2 else "<u4"
    mm = np.memmap(path, dtype=dt, mode="r", offset=16, shape=(count,))
    out = mm[:min(n_tokens, count)].astype(np.int32)
    del mm
    return out


def load_token_stream(
    source: Optional[str],
    vocab_size: int,
    n_tokens: int,
    tokenizer_name: Optional[str] = None,
    split: str = "train",
    seed: int = 0,
) -> Tuple[np.ndarray, str]:
    """Resolve a token stream. Returns (tokens, provenance).

    ``source`` may be a ``.npy`` path, an ``.skt`` shard, the literal
    ``wikitext2`` (requires HF datasets + a tokenizer), or None
    (synthetic).
    """
    if source and source.endswith(".npy"):
        stream = np.load(source).astype(np.int32)
        return stream[:n_tokens], f"file:{source}"
    if source and source.endswith(".skt"):
        return read_token_shard(source, n_tokens), f"shard:{source}"
    if source == "wikitext2":
        toks = _load_wikitext2(tokenizer_name, split)
        if toks is not None:
            return toks[:n_tokens], f"wikitext2/{split}"
        raise RuntimeError(
            "wikitext2 requested but HF datasets/tokenizer unavailable "
            "(offline without cache?); pass a pre-tokenized .npy instead")
    if source is not None:
        # A typo'd path or unknown format must not silently calibrate on
        # random tokens.
        raise ValueError(
            f"unrecognized token source {source!r}: expected a .npy path, "
            "a .skt shard, 'wikitext2', or None for synthetic")
    return synthetic_stream(vocab_size, n_tokens, seed), "synthetic"


def _load_wikitext2(tokenizer_name: Optional[str],
                    split: str) -> Optional[np.ndarray]:
    try:
        from datasets import load_dataset
        from transformers import AutoTokenizer
    except ImportError:
        return None
    try:
        ds = load_dataset("wikitext", "wikitext-2-raw-v1", split=split)
        tok = AutoTokenizer.from_pretrained(tokenizer_name or "gpt2")
        text = "\n\n".join(ds["text"])
        return np.asarray(tok(text).input_ids, np.int32)
    except Exception:
        return None


def calibration_batches(stream: np.ndarray, samples: int, seq_len: int,
                        batch: int = 2):
    """Slice the first samples*seq_len tokens into (batch, seq_len) arrays."""
    need = samples * seq_len
    stream = np.resize(stream, max(need, len(stream)))[:need]
    windows = stream.reshape(samples, seq_len)
    return [windows[i:i + batch] for i in range(0, samples, batch)]
