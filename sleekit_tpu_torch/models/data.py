"""Calibration and evaluation token streams (port of the synthetic half of
``sleekit_tpu/models/data.py``; the port keeps its own copy).

``load_token_stream`` (pre-tokenized files, shards, WikiText-2) is not
ported yet (ROADMAP, modules to port: what is left of ``models/``).
"""

from __future__ import annotations

import numpy as np


def synthetic_stream(vocab_size: int, n_tokens: int,
                     seed: int = 0) -> np.ndarray:
    """Deterministic Zipf-ish synthetic token stream (smoke/benchmarks):
    the JAX package's tokens for the same arguments."""
    rng = np.random.default_rng(seed)
    # Zipfian marginal roughly matches natural-text token statistics,
    # exercising the same embedding-gather patterns.
    ranks = rng.zipf(1.3, size=n_tokens)
    return ((ranks - 1) % vocab_size).astype(np.int32)


def calibration_batches(stream: np.ndarray, samples: int, seq_len: int,
                        batch: int = 2):
    """Slice the first samples*seq_len tokens into (batch, seq_len) arrays."""
    need = samples * seq_len
    stream = np.resize(stream, max(need, len(stream)))[:need]
    windows = stream.reshape(samples, seq_len)
    return [windows[i:i + batch] for i in range(0, samples, batch)]
