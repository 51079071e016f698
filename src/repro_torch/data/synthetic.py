"""Synthetic classification and language-model data.

Numpy-only copies of ``repro.data.synthetic.make_synthetic_classification``
and ``make_synthetic_lm``, kept draw for draw so both packages build the
same data for the same seed.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def make_synthetic_classification(
    n_classes: int = 10,
    dim: int = 32,
    n_train: int = 50_000,
    n_test: int = 10_000,
    noise: float = 1.0,
    separation: float = 2.0,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Returns (x_train, y_train, x_test, y_test); x float32, y int32.

    Gaussian-mixture vectors with a per-class linear map, so the task is not
    linearly separable but an MLP learns it."""
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(n_classes, dim)) * separation
    # per-class linear map to make the task non-trivial for linear models
    maps = rng.normal(size=(n_classes, dim, dim)) * (0.3 / np.sqrt(dim))

    def sample(n):
        y = rng.integers(0, n_classes, size=n).astype(np.int32)
        eps = rng.normal(size=(n, dim)).astype(np.float32)
        x = means[y] + np.einsum("nij,nj->ni", maps[y], eps) + noise * rng.normal(size=(n, dim))
        return x.astype(np.float32), y

    x_tr, y_tr = sample(n_train)
    x_te, y_te = sample(n_test)
    return x_tr, y_tr, x_te, y_te


def make_synthetic_lm(
    vocab_size: int = 512,
    seq_len: int = 256,
    n_seqs: int = 4096,
    temperature: float = 0.3,
    seed: int = 0,
    transition: np.ndarray | None = None,
) -> np.ndarray:
    """(n_seqs, seq_len) int32 tokens from a first-order Markov chain.

    ``temperature`` controls row entropy (lower = more predictable).  The
    chain is a dense (vocab, vocab) f64 matrix, so callers keep
    ``vocab_size`` small (the serving CLI draws over at most 512 ids)."""
    rng = np.random.default_rng(seed)
    if transition is None:
        logits = rng.normal(size=(vocab_size, vocab_size)) / max(temperature, 1e-3)
        transition = _softmax(logits)
    toks = np.empty((n_seqs, seq_len), dtype=np.int32)
    state = rng.integers(0, vocab_size, size=n_seqs)
    toks[:, 0] = state
    # vectorized chain stepping via inverse-CDF sampling
    cdf = np.cumsum(transition, axis=1)
    for t in range(1, seq_len):
        u = rng.random(n_seqs)
        state = (cdf[state] < u[:, None]).sum(axis=1)
        state = np.minimum(state, vocab_size - 1)
        toks[:, t] = state
    return toks


def _softmax(x: np.ndarray) -> np.ndarray:
    x = x - x.max(axis=-1, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=-1, keepdims=True)
