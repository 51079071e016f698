"""Synthetic classification data.

A numpy-only copy of ``repro.data.synthetic.make_synthetic_classification``,
kept draw for draw so both packages build the same dataset for the same seed.
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
