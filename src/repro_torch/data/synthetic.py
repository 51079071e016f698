"""Synthetic classification and language-model data.

Numpy copies of ``repro.data.synthetic.make_synthetic_classification``,
``make_synthetic_images``, ``make_synthetic_lm`` and
``make_markov_transition``, kept draw for draw so
both packages build the same data for the same seed; and the
encoder-decoder's synthetic source frames (``source_frames``), drawn with a
``torch.Generator``.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

# The LM CLIs (serving prompts, training data) draw from the chain over the
# first min(vocab, CHAIN_VOCAB) token ids: the chain is a dense (V, V) f64
# matrix, 131.6 GB at llama3.2-1b's vocabulary (ROADMAP queue C); at the
# reduced configs' vocab of 512 the reference draws the same data.
CHAIN_VOCAB = 512


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


def make_synthetic_images(
    n_classes: int = 10,
    hw: int = 8,
    channels: int = 3,
    n_train: int = 20_000,
    n_test: int = 4_000,
    noise: float = 0.6,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Tiny images: a class template (a smooth random field) plus noise.
    Returns (x_train, y_train, x_test, y_test); x NHWC float32, y int32."""
    rng = np.random.default_rng(seed)
    # smooth templates: low-frequency random fields per class
    freqs = rng.normal(size=(n_classes, channels, 3, 3))
    yy, xx = np.meshgrid(np.linspace(0, 1, hw), np.linspace(0, 1, hw), indexing="ij")
    basis = np.stack(
        [np.ones_like(xx), np.sin(2 * np.pi * xx), np.sin(2 * np.pi * yy),
         np.cos(2 * np.pi * xx), np.cos(2 * np.pi * yy), np.sin(4 * np.pi * xx),
         np.sin(4 * np.pi * yy), np.sin(2 * np.pi * (xx + yy)), np.cos(2 * np.pi * (xx - yy))],
        axis=-1,
    )  # (hw, hw, 9)
    templates = np.einsum("hwb,ncb->nchw", basis, freqs.reshape(n_classes, channels, 9))

    def sample(n):
        y = rng.integers(0, n_classes, size=n).astype(np.int32)
        x = templates[y] + noise * rng.normal(size=(n, channels, hw, hw))
        return np.transpose(x, (0, 2, 3, 1)).astype(np.float32), y  # NHWC

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
    ``vocab_size`` small (the CLIs draw over at most ``CHAIN_VOCAB`` ids)."""
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


def make_markov_transition(vocab_size: int, temperature: float, seed: int) -> np.ndarray:
    """A ``(vocab, vocab)`` f64 row-stochastic chain: softmax of
    ``default_rng(seed)`` normals over ``temperature``."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(vocab_size, vocab_size)) / max(temperature, 1e-3)
    return _softmax(logits)


def source_frames(batch: int, seq: int, d_model: int, seed: int, device) -> torch.Tensor:
    """An encoder-decoder's synthetic source frames (the stubbed speech
    frontend's output), ``(batch, seq, d_model)`` f32 normal from a
    ``torch.Generator`` on ``device`` seeded with ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.randn((batch, seq, d_model), generator=gen, device=device)


def _softmax(x: np.ndarray) -> np.ndarray:
    x = x - x.max(axis=-1, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=-1, keepdims=True)
