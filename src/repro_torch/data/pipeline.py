"""Federated data pipeline, and the LM training batches.

``FederatedData`` holds the client-partitioned dataset as stacked device
tensors ``(num_clients, n_per_client, ...)`` so a whole cohort's K local
minibatches are gathered in one indexing op per round:

    batches = gather_round_batches(data.client_x, data.client_y, gen, ids, K, B)
    # -> {"x": (C, K, B, ...), "y": (C, K, B)}
    full = gather_full_client_batch(data.client_x, data.client_y, ids)
    # -> {"x": (C, n_per_client, ...), "y": (C, n_per_client)}  (MimeLite)

Minibatch indices are drawn with replacement from a ``torch.Generator`` on
the data's device, or injected (``idx``) so that a test can hand both this
package and the reference the same draws.  ``LMFederatedData`` holds
per-client LM corpora in the same layout (``client_x`` the tokens,
``client_y`` the next-token labels), so the engine draws a cohort's LM
minibatches with the same gathers.  ``lm_batch_iterator`` feeds the
centralized LM training loop (``repro_torch.launch.train``).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.data.dirichlet import dirichlet_partition
from repro_torch.data.synthetic import CHAIN_VOCAB, make_markov_transition, make_synthetic_lm


def gather_round_batches(
    client_x: torch.Tensor,  # (N, n_per_client, ...)
    client_y: torch.Tensor,  # (N, n_per_client)
    generator: Optional[torch.Generator],
    cohort_idx: torch.Tensor,  # (C,) client ids
    local_steps: int,
    batch_size: int,
    idx: Optional[torch.Tensor] = None,  # (C, K, B) injected draw
) -> Dict[str, torch.Tensor]:
    """Cohort minibatch gather: ``(C, K, B, ...)`` per field, sampled with
    replacement within each client's shard."""
    C = cohort_idx.shape[0]
    n_per = client_x.shape[1]
    if idx is None:
        idx = torch.randint(0, n_per, (C, local_steps, batch_size),
                            generator=generator, device=client_x.device)
    rows = cohort_idx.long()[:, None, None]
    idx = idx.to(client_x.device).long()
    return {"x": client_x[rows, idx], "y": client_y[rows, idx]}


def gather_full_client_batch(client_x: torch.Tensor, client_y: torch.Tensor,
                             client_ids: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Each cohort client's whole local dataset, ``(C, n_per_client, ...)``
    per field: MimeLite's full-batch gradient at x_t runs over it."""
    rows = client_ids.long()
    return {"x": client_x[rows], "y": client_y[rows]}


class FederatedData:
    def __init__(
        self,
        x: np.ndarray,
        y: np.ndarray,
        num_clients: int,
        dirichlet_alpha: float = float("inf"),
        seed: int = 0,
        device="cuda",
    ) -> None:
        parts: List[np.ndarray] = dirichlet_partition(y, num_clients, dirichlet_alpha, seed=seed)
        n_per = min(len(p) for p in parts)
        self.num_clients = num_clients
        self.n_per_client = n_per
        self.client_x = torch.as_tensor(
            np.stack([x[p[:n_per]] for p in parts]), device=device)  # (N, n, ...)
        self.client_y = torch.as_tensor(
            np.stack([y[p[:n_per]] for p in parts]), device=device)  # (N, n)


def federated_lm_corpora(vocab_size: int, n_clients: int, seq_len: int, n_seqs: int = 256,
                         temperature: float = 0.3) -> np.ndarray:
    """Per-client corpora ``(n_clients, n_seqs, seq_len)`` int32, drawn as
    the reference's ``examples/federated_llm.py`` draws them: client c's
    chain is 0.6 × a shared base chain (seed 0) + 0.4 × its own (seed
    100 + c), and its sequences come from ``make_synthetic_lm(..., seed=c)``.
    The chains run over the first ``min(vocab_size, CHAIN_VOCAB)`` token ids
    (a dense (V, V) chain does not fit at a full vocabulary); at the
    reduced configs' vocabulary of 512 these are the example's corpora."""
    v = min(vocab_size, CHAIN_VOCAB)
    base = make_markov_transition(v, temperature=temperature, seed=0)
    out = []
    for c in range(n_clients):
        pert = make_markov_transition(v, temperature=temperature, seed=100 + c)
        out.append(make_synthetic_lm(v, seq_len, n_seqs, transition=0.6 * base + 0.4 * pert,
                                     seed=c))
    return np.stack(out)


class LMFederatedData:
    """Per-client LM corpora ``(N, n_seq, S + 1)`` (an array or a tensor) on
    ``device`` in the engine's data layout: ``client_x`` the tokens
    ``[..., :-1]`` and ``client_y`` the labels ``[..., 1:]``, ``(N, n_seq,
    S)`` int64 each, so
    ``gather_round_batches`` draws ``{"x": (C, K, B, S), "y": (C, K, B, S)}``
    and ``FederatedEngine.run_round`` / ``run_rounds`` step an LM as they
    step the MLP.  (The reference's example keeps only the tokens, which
    its engine's ``run_round`` cannot read: ROADMAP queue C.)"""

    def __init__(self, tokens, device="cuda") -> None:
        toks = torch.as_tensor(tokens if isinstance(tokens, torch.Tensor) else np.asarray(tokens),
                               dtype=torch.int64, device=device)
        self.num_clients, self.n_per_client = toks.shape[:2]
        self.client_x = toks[..., :-1]
        self.client_y = toks[..., 1:]


def lm_batch_iterator(tokens: np.ndarray, batch_size: int, seed: int = 0, device="cpu",
                      dtype=torch.int64):
    """Endless ``{"tokens": (B, S), "labels": (B, S)}`` batches for LM
    training, the reference's ``lm_batch_iterator`` draw for draw: rows of
    ``tokens`` ``(n_seqs, S + 1)`` picked with replacement by
    ``default_rng(seed)``, labels the inputs shifted by one, as ``dtype``
    tensors on ``device``."""
    rng = np.random.default_rng(seed)
    n = tokens.shape[0]
    while True:
        batch = tokens[rng.integers(0, n, size=batch_size)]
        yield {"tokens": torch.as_tensor(batch[:, :-1], dtype=dtype, device=device),
               "labels": torch.as_tensor(batch[:, 1:], dtype=dtype, device=device)}
