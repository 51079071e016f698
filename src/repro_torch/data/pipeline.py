"""Federated data pipeline.

``FederatedData`` holds the client-partitioned dataset as stacked device
tensors ``(num_clients, n_per_client, ...)`` so a whole cohort's K local
minibatches are gathered in one indexing op per round:

    batches = gather_round_batches(data.client_x, data.client_y, gen, ids, K, B)
    # -> {"x": (C, K, B, ...), "y": (C, K, B)}
    full = gather_full_client_batch(data.client_x, data.client_y, ids)
    # -> {"x": (C, n_per_client, ...), "y": (C, n_per_client)}  (MimeLite)

Minibatch indices are drawn with replacement from a ``torch.Generator`` on
the data's device, or injected (``idx``) so that a test can hand both this
package and the reference the same draws.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.data.dirichlet import dirichlet_partition


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
