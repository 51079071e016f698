"""Dirichlet non-IID client partitioner (paper appendix C.1).

A numpy-only copy of ``repro.data.dirichlet.dirichlet_partition``, kept
draw for draw so both packages partition identically for the same seed.

For each client draw q ~ Dir(alpha * 1) over classes, then fill the client's
(balanced) quota by sampling training points class-by-class according to q.
alpha -> inf approaches IID; alpha -> 0 approaches single-class clients.
"""
from __future__ import annotations

from typing import List

import numpy as np


def dirichlet_partition(
    labels: np.ndarray,
    num_clients: int,
    alpha: float,
    seed: int = 0,
) -> List[np.ndarray]:
    """Returns a list of index arrays, one per client, balanced sizes.

    alpha=float('inf') gives the IID split; alpha <= 0 is an error.
    """
    labels = np.asarray(labels)
    n = len(labels)
    per_client = n // num_clients
    rng = np.random.default_rng(seed)

    if np.isinf(alpha):
        perm = rng.permutation(n)
        return [perm[i * per_client : (i + 1) * per_client] for i in range(num_clients)]
    if alpha <= 0:
        raise ValueError("dirichlet alpha must be > 0 (use float('inf') for IID)")

    classes = np.unique(labels)
    n_classes = len(classes)
    # pools of shuffled indices per class, consumed front-to-back
    pools = {c: rng.permutation(np.nonzero(labels == c)[0]).tolist() for c in classes}
    out: List[np.ndarray] = []
    for _ in range(num_clients):
        q = rng.dirichlet(alpha * np.ones(n_classes))
        counts = rng.multinomial(per_client, q)
        idxs: List[int] = []
        for ci, c in enumerate(classes):
            take = min(counts[ci], len(pools[c]))
            idxs.extend(pools[c][:take])
            del pools[c][:take]
        # top up from whatever classes still have data (pool exhaustion)
        deficit = per_client - len(idxs)
        if deficit > 0:
            leftovers = [i for c in classes for i in pools[c]]
            rng.shuffle(leftovers)
            take = leftovers[:deficit]
            taken = set(take)
            for c in classes:
                pools[c] = [i for i in pools[c] if i not in taken]
            idxs.extend(take)
        out.append(np.asarray(idxs, dtype=np.int64))
    return out
