"""Million-client population layer: out-of-core client state and availability.

Counterpart of ``repro.data.population`` (numpy and PyTorch only).  A
stateful spec (SCAFFOLD's c_i, FedDyn's λ_i) keeps an ``(N, P)`` device
plane on the resident path — 88 GB at N = 1e6 for the CLI's MLP
(P = 22,026 f32) — and ``FederatedData`` stacks every client's shard on the
device.  This module removes both:

``HostPopulationStore``
    A sparse host-memory store of per-client f32 ``(P,)`` rows keyed by
    client id, zero until first written.  The engine gathers a dense
    ``(C, P)`` block for the cohort before its local steps and scatters the
    updated block after its fold, so device memory scales with the cohort
    and host memory with the set of touched clients.

``availability_log_weights``
    The availability processes of the cohort sampler (``cfg.availability``):
    uniform (None: the plain draw), Zipf-skewed traffic, and a time-of-day
    sinusoid phase-distributed over the clients.

``StreamingClientData``
    A virtual federated dataset: each client's shard is regenerated from
    ``(seed, client id)`` on demand, so only the sampled cohort's
    minibatches exist.  Its arrays are bitwise the reference's for the same
    seeds (the same numpy generators in the same order).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch

AVAILABILITY_PROCESSES = ("uniform", "zipf", "diurnal")
POPULATION_STORES = ("resident", "host")


# ----------------------------------------------------------------------
# availability processes
# ----------------------------------------------------------------------


def availability_log_weights(cfg, t=None, device=None) -> Optional[torch.Tensor]:
    """``(N,)`` f32 log availability weights for round ``t``, or None for
    the uniform process (the sampler then keeps its plain draw).

    ``t`` is the round counter — an int or a device tensor; only the
    diurnal process reads it (None means t = 0).  The weights live on
    ``t``'s device when it is a tensor, else on ``device``."""
    avail = cfg.availability
    if avail == "uniform":
        return None
    if avail not in AVAILABILITY_PROCESSES:
        raise ValueError(f"unknown availability process {avail!r}; "
                         f"known: {AVAILABILITY_PROCESSES}")
    if isinstance(t, torch.Tensor):
        device = t.device
    n = cfg.num_clients
    i = torch.arange(n, dtype=torch.float32, device=device)
    if avail == "zipf":
        # w_i ∝ (i+1)^-s: client ids double as a popularity ranking
        return torch.log1p(i) * -float(cfg.zipf_exponent)
    # diurnal: client i peaks at phase i/N of a diurnal_period-round day
    tt = (torch.zeros((), dtype=torch.float32, device=device) if t is None
          else torch.as_tensor(t, device=device).to(torch.float32))
    phase = tt / float(cfg.diurnal_period) + i / float(n)
    avail_i = 1.0 + float(cfg.diurnal_amplitude) * torch.sin(2.0 * math.pi * phase)
    return torch.log(torch.clamp(avail_i, min=1e-6))


# ----------------------------------------------------------------------
# client-state store
# ----------------------------------------------------------------------


class HostPopulationStore:
    """Sparse host-memory store of per-client flat state rows.

    Layout: ``{client_id: np.float32 (plane_size,)}``; a client absent
    from the dict reads as the zero row (every client-state init is
    zeros).  ``gather`` / ``scatter`` are the only operations the engine
    uses, each a dense copy over the cohort axis.  ``to_pytree`` packs the
    touched rows as ``{"ids": int32 (M,), "rows": f32 (M, P)}``, ids
    sorted — the reference's layout."""

    def __init__(self, num_clients: int, plane_size: int, dtype=np.float32):
        self.num_clients = int(num_clients)
        self.plane_size = int(plane_size)
        self.dtype = np.dtype(dtype)
        self._rows: Dict[int, np.ndarray] = {}

    @property
    def touched(self) -> int:
        """Number of clients whose state has ever been written."""
        return len(self._rows)

    @property
    def nbytes(self) -> int:
        return len(self._rows) * self.plane_size * self.dtype.itemsize

    def gather(self, ids: np.ndarray) -> np.ndarray:
        """Dense ``(C, P)`` block of the cohort's rows (zeros if unwritten)."""
        ids = np.asarray(ids)
        out = np.zeros((ids.shape[0], self.plane_size), dtype=self.dtype)
        for r, cid in enumerate(ids):
            row = self._rows.get(int(cid))
            if row is not None:
                out[r] = row
        return out

    def scatter(self, ids: np.ndarray, rows: np.ndarray) -> None:
        """Write the cohort's rows back (row r → client ids[r]), every row,
        inactive clients' unchanged rows included — the resident plane's
        ``index_copy`` semantics, bit for bit."""
        rows = np.asarray(rows, dtype=self.dtype)
        if rows.shape != (len(ids), self.plane_size):
            raise ValueError(
                f"scatter rows shape {rows.shape} != ({len(ids)}, {self.plane_size})")
        for r, cid in enumerate(np.asarray(ids)):
            self._rows[int(cid)] = np.array(rows[r], dtype=self.dtype)

    def to_pytree(self) -> Dict[str, np.ndarray]:
        ids = np.array(sorted(self._rows), dtype=np.int32)
        if len(ids):
            rows = np.stack([self._rows[int(i)] for i in ids]).astype(self.dtype)
        else:
            rows = np.zeros((0, self.plane_size), dtype=self.dtype)
        return {"ids": ids, "rows": rows}

    @classmethod
    def from_pytree(cls, tree: Dict[str, Any], num_clients: int,
                    plane_size: Optional[int] = None) -> "HostPopulationStore":
        ids = np.asarray(tree["ids"])
        rows = np.asarray(tree["rows"])
        if plane_size is None:
            plane_size = rows.shape[1] if rows.ndim == 2 else 0
        store = cls(num_clients, plane_size, dtype=rows.dtype if rows.size else np.float32)
        store.scatter(ids, rows)
        return store


class TransientStoreError(RuntimeError):
    """A host-store gather / scatter failed transiently (injected or real).
    The engine retries the same operation with capped exponential backoff
    (``FaultConfig.store_max_retries`` / ``store_backoff_base`` /
    ``store_backoff_cap``) and re-raises once the retries are spent; a
    retried run is bitwise the run that needed none."""


class FaultyStore:
    """Deterministic chaos wrapper: each ``gather`` / ``scatter`` raises
    :class:`TransientStoreError` with probability ``failure_rate`` before
    delegating (a failed call has no side effect, so a retry is safe).  The
    failure stream is ``np.random.default_rng((seed, 0xFA17))``, the
    reference's, one draw per call.  Everything else passes through to the
    wrapped store (``inner``)."""

    def __init__(self, inner: HostPopulationStore, failure_rate: float, seed: int = 0):
        self.inner = inner
        self.failure_rate = float(failure_rate)
        self._rng = np.random.default_rng((int(seed), 0xFA17))

    def _maybe_fail(self, op: str) -> None:
        if self._rng.random() < self.failure_rate:
            raise TransientStoreError(f"injected transient store {op} failure")

    def gather(self, ids: np.ndarray) -> np.ndarray:
        self._maybe_fail("gather")
        return self.inner.gather(ids)

    def scatter(self, ids: np.ndarray, rows: np.ndarray) -> None:
        self._maybe_fail("scatter")
        return self.inner.scatter(ids, rows)

    def __getattr__(self, name):
        return getattr(self.inner, name)


def make_population_store(cfg, plane_size: int) -> Optional[HostPopulationStore]:
    """The store for ``cfg.population_store`` (None for resident), wrapped
    in :class:`FaultyStore` when ``cfg.fault`` injects store failures."""
    kind = cfg.population_store
    if kind == "resident":
        return None
    if kind != "host":
        raise ValueError(f"unknown population_store {kind!r}; known: {POPULATION_STORES}")
    store = HostPopulationStore(cfg.num_clients, plane_size)
    fault = cfg.fault
    if fault is not None and fault.store_failure_rate > 0.0:
        return FaultyStore(store, fault.store_failure_rate, seed=fault.seed)
    return store


# ----------------------------------------------------------------------
# streaming federated data
# ----------------------------------------------------------------------


class StreamingClientData:
    """On-demand per-client synthetic shards for store-backed populations.

    Each client's shard is a function of ``(seed, client_id)`` — a Gaussian
    mixture (class means and per-class linear maps from ``seed``) with
    label skew towards the dominant class ``cid % n_classes`` — regenerated
    on the host whenever the client is sampled.  Only the cohort's
    ``(C, K, B, …)`` minibatch block is ever formed."""

    def __init__(self, num_clients: int, dim: int = 32, n_classes: int = 10,
                 n_per_client: int = 50, noise: float = 1.0,
                 separation: float = 2.0, label_skew: float = 0.7,
                 seed: int = 0):
        self.num_clients = int(num_clients)
        self.dim = int(dim)
        self.n_classes = int(n_classes)
        self.n_per_client = int(n_per_client)
        self.noise = float(noise)
        self.label_skew = float(label_skew)
        self.seed = int(seed)
        rng = np.random.default_rng(seed)
        self.means = (rng.normal(size=(n_classes, dim)) * separation).astype(np.float32)
        self.maps = (rng.normal(size=(n_classes, dim, dim))
                     * (0.3 / np.sqrt(dim))).astype(np.float32)

    def client_dataset(self, cid: int):
        """``(x (n_per, dim) f32, y (n_per,) i32)``, deterministic in cid."""
        rng = np.random.default_rng((self.seed, 977, int(cid)))
        n = self.n_per_client
        dominant = int(cid) % self.n_classes
        take = rng.random(n) < self.label_skew
        y = np.where(take, dominant,
                     rng.integers(0, self.n_classes, size=n)).astype(np.int32)
        eps = rng.normal(size=(n, self.dim)).astype(np.float32)
        x = (self.means[y] + np.einsum("nij,nj->ni", self.maps[y], eps)
             + self.noise * rng.normal(size=(n, self.dim)))
        return x.astype(np.float32), y

    def host_round_batches(self, ids: np.ndarray, seed: int,
                           local_steps: int, batch_size: int) -> Dict[str, np.ndarray]:
        """The cohort's minibatch block ``{"x": (C, K, B, dim), "y": (C, K,
        B)}``; ``seed`` is the round's batch seed (the engine draws it from
        the run's generator), so a round resamples deterministically."""
        ids = np.asarray(ids)
        rng = np.random.default_rng(int(seed))
        C = ids.shape[0]
        x = np.empty((C, local_steps, batch_size, self.dim), np.float32)
        y = np.empty((C, local_steps, batch_size), np.int32)
        for r, cid in enumerate(ids):
            cx, cy = self.client_dataset(int(cid))
            idx = rng.integers(0, self.n_per_client, size=(local_steps, batch_size))
            x[r] = cx[idx]
            y[r] = cy[idx]
        return {"x": x, "y": y}

    def host_full_batches(self, ids: np.ndarray) -> Dict[str, np.ndarray]:
        """Whole client shards ``{"x": (C, n_per, dim), "y": (C, n_per)}``
        (MimeLite's full-batch gradient)."""
        ids = np.asarray(ids)
        C = ids.shape[0]
        x = np.empty((C, self.n_per_client, self.dim), np.float32)
        y = np.empty((C, self.n_per_client), np.int32)
        for r, cid in enumerate(ids):
            x[r], y[r] = self.client_dataset(int(cid))
        return {"x": x, "y": y}

    def test_set(self, n_test: int = 2_000):
        """Held-out iid test split from the same mixture (no label skew)."""
        rng = np.random.default_rng((self.seed, 1009))
        y = rng.integers(0, self.n_classes, size=n_test).astype(np.int32)
        eps = rng.normal(size=(n_test, self.dim)).astype(np.float32)
        x = (self.means[y] + np.einsum("nij,nj->ni", self.maps[y], eps)
             + self.noise * rng.normal(size=(n_test, self.dim)))
        return x.astype(np.float32), y
