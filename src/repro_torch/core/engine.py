"""The federated round engine, main path: one synchronous round on the flat plane.

Counterpart of ``repro.core.engine`` cut to the route this slice ports —
``use_flat_plane`` with the fused kernels (the reference's
``use_fused_kernel=True``):

    sample cohort → broadcast (x_t, Δ_t) → K local steps over the cohort
    plane → masked-mean fold + momentum + server step

The cohort runs as ONE ``(C, P)`` plane, where the reference vmaps a
per-client scan: each local step is one batched forward/backward (the
model's products, left to PyTorch as the reference leaves them to XLA) and
ONE ``fed_direction`` launch for the whole cohort, with Δ_t broadcast as
``(P,)``.  The round closes with one ``server_update`` launch per fold
row.  All C = capacity rows compute; inactive rows carry weight 0 in the
fold and in the loss metric.

Every per-round value — the round counter, η_l, the fold coefficients, the
cohort mask and |S| — lives in device memory, and nothing in a round reads
one back to the host, so a round can later be captured in a CUDA graph.
``run_rounds`` is a plain Python loop over rounds.

Only the uniform-availability sync path exists here; a config that asks for
anything else raises ``NotImplementedError`` naming the ROADMAP item that
brings it (``check_supported``).
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import FedConfig
from repro_torch.core import algorithms  # noqa: F401  (registers the builtin specs)
from repro_torch.core.algorithms import sparse_client_finalize
from repro_torch.core.flat import FlatSpec
from repro_torch.core.registry import ServerState, get_algorithm, list_algorithms, server_init
from repro_torch.data.pipeline import gather_round_batches
from repro_torch.kernels.fed_direction.ops import direction_operands, fed_direction
from repro_torch.kernels.server_update.ops import fused_fold


class FedState(NamedTuple):
    """Flat engine state.  ``params`` is the ``(P,)`` f32 plane, ``server``
    holds the ``(P,)`` momentum plane and the int32 round counter, ``rng``
    the ``torch.Generator`` the round draws come from (advanced in place).
    Per-client state planes come with the specs that keep them (ROADMAP
    A.7)."""

    params: torch.Tensor
    server: ServerState
    rng: Optional[torch.Generator] = None


class RoundMetrics(NamedTuple):
    loss: torch.Tensor  # mean local training loss over active cohort × K steps
    n_active: torch.Tensor
    delta_norm: torch.Tensor  # ‖mean Δ_i‖
    momentum_norm: torch.Tensor  # ‖Δ_t‖ (server momentum entering the round)
    eta_l: torch.Tensor
    bytes_down: torch.Tensor  # server→clients this round
    bytes_up: torch.Tensor  # clients→server this round
    n_clipped: torch.Tensor = None  # bernoulli draws beyond the cohort capacity
    # fault counters: always 0 here (fault injection is ROADMAP A.9)
    n_dropped: torch.Tensor = None
    n_quarantined: torch.Tensor = None
    n_retries: torch.Tensor = None
    quorum_skipped: torch.Tensor = None  # 1.0 when survivors < max(1, min_quorum)


def metrics_to_host(ms: NamedTuple) -> Dict[str, np.ndarray]:
    """Bring a (stacked) metrics tuple to the host in ONE transfer; returns
    ``{field: np.ndarray}`` with scalars as shape ``(1,)``."""
    named = [(f, v) for f, v in zip(ms._fields, ms) if v is not None]
    stacked = torch.stack([v.to(torch.float32).reshape(-1) for _, v in named]).cpu().numpy()
    return {f: np.atleast_1d(row) for (f, _), row in zip(named, stacked)}


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; raises when CUDA is asked for and the
    machine has none — the port never carries on on the CPU unasked."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; "
            f"pass device='cpu' (CLI: --device cpu) to run on the CPU")
    return dev


# (predicate, what, ROADMAP item) for every knob the port does not run yet
_UNPORTED = (
    (lambda c: not c.use_flat_plane, "use_flat_plane=False (the per-leaf tree path)", "A.16"),
    (lambda c: c.pipeline_depth > 1 or c.staleness > 0,
     "pipeline_depth > 1 / staleness > 0 (the async ring)", "A.8"),
    (lambda c: c.cohort_shard > 0, "cohort_shard (multi-GPU cohort sharding)", "A.14"),
    (lambda c: c.population_store != "resident",
     "population_store other than 'resident' (the out-of-core store)", "A.11"),
    (lambda c: c.availability != "uniform",
     "availability other than 'uniform'", "A.11"),
    (lambda c: c.dropout_rate > 0.0, "dropout_rate > 0 (straggler dropout)", "A.11"),
    (lambda c: c.fault is not None, "fault injection", "A.9"),
    (lambda c: c.compression is not None, "uplink compression", "A.10"),
)


def check_supported(cfg: FedConfig) -> None:
    """Raise ``NotImplementedError`` (naming the ROADMAP item) for any part
    of ``cfg`` the port does not run yet, ``ValueError`` for bad values."""
    for pred, what, item in _UNPORTED:
        if pred(cfg):
            raise NotImplementedError(
                f"{what} is not ported to repro_torch yet (ROADMAP {item})")
    if cfg.algo not in list_algorithms():
        raise NotImplementedError(
            f"algorithm {cfg.algo!r} is not ported to repro_torch yet "
            f"(ROADMAP A.7); ported: {list(list_algorithms())}")
    if cfg.participation not in ("fixed", "bernoulli"):
        raise ValueError(f"unknown participation {cfg.participation!r}")
    for name in ("momentum_dtype", "aggregate_dtype"):
        if getattr(cfg, name) not in ("float32", "bfloat16"):
            raise ValueError(f"{name} must be 'float32' or 'bfloat16'")


def cohort_capacity(cfg: FedConfig) -> int:
    """Static cohort axis length. ``fixed``: exactly S. ``bernoulli``: a
    Binomial(N, p) tail bound, mean + ``bernoulli_capacity_sigma``·σ,
    clipped to N."""
    if cfg.participation == "fixed":
        return cfg.cohort_size
    p = cfg.cohort_size / cfg.num_clients
    sd = math.sqrt(cfg.num_clients * p * (1 - p))
    return min(cfg.num_clients, int(math.ceil(cfg.cohort_size + cfg.bernoulli_capacity_sigma * sd)))


def sample_cohort_ex(generator: torch.Generator, cfg: FedConfig, device):
    """Uniform-availability cohort draw on ``device``.  Returns
    ``(client_ids (C,), active_mask (C,), n_clipped ())`` with C the cohort
    capacity: the ids are the head of a random permutation (a choice
    without replacement); under ``bernoulli`` the count s of independent
    draws at p = S/N activates the first s rows (``mask = arange(C) < s``),
    and draws beyond capacity are counted in ``n_clipped``."""
    cap = cohort_capacity(cfg)
    ids = torch.randperm(cfg.num_clients, generator=generator, device=device)[:cap]
    if cfg.participation == "fixed":
        return ids, torch.ones(cap, dtype=torch.bool, device=device), \
            torch.zeros((), dtype=torch.int32, device=device)
    p = cfg.cohort_size / cfg.num_clients
    draws = torch.rand(cfg.num_clients, generator=generator, device=device) < p
    s_raw = draws.sum().to(torch.int32)
    s = s_raw.clamp(0 if cfg.allow_empty_cohort else 1, cap)
    mask = torch.arange(cap, device=device) < s
    return ids, mask, (s_raw - cap).clamp(min=0)


def local_learning_rate(cfg: FedConfig, t: torch.Tensor) -> torch.Tensor:
    """Appendix C.2: exponential per-round decay of η_l, as an f32 device
    tensor computed from the device round counter."""
    base = torch.full((), cfg.eta_l, dtype=torch.float32, device=t.device)
    decay = torch.full((), cfg.eta_l_decay, dtype=torch.float32, device=t.device)
    return base * decay ** t.to(torch.float32)


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(torch.square(x.to(torch.float32))))


class FederatedEngine:
    """Round engine for (algorithm, loss_fn, parameter layout).

    ``loss_fn(params, batch)`` takes cohort-batched params — leaves with a
    leading client axis, views of a ``(C, P)`` plane — and a batch with
    leading ``(C, B)`` axes, and returns the ``(C,)`` per-client mean losses
    (``repro_torch.models.small.classification_loss`` does).  ``spec`` is
    the ``FlatSpec`` of the model's params.

    Usage::

        eng = FederatedEngine(cfg, loss_fn, spec, device="cuda")
        state = eng.init(params, generator)
        state, metrics = eng.run_rounds(state, data, n_rounds)
        state, metrics = eng.run_round(state, data)
        state, metrics = eng.round_step(state, batches, ids, mask)
    """

    def __init__(self, cfg: FedConfig, loss_fn: Callable, spec: FlatSpec,
                 batch_size: int = 50, device="cuda") -> None:
        check_supported(cfg)
        self.cfg = cfg
        self.algo = get_algorithm(cfg.algo)
        self.loss_fn = loss_fn
        self.spec = spec
        self.batch_size = batch_size
        self.device = resolve_device(device)

    # -------------------------------------------------- init
    def init(self, params, generator: Optional[torch.Generator] = None) -> FedState:
        """Ravel ``params`` (any device) onto this engine's device and
        allocate the server planes the spec requires."""
        return FedState(
            params=self.spec.ravel(params).to(self.device),
            server=server_init(self.spec.size, self.algo.momentum_dtype(self.cfg),
                               device=self.device),
            rng=generator,
        )

    def payload_bytes(self) -> Dict[str, int]:
        """Per-client per-round communication in bytes (§4.2)."""
        nbytes = self.spec.nbytes
        down = nbytes * (2 if self.algo.needs_momentum_broadcast else 1)
        return {"down_per_client": down, "up_per_client": nbytes}  # one delta up

    # -------------------------------------------------- client phase
    def _value_and_grad(self, x: torch.Tensor, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-client losses ``(C,)`` and gradient plane ``(C, P)`` of the
        cohort plane ``x`` in one backward (each client's loss depends only
        on its own row, so the gradient of the sum is per-client)."""
        plane = x.detach().requires_grad_(True)
        with torch.enable_grad():
            losses = self.loss_fn(self.spec.unravel(plane), batch)
            (g,) = torch.autograd.grad(losses.sum(), plane)
        return losses.detach(), g

    def _flat_cohort_pass(self, x_t, m_t, batches, eta_l):
        """K local steps of the whole cohort on the ``(C, P)`` plane: one
        batched value-and-grad and ONE ``fed_direction`` launch per step.
        Returns (uplink planes by name, losses) with losses ``(C,)`` the
        per-client mean over the K steps."""
        cfg = self.cfg
        C = batches["y"].shape[0]
        auxes, coefs = direction_operands(self.algo, cfg, m_t, None, x_t, eta_l)
        x = x_t.expand(C, -1).contiguous()
        losses = []
        for k in range(cfg.local_steps):
            batch_k = {key: v[:, k] for key, v in batches.items()}
            loss, g = self._value_and_grad(x, batch_k)
            if cfg.weight_decay:
                g = cfg.weight_decay * x + g
            x = fed_direction(x, g, auxes, coefs)
            losses.append(loss)
        return sparse_client_finalize(x_t, x), torch.stack(losses, dim=1).mean(dim=1)

    # -------------------------------------------------- round
    def round_step(self, state: FedState, batches, ids, mask, n_clipped=None):
        """One round on given draws: ``batches`` = {"x": (C, K, B, ...),
        "y": (C, K, B)}, ``ids`` (C,), ``mask`` (C,) bool — the seam where a
        test injects the reference's draws.  ``ids`` selects no per-client
        state in the ported specs; ``n_clipped`` is the sampler's overflow
        count, reported in the metrics."""
        cfg, algo = self.cfg, self.algo
        fsrv = state.server
        eta_l = local_learning_rate(cfg, fsrv.round)
        x_t = state.params
        m_t = fsrv.momentum
        planes, losses = self._flat_cohort_pass(x_t, m_t, batches, eta_l)

        w = mask.to(torch.float32)
        n_active = w.sum()
        denom = n_active.clamp(min=1.0)
        new_x, new_m, mean_delta = fused_fold(algo, cfg, planes, w / denom, n_active,
                                              x_t, m_t, eta_l)
        # a below-quorum (or empty) cohort carries params/momentum through
        ok = n_active >= float(max(1, cfg.min_quorum))
        new_x = torch.where(ok, new_x, x_t)
        new_m = torch.where(ok, new_m, m_t)

        pay = self.payload_bytes()
        zero = torch.zeros((), dtype=torch.float32, device=x_t.device)
        metrics = RoundMetrics(
            loss=(losses * w).sum() / denom,
            n_active=n_active,
            delta_norm=_norm(mean_delta),
            momentum_norm=_norm(m_t),
            eta_l=eta_l,
            bytes_down=n_active * float(pay["down_per_client"]),
            bytes_up=n_active * float(pay["up_per_client"]),
            n_clipped=zero if n_clipped is None else n_clipped.to(torch.float32),
            n_dropped=zero,
            n_quarantined=zero,
            n_retries=zero,
            quorum_skipped=1.0 - ok.to(torch.float32),
        )
        new_server = fsrv._replace(momentum=new_m, round=fsrv.round + 1)
        return FedState(new_x, new_server, state.rng), metrics

    # -------------------------------------------------- data-driven round
    def _sample_round(self, state: FedState, data):
        gen = state.rng
        ids, mask, n_clipped = sample_cohort_ex(gen, self.cfg, self.device)
        batches = gather_round_batches(data.client_x, data.client_y, gen, ids,
                                       self.cfg.local_steps, self.batch_size)
        return batches, ids, mask, n_clipped

    def run_round(self, state: FedState, data) -> Tuple[FedState, RoundMetrics]:
        """Samples cohort + minibatches from a FederatedData and steps."""
        batches, ids, mask, n_clipped = self._sample_round(state, data)
        return self.round_step(state, batches, ids, mask, n_clipped)

    def run_rounds(self, state: FedState, data, n_rounds: int) -> Tuple[FedState, RoundMetrics]:
        """``n_rounds`` rounds as a Python loop; metrics come back stacked
        with a leading ``(n_rounds,)`` axis, still on the device."""
        if n_rounds < 1:
            raise ValueError(f"n_rounds must be >= 1, got {n_rounds}")
        rows = []
        for _ in range(n_rounds):
            state, m = self.run_round(state, data)
            rows.append(m)
        return state, RoundMetrics(*[torch.stack(col) for col in zip(*rows)])


# ----------------------------------------------------------------------
# evaluation
# ----------------------------------------------------------------------


def make_eval_fn(predict_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                 batch_size: int = 1000):
    """predict_fn(params, x) -> logits.  Returns eval(params, x, y) -> acc,
    with one device→host read per call."""

    @torch.no_grad()
    def evaluate(params, x, y) -> float:
        hits = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(0, x.shape[0], batch_size):
            logits = predict_fn(params, x[i:i + batch_size])
            hits += (logits.argmax(-1) == y[i:i + batch_size]).to(torch.float32).sum()
        return float(hits / x.shape[0])

    return evaluate
