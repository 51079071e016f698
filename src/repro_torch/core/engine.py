"""The federated round engine on the flat plane: sync rounds, the async ring
and the host population store.

Counterpart of ``repro.core.engine`` cut to the route this package ports —
``use_flat_plane`` with the fused kernels (the reference's
``use_fused_kernel=True``), for every registered algorithm.  A round is a
LAUNCH and a FOLD:

    launch: gather the cohort's client-state rows → broadcast (x_t, m) →
            K local steps over the cohort plane (+ MimeLite's full-batch
            gradient at x_t) → faults + quarantine → wire encoding
    fold:   fold rows + post-step (the staleness discount γ on the fold's
            coefficient row and on the post-step's mean) → quorum →
            scatter the client-state rows back

The cohort runs as ONE ``(C, P)`` plane, where the reference vmaps a
per-client scan: each local step is one batched forward/backward (the
model's products, left to PyTorch as the reference leaves them to XLA) and
ONE ``fed_direction`` launch for the whole cohort, with the broadcast plane
as ``(P,)`` and the client-state rows (SCAFFOLD's c_i, FedDyn's λ_i) as a
per-client ``(C, P)`` aux.  The fold is one ``server_update`` launch per
fold row — a row over a plane that arrives compressed to int8 or bf16 is
one ``dequant_update`` launch instead — then the spec's post-step (plain
PyTorch on ``(P,)`` planes).  All C = capacity rows compute; inactive rows
carry weight 0 in the fold, in the loss metric and in the scatter.

Three schedules drive these two steps, all plain Python loops:

* ``round_step`` / ``run_round`` / ``run_rounds`` — the sync round: launch,
  then fold at once (γ = 1);
* ``run_rounds_async`` — the async ring: each iteration launches a cohort
  against the current params and an S-rounds-stale broadcast momentum,
  pushes its uplink (``core.flat.CohortUplink``) into a depth-D ring and
  folds the oldest entry, D − 1 rounds old, with γ =
  ``staleness_discount^(D−1)``.  D = 1, S = 0 is the sync
  schedule bit for bit.  ``run_rounds_async_on`` is the loop itself, fed a
  callable that returns each round's draws (``RoundInputs``): the public
  loop feeds the engine's own sampler, the parity tests the reference's;
* ``population_store="host"`` — the same steps with the client-state (and
  top-k residual) rows gathered from and scattered to a host store
  (``repro_torch.data.population``) instead of an ``(N, P)`` device plane:
  ``run_rounds_store`` (the ring's loop at D = 1, S = 0, which is the sync
  schedule) and ``run_rounds_store_async``.  Store ≡ resident bit for bit.

Between the local steps and the fold sit the reference's two splices, each
absent when its config is None: fault injection and quarantine
(``cfg.fault``, ``repro_torch.core.faults``) and wire encoding
(``cfg.compression``, ``repro_torch.core.compress``).  Their draws are
counter-based hashes keyed by the device round counter
(``repro_torch.utils.draws``), or injected (``RoundDraws``).

Every per-round value — the round counter, η_l, the fold coefficients, the
cohort mask and |S| — lives in device memory, and nothing in a resident
round reads one back to the host.  The host store reads the cohort's ids.
The per-leaf tree path (A.16) and cohort sharding (A.14) raise
``NotImplementedError`` naming their ROADMAP item (``check_supported``).
"""
from __future__ import annotations

import math
import time
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import FedConfig
from repro_torch.core import algorithms  # noqa: F401  (registers the builtin specs)
from repro_torch.core.algorithms import sparse_client_finalize
from repro_torch.core.compress import (
    COMPRESS_STREAM,
    PLANE_STREAMS,
    QPlane,
    TopKPlane,
    as_qplane,
    carries_residuals,
    compress_plane,
    decompress_plane,
    error_feedback_topk,
    init_residuals,
    uplink_bytes_per_client,
    validate_compression,
)
from repro_torch.core.faults import (
    CORRUPT_MODES,
    corrupt_uplink,
    fault_masks,
    nanmedian_midpoint,
    rows_finite,
    rows_sqnorm,
    zero_rows,
)
from repro_torch.core.flat import CohortUplink, FlatSpec, ring_push
from repro_torch.core.registry import (
    ServerState,
    client_state_init,
    get_algorithm,
    list_algorithms,
    server_init,
)
from repro_torch.data.pipeline import gather_full_client_batch, gather_round_batches
from repro_torch.data.population import (
    AVAILABILITY_PROCESSES,
    POPULATION_STORES,
    TransientStoreError,
    availability_log_weights,
    make_population_store,
)
from repro_torch.kernels.fed_direction.ops import direction_operands, fed_direction
from repro_torch.kernels.server_update.ops import fused_fold
from repro_torch.utils.draws import uniform as hash_uniform


class FedState(NamedTuple):
    """Flat engine state.  ``params`` is the ``(P,)`` f32 plane, ``server``
    holds the ``(P,)`` momentum plane, the int32 round counter and the
    adaptive specs' ``(P,)`` second moment, ``rng`` the ``torch.Generator``
    the cohort and minibatch draws come from (advanced in place),
    ``residuals`` the ``(N, P)`` f32 top-k error-feedback rows (None unless
    the uplink is top-k on resident state), ``client_states`` the ``(N, P)``
    f32 per-client state plane — SCAFFOLD's c_i, FedDyn's λ_i — (None
    unless the spec keeps per-client state on resident state; under
    ``population_store="host"`` both live in host stores)."""

    params: torch.Tensor
    server: ServerState
    rng: Optional[torch.Generator] = None
    residuals: Optional[torch.Tensor] = None
    client_states: Optional[torch.Tensor] = None


class RoundDraws(NamedTuple):
    """Draws a caller hands ``round_step`` in place of the hash's (any may
    be None): the fault draws of ``faults.fault_masks`` and the int8
    rounding draws ``(C, P)`` of the delta plane (``u``), the state-delta
    plane and the extra plane.  The parity tests inject the reference's
    threefry draws through it."""

    u_drop: Optional[torch.Tensor] = None
    z_deadline: Optional[torch.Tensor] = None
    u_corrupt: Optional[torch.Tensor] = None
    z_noise: Optional[torch.Tensor] = None
    u: Optional[torch.Tensor] = None
    u_state_delta: Optional[torch.Tensor] = None
    u_extra: Optional[torch.Tensor] = None

    def rounding(self, plane: str) -> Optional[torch.Tensor]:
        """The injected int8 rounding draw of the uplink plane ``plane``."""
        return {"delta": self.u, "state_delta": self.u_state_delta,
                "extra": self.u_extra}[plane]


class RoundInputs(NamedTuple):
    """One round's draws as the loops consume them: ``batches`` =
    {"x": (C, K, B, ...), "y": (C, K, B)}, ``ids`` (C,) unique, ``mask``
    (C,) bool, the sampler's overflow count, each cohort client's whole
    dataset (MimeLite only) and injected fault / rounding draws."""

    batches: Dict[str, torch.Tensor]
    ids: torch.Tensor
    mask: torch.Tensor
    n_clipped: Optional[torch.Tensor] = None
    full_batches: Optional[Dict[str, torch.Tensor]] = None
    draws: Optional[RoundDraws] = None


class RoundMetrics(NamedTuple):
    loss: torch.Tensor  # mean local training loss over active cohort × K steps
    n_active: torch.Tensor
    delta_norm: torch.Tensor  # ‖mean Δ_i‖
    momentum_norm: torch.Tensor  # ‖Δ_t‖ (server momentum entering the round)
    eta_l: torch.Tensor
    bytes_down: torch.Tensor  # server→clients this round
    bytes_up: torch.Tensor  # clients→server this round
    n_clipped: torch.Tensor = None  # bernoulli draws beyond the cohort capacity
    # fault counters (0 when cfg.fault is None); retries count host-store
    # gather / scatter retries (population_store="host")
    n_dropped: torch.Tensor = None
    n_quarantined: torch.Tensor = None
    n_retries: torch.Tensor = None
    quorum_skipped: torch.Tensor = None  # 1.0 when survivors < max(1, min_quorum)


class AsyncRoundMetrics(NamedTuple):
    """Per-iteration metrics of the async ring.  ``loss`` / ``n_active`` /
    ``eta_l`` / ``momentum_norm`` / ``n_clipped`` / ``n_dropped`` /
    ``n_quarantined`` describe the cohort LAUNCHED this iteration;
    ``delta_norm`` / ``folded`` / ``quorum_skipped`` the fold (0 during the
    D − 1 fill iterations); ``eval_acc`` is −1.0 off the eval cadence."""

    loss: torch.Tensor
    n_active: torch.Tensor
    delta_norm: torch.Tensor
    momentum_norm: torch.Tensor  # ‖broadcast momentum‖ as the clients saw it
    eta_l: torch.Tensor
    bytes_down: torch.Tensor
    bytes_up: torch.Tensor
    folded: torch.Tensor  # 0/1: did this iteration fold a cohort
    eval_acc: torch.Tensor
    n_clipped: torch.Tensor = None
    n_dropped: torch.Tensor = None
    n_quarantined: torch.Tensor = None
    n_retries: torch.Tensor = None
    quorum_skipped: torch.Tensor = None


class _Launched(NamedTuple):
    """What a launch reports besides its ring entry."""

    n_active: torch.Tensor
    loss: torch.Tensor  # masked mean over the launched cohort
    n_dropped: torch.Tensor
    n_quarantined: torch.Tensor


def metrics_to_host(ms: NamedTuple) -> Dict[str, np.ndarray]:
    """Bring a (stacked) metrics tuple to the host in ONE transfer; returns
    ``{field: np.ndarray}`` with scalars as shape ``(1,)``."""
    named = [(f, v) for f, v in zip(ms._fields, ms) if v is not None]
    stacked = torch.stack([v.to(torch.float32).reshape(-1) for _, v in named]).cpu().numpy()
    return {f: np.atleast_1d(row) for (f, _), row in zip(named, stacked)}


def _stack(cls, rows):
    return cls(*[torch.stack(col) for col in zip(*rows)])


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
    (lambda c: c.cohort_shard > 0, "cohort_shard (multi-GPU cohort sharding)", "A.14"),
)


def check_supported(cfg: FedConfig) -> None:
    """Raise ``NotImplementedError`` (naming the ROADMAP item) for any part
    of ``cfg`` the port does not run yet, ``ValueError`` for bad values."""
    for pred, what, item in _UNPORTED:
        if pred(cfg):
            raise NotImplementedError(
                f"{what} is not ported to repro_torch yet (ROADMAP {item})")
    if cfg.algo not in list_algorithms():
        raise ValueError(f"unknown federated algorithm {cfg.algo!r}; registered: "
                         f"{list(list_algorithms())}")
    if cfg.participation not in ("fixed", "bernoulli"):
        raise ValueError(f"unknown participation {cfg.participation!r}")
    for name in ("momentum_dtype", "aggregate_dtype"):
        if getattr(cfg, name) not in ("float32", "bfloat16"):
            raise ValueError(f"{name} must be 'float32' or 'bfloat16'")
    if cfg.fault is not None and cfg.fault.corrupt_mode not in CORRUPT_MODES:
        raise ValueError(f"unknown corrupt_mode {cfg.fault.corrupt_mode!r}; "
                         f"known: nan | inf | noise")
    if cfg.population_store not in POPULATION_STORES:
        raise ValueError(f"unknown population_store {cfg.population_store!r}; "
                         f"known: {POPULATION_STORES}")
    if cfg.availability not in AVAILABILITY_PROCESSES:
        raise ValueError(f"unknown availability process {cfg.availability!r}; "
                         f"known: {AVAILABILITY_PROCESSES}")


def cohort_capacity(cfg: FedConfig) -> int:
    """Static cohort axis length. ``fixed``: exactly S. ``bernoulli``: a
    Binomial(N, p) tail bound, mean + ``bernoulli_capacity_sigma``·σ,
    clipped to N."""
    if cfg.participation == "fixed":
        return cfg.cohort_size
    p = cfg.cohort_size / cfg.num_clients
    sd = math.sqrt(cfg.num_clients * p * (1 - p))
    return min(cfg.num_clients, int(math.ceil(cfg.cohort_size + cfg.bernoulli_capacity_sigma * sd)))


def sample_cohort_ex(generator: torch.Generator, cfg: FedConfig, device, t=None):
    """Cohort draw on ``device``.  Returns ``(client_ids (C,), active_mask
    (C,), n_clipped ())`` with C the cohort capacity; the ids are unique,
    which the client-state scatter relies on.

    Uniform availability: the ids are the head of a random permutation;
    under ``bernoulli`` the count s of independent draws at p = S/N
    activates the first s rows (``mask = arange(C) < s``).  Non-uniform
    (``availability_log_weights``, ``t`` the round counter the diurnal
    process reads): a Gumbel top-k over the log weights, a weighted choice
    without replacement, thinned under ``bernoulli`` by per-client
    probabilities ``clip(S·softmax(logw), 0, 1)``.  Draws beyond capacity
    are counted in ``n_clipped``.  ``cfg.dropout_rate`` then drops each
    selected client from the mask independently; a cohort that loses
    everyone keeps its first client unless ``allow_empty_cohort``.  With
    uniform availability and no dropout the generator is consumed exactly
    as by the plain draw."""
    cap = cohort_capacity(cfg)
    logw = availability_log_weights(cfg, t, device)
    if logw is None:
        ids = torch.randperm(cfg.num_clients, generator=generator, device=device)[:cap]
    else:
        u = torch.rand(cfg.num_clients, generator=generator, device=device)
        tiny = torch.finfo(torch.float32).tiny
        gumbel = -torch.log(-torch.log(torch.clamp(u, min=tiny)))
        ids = torch.topk(logw + gumbel, cap).indices
    n_clipped = torch.zeros((), dtype=torch.int32, device=device)
    if cfg.participation == "fixed":
        mask = torch.ones(cap, dtype=torch.bool, device=device)
    else:
        if logw is None:
            q = cfg.cohort_size / cfg.num_clients
        else:
            q = torch.clamp(cfg.cohort_size * torch.softmax(logw, dim=0), 0.0, 1.0)
        draws = torch.rand(cfg.num_clients, generator=generator, device=device) < q
        s_raw = draws.sum().to(torch.int32)
        s = s_raw.clamp(0 if cfg.allow_empty_cohort else 1, cap)
        mask = torch.arange(cap, device=device) < s
        n_clipped = (s_raw - cap).clamp(min=0)
    if cfg.dropout_rate > 0.0:
        keep = torch.rand(cap, generator=generator, device=device) < 1.0 - cfg.dropout_rate
        kept = mask & keep
        if cfg.allow_empty_cohort:
            mask = kept
        else:
            first = mask & (torch.arange(cap, device=device) == mask.to(torch.int8).argmax())
            mask = torch.where(kept.any(), kept, first)
    return ids, mask, n_clipped


def local_learning_rate(cfg: FedConfig, t: torch.Tensor) -> torch.Tensor:
    """Appendix C.2: exponential per-round decay of η_l, as an f32 device
    tensor computed from the device round counter."""
    base = torch.full((), cfg.eta_l, dtype=torch.float32, device=t.device)
    decay = torch.full((), cfg.eta_l_decay, dtype=torch.float32, device=t.device)
    return base * decay ** t.to(torch.float32)


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(torch.square(x.to(torch.float32))))


@torch.no_grad()
def _accuracy(predict_fn, params, x, y, batch_size: int) -> torch.Tensor:
    """Test accuracy as a device scalar (no host read)."""
    hits = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, x.shape[0], batch_size):
        logits = predict_fn(params, x[i:i + batch_size])
        hits += (logits.argmax(-1) == y[i:i + batch_size]).to(torch.float32).sum()
    return hits / x.shape[0]


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
        state, metrics = eng.run_rounds_async(state, data, n_rounds,
                                              pipeline_depth=2, staleness=1)
        state, metrics = eng.round_step(state, batches, ids, mask,
                                        full_batches=full)  # full: MimeLite only

    ``data`` is a ``FederatedData`` (device-resident shards) or, under
    ``population_store="host"``, also a ``StreamingClientData``.
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
        self.compression = cfg.compression
        if self.compression is not None:
            validate_compression(self.compression)
        # host stores of the client-state rows and the top-k residual rows
        # (population_store="host"), attached by init()
        self.population = None
        self.residual_population = None

    @property
    def _host(self) -> bool:
        return self.cfg.population_store == "host"

    # -------------------------------------------------- init
    def init(self, params, generator: Optional[torch.Generator] = None) -> FedState:
        """Ravel ``params`` (any device) onto this engine's device and
        allocate the planes the spec's flags require: the server planes
        (the second moment iff ``needs_second_moment``), the ``(N, P)`` zero
        client-state plane iff ``needs_client_state``, and the ``(N, P)``
        zero residual rows under top-k compression.  Under
        ``population_store="host"`` neither ``(N, P)`` plane is allocated:
        fresh host stores are attached as ``self.population`` (stateful
        specs) and ``self.residual_population`` (top-k)."""
        cfg, size = self.cfg, self.spec.size
        residuals = client_states = None
        if self._host:
            self.population = (make_population_store(cfg, size)
                               if self.algo.needs_client_state else None)
            self.residual_population = (make_population_store(cfg, size)
                                        if carries_residuals(self.compression) else None)
        else:
            residuals = init_residuals(self.compression, cfg.num_clients, size, self.device)
            client_states = client_state_init(self.algo, cfg.num_clients, size, self.device)
        return FedState(
            params=self.spec.ravel(params).to(self.device),
            server=server_init(size, self.algo.momentum_dtype(cfg), device=self.device,
                               needs_second_moment=self.algo.needs_second_moment),
            rng=generator,
            residuals=residuals,
            client_states=client_states,
        )

    def payload_bytes(self) -> Dict[str, int]:
        """Per-client per-round communication in bytes (§4.2): x_t down,
        plus Δ_t (or SCAFFOLD's c) when the spec broadcasts it; up, P per
        wire plane (``wire_uplink_planes``), or under compression the
        planes' bytes on the wire."""
        nbytes = self.spec.nbytes
        down = nbytes * (2 if self.algo.needs_momentum_broadcast else 1)
        up = uplink_bytes_per_client(self.compression, self.algo.wire_uplink_planes,
                                     self.spec.size, nbytes)
        return {"down_per_client": down, "up_per_client": up}

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

    def _flat_cohort_pass(self, x_t, m_t, batches, eta_l, cst=None, full_batches=None):
        """K local steps of the whole cohort on the ``(C, P)`` plane: one
        batched value-and-grad and ONE ``fed_direction`` launch per step.
        ``m_t`` is the broadcast plane the clients descend against (the
        current momentum, or an S-rounds-stale one on the async ring),
        ``cst`` the cohort's ``(C, P)`` client-state rows (the
        ``client_state`` stream), ``full_batches`` each client's whole
        dataset, over which a full-batch spec takes one more batched
        gradient at x_t.  Returns (uplink planes by name, losses) with
        losses ``(C,)`` the per-client mean over the K steps."""
        cfg, algo = self.cfg, self.algo
        C = batches["y"].shape[0]
        auxes, coefs = direction_operands(algo, cfg, m_t, cst, x_t, eta_l)
        x0 = x_t.expand(C, -1).contiguous()
        x = x0
        losses = []
        for k in range(cfg.local_steps):
            batch_k = {key: v[:, k] for key, v in batches.items()}
            loss, g = self._value_and_grad(x, batch_k)
            if cfg.weight_decay:
                g = cfg.weight_decay * x + g
            x = fed_direction(x, g, auxes, coefs)
            losses.append(loss)
        full_grad = None
        if algo.needs_full_grad:
            _, full_grad = self._value_and_grad(x0, full_batches)
        planes = sparse_client_finalize(algo, cfg, x_t, x, cst, m_t, eta_l, full_grad)
        return planes, torch.stack(losses, dim=1).mean(dim=1)

    def _client_rows(self, state: FedState, ids) -> torch.Tensor:
        """The cohort's ``(C, P)`` client-state rows from the resident plane."""
        if state.client_states is None:
            raise ValueError(f"{self.algo.name} keeps per-client state — call "
                             f"eng.init(params, generator) so FedState.client_states "
                             f"is allocated before stepping")
        return state.client_states.index_select(0, ids.long())

    # -------------------------------------------------- faults
    def _inject_faults(self, t, ids, mask, planes, d: RoundDraws):
        """Apply the fault model to one cohort's uplink, between the local
        steps and the fold.  Returns ``(mask, planes, n_dropped,
        n_quarantined)``.

        Drops and the deadline thin the mask; corruption rewrites the delta
        rows of surviving clients; quarantine both masks out and zeroes, in
        every uplink plane, the rows of a client with a non-finite element
        in any plane or a delta-norm outlier (exact zeros: a 0-weight NaN
        row would still poison the fold).  With ``cfg.fault`` None nothing
        runs."""
        fault = self.cfg.fault
        zero = torch.zeros((), dtype=torch.float32, device=mask.device)
        if fault is None:
            return mask, planes, zero, zero
        delta = planes["delta"]
        plan = fault_masks(fault, t, ids, delta.shape[-1], u_drop=d.u_drop,
                           z_deadline=d.z_deadline, u_corrupt=d.u_corrupt,
                           z_noise=d.z_noise)
        n_dropped = zero
        if fault.drop_rate > 0.0 or fault.deadline > 0.0:
            n_dropped = (mask & plan.drop).to(torch.float32).sum()
            mask = mask & ~plan.drop
        if fault.corrupt_rate > 0.0:
            delta = corrupt_uplink(fault, plan.corrupt & mask, plan.noise, delta)
        planes = {**planes, "delta": delta}
        n_quar = zero
        if fault.quarantine:
            fin = rows_finite(delta)
            for name in ("state_delta", "extra"):
                if planes.get(name) is not None:
                    fin = fin & rows_finite(planes[name])
            bad = ~fin
            if fault.quarantine_norm_mult > 0.0:
                norm = torch.sqrt(rows_sqnorm(delta))
                act = mask & fin
                med = nanmedian_midpoint(torch.where(act, norm, float("nan")))
                bad = bad | (act & (norm > fault.quarantine_norm_mult * med))
            n_quar = (mask & bad).to(torch.float32).sum()
            planes = {k: None if v is None else zero_rows(v, bad) for k, v in planes.items()}
            mask = mask & ~bad
        return mask, planes, n_dropped, n_quar

    # -------------------------------------------------- uplink compression
    def _residual_rows_for(self, state: FedState, ids):
        """The cohort's error-feedback residual rows (top-k only)."""
        if not carries_residuals(self.compression):
            return None
        if state.residuals is None:
            raise ValueError("topk compression carries an error-feedback residual "
                             "stream — call eng.init(params, generator) so "
                             "FedState.residuals is allocated before stepping")
        return state.residuals.index_select(0, ids.long())

    def _compress_uplink(self, t, ids, planes, w, residual_rows, d: RoundDraws):
        """Wire-encode the cohort's wire planes (``wire_uplink_planes``),
        between fault injection and fold.  Returns ``(planes,
        new_residual_rows)`` (rows None except under top-k).  Each plane
        stays in its wire form until the fold: int8 and bf16 planes as a
        ``QPlane`` for the dequant kernel, each with its own rounding
        stream (the fold decodes ``state_delta`` once more for the
        client-state scatter); top-k sparsifies the delta plane only (the
        other wire planes ride f32) into a ``TopKPlane`` that the fold
        densifies.  ``w`` (the post-fault weights) keeps the residual of a
        client that did not transmit."""
        comp = self.compression
        out = dict(planes)
        new_rows = None
        for name in self.algo.wire_uplink_planes:
            pv = planes[name]
            if comp.kind == "topk":
                if name == "delta":
                    out[name], _, new_rows = error_feedback_topk(comp, pv, residual_rows, w,
                                                                 pv.shape[-1])
                continue
            u = d.rounding(name)
            if comp.kind == "int8" and u is None:
                u = hash_uniform(comp.seed, t, COMPRESS_STREAM + PLANE_STREAMS[name], ids,
                                 pv.shape[-1])
            out[name] = as_qplane(compress_plane(comp, pv, u))
        return out, new_rows

    # -------------------------------------------------- launch and fold
    def _launch(self, state: FedState, m_used, inp: RoundInputs, cohort_rows=None,
                residual_rows=None):
        """Client phase of a round: run the cohort against (current params,
        broadcast plane ``m_used``), apply faults and wire encoding (at
        launch: drops and corruption happen on the wire, and a top-k
        residual updates when its client transmits), and pack the uplink as
        a ring entry carrying its launch-time η_l.  ``cohort_rows`` /
        ``residual_rows`` are host-store rows in place of the resident
        gathers.  Returns ``(entry, _Launched, new_residual_rows)``."""
        cfg, algo = self.cfg, self.algo
        d = inp.draws or RoundDraws()
        t = state.server.round
        eta_l = local_learning_rate(cfg, t)
        cst = None
        if algo.needs_client_state:
            cst = cohort_rows if cohort_rows is not None else self._client_rows(state, inp.ids)
        if algo.needs_full_grad and inp.full_batches is None:
            raise ValueError(f"{algo.name} takes a full-batch gradient at x_t: pass "
                             f"full_batches (data.pipeline.gather_full_client_batch)")
        planes, losses = self._flat_cohort_pass(state.params, m_used, inp.batches, eta_l, cst,
                                                inp.full_batches)
        mask, planes, n_dropped, n_quar = self._inject_faults(t, inp.ids, inp.mask, planes, d)
        w = mask.to(torch.float32)
        n_active = w.sum()
        new_res_rows = None
        if self.compression is not None:
            res = (residual_rows if residual_rows is not None
                   else self._residual_rows_for(state, inp.ids))
            planes, new_res_rows = self._compress_uplink(t, inp.ids, planes, w, res, d)
        entry = CohortUplink(delta=planes["delta"], state_delta=planes.get("state_delta"),
                             extra=planes.get("extra"), ids=inp.ids, w=w, eta_l=eta_l)
        loss = (losses * w).sum() / n_active.clamp(min=1.0)
        return entry, _Launched(n_active, loss, n_dropped, n_quar), new_res_rows

    def _close_post(self, fsrv: ServerState, new_x, new_m, mean_delta, n_active, eta_l,
                    discount: float = 1.0):
        """Adopt the folded momentum, then run the spec's post-step on the
        ``(P,)`` planes with the discounted cohort mean γ·mean of the delta
        plane (the fold returns it undiscounted; the post-step reads the
        post-fold momentum)."""
        new_server = fsrv._replace(momentum=new_m)
        post = self.algo.server_post_fn
        if post is not None:
            dmean = mean_delta if discount == 1.0 else discount * mean_delta
            new_x, new_server = post(self.cfg, new_x, new_server, dmean, n_active, eta_l)
        return new_x, new_server

    def _fold(self, state: FedState, entry: CohortUplink, discount: float = 1.0,
              fold_rows=None, emit_rows: bool = False):
        """Server phase: fold ONE entry into the state — the spec's fold
        rows with the entry's launch-time η_l and the staleness discount
        ``discount`` on the coefficient row, the post-step, the quorum
        (enforced here: the surviving weights are final only now), and the
        client-state scatter, whose base rows are gathered at fold time
        (``fold_rows`` from a host store, else the resident plane).  A
        compressed state delta is decoded for the scatter; with
        ``emit_rows`` the updated ``(C, P)`` rows come back instead of being
        scattered.  Leaves the round counter alone.  Returns ``(state,
        ‖mean Δ‖, quorum_skipped, rows)``."""
        cfg, algo = self.cfg, self.algo
        delta = entry.delta
        if isinstance(delta, TopKPlane):
            delta = decompress_plane(delta, self.spec.size)
        w = entry.w
        n_active = w.sum()
        x_t, fsrv = state.params, state.server
        planes = {"delta": delta, "state_delta": entry.state_delta, "extra": entry.extra}
        new_x, new_m, mean_delta = fused_fold(algo, cfg, planes, w / n_active.clamp(min=1.0),
                                              n_active, x_t, fsrv.momentum, entry.eta_l,
                                              discount=discount)
        new_x, new_server = self._close_post(fsrv, new_x, new_m, mean_delta, n_active,
                                             entry.eta_l, discount)
        # a below-quorum (or empty) cohort carries the server planes through
        ok = n_active >= float(max(1, cfg.min_quorum))
        new_x = torch.where(ok, new_x, x_t)
        sm = new_server.second_moment
        new_server = new_server._replace(
            momentum=torch.where(ok, new_server.momentum, fsrv.momentum),
            second_moment=None if sm is None else torch.where(ok, sm, fsrv.second_moment))
        # client-state rows of active members only; below quorum the
        # weights are zero and each row is written back as cst + 0·sd
        new_cst, rows = state.client_states, None
        if algo.needs_client_state:
            sd = entry.state_delta
            if isinstance(sd, QPlane):
                sd = decompress_plane(sd)
            base = fold_rows if fold_rows is not None else self._client_rows(state, entry.ids)
            rows = base + sd * (w * ok.to(torch.float32))[:, None]
            if not emit_rows:
                new_cst = new_cst.index_copy(0, entry.ids.long(), rows)
                rows = None
        state = state._replace(params=new_x, server=new_server, client_states=new_cst)
        return state, _norm(mean_delta), 1.0 - ok.to(torch.float32), rows

    @staticmethod
    def _adopt_residuals(state: FedState, ids, new_rows) -> FedState:
        """Write a launch's top-k residual rows into the resident plane: the
        residual is client-side state, updated whatever the quorum decides."""
        if new_rows is None or state.residuals is None:
            return state
        return state._replace(residuals=state.residuals.index_copy(0, ids.long(), new_rows))

    # -------------------------------------------------- sync round
    def round_step(self, state: FedState, batches, ids, mask, n_clipped=None,
                   draws: Optional[RoundDraws] = None, full_batches=None):
        """One round on given draws: ``batches`` = {"x": (C, K, B, ...),
        "y": (C, K, B)}, ``ids`` (C,) unique, ``mask`` (C,) bool — the seam
        where a test injects the reference's draws, with ``draws`` in place
        of the fault and rounding hashes.  ``ids`` keys the fault and
        rounding draws and selects the residual and client-state rows;
        ``n_clipped`` is the sampler's overflow count, reported in the
        metrics; ``full_batches`` = {"x": (C, n, ...), "y": (C, n)} is each
        client's whole dataset, which a full-batch spec (MimeLite) needs.

        The round is a launch and an immediate fold (γ = 1)."""
        inp = RoundInputs(batches, ids, mask, n_clipped, full_batches, draws)
        m_t = state.server.momentum
        entry, lau, new_res = self._launch(state, m_t, inp)
        state = self._adopt_residuals(state, ids, new_res)
        state, norm, skipped, _ = self._fold(state, entry, 1.0)
        state = state._replace(server=state.server._replace(round=state.server.round + 1))
        pay = self.payload_bytes()
        zero = torch.zeros((), dtype=torch.float32, device=m_t.device)
        metrics = RoundMetrics(
            loss=lau.loss,
            n_active=lau.n_active,
            delta_norm=norm,
            momentum_norm=_norm(m_t),
            eta_l=entry.eta_l,
            bytes_down=lau.n_active * float(pay["down_per_client"]),
            bytes_up=lau.n_active * float(pay["up_per_client"]),
            n_clipped=zero if n_clipped is None else n_clipped.to(torch.float32),
            n_dropped=lau.n_dropped,
            n_quarantined=lau.n_quarantined,
            n_retries=zero,
            quorum_skipped=skipped,
        )
        return state, metrics

    # -------------------------------------------------- data-driven round
    def _draw_round(self, generator, t, data) -> RoundInputs:
        """One round's cohort and minibatches from device-resident data
        (and, for a full-batch spec, each cohort client's whole dataset);
        ``t`` is the round counter the availability process reads."""
        ids, mask, n_clipped = sample_cohort_ex(generator, self.cfg, self.device, t)
        batches = gather_round_batches(data.client_x, data.client_y, generator, ids,
                                       self.cfg.local_steps, self.batch_size)
        full = None
        if self.algo.needs_full_grad:
            full = gather_full_client_batch(data.client_x, data.client_y, ids)
        return RoundInputs(batches, ids, mask, n_clipped, full)

    def _sample_round(self, state: FedState, data):
        inp = self._draw_round(state.rng, state.server.round, data)
        return inp.batches, inp.ids, inp.mask, inp.n_clipped

    def run_round(self, state: FedState, data) -> Tuple[FedState, RoundMetrics]:
        """Samples cohort + minibatches from the data and steps; a
        full-batch spec also gets each cohort client's whole dataset."""
        if self._host:
            state, ms = self.run_rounds_store(state, data, 1)
            return state, RoundMetrics(*[None if v is None else v[0] for v in ms])
        inp = self._draw_round(state.rng, state.server.round, data)
        return self.round_step(state, inp.batches, inp.ids, inp.mask, inp.n_clipped,
                               full_batches=inp.full_batches)

    def run_rounds(self, state: FedState, data, n_rounds: int) -> Tuple[FedState, RoundMetrics]:
        """``n_rounds`` rounds as a Python loop; metrics come back stacked
        with a leading ``(n_rounds,)`` axis, still on the device."""
        if n_rounds < 1:
            raise ValueError(f"n_rounds must be >= 1, got {n_rounds}")
        if self._host:
            return self.run_rounds_store(state, data, n_rounds)
        rows = []
        for _ in range(n_rounds):
            state, m = self.run_round(state, data)
            rows.append(m)
        return state, _stack(RoundMetrics, rows)

    # -------------------------------------------------- async ring
    def _async_args(self, n_rounds, pipeline_depth, staleness) -> Tuple[int, int]:
        D = self.cfg.pipeline_depth if pipeline_depth is None else pipeline_depth
        S = self.cfg.staleness if staleness is None else staleness
        if n_rounds < 1:
            raise ValueError(f"n_rounds must be >= 1, got {n_rounds}")
        if D < 1:
            raise ValueError(f"pipeline_depth must be >= 1, got {D}")
        if S < 0:
            raise ValueError(f"staleness must be >= 0, got {S}")
        return D, S

    def run_rounds_async(self, state: FedState, data, n_rounds: int, *,
                         pipeline_depth: Optional[int] = None, staleness: Optional[int] = None,
                         eval_every: int = 0, eval_data=None, predict_fn=None,
                         eval_batch_size: int = 1000, drain: bool = True):
        """Overlapping cohorts: ``n_rounds`` iterations, each launching one
        cohort against the current params and a broadcast momentum
        ``staleness`` rounds stale, pushing its uplink into a
        ``pipeline_depth``-deep ring and folding the oldest entry with the
        staleness discount γ = ``cfg.staleness_discount^(D−1)`` (the
        fold's coefficient row and the post-step's mean).  The first D − 1
        iterations only launch (``metrics.folded`` 0); ``drain`` folds the
        entries still in flight at the end, oldest first, with the same γ.
        The round counter is launch-aligned, so η_l and the fault and
        rounding draws follow the sync schedule; D = 1, S = 0 IS the sync
        schedule, bit for bit.

        ``eval_every > 0`` (with ``predict_fn`` and ``eval_data=(x, y)``)
        evaluates the post-fold params every eval_every-th iteration
        (``metrics.eval_acc``, −1.0 off the cadence).  Under
        ``population_store="host"`` the ring runs with the host stores
        (``run_rounds_store_async``), without in-loop eval."""
        D, S = self._async_args(n_rounds, pipeline_depth, staleness)
        if self._host:
            if eval_every:
                raise ValueError("population_store='host' runs the async ring with host "
                                 "stores — in-loop eval is unavailable; eval between calls")
            return self.run_rounds_store_async(state, data, n_rounds, pipeline_depth=D,
                                               staleness=S, drain=drain)
        evaluate = None
        if eval_every:
            if predict_fn is None or eval_data is None:
                raise ValueError("eval_every > 0 needs predict_fn and eval_data=(x, y)")
            x_te, y_te = eval_data

            def evaluate(plane):
                return _accuracy(predict_fn, self.spec.unravel(plane), x_te, y_te,
                                 eval_batch_size)

        state, ms, _ = self.run_rounds_async_on(
            state, lambda st: self._draw_round(st.rng, st.server.round, data), n_rounds,
            pipeline_depth=D, staleness=S, drain=drain, evaluate=evaluate,
            eval_every=eval_every)
        return state, ms

    def run_rounds_async_on(self, state: FedState, inputs: Callable[[FedState], RoundInputs],
                            n_rounds: int, *, pipeline_depth: int, staleness: int,
                            drain: bool = True, evaluate=None, eval_every: int = 0):
        """The async loop on given draws: ``inputs(state)`` returns each
        iteration's ``RoundInputs`` (``run_rounds_async`` feeds the engine's
        sampler, the parity tests the reference's draws).  Returns
        ``(state, AsyncRoundMetrics stacked, pending)``, ``pending`` the
        entries still in flight (empty after ``drain``; ``drain_async``
        folds them later).  Under ``population_store="host"`` the rows come
        from and go back to the host stores at the resident gather and
        scatter points: at launch, and at fold time."""
        cfg, algo = self.cfg, self.algo
        D, S = self._async_args(n_rounds, pipeline_depth, staleness)
        store, res_store = self._stores()
        mhist = None
        if S > 0 and algo.needs_momentum_broadcast:
            # slot t mod S holds the momentum entering round t − S
            mhist = [state.server.momentum] * S
        discount = float(cfg.staleness_discount) ** (D - 1)
        pay = self.payload_bytes()
        dev = state.params.device
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        pending: Tuple[CohortUplink, ...] = ()
        rows = []
        for t in range(n_rounds):
            r0 = state.server.round
            inp = inputs(state)
            m_used = state.server.momentum
            if mhist is not None:
                m_used, mhist[t % S] = mhist[t % S], state.server.momentum
            retries = 0
            stored = store is not None or res_store is not None
            ids_np = inp.ids.cpu().numpy() if stored else None
            cohort_rows, res_rows, r = self._gather_rows(store, res_store, ids_np)
            retries += r
            entry, lau, new_res = self._launch(state, m_used, inp, cohort_rows, res_rows)
            if res_store is not None:
                retries += self._scatter_rows(None, res_store, ids_np, None, new_res)
            else:
                state = self._adopt_residuals(state, inp.ids, new_res)
            if len(pending) + 1 >= D:
                oldest, pending = ring_push(pending, entry)
                state, norm, skipped, r = self._fold_stored(state, oldest, discount, store)
                retries += r
                folded = 1.0
            else:  # pipeline fill: launch only
                pending = (*pending, entry)
                norm = skipped = zero
                folded = 0.0
            # the round counter is launch-aligned, as in the sync schedule
            state = state._replace(server=state.server._replace(round=r0 + 1))
            eval_acc = (evaluate(state.params) if evaluate is not None
                        and (t + 1) % eval_every == 0 else zero - 1.0)
            rows.append(AsyncRoundMetrics(
                loss=lau.loss,
                n_active=lau.n_active,
                delta_norm=norm,
                momentum_norm=_norm(m_used),
                eta_l=entry.eta_l,
                bytes_down=lau.n_active * float(pay["down_per_client"]),
                bytes_up=lau.n_active * float(pay["up_per_client"]),
                folded=zero + folded,
                eval_acc=eval_acc,
                n_clipped=zero if inp.n_clipped is None else inp.n_clipped.to(torch.float32),
                n_dropped=lau.n_dropped,
                n_quarantined=lau.n_quarantined,
                n_retries=zero + retries,
                quorum_skipped=skipped,
            ))
        if drain:
            state = self.drain_async(state, pending, D)
            pending = ()
        return state, _stack(AsyncRoundMetrics, rows), pending

    def drain_async(self, state: FedState, pending, pipeline_depth: int) -> FedState:
        """Fold the entries still in flight, oldest first, with the
        discount of a ``pipeline_depth``-deep ring (the configured overlap,
        whatever ``len(pending)`` is).  The round counter stays."""
        discount = float(self.cfg.staleness_discount) ** (pipeline_depth - 1)
        store, _ = self._stores()
        for entry in pending:
            state = self._fold_stored(state, entry, discount, store)[0]
        return state

    # -------------------------------------------------- host population store
    def _stores(self):
        """``(client-state store, residual store)`` of the host path; each
        None where the run keeps no such rows (and on resident state)."""
        if not self._host:
            return None, None
        store = res_store = None
        if self.algo.needs_client_state:
            if self.population is None:
                raise RuntimeError("population store missing — call eng.init(params, "
                                   "generator) before store-backed rounds")
            store = self.population
        if carries_residuals(self.compression):
            if self.residual_population is None:
                raise RuntimeError("residual store missing — call eng.init(params, "
                                   "generator) before store-backed rounds with topk "
                                   "compression")
            res_store = self.residual_population
        return store, res_store

    def _store_io(self, fn, *args):
        """A host-store gather / scatter with capped exponential backoff on
        ``TransientStoreError``, re-raised once ``store_max_retries`` retries
        are spent.  Returns ``(result, n_retries)``; a retry repeats the same
        operation, so retries never change the math."""
        fault = self.cfg.fault
        if fault is None:
            return fn(*args), 0
        attempt = 0
        while True:
            try:
                return fn(*args), attempt
            except TransientStoreError:
                if attempt >= fault.store_max_retries:
                    raise
                delay = min(float(fault.store_backoff_cap),
                            float(fault.store_backoff_base) * (2.0 ** attempt))
                if delay > 0.0:
                    time.sleep(delay)
                attempt += 1

    def _gather_rows(self, store, res_store, ids_np):
        """The cohort's rows from both stores (None where there is no
        store), on the device.  Returns ``(rows, residual_rows,
        n_retries)``."""
        out, retries = [], 0
        for s in (store, res_store):
            got = None
            if s is not None:
                got, r = self._store_io(s.gather, ids_np)
                retries += r
                got = torch.from_numpy(got).to(self.device)
            out.append(got)
        return out[0], out[1], retries

    def _scatter_rows(self, store, res_store, ids_np, rows, res_rows) -> int:
        """Write updated rows back to both stores; returns the retries."""
        retries = 0
        for s, got in ((store, rows), (res_store, res_rows)):
            if s is not None and got is not None:
                retries += self._store_io(s.scatter, ids_np, got.cpu().numpy())[1]
        return retries

    def _fold_stored(self, state: FedState, entry: CohortUplink, discount: float, store):
        """``_fold`` with the client-state rows gathered from ``store`` at
        fold time and scattered back (resident when ``store`` is None).
        Returns ``(state, ‖mean Δ‖, quorum_skipped, n_retries)``."""
        if store is None:
            state, norm, skipped, _ = self._fold(state, entry, discount)
            return state, norm, skipped, 0
        ids_np = entry.ids.cpu().numpy()
        frows, _, retries = self._gather_rows(store, None, ids_np)
        state, norm, skipped, rows = self._fold(state, entry, discount, fold_rows=frows,
                                                emit_rows=True)
        return state, norm, skipped, retries + self._scatter_rows(store, None, ids_np, rows,
                                                                  None)

    def _host_sample(self, generator, t, data):
        """One round's draws under the host loop.  Device-resident data goes
        through the resident sampler (the same draws as ``run_rounds``);
        streaming data (``StreamingClientData``) samples the ids on the
        device, then one int seed from the same generator for
        ``host_round_batches``."""
        if hasattr(data, "client_x"):
            return self._draw_round(generator, t, data)
        ids, mask, n_clipped = sample_cohort_ex(generator, self.cfg, self.device, t)
        seed = int(torch.randint(0, 2**31 - 1, (), generator=generator, device=self.device))
        ids_np = ids.cpu().numpy()
        raw = data.host_round_batches(ids_np, seed, self.cfg.local_steps, self.batch_size)
        batches = {k: torch.from_numpy(v).to(self.device) for k, v in raw.items()}
        full = None
        if self.algo.needs_full_grad:
            full = {k: torch.from_numpy(v).to(self.device)
                    for k, v in data.host_full_batches(ids_np).items()}
        return RoundInputs(batches, ids, mask, n_clipped, full)

    def run_rounds_store(self, state: FedState, data, n_rounds: int):
        """The sync schedule for ``population_store="host"``: the ring's
        loop at D = 1, S = 0 (which is the sync round, bit for bit) with the
        cohort's rows gathered from the stores at launch and at fold time
        and scattered back after the fold.  No ``(N, ·)`` device plane
        exists, so N is bounded by host memory over the touched clients.
        ``data`` is a ``FederatedData`` (the same draws as the resident
        engine's) or a ``StreamingClientData``.  Returns ``(state,
        RoundMetrics)``."""
        state, ms = self.run_rounds_store_async(state, data, n_rounds, pipeline_depth=1,
                                                staleness=0)
        return state, RoundMetrics(**{f: getattr(ms, f) for f in RoundMetrics._fields})

    def run_rounds_store_async(self, state: FedState, data, n_rounds: int, *,
                               pipeline_depth: Optional[int] = None,
                               staleness: Optional[int] = None, drain: bool = True):
        """The async ring for ``population_store="host"``: the resident
        ring's loop (``run_rounds_async_on``) with host-store gathers and
        scatters at the resident gather and scatter points — at launch for
        the local steps and the top-k residuals, at fold time for the
        client-state scatter.  The ring's planes are ``(C, P)``, never
        ``(N, ·)``.  Returns ``(state, AsyncRoundMetrics)``."""
        D, S = self._async_args(n_rounds, pipeline_depth, staleness)
        state, ms, _ = self.run_rounds_async_on(
            state, lambda st: self._host_sample(st.rng, st.server.round, data), n_rounds,
            pipeline_depth=D, staleness=S, drain=drain)
        return state, ms


# ----------------------------------------------------------------------
# evaluation
# ----------------------------------------------------------------------


def make_eval_fn(predict_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                 batch_size: int = 1000):
    """predict_fn(params, x) -> logits.  Returns eval(params, x, y) -> acc,
    with one device→host read per call."""

    def evaluate(params, x, y) -> float:
        return float(_accuracy(predict_fn, params, x, y, batch_size))

    return evaluate
