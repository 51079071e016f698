"""The federated round engine: one synchronous round on the flat plane.

Counterpart of ``repro.core.engine`` cut to the route this package ports —
``use_flat_plane`` with the fused kernels (the reference's
``use_fused_kernel=True``), for every registered algorithm:

    sample cohort → gather the cohort's client-state rows → broadcast
    (x_t, Δ_t) → K local steps over the cohort plane (+ MimeLite's
    full-batch gradient at x_t) → faults + quarantine → wire encoding →
    fold rows + post-step → scatter the client-state rows back

The cohort runs as ONE ``(C, P)`` plane, where the reference vmaps a
per-client scan: each local step is one batched forward/backward (the
model's products, left to PyTorch as the reference leaves them to XLA) and
ONE ``fed_direction`` launch for the whole cohort, with Δ_t broadcast as
``(P,)`` and the client-state rows (SCAFFOLD's c_i, FedDyn's λ_i) as a
per-client ``(C, P)`` aux.  The round closes with one ``server_update``
launch per fold row — a row over a plane that arrives compressed to int8
or bf16 is one ``dequant_update`` launch instead — then the spec's
post-step (plain PyTorch on ``(P,)`` planes).  All C = capacity rows
compute; inactive rows carry weight 0 in the fold, in the loss metric and
in the client-state scatter.

Between the local steps and the fold sit the reference's two splices, each
absent when its config is None: fault injection and quarantine
(``cfg.fault``, ``repro_torch.core.faults``) and wire encoding
(``cfg.compression`` or the spec's default, ``repro_torch.core.compress``).
Their draws are counter-based hashes keyed by the device round counter
(``repro_torch.utils.draws``); ``round_step`` takes them injected instead
(``RoundDraws``), which is the seam the parity tests use.

Every per-round value — the round counter, η_l, the fold coefficients, the
cohort mask and |S| — lives in device memory, and nothing in a round reads
one back to the host, so a round can later be captured in a CUDA graph.
``run_rounds`` is a plain Python loop over rounds.

Only the uniform-availability sync path with resident state exists here; a
config that asks for anything else raises ``NotImplementedError`` naming the
ROADMAP item that brings it (``check_supported``).
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import FedConfig
from repro_torch.core import algorithms  # noqa: F401  (registers the builtin specs)
from repro_torch.core.algorithms import sparse_client_finalize
from repro_torch.core.compress import (
    COMPRESS_STREAM,
    PLANE_STREAMS,
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
from repro_torch.core.flat import FlatSpec
from repro_torch.core.registry import (
    ServerState,
    client_state_init,
    get_algorithm,
    list_algorithms,
    server_init,
)
from repro_torch.data.pipeline import gather_full_client_batch, gather_round_batches
from repro_torch.kernels.fed_direction.ops import direction_operands, fed_direction
from repro_torch.kernels.server_update.ops import fused_fold
from repro_torch.utils.draws import uniform as hash_uniform


class FedState(NamedTuple):
    """Flat engine state.  ``params`` is the ``(P,)`` f32 plane, ``server``
    holds the ``(P,)`` momentum plane, the int32 round counter and the
    adaptive specs' ``(P,)`` second moment, ``rng`` the ``torch.Generator``
    the cohort and minibatch draws come from (advanced in place),
    ``residuals`` the ``(N, P)`` f32 top-k error-feedback rows (None unless
    the uplink is top-k), ``client_states`` the ``(N, P)`` f32 per-client
    state plane — SCAFFOLD's c_i, FedDyn's λ_i — (None unless the spec
    keeps per-client state)."""

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


class RoundMetrics(NamedTuple):
    loss: torch.Tensor  # mean local training loss over active cohort × K steps
    n_active: torch.Tensor
    delta_norm: torch.Tensor  # ‖mean Δ_i‖
    momentum_norm: torch.Tensor  # ‖Δ_t‖ (server momentum entering the round)
    eta_l: torch.Tensor
    bytes_down: torch.Tensor  # server→clients this round
    bytes_up: torch.Tensor  # clients→server this round
    n_clipped: torch.Tensor = None  # bernoulli draws beyond the cohort capacity
    # fault counters (0 when cfg.fault is None); retries need the host
    # store (ROADMAP A.11) and stay 0
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
    (lambda c: c.fault is not None and c.fault.store_failure_rate > 0.0,
     "fault.store_failure_rate > 0 (host-store failures and retries)", "A.11"),
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
    and draws beyond capacity are counted in ``n_clipped``.  The ids are
    unique, which the client-state scatter relies on."""
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
        state, metrics = eng.round_step(state, batches, ids, mask,
                                        full_batches=full)  # full: MimeLite only
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

    # -------------------------------------------------- init
    def init(self, params, generator: Optional[torch.Generator] = None) -> FedState:
        """Ravel ``params`` (any device) onto this engine's device and
        allocate the planes the spec's flags require: the server planes
        (the second moment iff ``needs_second_moment``), the ``(N, P)`` zero
        client-state plane iff ``needs_client_state``, and the ``(N, P)``
        zero residual rows under top-k compression."""
        cfg, size = self.cfg, self.spec.size
        return FedState(
            params=self.spec.ravel(params).to(self.device),
            server=server_init(size, self.algo.momentum_dtype(cfg), device=self.device,
                               needs_second_moment=self.algo.needs_second_moment),
            rng=generator,
            residuals=init_residuals(self.compression, cfg.num_clients, size, self.device),
            client_states=client_state_init(self.algo, cfg.num_clients, size, self.device),
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
        ``cst`` is the cohort's ``(C, P)`` client-state rows (the
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
        new_residual_rows)`` (rows None except under top-k).  int8 and bf16
        planes reach the fold compressed, as a ``QPlane`` for the dequant
        kernel, each with its own rounding stream — except ``state_delta``,
        which the client-state scatter needs dense too, so it is decoded at
        once and folds dense.  Top-k sparsifies the delta plane only (the
        other wire planes ride f32) and folds the dense plane that arrived
        on the wire; ``w`` (the post-fault weights) keeps the residual of a
        client that did not transmit."""
        comp = self.compression
        out = dict(planes)
        new_rows = None
        for name in self.algo.wire_uplink_planes:
            pv = planes[name]
            if comp.kind == "topk":
                if name == "delta":
                    _, out[name], new_rows = error_feedback_topk(comp, pv, residual_rows, w,
                                                                 pv.shape[-1])
                continue
            u = d.rounding(name)
            if comp.kind == "int8" and u is None:
                u = hash_uniform(comp.seed, t, COMPRESS_STREAM + PLANE_STREAMS[name], ids,
                                 pv.shape[-1])
            rep = as_qplane(compress_plane(comp, pv, u))
            out[name] = decompress_plane(rep) if name == "state_delta" else rep
        return out, new_rows

    def _close_post(self, fsrv: ServerState, new_x, new_m, mean_delta, n_active, eta_l):
        """Adopt the folded momentum, then run the spec's post-step on the
        ``(P,)`` planes with the delta plane's cohort mean (it reads the
        post-fold momentum)."""
        new_server = fsrv._replace(momentum=new_m)
        post = self.algo.server_post_fn
        if post is not None:
            new_x, new_server = post(self.cfg, new_x, new_server, mean_delta, n_active, eta_l)
        return new_x, new_server

    # -------------------------------------------------- round
    def round_step(self, state: FedState, batches, ids, mask, n_clipped=None,
                   draws: Optional[RoundDraws] = None, full_batches=None):
        """One round on given draws: ``batches`` = {"x": (C, K, B, ...),
        "y": (C, K, B)}, ``ids`` (C,) unique, ``mask`` (C,) bool — the seam
        where a test injects the reference's draws, with ``draws`` in place
        of the fault and rounding hashes.  ``ids`` keys the fault and
        rounding draws and selects the residual and client-state rows;
        ``n_clipped`` is the sampler's overflow count, reported in the
        metrics; ``full_batches`` = {"x": (C, n, ...), "y": (C, n)} is each
        client's whole dataset, which a full-batch spec (MimeLite) needs."""
        cfg, algo = self.cfg, self.algo
        d = draws or RoundDraws()
        fsrv = state.server
        t = fsrv.round
        eta_l = local_learning_rate(cfg, t)
        x_t = state.params
        m_t = fsrv.momentum
        cst = None
        if algo.needs_client_state:
            if state.client_states is None:
                raise ValueError(f"{algo.name} keeps per-client state — call "
                                 f"eng.init(params, generator) so FedState.client_states "
                                 f"is allocated before stepping")
            cst = state.client_states.index_select(0, ids.long())  # ONE gather
        if algo.needs_full_grad and full_batches is None:
            raise ValueError(f"{algo.name} takes a full-batch gradient at x_t: pass "
                             f"full_batches (data.pipeline.gather_full_client_batch)")
        planes, losses = self._flat_cohort_pass(x_t, m_t, batches, eta_l, cst, full_batches)
        mask, planes, n_dropped, n_quar = self._inject_faults(t, ids, mask, planes, d)

        w = mask.to(torch.float32)
        n_active = w.sum()
        denom = n_active.clamp(min=1.0)
        new_res_rows = None
        if self.compression is not None:
            planes, new_res_rows = self._compress_uplink(
                t, ids, planes, w, self._residual_rows_for(state, ids), d)
        new_x, new_m, mean_delta = fused_fold(algo, cfg, planes, w / denom, n_active,
                                              x_t, m_t, eta_l)
        new_x, new_server = self._close_post(fsrv, new_x, new_m, mean_delta, n_active, eta_l)
        # a below-quorum (or empty) cohort carries the server planes through
        ok = n_active >= float(max(1, cfg.min_quorum))
        new_x = torch.where(ok, new_x, x_t)
        sm = new_server.second_moment
        new_server = new_server._replace(
            momentum=torch.where(ok, new_server.momentum, m_t),
            second_moment=None if sm is None else torch.where(ok, sm, fsrv.second_moment),
            round=fsrv.round + 1)
        # client-state rows of active members only; below quorum the
        # weights are zero and each row is written back as cst + 0·sd
        new_cst = state.client_states
        if algo.needs_client_state:
            w_sc = w * ok.to(torch.float32)
            upd = cst + planes["state_delta"] * w_sc[:, None]
            new_cst = new_cst.index_copy(0, ids.long(), upd)
        # the residual is client-side state: it tracks what the client did
        # not send, whatever the quorum decides
        new_res = state.residuals
        if new_res_rows is not None:
            new_res = new_res.index_copy(0, ids.long(), new_res_rows)

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
            n_dropped=n_dropped,
            n_quarantined=n_quar,
            n_retries=zero,
            quorum_skipped=1.0 - ok.to(torch.float32),
        )
        return FedState(new_x, new_server, state.rng, new_res, new_cst), metrics

    # -------------------------------------------------- data-driven round
    def _sample_round(self, state: FedState, data):
        gen = state.rng
        ids, mask, n_clipped = sample_cohort_ex(gen, self.cfg, self.device)
        batches = gather_round_batches(data.client_x, data.client_y, gen, ids,
                                       self.cfg.local_steps, self.batch_size)
        return batches, ids, mask, n_clipped

    def run_round(self, state: FedState, data) -> Tuple[FedState, RoundMetrics]:
        """Samples cohort + minibatches from a FederatedData and steps; a
        full-batch spec also gets each cohort client's whole dataset."""
        batches, ids, mask, n_clipped = self._sample_round(state, data)
        full = None
        if self.algo.needs_full_grad:
            full = gather_full_client_batch(data.client_x, data.client_y, ids)
        return self.round_step(state, batches, ids, mask, n_clipped, full_batches=full)

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
