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

A spec's escape hatches (``repro_torch.core.registry``) change the two
steps, never the schedules: a ``direction_fn`` runs in plain PyTorch once
per client row of each local step (the callable sees one client's ``(P,)``
planes, as under the reference's vmap) and launches no ``fed_direction``;
a ``server_fn`` gets the masked cohort mean of each uplink plane, taken
by the fold kernel with neither x nor m written (one launch a plane), in
place of the fold rows and the post-step.

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

Cohort sharding (``cohort_group=`` / ``cfg.cohort_shard``) spreads a round
over the ranks of a ``torch.distributed`` process group, one process a
shard (``repro_torch.launch.mesh``), where the reference runs ``shard_map``
over a ``("clients",)`` mesh.  Every rank draws the WHOLE cohort from its
own copy of the generator (the unsharded stream), pads it to C_pad =
``padded_cohort(C, n)`` (data by edge rows, weights by zeros) and computes
only its rows ``[r·C_loc, (r+1)·C_loc)``: the local steps, corruption and
wire encoding.  The fold is ``scatter_fold``: an ``all_to_all`` to column
blocks, the ported fold kernels on this rank's ``(C_pad, ceil(P/n))``
block, then an ``all_gather`` of the ``(P,)`` planes.  The masks, the
quarantine's decision (from all-gathered row flags and norms), the loss
metric (from the all-gathered loss row) and the post-step run replicated;
updated client-state and top-k residual rows are all-gathered into every
rank's replicated ``(N, P)`` planes.  Sharded ≡ unsharded, bit for bit.

Every per-round value — the round counter, η_l, the fold coefficients, the
cohort mask and |S| — lives in device memory, and nothing in a resident
round reads one back to the host.  The host store reads the cohort's ids.

A model group (``model_group=``, a ``core.flat.GroupPlane``) runs a round
whose clients are each a model tensor-sharded over the group's ranks (the
reference's ``fed_dryrun`` layout): every rank holds its share's columns
of every plane, ``(C, P_r)``, runs the same round on the same draws, and
launches the same kernels on its share.  The gradient comes through the
model's differentiable collectives (``cohort_loss_fn(model, parallel)``)
with its partial parts summed over the group, and ``delta_norm`` /
``momentum_norm`` are the whole plane's (``GroupPlane.norm``).  What reads
a client's whole row reads it through the group: the fault layer's drop,
deadline and corruption flags are ``(C,)`` draws, the same on every rank;
the noise draw takes the whole plane's columns of the share
(``GroupPlane.columns``, ``draws.normal_at``); the quarantine ANDs the
rows' finite flags over the group and takes each row's whole norm
(``GroupPlane.rows_sqnorm``), so every rank decides alike.  A
``direction_fn`` sees a client's whole planes, gathered over the group a
client row at a time (``GroupPlane.gather_plane``), and hands back the
rank's share of its direction; a ``server_fn`` gets the whole cohort
means, ``x_t`` and server planes and hands back their share.  Uplink
compression, the async ring and the host store raise
``NotImplementedError`` naming ROADMAP A.16 (e) 4: the reference's tree
path, its route for this layout, refuses them too.

Both together are the reference's ``fed_dryrun`` layout, a grid of data ×
model ranks (``launch.mesh.make_grid``): ``cohort_group`` the rank's data
group and ``model_group`` a plane over its model group.  Each rank draws
the whole cohort, computes its ``(C_loc, P_r)`` rows, launches
``fed_direction`` K times a round on them and folds with ``scatter_fold``
over the data group on its share's columns (one ``server_update`` launch
on its ``(C_pad, ceil(P_r/D))`` block).  ``x`` and ``m`` stay replicated
over data: the round keeps no FSDP storage.

The per-leaf tree path (``use_flat_plane=False``) is the reference's
numerical oracle and its route for params that are not all floating
point: the state is the params tree itself, leaf by leaf in each leaf's
dtype (``tree_server_init``, ``tree_client_state_init``), and a round
(``_tree_round``) gathers the cohort's client-state leaves, runs the K
local steps as one batched forward/backward a step over ``(C, *shape)``
leaves (``client_update`` is its one-client case) with the spec's
direction interpreted leaf by leaf and a cast back to each leaf's dtype at
every step, injects the faults over the leaf trees, takes the masked mean
of every uplink tree leaf by leaf in ``aggregate_dtype`` (the unused
planes are zeros, as in the reference) and closes with
``tree_server_update``, the quorum's no-op fold and the client-state
scatter.  It launches no kernel.  Uplink compression, the host store,
cohort sharding and the async ring raise the reference's ``ValueError``
there.  Over a model group (the reference's route for that layout) the
state is the rank's share tree and the loss runs on the group: each
backward's partial parts are summed over the group
(``rules.sum_partial`` on the ``(C, *share)`` leaves), the norms are the
whole tree's, the faults run over the leaf shares as on the flat plane,
and an escape hatch sees whole leaf trees (``tree_direction`` /
``tree_server_update`` with ``group=``); with a cohort group beside it,
it raises ``NotImplementedError`` naming ROADMAP A.16 (e) 5.
As in the reference, a sub-f32 leaf comes back from the server step in
f32 (the fold's f32 mean promotes it), and an integer leaf raises
``TypeError`` at its gradient.

Inside ``run_rounds`` and the async loops the round updates the state's
planes in place: a loop's first fold (and first residual write) makes new
planes, so the caller's state stays as it was, and from then on params,
momentum, second moment, client states and residuals each keep their
storage (``repro_torch.analysis.trace`` contract (a)).  ``round_step``
and ``run_round`` return new planes and leave their input as it was.
"""
from __future__ import annotations

import math
import time
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import FedConfig
from repro_torch.core import algorithms  # noqa: F401  (registers the builtin specs)
from repro_torch.core.algorithms import FlatClientOutputs, sparse_client_finalize
from repro_torch.core.compress import (
    COMPRESS_STREAM,
    PLANE_STREAMS,
    QPlane,
    TopKPlane,
    as_qplane,
    carries_residuals,
    compress_plane,
    decompress_plane,
    effective_compression,
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
    row_size,
    rows_finite,
    rows_sqnorm,
    zero_rows,
)
from repro_torch.core.flat import (
    CohortUplink,
    FlatSpec,
    GroupPlane,
    gather_rows,
    pad_cohort,
    ring_push,
)
from repro_torch.core.registry import (
    ClientOutputs,
    ServerState,
    client_state_init,
    get_algorithm,
    list_algorithms,
    server_init,
    tree_client_state_init,
    tree_server_init,
    zeros_view,
)
from repro_torch.data.pipeline import gather_full_client_batch, gather_round_batches
from repro_torch.data.population import (
    AVAILABILITY_PROCESSES,
    POPULATION_STORES,
    TransientStoreError,
    availability_log_weights,
    make_population_store,
)
from repro_torch.kernels.fed_direction.ops import (
    direction_operands,
    fed_direction,
    flat_direction_step,
)
from repro_torch.kernels.server_update.ops import (
    fold_means,
    fused_fold,
    scatter_fold,
    scatter_means,
)
from repro_torch.launch.mesh import make_cohort_group
from repro_torch.sharding.rules import cohort_axis_size, padded_cohort, sum_partial
from repro_torch.utils.draws import uniform as hash_uniform
from repro_torch.utils.trees import (
    tree_bytes,
    tree_flatten_with_path,
    tree_leaves,
    tree_map,
    tree_unflatten,
)


class FedState(NamedTuple):
    """Flat engine state.  ``params`` is the ``(P,)`` f32 plane, ``server``
    holds the ``(P,)`` momentum plane, the int32 round counter and the
    adaptive specs' ``(P,)`` second moment, ``rng`` the ``torch.Generator``
    the cohort and minibatch draws come from (advanced in place),
    ``residuals`` the ``(N, P)`` f32 top-k error-feedback rows (None unless
    the uplink is top-k on resident state), ``client_states`` the ``(N, P)``
    f32 per-client state plane — SCAFFOLD's c_i, FedDyn's λ_i — (None
    unless the spec keeps per-client state on resident state; under
    ``population_store="host"`` both live in host stores).  On the tree
    path ``params``, the server planes and ``client_states`` (``(N, …)``
    leaves) are trees of the params' structure, and ``residuals`` is
    None."""

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


def synchronize(device: torch.device) -> None:
    """Wait for ``device``'s queued work (a no-op on the CPU), so a host
    clock read after it times that work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def check_supported(cfg: FedConfig) -> None:
    """Raise ``ValueError`` for bad values in ``cfg``."""
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


def check_model_group(cfg: FedConfig, algo) -> None:
    """Refuse, naming ROADMAP A.16 (e) 4, what a round over a model group
    does not run: routes past the reference's, whose tree path (its route
    for this layout) refuses them too."""
    for on, what in (
            (effective_compression(cfg, algo) is not None,
             "uplink compression (int8's per-row scales and top-k's selection run over the "
             "whole row)"),
            (cfg.population_store == "host", "population_store='host'")):
        if on:
            raise NotImplementedError(f"{what} under a model group is not ported (ROADMAP "
                                      f"A.16 (e) 4; the reference's tree path refuses it too)")


def check_tree_path(cfg: FedConfig, algo, cohort_group, model_group) -> None:
    """Refuse, with the reference's messages, what the per-leaf tree path
    does not run: each is a transform of flat ``(C, P)`` planes.  Over a
    model group, a cohort group beside it raises ``NotImplementedError``
    naming ROADMAP A.16 (e) 5."""
    if effective_compression(cfg, algo) is not None:
        raise ValueError("uplink compression is a flat-plane transform (it quantizes (C, P) "
                         "cohort planes) — set cfg.use_flat_plane=True (the tree path stays "
                         "the uncompressed oracle)")
    if cfg.population_store == "host":
        raise ValueError("population_store='host' rides the flat parameter plane (the store "
                         "gathers/scatters contiguous (C, P) rows) — set "
                         "cfg.use_flat_plane=True")
    if (cohort_group is not None or cfg.cohort_shard > 0) and model_group is not None:
        raise NotImplementedError("the per-leaf tree path (use_flat_plane=False) on a grid, "
                                  "the cohort over data beside a model group, is not ported "
                                  "yet (ROADMAP A.16 (e) 5)")
    if cohort_group is not None or cfg.cohort_shard > 0:
        raise ValueError("cohort-parallel execution runs on the flat parameter plane — it "
                         "shards (C, P) uplink planes; set cfg.use_flat_plane=True (the tree "
                         "path stays the single-device oracle)")


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


def sample_cohort(generator: torch.Generator, cfg: FedConfig, device, t=None):
    """``(client_ids (C,), active_mask (C,))``: ``sample_cohort_ex`` without
    the overflow count."""
    ids, mask, _ = sample_cohort_ex(generator, cfg, device, t)
    return ids, mask


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


# ----------------------------------------------------------------------
# the cohort's local steps on the flat plane
# ----------------------------------------------------------------------


def _plane_value_and_grad(loss_fn, spec: FlatSpec, x: torch.Tensor, batch,
                          model_group: Optional[GroupPlane] = None):
    """Per-client losses ``(C,)`` and gradient plane ``(C, P)`` of the
    cohort plane ``x`` in one backward (each client's loss depends only
    on its own row, so the gradient of the sum is per-client).

    The gradient is taken with respect to each leaf's view of the plane
    and written into its columns of one ``(C, P)`` buffer.  Taken with
    respect to the plane, each view's slice backward would write a zero
    ``(C, P)`` plane and the planes would be summed: the same values
    (every element has one nonzero term), but at an LM's width one
    plane is gigabytes and the model has a dozen leaves."""
    plane = x.detach().requires_grad_(True)
    with torch.enable_grad():
        views = spec.views(plane)
        losses = loss_fn(spec.unravel_views(views), batch)
        grads = list(torch.autograd.grad(losses.sum(), views, allow_unused=True))
    g = torch.empty_like(x)
    for i, l in enumerate(spec.leaves):
        cols = g[..., l.offset:l.offset + l.size]
        if grads[i] is None:  # a leaf the loss does not read
            cols.zero_()
        else:
            cols.copy_(grads[i].reshape(cols.shape))
        grads[i] = None  # free each leaf's gradient once it is in the plane
    if model_group is not None:  # the parts each rank reads only in part
        model_group.sum_partial(spec, g)
    return losses.detach(), g


def _cohort_pass(algo, cfg, loss_fn, spec: FlatSpec, x_t, m_t, batches, eta_l, cst=None,
                 full_batches=None, model_group: Optional[GroupPlane] = None):
    """K local steps of the whole cohort on the ``(C, P)`` plane: one
    batched value-and-grad and ONE ``fed_direction`` launch per step
    (a ``direction_fn`` spec: its callable on each client row instead).
    Returns (uplink planes by name, losses ``(C,)``)."""
    C = batches["y"].shape[0]
    if algo.direction_fn is None:
        auxes, coefs = direction_operands(algo, cfg, m_t, cst, x_t, eta_l)

        def step(x, g):
            return fed_direction(x, g, auxes, coefs)
    elif model_group is None:
        # an escape hatch sees one client's (P,) planes: a direction such
        # as g / ‖g‖ means something else over the whole (C, P) plane
        def step(x, g):
            return torch.stack([
                flat_direction_step(algo, cfg, x[c], g[c], m_t,
                                    None if cst is None else cst[c], x_t, eta_l)
                for c in range(C)])
    else:
        # over a model group, a client's whole planes: gathered a row at a
        # time, the direction's share kept
        def whole(v):
            return None if v is None else model_group.gather_plane(spec, v)

        m_w, x0_w = whole(m_t), whole(x_t)

        def step(x, g):
            rows = []
            for c in range(C):
                v = algo.direction(cfg, m_w, whole(None if cst is None else cst[c]),
                                   whole(x[c]), x0_w, whole(g[c]))
                rows.append((x[c] - eta_l * model_group.share_plane(spec, v)).to(x.dtype))
            return torch.stack(rows)
    x0 = x_t.expand(C, -1).contiguous()
    x = x0
    losses = []
    for k in range(cfg.local_steps):
        batch_k = {key: v[:, k] for key, v in batches.items()}
        loss, g = _plane_value_and_grad(loss_fn, spec, x, batch_k, model_group)
        if cfg.weight_decay:
            g = cfg.weight_decay * x + g
        x = step(x, g)
        losses.append(loss)
    full_grad = None
    if algo.needs_full_grad:
        _, full_grad = _plane_value_and_grad(loss_fn, spec, x0, full_batches, model_group)
    planes = sparse_client_finalize(algo, cfg, x_t, x, cst, m_t, eta_l, full_grad)
    return planes, torch.stack(losses, dim=1).mean(dim=1)


def _one_row(tree):
    return None if tree is None else tree_map(lambda a: a[None], tree)


def flat_client_update(algo, cfg, loss_fn, spec: FlatSpec, x_t, x0_tree, m_t, m_tree,
                       cst_tree_i, cst_flat_i, batches, eta_l, full_grad_batch=None,
                       unroll: bool = False):
    """One client's K local steps on the flat plane, in the reference's
    argument order: the cohort pass of the engine on one row (the fused
    route: ``fed_direction`` a step, or the ``direction_fn``).  ``x_t`` /
    ``m_t`` are ``(P,)``, ``cst_flat_i`` this client's ``(P,)`` state row
    or None, ``batches`` ``{"x": (K, B, …), "y": (K, B)}`` and
    ``full_grad_batch`` the client's whole dataset (MimeLite).
    ``loss_fn`` follows the port's convention: leaves with a leading
    client axis in, ``(C,)`` losses out (``FederatedEngine``).  The tree
    views ``x0_tree``, ``m_tree`` and ``cst_tree_i`` and ``unroll`` (the
    reference's leaf route and its dry-run form) are accepted and unused.
    Returns ``(FlatClientOutputs, mean local loss)``."""
    planes, losses = _cohort_pass(
        get_algorithm(algo) if isinstance(algo, str) else algo, cfg, loss_fn, spec, x_t, m_t,
        _one_row(batches), eta_l, None if cst_flat_i is None else cst_flat_i[None],
        _one_row(full_grad_batch))
    return FlatClientOutputs(*(None if planes[k] is None else planes[k][0]
                               for k in ("delta", "state_delta", "extra"))), losses[0]


# ----------------------------------------------------------------------
# the per-leaf tree path
# ----------------------------------------------------------------------


def _tree_value_and_grad(loss_fn, leaves, paths, treedef, batch,
                         group: Optional[GroupPlane] = None):
    """Per-client losses ``(C,)`` and the gradient leaves of a cohort's
    ``(C, …)`` leaves, each in its leaf's dtype, in one backward (over a
    model ``group``, each leaf's partial parts summed over it).  A leaf
    that is not floating point raises ``TypeError``, as the reference's
    ``jax.grad`` does on the tree path."""
    for path, leaf in zip(paths, leaves):
        if not leaf.dtype.is_floating_point:
            raise TypeError(f"grad requires floating-point inputs, but the params leaf "
                            f"{path} has dtype {leaf.dtype}")
    xs = [leaf.detach().requires_grad_(True) for leaf in leaves]
    with torch.enable_grad():
        losses = loss_fn(tree_unflatten(treedef, xs), batch)
        grads = torch.autograd.grad(losses.sum(), xs, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(xs, grads)]
    if group is not None:
        sum_partial(grads, group.parts, group.parallel, lead=1)
    return losses.detach(), grads


def _leaf_step(x: torch.Tensor, v: torch.Tensor, eta_l: torch.Tensor) -> torch.Tensor:
    """``x − η_l·v`` computed in the promoted dtype (at least f32, as the
    reference's f32 η_l promotes it) and cast back to the leaf's dtype."""
    dt = torch.promote_types(torch.promote_types(x.dtype, v.dtype), eta_l.dtype)
    return (x.to(dt) - eta_l * v.to(dt)).to(x.dtype)


def _tree_cohort_update(algo, cfg, loss_fn, params, m, cst, batches, eta_l,
                        full_batches=None, group: Optional[GroupPlane] = None):
    """K local steps of a cohort on the tree path: ``params`` and ``m`` the
    broadcast trees, ``cst`` the cohort's client-state tree of ``(C, …)``
    leaves (zeros for a stateless spec), ``batches`` leaves ``(C, K, B,
    …)``.  Each step is one batched forward/backward over ``(C, *shape)``
    leaves, weight decay, the spec's direction (a ``direction_fn`` once
    per client on its leaf trees, whole ones over a model ``group``) and
    the step cast back to each leaf's dtype.  Returns ``(ClientOutputs of
    (C, …) leaves, losses (C,))``."""
    flat, treedef = tree_flatten_with_path(params)
    paths = [path for path, _ in flat]
    C = tree_leaves(batches)[0].shape[0]

    def cohort(leaves):
        return [leaf.expand(C, *leaf.shape).contiguous() for leaf in leaves]

    x = cohort([leaf for _, leaf in flat])
    losses = []
    for k in range(cfg.local_steps):
        batch_k = tree_map(lambda b: b[:, k], batches)
        loss, g = _tree_value_and_grad(loss_fn, x, paths, treedef, batch_k, group)
        if cfg.weight_decay:
            g = [cfg.weight_decay * xi + gi for xi, gi in zip(x, g)]
        xt, gt = tree_unflatten(treedef, x), tree_unflatten(treedef, g)
        if algo.direction_fn is None:
            v = algo.tree_direction(cfg, m, cst, xt, params, gt)
        else:  # the escape hatch sees one client's leaf trees
            rows = [algo.tree_direction(cfg, m, tree_map(lambda a: a[c], cst),
                                        tree_map(lambda a: a[c], xt), params,
                                        tree_map(lambda a: a[c], gt), group=group)
                    for c in range(C)]
            v = tree_map(lambda *vs: torch.stack(vs), *rows)
        x = [_leaf_step(xi, vi, eta_l) for xi, vi in zip(x, tree_leaves(v))]
        losses.append(loss)
    full_grad = None
    if algo.needs_full_grad:
        _, fg = _tree_value_and_grad(loss_fn, cohort([leaf for _, leaf in flat]), paths,
                                     treedef, full_batches, group)
        full_grad = tree_unflatten(treedef, fg)
    outs = algo.client_finalize(cfg, params, tree_unflatten(treedef, x), cst, m, eta_l,
                                full_grad)
    return outs, torch.stack(losses, dim=1).mean(dim=1)


def client_update(algo, cfg, loss_fn, params, bcast_momentum, client_state, batches, eta_l,
                  full_grad_batch=None, unroll: bool = False):
    """One client's K local steps on the tree path, in the reference's
    argument order: weight decay, the spec's direction over the leaf trees
    and a cast back to each leaf's dtype at every step, then
    ``client_finalize``.  ``params`` / ``bcast_momentum`` are leaf trees,
    ``client_state`` this client's state tree (None: zeros), ``batches``
    ``{"x": (K, B, …), "y": (K, B)}`` and ``full_grad_batch`` the client's
    whole dataset (MimeLite).  ``loss_fn`` follows the port's convention:
    leaves with a leading client axis in, ``(C,)`` losses out
    (``FederatedEngine``).  ``unroll`` (the reference's dry-run form) is
    accepted and unused.  Returns ``(ClientOutputs, mean local loss)``."""
    algo = get_algorithm(algo) if isinstance(algo, str) else algo
    cst = (tree_map(torch.zeros_like, params) if client_state is None else client_state)
    outs, losses = _tree_cohort_update(algo, cfg, loss_fn, params, bcast_momentum,
                                       _one_row(cst), _one_row(batches), eta_l,
                                       _one_row(full_grad_batch))
    return ClientOutputs(*(tree_map(lambda a: a[0], t) for t in outs)), losses[0]


def _tree_norm(tree, group: Optional[GroupPlane] = None) -> torch.Tensor:
    """‖tree‖ over every leaf, in f32; over a model ``group``, of the whole
    tree whose share ``tree`` is."""
    if group is not None:
        return group.tree_norm(tree_leaves(tree))
    return torch.sqrt(sum(torch.sum(torch.square(leaf.to(torch.float32)))
                          for leaf in tree_leaves(tree)))


class FederatedEngine:
    """Round engine for (algorithm, loss_fn, parameter layout).

    ``loss_fn(params, batch)`` takes cohort-batched params — leaves with a
    leading client axis, views of a ``(C, P)`` plane — and a batch with
    leading ``(C, B)`` axes, and returns the ``(C,)`` per-client mean losses
    (``repro_torch.models.small.classification_loss`` does; for an LM,
    ``repro_torch.models.model.cohort_loss_fn`` over ``LMFederatedData``).
    ``spec`` is the ``FlatSpec`` of the model's params.

    Usage::

        eng = FederatedEngine(cfg, loss_fn, spec, device="cuda")
        state = eng.init(params, generator)
        state, metrics = eng.run_rounds(state, data, n_rounds)
        state, metrics = eng.run_rounds_async(state, data, n_rounds,
                                              pipeline_depth=2, staleness=1)
        state, metrics = eng.round_step(state, batches, ids, mask,
                                        full_batches=full)  # full: MimeLite only

    ``data`` is a ``FederatedData`` or an ``LMFederatedData``
    (device-resident shards) or, under ``population_store="host"``, also a
    ``StreamingClientData``.

    ``cohort_group`` (a process group this rank belongs to) or
    ``cfg.cohort_shard = n`` (the default group, which must have n ranks)
    shards the cohort over the group's ranks; each rank builds the same
    engine and calls the same methods, and every rank ends each call with
    the same state.

    ``model_group`` (a ``GroupPlane``, ``sharding.shard.group_plane(spec,
    model_cfg, parallel)``) makes each client a model group: ``spec`` is
    this rank's share's, ``loss_fn`` runs on the group
    (``cohort_loss_fn(model, parallel)``), and each rank builds the same
    engine and calls the same methods with the same draws.

    ``cfg.use_flat_plane=False`` runs the per-leaf tree path: the state is
    the params tree (``init`` copies it onto the device; over a model group
    this rank's share tree), ``spec`` may be None (a model group's plane is
    built from the share's ``FlatSpec`` all the same), and the same
    ``loss_fn`` gets ``(C, *shape)`` leaves in each leaf's dtype.
    """

    def __init__(self, cfg: FedConfig, loss_fn: Callable, spec: FlatSpec,
                 batch_size: int = 50, device="cuda", cohort_group=None,
                 model_group: Optional[GroupPlane] = None) -> None:
        check_supported(cfg)
        if model_group is not None:
            check_model_group(cfg, get_algorithm(cfg.algo))
        if not cfg.use_flat_plane:
            check_tree_path(cfg, get_algorithm(cfg.algo), cohort_group, model_group)
        self.model_group = model_group
        self._draws_checked = False
        if cfg.population_store == "host" and (cohort_group is not None
                                               or cfg.cohort_shard > 0):
            raise ValueError("population_store='host' is host-loop execution and is not "
                             "composable with cohort sharding — drop cohort_group / set "
                             "cfg.cohort_shard=0")
        if cohort_group is None and cfg.cohort_shard > 0:
            cohort_group = make_cohort_group(cfg.cohort_shard)
        # cohort sharding: the group, its size n, this rank, and the rows
        # [r·C_loc, (r+1)·C_loc) this rank owns of the padded cohort
        self.cohort_group = cohort_group
        self._shards, self._rank, self._rows = 1, 0, None
        if cohort_group is not None:
            self._shards = cohort_axis_size(cohort_group)
            if cfg.cohort_shard > 0 and self._shards != cfg.cohort_shard:
                raise ValueError(f"cfg.cohort_shard={cfg.cohort_shard} but the cohort group "
                                 f"has {self._shards} ranks")
            self._rank = dist.get_rank(cohort_group)
            c_loc = padded_cohort(cohort_capacity(cfg), self._shards) // self._shards
            self._rows = slice(self._rank * c_loc, (self._rank + 1) * c_loc)
        self.cfg = cfg
        self.algo = get_algorithm(cfg.algo)
        self.loss_fn = loss_fn
        self.spec = spec
        self.batch_size = batch_size
        self.device = resolve_device(device)
        # cfg.compression, else the spec's declared wire format
        self.compression = effective_compression(cfg, self.algo)
        if self.compression is not None:
            validate_compression(self.compression)
        # host stores of the client-state rows and the top-k residual rows
        # (population_store="host"), attached by init()
        self.population = None
        self.residual_population = None

    def params_tree(self, state: FedState):
        """The model's params tree of ``state``: views of the flat plane, or
        on the tree path the state's own tree."""
        return self.spec.unravel(state.params) if self.cfg.use_flat_plane else state.params

    def _plane_norm(self, x: torch.Tensor) -> torch.Tensor:
        """‖x‖ of a ``(P,)`` plane; over a model group, of the whole plane."""
        if self.model_group is None:
            return _norm(x)
        return self.model_group.norm(self.spec, x)

    @property
    def _host(self) -> bool:
        return self.cfg.population_store == "host"

    # -------------------------------------------------- cohort sharding
    @property
    def cohort_rank(self) -> int:
        """This process's rank in the cohort group (0 when unsharded)."""
        return self._rank

    def _padded(self, a, mode: str = "edge"):
        """``a`` (cohort-leading, C rows) padded to C_pad rows; as it is
        when unsharded."""
        if self._rows is None:
            return a
        return pad_cohort(a, self._shards * (self._rows.stop - self._rows.start), mode)

    def _own(self, a, mode: str = "edge"):
        """This rank's rows of the cohort-leading ``a`` (a tensor, a dict
        of them or None) after padding; all of ``a`` when unsharded."""
        if self._rows is None or a is None:
            return a
        a = self._padded(a, mode)
        if isinstance(a, dict):
            return {k: v[self._rows] for k, v in a.items()}
        return a[self._rows]

    def _all_rows(self, rows):
        """Every rank's rows of a ``(C_loc, ...)`` tensor, all-gathered into
        the padded cohort ``(C_pad, ...)``; as it is when unsharded."""
        if self._rows is None:
            return rows
        return gather_rows(rows, self.cohort_group, self._shards)

    # -------------------------------------------------- init
    def init(self, params, generator: Optional[torch.Generator] = None) -> FedState:
        """Ravel ``params`` (any device) onto this engine's device and
        allocate the planes the spec's flags require: the server planes
        (the second moment iff ``needs_second_moment``), the ``(N, P)`` zero
        client-state plane iff ``needs_client_state``, and the ``(N, P)``
        zero residual rows under top-k compression.  Under
        ``population_store="host"`` neither ``(N, P)`` plane is allocated:
        fresh host stores are attached as ``self.population`` (stateful
        specs) and ``self.residual_population`` (top-k).  On the tree path
        the state is a copy of the params tree on this engine's device with
        the reference's tree planes (``tree_server_init`` in
        ``cfg.momentum_dtype``, ``tree_client_state_init``)."""
        cfg = self.cfg
        if not cfg.use_flat_plane:
            params = tree_map(lambda a: a.detach().to(self.device, copy=True), params)
            return FedState(
                params=params,
                server=tree_server_init(params, cfg.momentum_dtype,
                                        needs_second_moment=self.algo.needs_second_moment),
                rng=generator, client_states=tree_client_state_init(params, cfg))
        size = self.spec.size
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

    def payload_bytes(self, params=None) -> Dict[str, int]:
        """Per-client per-round communication in bytes (§4.2): x_t down,
        plus Δ_t (or SCAFFOLD's c) when the spec broadcasts it; up, P per
        wire plane (``wire_uplink_planes``), or under compression the
        planes' bytes on the wire.  The tree path passes the round's
        ``params`` tree, whose leaf dtypes set the bytes."""
        if params is not None:
            nbytes = size = tree_bytes(params)
        else:
            nbytes, size = self.spec.nbytes, self.spec.size
        if self.model_group is not None:  # a client's whole model, not this rank's share
            nbytes, size = self.model_group.whole_nbytes, self.model_group.whole_size
        down = nbytes * (2 if self.algo.needs_momentum_broadcast else 1)
        up = uplink_bytes_per_client(self.compression, self.algo.wire_uplink_planes,
                                     size, nbytes)
        return {"down_per_client": down, "up_per_client": up}

    # -------------------------------------------------- client phase
    def _value_and_grad(self, x: torch.Tensor, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-client losses ``(C,)`` and gradient plane ``(C, P)`` of the
        cohort plane ``x`` (``_plane_value_and_grad``)."""
        return _plane_value_and_grad(self.loss_fn, self.spec, x, batch, self.model_group)

    def _flat_cohort_pass(self, x_t, m_t, batches, eta_l, cst=None, full_batches=None):
        """K local steps of the whole cohort on the ``(C, P)`` plane: one
        batched value-and-grad and ONE ``fed_direction`` launch per step
        (a ``direction_fn`` spec: its callable on each client row instead).
        ``m_t`` is the broadcast plane the clients descend against (the
        current momentum, or an S-rounds-stale one on the async ring),
        ``cst`` the cohort's ``(C, P)`` client-state rows (the
        ``client_state`` stream), ``full_batches`` each client's whole
        dataset, over which a full-batch spec takes one more batched
        gradient at x_t.  Returns (uplink planes by name, losses) with
        losses ``(C,)`` the per-client mean over the K steps."""
        return _cohort_pass(self.algo, self.cfg, self.loss_fn, self.spec, x_t, m_t, batches,
                            eta_l, cst, full_batches, self.model_group)

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
        runs.

        ``planes`` are ``(C, P)`` planes, or on the tree path trees of
        ``(C, …)`` leaves (the noise draw's columns go to the leaves in
        order).  Under cohort sharding ``ids`` and ``mask`` are the whole cohort's,
        ``planes`` this rank's rows: the drop and deadline draws run for the
        whole cohort on every rank, corruption touches this rank's rows
        (never a pad row), and the quarantine decides from every rank's
        row flags and norms, all-gathered, so every rank decides alike.
        Over a model group ``planes`` are the share's columns (leaves):
        the noise is each leaf's whole-plane columns of the one stream, the
        finite flags are ANDed and the norms summed over the group before
        that gather."""
        fault = self.cfg.fault
        zero = torch.zeros((), dtype=torch.float32, device=mask.device)
        if fault is None:
            return mask, planes, zero, zero
        group = self.model_group
        delta = planes["delta"]
        columns = None if group is None else (lambda i: group.columns(i, mask.device))
        plan = fault_masks(fault, t, ids, row_size(delta) if group is None else 0,
                           noise_ids=self._own(ids), columns=columns, u_drop=d.u_drop,
                           z_deadline=d.z_deadline, u_corrupt=d.u_corrupt,
                           z_noise=self._own(d.z_noise))
        n_dropped = zero
        if fault.drop_rate > 0.0 or fault.deadline > 0.0:
            n_dropped = (mask & plan.drop).to(torch.float32).sum()
            mask = mask & ~plan.drop
        if fault.corrupt_rate > 0.0:
            cmask = self._own(plan.corrupt & mask, "zero")
            if group is not None and isinstance(delta, torch.Tensor):  # leaf by leaf
                leaves = corrupt_uplink(fault, cmask, plan.noise, self.spec.views(delta))
                delta = torch.cat([leaf.reshape(leaf.shape[0], -1) for leaf in leaves], dim=1)
            else:
                delta = corrupt_uplink(fault, cmask, plan.noise, delta)
        planes = {**planes, "delta": delta}
        n_quar = zero
        if fault.quarantine:
            fin = rows_finite(delta)
            for name in ("state_delta", "extra"):
                if planes.get(name) is not None:
                    fin = fin & rows_finite(planes[name])
            if group is not None:
                fin = group.rows_finite(fin)
            fin = self._all_rows(fin)
            mask_p = self._padded(mask, "zero")
            bad = ~fin
            if fault.quarantine_norm_mult > 0.0:
                sq = rows_sqnorm(delta) if group is None else group.rows_sqnorm(
                    self.spec.views(delta) if isinstance(delta, torch.Tensor)
                    else tree_leaves(delta))
                norm = self._all_rows(torch.sqrt(sq))
                act = mask_p & fin
                med = nanmedian_midpoint(torch.where(act, norm, float("nan")))
                bad = bad | (act & (norm > fault.quarantine_norm_mult * med))
            n_quar = (mask_p & bad).to(torch.float32).sum()
            mine = bad if self._rows is None else bad[self._rows]
            planes = {k: None if v is None else zero_rows(v, mine) for k, v in planes.items()}
            mask = mask & ~bad[:mask.shape[0]]
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
            u = self._own(d.rounding(name))
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
        # under cohort sharding this rank computes its rows only; the ids,
        # the mask and the weight row stay whole (C,)
        C = inp.ids.shape[0]
        ids = self._own(inp.ids)
        cst = None
        if algo.needs_client_state:
            cst = cohort_rows if cohort_rows is not None else self._client_rows(state, ids)
        if algo.needs_full_grad and inp.full_batches is None:
            raise ValueError(f"{algo.name} takes a full-batch gradient at x_t: pass "
                             f"full_batches (data.pipeline.gather_full_client_batch)")
        planes, losses = self._flat_cohort_pass(state.params, m_used, self._own(inp.batches),
                                                eta_l, cst, self._own(inp.full_batches))
        mask, planes, n_dropped, n_quar = self._inject_faults(t, inp.ids, inp.mask, planes, d)
        w = mask.to(torch.float32)
        n_active = w.sum()
        new_res_rows = None
        if self.compression is not None:
            res = (residual_rows if residual_rows is not None
                   else self._residual_rows_for(state, ids))
            planes, new_res_rows = self._compress_uplink(t, ids, planes, self._own(w, "zero"),
                                                         res, d)
            if new_res_rows is not None:
                new_res_rows = self._all_rows(new_res_rows)[:C]
        entry = CohortUplink(delta=planes["delta"], state_delta=planes.get("state_delta"),
                             extra=planes.get("extra"), ids=inp.ids, w=w, eta_l=eta_l)
        loss = (self._all_rows(losses)[:C] * w).sum() / n_active.clamp(min=1.0)
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
              fold_rows=None, emit_rows: bool = False, in_place: bool = False):
        """Server phase: fold ONE entry into the state — the spec's fold
        rows with the entry's launch-time η_l and the staleness discount
        ``discount`` on the coefficient row and the post-step (a
        ``server_fn`` spec: the cohort means, and ``server_fn`` on
        γ·mean), the quorum (enforced here: the surviving weights are
        final only now), and the client-state scatter, whose base rows are
        gathered at fold time (``fold_rows`` from a host store, else the
        resident plane).  A
        compressed state delta is decoded for the scatter; with
        ``emit_rows`` the updated ``(C, P)`` rows come back instead of being
        scattered.  ``in_place`` writes the new params, server planes and
        client-state rows into the state's own buffers (the loops, which
        own them after their first fold).  Leaves the round counter alone.  Returns ``(state,
        ‖mean Δ‖, quorum_skipped, rows)``.

        Under cohort sharding the entry's planes are this rank's rows: the
        fold rows run through ``scatter_fold`` (the means through
        ``scatter_means``) and the updated client-state
        rows are all-gathered before the scatter, which writes the C real
        rows only (pad ids repeat the last id)."""
        cfg, algo = self.cfg, self.algo
        delta = entry.delta
        if isinstance(delta, TopKPlane):
            delta = decompress_plane(delta, self.spec.size)
        w = entry.w
        n_active = w.sum()
        x_t, fsrv = state.params, state.server
        planes = {"delta": delta, "state_delta": entry.state_delta, "extra": entry.extra}
        wn = w / n_active.clamp(min=1.0)
        if algo.server_fn is not None:
            if self._rows is None:
                means = fold_means(algo, cfg, planes, wn, x_t, fsrv.momentum)
            else:
                means = scatter_means(algo, cfg, planes, self._padded(wn, "zero"), x_t,
                                      fsrv.momentum, group=self.cohort_group,
                                      rank=self._rank, n_shards=self._shards)
            mean_delta = means["delta"]
            new_x, new_server = self._server_fn(x_t, fsrv, means, n_active, entry.eta_l,
                                                discount)
            new_server = new_server._replace(round=fsrv.round)  # the loops advance it
        else:
            if self._rows is None:
                new_x, new_m, mean_delta = fused_fold(algo, cfg, planes, wn, n_active, x_t,
                                                      fsrv.momentum, entry.eta_l,
                                                      discount=discount)
            else:
                new_x, new_m, mean_delta = scatter_fold(
                    algo, cfg, planes, self._padded(wn, "zero"), n_active, x_t,
                    fsrv.momentum, entry.eta_l, discount=discount, group=self.cohort_group,
                    rank=self._rank, n_shards=self._shards)
            new_x, new_server = self._close_post(fsrv, new_x, new_m, mean_delta, n_active,
                                                 entry.eta_l, discount)
        # a below-quorum (or empty) cohort carries the server planes through
        ok = n_active >= float(max(1, cfg.min_quorum))
        new_x = torch.where(ok, new_x, x_t)
        new_m = torch.where(ok, new_server.momentum, fsrv.momentum)
        sm = new_server.second_moment
        new_sm = None if sm is None else torch.where(ok, sm, fsrv.second_moment)
        if in_place:
            new_x, new_m = x_t.copy_(new_x), fsrv.momentum.copy_(new_m)
            new_sm = None if sm is None else fsrv.second_moment.copy_(new_sm)
        new_server = new_server._replace(momentum=new_m, second_moment=new_sm)
        # client-state rows of active members only; below quorum the
        # weights are zero and each row is written back as cst + 0·sd
        new_cst, rows = state.client_states, None
        if algo.needs_client_state:
            sd = entry.state_delta
            if isinstance(sd, QPlane):
                sd = decompress_plane(sd)
            base = (fold_rows if fold_rows is not None
                    else self._client_rows(state, self._own(entry.ids)))
            rows = base + sd * (self._own(w, "zero") * ok.to(torch.float32))[:, None]
            rows = self._all_rows(rows)[:w.shape[0]]
            if not emit_rows:
                scatter = new_cst.index_copy_ if in_place else new_cst.index_copy
                new_cst = scatter(0, entry.ids.long(), rows)
                rows = None
        state = state._replace(params=new_x, server=new_server, client_states=new_cst)
        return state, self._plane_norm(mean_delta), 1.0 - ok.to(torch.float32), rows

    def _server_fn(self, x_t, fsrv: ServerState, means, n_active, eta_l, discount: float):
        """The spec's ``server_fn`` on the cohort means; over a model group
        on the whole planes (the means, ``x_t`` and the server planes
        gathered), handing back this rank's share of what it returns."""
        sd, extra = means.get("state_delta"), means.get("extra")
        group = self.model_group
        if group is None:
            return self.algo.server_update(self.cfg, x_t, fsrv, means["delta"], sd, extra,
                                           n_active, eta_l, discount)

        def whole(v):
            return None if v is None else group.gather_plane(self.spec, v)

        def share(v):
            return None if v is None else group.share_plane(self.spec, v)

        srv = fsrv._replace(momentum=whole(fsrv.momentum),
                            second_moment=whole(fsrv.second_moment))
        new_x, new_server = self.algo.server_update(
            self.cfg, whole(x_t), srv, whole(means["delta"]), whole(sd), whole(extra),
            n_active, eta_l, discount)
        return share(new_x), new_server._replace(momentum=share(new_server.momentum),
                                                 second_moment=share(new_server.second_moment))

    @staticmethod
    def _adopt_residuals(state: FedState, ids, new_rows, in_place: bool = False) -> FedState:
        """Write a launch's top-k residual rows into the resident plane (in
        its own buffer with ``in_place``): the residual is client-side
        state, updated whatever the quorum decides."""
        if new_rows is None or state.residuals is None:
            return state
        scatter = state.residuals.index_copy_ if in_place else state.residuals.index_copy
        return state._replace(residuals=scatter(0, ids.long(), new_rows))

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

        The round is a launch and an immediate fold (γ = 1); on the tree
        path, ``_tree_round``."""
        return self._round(state, RoundInputs(batches, ids, mask, n_clipped, full_batches,
                                              draws))

    def _round(self, state: FedState, inp: RoundInputs, in_place: bool = False):
        """One sync round on ``inp``; ``in_place`` folds into the state's own
        buffers (see ``_fold``)."""
        if not self.cfg.use_flat_plane:
            return self._tree_round(state, inp)
        m_t = state.server.momentum
        m_norm = self._plane_norm(m_t)  # before a fold in place moves it
        entry, lau, new_res = self._launch(state, m_t, inp)
        state = self._adopt_residuals(state, inp.ids, new_res, in_place)
        state, norm, skipped, _ = self._fold(state, entry, 1.0, in_place=in_place)
        state = state._replace(server=state.server._replace(round=state.server.round + 1))
        pay = self.payload_bytes()
        zero = torch.zeros((), dtype=torch.float32, device=m_t.device)
        metrics = RoundMetrics(
            loss=lau.loss,
            n_active=lau.n_active,
            delta_norm=norm,
            momentum_norm=m_norm,
            eta_l=entry.eta_l,
            bytes_down=lau.n_active * pay["down_per_client"],
            bytes_up=lau.n_active * pay["up_per_client"],
            n_clipped=zero if inp.n_clipped is None else inp.n_clipped.to(torch.float32),
            n_dropped=lau.n_dropped,
            n_quarantined=lau.n_quarantined,
            n_retries=zero,
            quorum_skipped=skipped,
        )
        return state, metrics

    def _tree_round(self, state: FedState, inp: RoundInputs):
        """One round of the per-leaf tree path (the reference's
        ``_tree_round_step``): gather the cohort's client-state leaves
        (zeros for a stateless spec), the cohort's local steps
        (``_tree_cohort_update``), faults, the masked mean of every uplink
        tree leaf by leaf in ``aggregate_dtype``, ``tree_server_update``,
        the quorum's no-op fold and the client-state scatter.  Launches no
        kernel."""
        cfg, algo = self.cfg, self.algo
        t = state.server.round
        eta_l = local_learning_rate(cfg, t)
        ids, x_t, srv = inp.ids, state.params, state.server
        if algo.needs_full_grad and inp.full_batches is None:
            raise ValueError(f"{algo.name} takes a full-batch gradient at x_t: pass "
                             f"full_batches (data.pipeline.gather_full_client_batch)")
        if algo.needs_client_state:
            if state.client_states is None:
                raise ValueError(f"{algo.name} keeps per-client state — call "
                                 f"eng.init(params, generator) so FedState.client_states "
                                 f"is allocated before stepping")
            cst = tree_map(lambda a: a.index_select(0, ids.long()), state.client_states)
        else:
            cst = tree_map(lambda p: zeros_view(p, (ids.shape[0], *p.shape)), x_t)
        group = self.model_group
        outs, losses = _tree_cohort_update(algo, cfg, self.loss_fn, x_t, srv.momentum, cst,
                                           inp.batches, eta_l, inp.full_batches, group)
        mask, planes, n_dropped, n_quar = self._inject_faults(t, ids, inp.mask, outs._asdict(),
                                                              inp.draws or RoundDraws())
        w = mask.to(torch.float32)
        n_active = w.sum()
        agg = getattr(torch, cfg.aggregate_dtype)

        def mmean(tree):
            return tree_map(lambda a: torch.tensordot(w.to(agg), a.to(agg), dims=1).to(
                torch.float32) / n_active.clamp(min=1.0), tree)

        means = [mmean(planes[k]) for k in ("delta", "state_delta", "extra")]
        new_x, new_srv = algo.tree_server_update(cfg, x_t, srv, *means, n_active, eta_l,
                                                 group=group)
        # a below-quorum (or empty) cohort carries the server trees through
        ok = n_active >= float(max(1, cfg.min_quorum))

        def keep(new, old):
            return None if new is None else tree_map(lambda a, b: torch.where(ok, a, b), new, old)

        new_srv = new_srv._replace(momentum=keep(new_srv.momentum, srv.momentum),
                                   second_moment=keep(new_srv.second_moment, srv.second_moment),
                                   round=t + 1)
        new_cst = state.client_states
        if algo.needs_client_state:  # active members only; none below quorum
            w_sc = w * ok.to(torch.float32)

            def scatter(a, d):
                rows = a.index_select(0, ids.long()) + d * w_sc.reshape(
                    -1, *([1] * (d.dim() - 1))).to(a.dtype)
                return a.index_copy(0, ids.long(), rows.to(a.dtype))

            new_cst = tree_map(scatter, state.client_states, planes["state_delta"])
        pay = self.payload_bytes(x_t)
        zero = torch.zeros((), dtype=torch.float32, device=w.device)
        metrics = RoundMetrics(
            loss=(losses * w).sum() / n_active.clamp(min=1.0),
            n_active=n_active,
            delta_norm=_tree_norm(means[0], group),
            momentum_norm=_tree_norm(srv.momentum, group),
            eta_l=eta_l,
            bytes_down=n_active * pay["down_per_client"],
            bytes_up=n_active * pay["up_per_client"],
            n_clipped=zero if inp.n_clipped is None else inp.n_clipped.to(torch.float32),
            n_dropped=n_dropped,
            n_quarantined=n_quar,
            n_retries=zero,
            quorum_skipped=1.0 - ok.to(torch.float32),
        )
        return state._replace(params=keep(new_x, x_t), server=new_srv,
                              client_states=new_cst), metrics

    # -------------------------------------------------- data-driven round
    def _draw_round(self, generator, t, data) -> RoundInputs:
        """One round's cohort and minibatches from device-resident data
        (and, for a full-batch spec, each cohort client's whole dataset);
        ``t`` is the round counter the availability process reads."""
        ids, mask, n_clipped = sample_cohort_ex(generator, self.cfg, self.device, t)
        batches = gather_round_batches(data.client_x, data.client_y, generator, ids,
                                       self.cfg.local_steps, self.batch_size)
        if self.model_group is not None and not self._draws_checked:
            self._check_same_draws(ids, mask, batches)
        full = None
        if self.algo.needs_full_grad:
            full = gather_full_client_batch(data.client_x, data.client_y, ids)
        return RoundInputs(batches, ids, mask, n_clipped, full)

    def _check_same_draws(self, ids, mask, batches) -> None:
        """Over a model group every rank must draw the same cohort and
        minibatches from its own generator; check the first round's draws
        once (one ``all_gather`` of their ids and sums over the model group,
        and over the cohort group beside it) rather than trust it across
        devices."""
        d = torch.stack([t.to(torch.float64).sum() for t in (ids, mask, *batches.values())])
        d = torch.cat([d, ids.to(torch.float64)])
        every = self.model_group.parallel.all_gather(d[None], dim=0)
        if self.cohort_group is not None:
            every = torch.cat([every, gather_rows(d[None], self.cohort_group, self._shards)])
        if not bool((every == every[0]).all()):
            raise RuntimeError("the ranks of the model group drew different cohorts or "
                               "minibatches: seed every rank's generator alike")
        self._draws_checked = True

    def _sample_round(self, state: FedState, data):
        inp = self._draw_round(state.rng, state.server.round, data)
        return inp.batches, inp.ids, inp.mask, inp.n_clipped

    def run_round(self, state: FedState, data) -> Tuple[FedState, RoundMetrics]:
        """Samples cohort + minibatches from the data and steps; a
        full-batch spec also gets each cohort client's whole dataset."""
        if self._host:
            state, ms = self.run_rounds_store(state, data, 1)
            return state, RoundMetrics(*[None if v is None else v[0] for v in ms])
        return self._round(state, self._draw_round(state.rng, state.server.round, data))

    def run_rounds(self, state: FedState, data, n_rounds: int) -> Tuple[FedState, RoundMetrics]:
        """``n_rounds`` rounds as a Python loop; metrics come back stacked
        with a leading ``(n_rounds,)`` axis, still on the device.  The first
        round writes new planes, the later ones fold into those in place:
        the caller's ``state`` stays as it was."""
        if n_rounds < 1:
            raise ValueError(f"n_rounds must be >= 1, got {n_rounds}")
        if self._host:
            return self.run_rounds_store(state, data, n_rounds)
        rows = []
        for i in range(n_rounds):
            inp = self._draw_round(state.rng, state.server.round, data)
            state, m = self._round(state, inp, in_place=i > 0)
            rows.append(m)
        return state, _stack(RoundMetrics, rows)

    # -------------------------------------------------- async ring
    def _async_args(self, n_rounds, pipeline_depth, staleness) -> Tuple[int, int]:
        if self.model_group is not None:
            raise NotImplementedError("the async ring under a model group is not ported (ROADMAP "
                                      "A.16 (e) 4; the reference's tree path refuses it too)")
        D = self.cfg.pipeline_depth if pipeline_depth is None else pipeline_depth
        S = self.cfg.staleness if staleness is None else staleness
        if n_rounds < 1:
            raise ValueError(f"n_rounds must be >= 1, got {n_rounds}")
        if D < 1:
            raise ValueError(f"pipeline_depth must be >= 1, got {D}")
        if S < 0:
            raise ValueError(f"staleness must be >= 0, got {S}")
        if not self.cfg.use_flat_plane:
            raise ValueError("run_rounds_async requires cfg.use_flat_plane=True — the "
                             "in-flight cohort ring is a flat-plane carry (the tree path "
                             "stays the sync oracle)")
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
        scatter points: at launch, and at fold time.  The loop's first fold
        (and first residual write) makes new planes, the later ones write
        into them in place; the S-stale momenta sit in S buffers of their
        own."""
        cfg, algo = self.cfg, self.algo
        D, S = self._async_args(n_rounds, pipeline_depth, staleness)
        store, res_store = self._stores()
        mhist = None
        if S > 0 and algo.needs_momentum_broadcast:
            # slot t mod S holds the momentum entering round t − S
            mhist = [state.server.momentum.clone() for _ in range(S)]
        discount = float(cfg.staleness_discount) ** (D - 1)
        pay = self.payload_bytes()
        dev = state.params.device
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        pending: Tuple[CohortUplink, ...] = ()
        rows = []
        folded_once = adopted_once = False
        for t in range(n_rounds):
            r0 = state.server.round
            inp = inputs(state)
            m_used = state.server.momentum if mhist is None else mhist[t % S]
            m_norm = _norm(m_used)
            retries = 0
            stored = store is not None or res_store is not None
            ids_np = inp.ids.cpu().numpy() if stored else None  # repro: noqa REP003 -- the host store's ids: its designed boundary
            cohort_rows, res_rows, r = self._gather_rows(store, res_store, ids_np)
            retries += r
            entry, lau, new_res = self._launch(state, m_used, inp, cohort_rows, res_rows)
            if mhist is not None:  # the slot now keeps the momentum entering round t
                mhist[t % S].copy_(state.server.momentum)
            if res_store is not None:
                retries += self._scatter_rows(None, res_store, ids_np, None, new_res)
            else:
                state = self._adopt_residuals(state, inp.ids, new_res, adopted_once)
                adopted_once = adopted_once or new_res is not None
            if len(pending) + 1 >= D:
                oldest, pending = ring_push(pending, entry)
                state, norm, skipped, r = self._fold_stored(state, oldest, discount, store,
                                                            folded_once)
                folded_once = True
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
                momentum_norm=m_norm,
                eta_l=entry.eta_l,
                bytes_down=lau.n_active * pay["down_per_client"],
                bytes_up=lau.n_active * pay["up_per_client"],
                folded=zero + folded,
                eval_acc=eval_acc,
                n_clipped=zero if inp.n_clipped is None else inp.n_clipped.to(torch.float32),
                n_dropped=lau.n_dropped,
                n_quarantined=lau.n_quarantined,
                n_retries=zero + retries,
                quorum_skipped=skipped,
            ))
        if drain:
            state = self._drain(state, pending, D, folded_once)
            pending = ()
        return state, _stack(AsyncRoundMetrics, rows), pending

    def drain_async(self, state: FedState, pending, pipeline_depth: int) -> FedState:
        """Fold the entries still in flight, oldest first, with the
        discount of a ``pipeline_depth``-deep ring (the configured overlap,
        whatever ``len(pending)`` is).  The round counter stays."""
        return self._drain(state, pending, pipeline_depth)

    def _drain(self, state: FedState, pending, pipeline_depth: int, in_place: bool = False):
        discount = float(self.cfg.staleness_discount) ** (pipeline_depth - 1)
        store, _ = self._stores()
        for i, entry in enumerate(pending):
            state = self._fold_stored(state, entry, discount, store, in_place or i > 0)[0]
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
                rows = got.cpu().numpy()  # repro: noqa REP003 -- rows back to the host store
                retries += self._store_io(s.scatter, ids_np, rows)[1]
        return retries

    def _fold_stored(self, state: FedState, entry: CohortUplink, discount: float, store,
                     in_place: bool = False):
        """``_fold`` with the client-state rows gathered from ``store`` at
        fold time and scattered back (resident when ``store`` is None).
        Returns ``(state, ‖mean Δ‖, quorum_skipped, n_retries)``."""
        if store is None:
            state, norm, skipped, _ = self._fold(state, entry, discount, in_place=in_place)
            return state, norm, skipped, 0
        ids_np = entry.ids.cpu().numpy()  # repro: noqa REP003 -- the host store's ids at fold time
        frows, _, retries = self._gather_rows(store, None, ids_np)
        state, norm, skipped, rows = self._fold(state, entry, discount, fold_rows=frows,
                                                emit_rows=True, in_place=in_place)
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
