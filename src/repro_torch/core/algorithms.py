"""Builtin federated algorithms as registry specs: the paper's FedCM, its
baselines and the wider family.

Counterpart of ``repro.core.algorithms``: FedCM (Algorithm 2), FedAvg,
FedAdam / FedAdagrad / FedYogi [Reddi+20], SCAFFOLD [Karimireddy+20b],
FedDyn [Acar+21], MimeLite [Karimireddy+20a], FedAvgM [Hsu+19], FedProx
[Li+20] and FedACG-style server lookahead [Kim+22].  Every algorithm is an
``AlgorithmSpec`` (``repro_torch.core.registry``): a direction row for the
``fed_direction`` kernel, fold rows for ``server_update`` /
``dequant_update``, an optional post-step and state-plane flags; the
engine has no per-algorithm branch.

The paper-faithful convention (appendix C.2) holds: the pseudo-gradient is
``Δ_{t+1} = −(1/(η_l·K)) · mean_i(x_{i,K} − x_t)`` and the server step on
it is ``η_g·η_l·K``, so ``η_g = 1`` is plain client-model averaging.  The
adaptive methods step with an absolute server lr ``η_g``.

Post-steps and state updates are plain PyTorch on the ``(P,)`` and
``(C, P)`` planes (the reference's are jnp outside any Pallas kernel), with
the reference's operation order.  Post-steps read the momentum AFTER the
fold (``srv.momentum`` is m').
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.core.registry import (
    AlgorithmSpec,
    DirectionRow,
    FoldPass,
    get_algorithm,
    list_algorithms,
    register_algorithm,
)


class _AlgorithmsView:
    """Read-only dict-like view of the registry (the reference's
    ``ALGORITHMS``): a spec registered at runtime shows here too."""

    def __getitem__(self, name: str) -> AlgorithmSpec:
        return get_algorithm(name)

    def __contains__(self, name: str) -> bool:
        return name in list_algorithms()

    def __iter__(self):
        return iter(list_algorithms())

    def __len__(self) -> int:
        return len(list_algorithms())

    def keys(self):
        return list_algorithms()

    def items(self):
        return [(n, get_algorithm(n)) for n in list_algorithms()]


ALGORITHMS = _AlgorithmsView()

# ----------------------------------------------------------------------
# shared coefficient / post-step pieces
# ----------------------------------------------------------------------


def _eta_g_eff(cfg, eta_l):
    # appendix C.2: the effective server step on Δ_{t+1} is η_g·η_l·K
    return cfg.eta_g * eta_l * cfg.local_steps


def _c_pseudo_grad(cfg, eta_l, n_active):
    """Fold coefficient turning mean(Δ_i) into Δ_{t+1} (Algorithm 1/2
    line 13): ``m ← −mean/(η_l·K)``.  ``eta_l`` is a device tensor, so the
    result is one too."""
    return -1.0 / (eta_l * cfg.local_steps)


def _c_alpha_pseudo_grad(cfg, eta_l, n_active):
    """EMA coupling of the adaptive methods: ``m ← (1−α)·m + α·Δ_{t+1}``.
    A true f32 division, as the reference's: PyTorch's ``float / tensor``
    multiplies by the reciprocal, which rounds once more."""
    den = eta_l * cfg.local_steps
    return torch.full((), -cfg.alpha, dtype=torch.float32, device=den.device) / den


def _c_eta_g(cfg, eta_l, n_active):
    return cfg.eta_g


def _c_one_minus_alpha(cfg, eta_l, n_active):
    return 1.0 - cfg.alpha


def _c_participation_frac(cfg, eta_l, n_active):
    """SCAFFOLD server control variate: ``c ← c + (|S|/N)·mean(Δc_i)``."""
    return n_active / cfg.num_clients


def _c_feddyn_h(cfg, eta_l, n_active):
    """FedDyn: ``h ← h − α_dyn·(|S|/N)·mean(Δ_i)``."""
    return -cfg.feddyn_alpha * (n_active / cfg.num_clients)


def _pseudo_grad(mean_delta, eta_l, K):
    """Δ_{t+1} = −(1/(η_l·K))·mean_i(Δ_i)."""
    return mean_delta * (-1.0 / (eta_l * K))


# --- per-client state updates on the (C, P) cohort planes


def _scaffold_state_update(cfg, x0, xK, c_i, c, delta, eta_l):
    # option II: c_i⁺ = c_i − c + (x_t − x_{i,K}) / (K·η_l)
    c_new = c_i - c - delta / (cfg.local_steps * eta_l)
    return c_new - c_i


def _feddyn_state_update(cfg, x0, xK, lam_i, m, delta, eta_l):
    # λ_i ← λ_i − α_dyn·(θ_i − x_t)
    return delta * -cfg.feddyn_alpha


# --- server post-steps on the (P,) planes


def _feddyn_post(cfg, x, srv, dmean, n_active, eta_l):
    # the fold did h ← h − α_dyn·(|S|/N)·mean and x ← x + mean; the dual
    # shift is x ← x − h/α_dyn
    return (-1.0 / cfg.feddyn_alpha) * srv.momentum + x, srv


def _precondition_step(cfg, x, m, v):
    return x - cfg.eta_g * m / (torch.sqrt(v) + cfg.adam_tau)


def _fedadam_post(cfg, x, srv, dmean, n_active, eta_l):
    # the fold did m ← (1−α)m + α·Δ_{t+1}; here the v EMA and the
    # preconditioned absolute-lr step
    pg = _pseudo_grad(dmean, eta_l, cfg.local_steps)
    v = cfg.adam_beta2 * srv.second_moment + (1.0 - cfg.adam_beta2) * torch.square(pg)
    return _precondition_step(cfg, x, srv.momentum, v), srv._replace(second_moment=v)


def _fedadagrad_post(cfg, x, srv, dmean, n_active, eta_l):
    # v accumulates without decay: v ← v + Δ²_{t+1}
    pg = _pseudo_grad(dmean, eta_l, cfg.local_steps)
    v = srv.second_moment + torch.square(pg)
    return _precondition_step(cfg, x, srv.momentum, v), srv._replace(second_moment=v)


def _fedyogi_post(cfg, x, srv, dmean, n_active, eta_l):
    # sign-controlled second moment: v ← v − (1−β2)·sign(v − Δ²)·Δ²
    pg = _pseudo_grad(dmean, eta_l, cfg.local_steps)
    vi, sq = srv.second_moment, torch.square(pg)
    v = vi - (1.0 - cfg.adam_beta2) * torch.sign(vi - sq) * sq
    return _precondition_step(cfg, x, srv.momentum, v), srv._replace(second_moment=v)


def _fedavgm_post(cfg, x, srv, dmean, n_active, eta_l):
    # heavy-ball step along the post-fold momentum: x ← x − η_g·η_l·K·m'
    return -_eta_g_eff(cfg, eta_l) * srv.momentum + x, srv


def _fedacg_post(cfg, x, srv, dmean, n_active, eta_l):
    # lookahead: step along pg + λ·m' (the momentum the next round broadcasts)
    pg = _pseudo_grad(dmean, eta_l, cfg.local_steps)
    step = pg + cfg.acg_lambda * srv.momentum
    return -_eta_g_eff(cfg, eta_l) * step + x, srv


# ----------------------------------------------------------------------
# the builtin specs
# ----------------------------------------------------------------------

register_algorithm(AlgorithmSpec(
    name="fedavg",
    direction_row=DirectionRow(),  # v = g
    # m' := Δ_{t+1} (kept for metrics/inspection);  x' = x + η_g·mean
    fold=(FoldPass("delta", c_mm=0.0, c_md=_c_pseudo_grad, c_xd=_c_eta_g),),
))

register_algorithm(AlgorithmSpec(
    name="fedcm",
    # Algorithm 2, line 8: v = α·g + (1−α)·Δ_t
    direction_row=DirectionRow(
        c_g=lambda cfg: cfg.alpha,
        aux=(("momentum", lambda cfg: 1.0 - cfg.alpha),),
    ),
    # lines 13–14: Δ_{t+1} IS the new momentum
    fold=(FoldPass("delta", c_mm=0.0, c_md=_c_pseudo_grad, c_xd=_c_eta_g),),
    needs_momentum_broadcast=True,
    momentum_store="momentum_dtype",
))

register_algorithm(AlgorithmSpec(
    name="fedadam",
    direction_row=DirectionRow(),  # clients run plain SGD
    # m ← (1−α)·m + α·Δ_{t+1}; the v EMA and the preconditioned step are the post
    fold=(FoldPass("delta", c_mm=_c_one_minus_alpha, c_md=_c_alpha_pseudo_grad, c_xd=0.0),),
    server_post_fn=_fedadam_post,
    needs_second_moment=True,
))

register_algorithm(AlgorithmSpec(
    name="scaffold",
    # v = g − c_i + c  (the server's c rides the momentum broadcast)
    direction_row=DirectionRow(aux=(("client_state", -1.0), ("momentum", 1.0))),
    state_update_fn=_scaffold_state_update,
    # params pass over Δ, then the c pass over Δc (writes m only)
    fold=(FoldPass("delta", c_mm=1.0, c_md=0.0, c_xd=_c_eta_g),
          FoldPass("state_delta", c_mm=1.0, c_md=_c_participation_frac, c_xd=0.0)),
    needs_client_state=True,
    needs_momentum_broadcast=True,
    client_state_uplink=True,  # Δc_i goes up; c comes down with the broadcast
))

register_algorithm(AlgorithmSpec(
    name="feddyn",
    # local objective f_i(x) − ⟨λ_i, x⟩ + (α_dyn/2)‖x − x_t‖²
    direction_row=DirectionRow(c_x=lambda cfg: cfg.feddyn_alpha,
                               aux=(("client_state", -1.0),)),
    state_update_fn=_feddyn_state_update,
    # h ← h − α_dyn·(|S|/N)·mean;  x ← (x + mean) − h/α_dyn (post)
    fold=(FoldPass("delta", c_mm=1.0, c_md=_c_feddyn_h, c_xd=1.0),),
    server_post_fn=_feddyn_post,
    needs_client_state=True,
    # λ_i never leaves the client: no uplink charge for the state plane
))

register_algorithm(AlgorithmSpec(
    name="mimelite",
    # d = α·g + (1−α)·m, FedCM's form; m is updated from full-batch
    # gradients at x_t (the ``extra`` fold row, which writes m only)
    direction_row=DirectionRow(
        c_g=lambda cfg: cfg.alpha,
        aux=(("momentum", lambda cfg: 1.0 - cfg.alpha),),
    ),
    fold=(FoldPass("delta", c_mm=1.0, c_md=0.0, c_xd=_c_eta_g),
          FoldPass("extra", c_mm=_c_one_minus_alpha, c_md=lambda cfg, e, n: cfg.alpha,
                   c_xd=0.0)),
    needs_momentum_broadcast=True,
    needs_full_grad=True,
))

register_algorithm(AlgorithmSpec(
    name="fedavgm",
    direction_row=DirectionRow(),  # clients run plain SGD
    # server heavy-ball, β = 1−α: m' = (1−α)·m + Δ_{t+1};  x ← x − η_g·η_l·K·m'
    fold=(FoldPass("delta", c_mm=_c_one_minus_alpha, c_md=_c_pseudo_grad, c_xd=0.0),),
    server_post_fn=_fedavgm_post,
))

register_algorithm(AlgorithmSpec(
    name="fedadagrad",
    direction_row=DirectionRow(),
    fold=(FoldPass("delta", c_mm=_c_one_minus_alpha, c_md=_c_alpha_pseudo_grad, c_xd=0.0),),
    server_post_fn=_fedadagrad_post,
    needs_second_moment=True,
))

register_algorithm(AlgorithmSpec(
    name="fedyogi",
    direction_row=DirectionRow(),
    fold=(FoldPass("delta", c_mm=_c_one_minus_alpha, c_md=_c_alpha_pseudo_grad, c_xd=0.0),),
    server_post_fn=_fedyogi_post,
    needs_second_moment=True,
))

register_algorithm(AlgorithmSpec(
    name="fedprox",
    # local objective f_i(x) + (μ/2)‖x − x_t‖²: v = g + μ·(x − x_t); μ = 0 is FedAvg
    direction_row=DirectionRow(c_x=lambda cfg: cfg.fedprox_mu),
    fold=(FoldPass("delta", c_mm=0.0, c_md=_c_pseudo_grad, c_xd=_c_eta_g),),
))

register_algorithm(AlgorithmSpec(
    name="fedacg",
    direction_row=DirectionRow(),
    # m' = λ·m + Δ_{t+1};  x ← x − η_g·η_l·K·(Δ_{t+1} + λ·m')
    fold=(FoldPass("delta", c_mm=lambda cfg, e, n: cfg.acg_lambda, c_md=_c_pseudo_grad,
                   c_xd=0.0),),
    server_post_fn=_fedacg_post,
))


class FlatClientOutputs(NamedTuple):
    """One client's uplink on the flat plane (``flat_client_update``):
    ``(P,)`` planes, None for a plane the spec does not use."""

    delta: Any  # x_{i,K} − x_t
    state_delta: Optional[Any]  # SCAFFOLD's Δc_i / FedDyn's Δλ_i, or None
    extra: Optional[Any]  # MimeLite's full-batch gradient, or None


def sparse_client_finalize(algo: AlgorithmSpec, cfg, x0, xK, cst, m, eta_l,
                           full_grad) -> dict:
    """The cohort's uplink planes by name, ``(C, P)`` each: ``delta`` =
    x_{i,K} − x_t, ``state_delta`` from the spec's state update (SCAFFOLD's
    Δc_i, FedDyn's Δλ_i) and ``extra`` = the full-batch gradient at x_t
    (MimeLite); a plane the spec does not use is None, never materialized.
    The reference's operation order."""
    delta = xK - x0
    state_delta = None
    if algo.needs_client_state:
        state_delta = algo.state_update_fn(cfg, x0, xK, cst, m, delta, eta_l)
    extra = full_grad if algo.needs_full_grad else None
    return {"delta": delta, "state_delta": state_delta, "extra": extra}
