"""Builtin federated algorithms as registry specs: FedCM and FedAvg.

Counterpart of ``repro.core.algorithms``, cut to the two specs this slice
ports (the other nine are ROADMAP A.7).  The paper-faithful convention
(appendix C.2) holds: the pseudo-gradient is
``Δ_{t+1} = −(1/(η_l·K)) · mean_i(x_{i,K} − x_t)`` and the server step on it
is ``η_g·η_l·K``, so ``η_g = 1`` is plain client-model averaging.

FedAvg costs nothing extra: it is FedCM's fold with the zero-aux direction
launch, and FedCM at α = 1 drops its momentum stream (a static zero) and
becomes exactly that launch.
"""
from __future__ import annotations

from repro_torch.core.registry import (
    AlgorithmSpec,
    DirectionRow,
    FoldPass,
    register_algorithm,
)


def _c_pseudo_grad(cfg, eta_l, n_active):
    """Fold coefficient turning mean(Δ_i) into Δ_{t+1} (Algorithm 1/2
    line 13): ``m ← −mean/(η_l·K)``.  ``eta_l`` is a device tensor, so the
    result is one too."""
    return -1.0 / (eta_l * cfg.local_steps)


def _c_eta_g(cfg, eta_l, n_active):
    return cfg.eta_g


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


def sparse_client_finalize(x0, xK) -> dict:
    """The cohort's uplink planes by name: the ported specs send only the
    delta plane ``x_{i,K} − x_t`` (``(C, P)``); no state or extra plane is
    materialized."""
    return {"delta": xK - x0}
