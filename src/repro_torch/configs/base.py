"""The federated round configuration: a copy of ``repro.configs.base.FedConfig``
cut to the fields this package reads, with the same names and defaults.

Fields for features the port does not run yet stay in the copy so that a
config asking for them fails loudly (``repro_torch.core.engine`` raises
``NotImplementedError`` naming the ROADMAP item that brings each one)
instead of being dropped on the floor.  The port has one execution route,
the flat plane through the hand-written kernels, so the reference's
``use_fused_kernel`` switch has no counterpart here.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional


@dataclass(frozen=True)
class FedConfig:
    """Federated round configuration (paper §6.1 defaults)."""

    # a name in the port's algorithm registry (repro_torch.core.registry)
    algo: str = "fedcm"
    num_clients: int = 100
    cohort_size: int = 10  # |S|
    local_steps: int = 10  # K
    alpha: float = 0.1
    eta_l: float = 0.1
    eta_g: float = 1.0
    eta_l_decay: float = 0.998  # exponential decay per round (appendix C.2)
    weight_decay: float = 1e-3
    # "fixed" = exactly cohort_size w/o replacement, "bernoulli" = each
    # client independently with prob cohort_size/num_clients
    participation: str = "fixed"
    rounds: int = 100
    seed: int = 0
    # server momentum Δ_t storage/broadcast dtype ("float32" | "bfloat16")
    momentum_dtype: str = "float32"
    # dtype the (C, P) delta plane is cast to before the cohort reduction
    aggregate_dtype: str = "float32"
    # only True is ported; the per-leaf tree path is ROADMAP A.16
    use_flat_plane: bool = True
    # async pipelined engine (ROADMAP A.8): only the sync schedule is ported
    pipeline_depth: int = 1
    staleness: int = 0
    staleness_discount: float = 1.0
    # cohort-parallel execution over several devices (ROADMAP A.14)
    cohort_shard: int = 0
    # per-client state store and availability process (ROADMAP A.11)
    population_store: str = "resident"
    availability: str = "uniform"
    dropout_rate: float = 0.0
    # bernoulli cohort capacity = mean + σ·sd tail bound; an overflow is
    # counted in RoundMetrics.n_clipped
    bernoulli_capacity_sigma: float = 5.0
    # fault injection model (ROADMAP A.9); None is the only ported value
    fault: Optional[Any] = None
    # below max(1, min_quorum) active clients the round is a no-op
    min_quorum: int = 0
    # let a bernoulli draw of 0 produce an empty cohort (a guarded no-op)
    allow_empty_cohort: bool = False
    # uplink compression (ROADMAP A.10); None is the only ported value
    compression: Optional[Any] = None
