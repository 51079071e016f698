"""The federated round configuration: copies of ``repro.configs.base``'s
``FedConfig`` (cut to the fields this package reads), ``FaultConfig`` and
``CompressionConfig``, with the same names and defaults.

Fields for features the port does not run yet stay in the copy so that a
config asking for them fails loudly (``repro_torch.core.engine`` raises
``NotImplementedError`` naming the ROADMAP item that brings each one)
instead of being dropped on the floor.  The port has one execution route,
the flat plane through the hand-written kernels, so the reference's
``use_fused_kernel`` switch has no counterpart here.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class FaultConfig:
    """Fault injection as config data (``repro_torch.core.faults``).

    Every fault is a mask/plane transform between the cohort's local steps
    and the server fold, drawn from the counter-based hash of
    ``repro_torch.utils.draws`` keyed by ``(seed, absolute round, stream,
    client id)`` — not by cohort slot — so a client's fate in a round does
    not depend on where the sampler placed it, and a resumed run replays
    the same faults.  ``fault=None`` on ``FedConfig`` runs no fault code.
    """

    # per-client per-round probability the uplink is lost entirely
    drop_rate: float = 0.0
    # straggler deadline: client round time ~ LogNormal(0, σ) in units of
    # the median client; a client slower than ``deadline`` misses the round
    # (its uplink counts as dropped).  0 = no deadline.
    deadline: float = 0.0
    straggler_sigma: float = 0.5
    # payload corruption: per-client probability the delta plane arrives
    # corrupted, and how — "nan"/"inf" overwrite the row, "noise" adds
    # relative Gaussian noise of scale ``noise_scale × |value|``
    corrupt_rate: float = 0.0
    corrupt_mode: str = "nan"  # nan | inf | noise
    noise_scale: float = 1.0
    # transient host-store failures and their retry policy; the store is
    # ROADMAP A.11, so only store_failure_rate = 0 runs
    store_failure_rate: float = 0.0
    store_max_retries: int = 6
    store_backoff_base: float = 0.02
    store_backoff_cap: float = 0.5
    # uplink quarantine: zero the fold weight and the payload row (to exact
    # zeros, so 0·NaN never reaches the fold) of any client whose uplink is
    # non-finite; with quarantine_norm_mult > 0 also of finite rows whose
    # ‖Δ‖ exceeds mult × median(‖Δ‖ of the surviving cohort)
    quarantine: bool = True
    quarantine_norm_mult: float = 0.0
    # fault-stream seed, independent of FedConfig.seed
    seed: int = 0


@dataclass(frozen=True)
class CompressionConfig:
    """Uplink compression as config data (``repro_torch.core.compress``).

    Kinds:
      ``"int8"`` — per-row absmax-scaled stochastic-rounded int8 (unbiased);
                   1 byte/element + one f32 scale per client row.
      ``"bf16"`` — round-to-nearest-even bfloat16; 2 bytes/element.
      ``"topk"`` — magnitude top-k (k = topk_frac·P) with error-feedback
                   residuals kept per client in ``FedState.residuals``.
    """

    kind: str = "int8"  # int8 | bf16 | topk
    # fraction of plane elements kept per client row under "topk"
    topk_frac: float = 0.01
    # stochastic-rounding stream seed, independent of FedConfig.seed and
    # keyed by absolute round, so a resumed run rounds identically
    seed: int = 0


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
    # fault injection model; None runs no fault code
    fault: Optional[FaultConfig] = None
    # below max(1, min_quorum) active clients the round is a no-op
    min_quorum: int = 0
    # let a bernoulli draw of 0 produce an empty cohort (a guarded no-op)
    allow_empty_cohort: bool = False
    # uplink compression; None sends the f32 delta plane
    compression: Optional[CompressionConfig] = None
