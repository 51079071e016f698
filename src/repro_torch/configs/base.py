"""Configurations: copies of ``repro.configs.base``'s ``FedConfig`` (cut to
the fields this package reads), ``FaultConfig``, ``CompressionConfig`` and
``ModelConfig`` (every field), with the same names and defaults, the four
workload shapes (``ShapeConfig``, ``SHAPES``), and the architecture
registry: all ten archs of the reference's pool (the dense, moe, ssm,
hybrid and vlm decoder-only families and the encoder-decoder).

Fields for features the port does not run yet stay in the copy so that a
config asking for them fails loudly (``repro_torch.core.engine`` raises
``NotImplementedError`` naming the ROADMAP item that brings each one)
instead of being dropped on the floor.  The port has one execution route,
the flat plane through the hand-written kernels, so the reference's
``use_fused_kernel`` switch has no counterpart here.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, replace
from typing import Dict, Optional, Tuple


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
    # transient host-store failures (population_store="host": each store
    # gather / scatter fails with this probability) and the retry policy:
    # capped exponential backoff, re-raised after store_max_retries
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
    # FedAdam / FedAdagrad / FedYogi: second-moment decay and the
    # preconditioner's floor τ in x ← x − η_g·m / (√v + τ)
    adam_beta2: float = 0.99
    adam_tau: float = 1e-2
    # FedDyn: regularizer strength α_dyn
    feddyn_alpha: float = 0.01
    # FedProx: proximal strength μ (v = g + μ·(x − x_t))
    fedprox_mu: float = 0.01
    # FedACG: server lookahead λ (m' = λ·m + Δ_{t+1}; step along Δ_{t+1} + λ·m')
    acg_lambda: float = 0.85
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
    # async pipelined engine (FederatedEngine.run_rounds_async): cohorts in
    # flight, rounds of momentum staleness the clients descend against, and
    # the fold weight γ per round of staleness (a fold is D − 1 rounds old
    # and weighs γ^(D−1))
    pipeline_depth: int = 1
    staleness: int = 0
    staleness_discount: float = 1.0
    # cohort-parallel execution: the number of ranks (one process each)
    # the cohort is sharded over; 0 = one process (repro_torch.launch.mesh)
    cohort_shard: int = 0
    # where per-client state rows live: "resident" = the (N, P) device
    # plane, "host" = a sparse host store (repro_torch.data.population),
    # gathered as (C, P) rows before a cohort's step and scattered after
    # its fold, so device memory scales with the cohort, not with N
    population_store: str = "resident"
    # availability process of the cohort sampler: "uniform" (the plain
    # draw), "zipf" (w_i ∝ (i+1)^-zipf_exponent) or "diurnal" (a sinusoid
    # over the round counter, client i peaking at phase i/N of a
    # diurnal_period-round day)
    availability: str = "uniform"
    zipf_exponent: float = 1.1
    diurnal_period: float = 24.0
    diurnal_amplitude: float = 0.8
    # straggler model: each selected client drops out of the round's mask
    # with this probability (a fully dropped cohort keeps its first client
    # unless allow_empty_cohort)
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


@dataclass(frozen=True)
class ModelConfig:
    """An LM architecture (counterpart of ``repro.configs.base.ModelConfig``):
    every field, under the same names and defaults."""

    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default: d_model // n_heads

    # --- attention variants ---
    use_rope: bool = True
    rope_theta: float = 10000.0
    qk_norm: bool = False
    sliding_window: Optional[int] = None  # window for "local" attention layers
    # (n_local, n_global) per repeating period; None = all-global.
    local_global_pattern: Optional[Tuple[int, int]] = None

    # --- mlp ---
    mlp_type: str = "gated_silu"  # gated_silu | gelu
    tie_embeddings: bool = False

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_every: int = 1  # a layer is MoE iff (layer_idx % moe_every == moe_every-1)
    shared_expert: bool = False
    router_z_loss: float = 1e-3
    load_balance_loss: float = 1e-2

    # --- SSM (mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 64

    # --- hybrid (zamba2-style): a shared attention block every attn_every layers ---
    attn_every: int = 0

    # --- encoder-decoder (seamless-m4t) ---
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0

    # --- modality frontend (stubbed, as in the reference) ---
    input_mode: str = "tokens"  # tokens | embeddings

    # --- numerics ---
    dtype: str = "float32"  # activation dtype
    param_dtype: str = "float32"

    # --- provenance ---
    source: str = ""

    @property
    def padded_vocab(self) -> int:
        """Embedding table rows: the vocab rounded up to 256, as in the
        reference (token ids stay < vocab_size; the pad rows are dead)."""
        return -(-self.vocab_size // 256) * 256

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def ssm_heads(self) -> int:
        return (self.ssm_expand * self.d_model) // self.ssm_head_dim


@dataclass(frozen=True)
class ShapeConfig:
    """A workload shape, the reference's: ``kind`` is train, prefill or
    decode; a decode shape's ``seq_len`` is the depth of its cache."""

    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


# The reference's architecture pool, in its order, all ported.
_MODULE_FOR: Dict[str, str] = {
    "starcoder2-7b": "starcoder2_7b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "dbrx-132b": "dbrx_132b",
    "zamba2-7b": "zamba2_7b",
    "llama3.2-1b": "llama3_2_1b",
    "qwen3-14b": "qwen3_14b",
    "gemma3-12b": "gemma3_12b",
    "chameleon-34b": "chameleon_34b",
    "mamba2-1.3b": "mamba2_1_3b",
}
ARCH_IDS = list(_MODULE_FOR)


def get_config(name: str) -> ModelConfig:
    """The published config of an arch (``llama3.2-1b`` or ``mamba2_1_3b``
    spelling); an unknown name raises ``KeyError``."""
    key = name.replace("_", "-") if name not in _MODULE_FOR else name
    for k, mod in _MODULE_FOR.items():
        if mod == name:
            key = k
    if key in _MODULE_FOR:
        return importlib.import_module(f"repro_torch.configs.{_MODULE_FOR[key]}").CONFIG
    raise KeyError(f"unknown architecture {name!r}; known: {ARCH_IDS}")


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family variant for CPU tests (the reference's, verbatim):
    ≤ 2 layers, d_model ≤ 256, vocab ≤ 512, f32."""
    d_model = min(cfg.d_model, 256)
    n_heads = min(cfg.n_heads, 4)
    if n_heads > 0:
        head_dim = max(d_model // n_heads, 32)
        n_kv = min(cfg.n_kv_heads, n_heads)
        if n_heads % n_kv != 0:
            n_kv = 1
    else:  # attention-free (ssm)
        head_dim = None
        n_kv = 0
    updates = dict(
        name=cfg.name + "-reduced",
        n_layers=2,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=head_dim,
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 512),
        dtype="float32",
        param_dtype="float32",
    )
    if cfg.n_experts:
        updates["n_experts"] = min(cfg.n_experts, 4)
        updates["top_k"] = min(cfg.top_k, 2)
        updates["moe_every"] = min(cfg.moe_every, 2)
    if cfg.family in ("ssm", "hybrid"):
        updates["ssm_state"] = min(cfg.ssm_state, 16)
        updates["ssm_head_dim"] = 32
        updates["ssm_chunk"] = 16
        if cfg.family == "hybrid":
            updates["n_layers"] = 2
            updates["attn_every"] = 2  # layer 1 is the shared attention block
    if cfg.is_encoder_decoder:
        updates["n_encoder_layers"] = 2
    if cfg.sliding_window is not None:
        updates["sliding_window"] = min(cfg.sliding_window, 8)
    if cfg.local_global_pattern is not None:
        updates["local_global_pattern"] = (1, 1)
    return replace(cfg, **updates)
