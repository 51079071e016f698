"""Declarative algorithm registry: one ``AlgorithmSpec`` drives the round.

Counterpart of ``repro.core.registry``, cut to what the ported slice reads.
An algorithm is data:

(a) a client direction row (``DirectionRow``) that the ``fed_direction``
    kernel consumes as its coefficient vector::

        v = c_g·g + c_x·(x − x_t) + Σ_s c_s·stream_s

    with the named stream ``"momentum"`` (the broadcast Δ_t);

(b) server fold rows (``FoldPass``), one ``server_update`` launch each::

        mean = Σ_c wn_c · plane_c
        m'   = c_mm·m + c_md·(γ·mean)
        x'   = x + c_xd·(γ·mean)

(c) state flags: whether Δ_t is broadcast (payload accounting) and the
    dtype the momentum plane is stored in.

The uplink's wire format is not part of a spec: ``cfg.compression`` alone
selects it (``repro_torch.core.compress``).

Coefficients are floats or callables: ``cfg -> float`` for direction rows,
``(cfg, eta_l, n_active) -> scalar`` for fold rows, where ``eta_l`` and
``n_active`` are device tensors (η_l decays per round, |S| is drawn), so a
callable's result stays on the device.  Static zeros and ones are
structural: they drop a kernel operand or skip an output write.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Tuple, Union

import torch

DirCoef = Union[float, Callable[[Any], float]]
FoldCoef = Union[float, Callable[[Any, Any, Any], Any]]

#: stream names a DirectionRow may reference
DIRECTION_STREAMS = ("momentum", "client_state")
#: uplink plane names a FoldPass may reference
FOLD_PLANES = ("delta",)


class DirectionRow(NamedTuple):
    """Affine client-direction coefficients (see module docstring (a))."""

    c_g: DirCoef = 1.0  # on the minibatch gradient g
    c_x: DirCoef = 0.0  # on the proximal drift (x − x_t)
    aux: Tuple[Tuple[str, DirCoef], ...] = ()  # (stream name, coefficient)


class FoldPass(NamedTuple):
    """One ``server_update`` coefficient row over one uplink plane."""

    plane: str  # "delta" (per-client state planes come with ROADMAP A.7)
    c_mm: FoldCoef = 1.0  # momentum carry-over
    c_md: FoldCoef = 0.0  # momentum ← mean coupling
    c_xd: FoldCoef = 0.0  # param step on the mean


class ServerState(NamedTuple):
    """Server-side planes: ``momentum`` (P,) in the spec's store dtype and
    the int32 round counter, a 0-d device tensor.  (The reference's
    second-moment plane comes with the adaptive specs, ROADMAP A.7.)"""

    momentum: torch.Tensor
    round: torch.Tensor


def _dir_coef(c: DirCoef, cfg) -> float:
    return float(c(cfg)) if callable(c) else float(c)


def _fold_coef(c: FoldCoef, cfg, eta_l, n_active):
    return c(cfg, eta_l, n_active) if callable(c) else c


def _is_static_zero(c) -> bool:
    return isinstance(c, (int, float)) and float(c) == 0.0


def _is_static_one(c) -> bool:
    return isinstance(c, (int, float)) and float(c) == 1.0


class AlgorithmSpec(NamedTuple):
    """One federated algorithm as data (see module docstring).  Post-steps,
    per-client state, full-batch gradients and second moments — the rest of
    the reference's spec — come with the specs that need them (ROADMAP
    A.7)."""

    name: str
    direction_row: DirectionRow = DirectionRow()
    fold: Tuple[FoldPass, ...] = (FoldPass("delta"),)
    needs_momentum_broadcast: bool = False
    # stored-momentum dtype policy: "float32", or "momentum_dtype" to honor
    # cfg.momentum_dtype (FedCM's broadcastable Δ_t)
    momentum_store: str = "float32"

    @property
    def wire_uplink_planes(self) -> Tuple[str, ...]:
        """The uplink planes that cross the client→server wire, which the
        payload accounting charges.  The ported specs keep no per-client
        state and send no full-batch gradient, so this is the delta plane
        alone (state and extra planes come with ROADMAP A.7)."""
        return ("delta",)

    def momentum_dtype(self, cfg) -> torch.dtype:
        """The dtype the server momentum plane is stored in."""
        if self.momentum_store == "momentum_dtype":
            return getattr(torch, cfg.momentum_dtype)
        return torch.float32


_REGISTRY: Dict[str, AlgorithmSpec] = {}


def _validate(spec: AlgorithmSpec) -> None:
    if not spec.name or not isinstance(spec.name, str):
        raise ValueError(f"AlgorithmSpec needs a non-empty string name, got {spec.name!r}")
    if spec.momentum_store not in ("float32", "momentum_dtype"):
        raise ValueError(f"{spec.name}: momentum_store must be 'float32' or 'momentum_dtype'")
    for stream, _ in spec.direction_row.aux:
        if stream not in DIRECTION_STREAMS:
            raise ValueError(f"{spec.name}: unknown direction stream {stream!r}")
        if stream == "client_state":
            raise ValueError(f"{spec.name}: client-state streams are ROADMAP A.7")
        if stream == "momentum" and not spec.needs_momentum_broadcast:
            raise ValueError(f"{spec.name}: direction consumes 'momentum' but "
                             f"needs_momentum_broadcast is False")
    for p in spec.fold:
        if p.plane not in FOLD_PLANES:
            raise ValueError(f"{spec.name}: unknown fold plane {p.plane!r}")


def register_algorithm(spec: AlgorithmSpec) -> AlgorithmSpec:
    """Validate and register ``spec``; duplicate names raise."""
    if not isinstance(spec, AlgorithmSpec):
        raise TypeError(f"expected AlgorithmSpec, got {type(spec).__name__}")
    _validate(spec)
    if spec.name in _REGISTRY:
        raise ValueError(f"algorithm {spec.name!r} already registered")
    _REGISTRY[spec.name] = spec
    return spec


def get_algorithm(name: str) -> AlgorithmSpec:
    if name not in _REGISTRY:
        raise KeyError(f"unknown federated algorithm {name!r}; registered: "
                       f"{sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_algorithms() -> Tuple[str, ...]:
    """Registered algorithm names, sorted."""
    return tuple(sorted(_REGISTRY))


def server_init(size: int, momentum_dtype=torch.float32, device=None) -> ServerState:
    """Allocate the flat server planes: zero momentum, round 0."""
    return ServerState(momentum=torch.zeros((size,), dtype=momentum_dtype, device=device),
                       round=torch.zeros((), dtype=torch.int32, device=device))
