"""Declarative algorithm registry: one ``AlgorithmSpec`` drives the round.

Counterpart of ``repro.core.registry``.  An algorithm is data:

(a) a client direction row (``DirectionRow``) that the ``fed_direction``
    kernel consumes as its coefficient vector::

        v = c_g·g + c_x·(x − x_t) + Σ_s c_s·stream_s

    with the named streams ``"momentum"`` (the broadcast Δ_t, or
    SCAFFOLD's c) and ``"client_state"`` (this client's c_i / λ_i);

(b) server fold rows (``FoldPass``), one ``server_update`` launch each::

        mean = Σ_c wn_c · plane_c
        m'   = c_mm·m + c_md·(γ·mean)
        x'   = x + c_xd·(γ·mean)

    over the uplink planes ``"delta"``, ``"state_delta"`` (SCAFFOLD's Δc_i,
    FedDyn's Δλ_i) and ``"extra"`` (MimeLite's full-batch gradient), plus
    an optional pure ``server_post_fn(cfg, x, server, dmean, n_active,
    eta_l) -> (x, server)`` for what a streaming pass cannot express
    (FedAdam's preconditioner, FedDyn's ``−h/α`` shift, FedACG's
    lookahead), run on the ``(P,)`` planes after the fold;

(c) state flags: per-client state (``needs_client_state``, with its
    ``state_update_fn`` and whether its delta rides the wire,
    ``client_state_uplink``), the Δ_t broadcast, the full-batch gradient,
    the server's second moment, and the dtype the momentum plane is stored
    in.  ``FedState`` allocation and the payload accounting derive from
    them, never from algorithm names.

The uplink's wire format is not part of a spec: ``cfg.compression`` alone
selects it (``repro_torch.core.compress``); no builtin spec declares one.
The reference's ``direction_fn`` / ``server_fn`` escape hatches are not
ported: no builtin spec uses them.

Coefficients are floats or callables: ``cfg -> float`` for direction rows,
``(cfg, eta_l, n_active) -> scalar`` for fold rows, where ``eta_l`` and
``n_active`` are device tensors (η_l decays per round, |S| is drawn), so a
callable's result stays on the device.  Static zeros and ones are
structural: they drop a kernel operand or skip an output write.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple, Union

import torch

DirCoef = Union[float, Callable[[Any], float]]
FoldCoef = Union[float, Callable[[Any, Any, Any], Any]]

#: stream names a DirectionRow may reference
DIRECTION_STREAMS = ("momentum", "client_state")
#: uplink plane names a FoldPass may reference
FOLD_PLANES = ("delta", "state_delta", "extra")


class DirectionRow(NamedTuple):
    """Affine client-direction coefficients (see module docstring (a))."""

    c_g: DirCoef = 1.0  # on the minibatch gradient g
    c_x: DirCoef = 0.0  # on the proximal drift (x − x_t)
    aux: Tuple[Tuple[str, DirCoef], ...] = ()  # (stream name, coefficient)


class FoldPass(NamedTuple):
    """One ``server_update`` coefficient row over one uplink plane."""

    plane: str  # "delta" | "state_delta" | "extra"
    c_mm: FoldCoef = 1.0  # momentum carry-over
    c_md: FoldCoef = 0.0  # momentum ← mean coupling
    c_xd: FoldCoef = 0.0  # param step on the mean


class ServerState(NamedTuple):
    """Server-side planes: ``momentum`` (P,) in the spec's store dtype
    (FedCM's Δ_t, FedAdam's m, SCAFFOLD's c, FedDyn's h), the int32 round
    counter, a 0-d device tensor, and ``second_moment``, the (P,) f32 v of
    the adaptive specs (None unless the spec needs it)."""

    momentum: torch.Tensor
    round: torch.Tensor
    second_moment: Optional[torch.Tensor] = None


def _dir_coef(c: DirCoef, cfg) -> float:
    return float(c(cfg)) if callable(c) else float(c)


def _fold_coef(c: FoldCoef, cfg, eta_l, n_active):
    return c(cfg, eta_l, n_active) if callable(c) else c


def _is_static_zero(c) -> bool:
    return isinstance(c, (int, float)) and float(c) == 0.0


def _is_static_one(c) -> bool:
    return isinstance(c, (int, float)) and float(c) == 1.0


class AlgorithmSpec(NamedTuple):
    """One federated algorithm as data (see module docstring)."""

    name: str
    # --- (a) client direction ---
    direction_row: Optional[DirectionRow] = DirectionRow()
    # round-close per-client state update, or None (stateless):
    #   (cfg, x0, xK, cst, m, delta, eta_l) -> state_delta
    state_update_fn: Optional[Callable] = None
    # --- (b) server fold ---
    fold: Tuple[FoldPass, ...] = (FoldPass("delta"),)
    # (cfg, x, server, dmean, n_active, eta_l) -> (x, server)
    server_post_fn: Optional[Callable] = None
    # --- (c) state-plane requirements ---
    needs_client_state: bool = False
    needs_momentum_broadcast: bool = False
    needs_full_grad: bool = False
    needs_second_moment: bool = False
    client_state_uplink: bool = False  # does Δstate ride the uplink (payload)
    # stored-momentum dtype policy: "float32", or "momentum_dtype" to honor
    # cfg.momentum_dtype (FedCM's broadcastable Δ_t)
    momentum_store: str = "float32"

    @property
    def wire_uplink_planes(self) -> Tuple[str, ...]:
        """The uplink planes that cross the client→server wire, which the
        payload accounting charges: ``delta`` always, ``state_delta`` iff
        the client state's delta goes up (SCAFFOLD's Δc_i does, FedDyn's
        λ_i never leaves the client), ``extra`` iff the spec sends a
        full-batch gradient (MimeLite)."""
        names = ["delta"]
        if self.needs_client_state and self.client_state_uplink:
            names.append("state_delta")
        if self.needs_full_grad:
            names.append("extra")
        return tuple(names)

    def momentum_dtype(self, cfg) -> torch.dtype:
        """The dtype the server momentum plane is stored in."""
        if self.momentum_store == "momentum_dtype":
            return getattr(torch, cfg.momentum_dtype)
        return torch.float32


_REGISTRY: Dict[str, AlgorithmSpec] = {}


def _validate(spec: AlgorithmSpec) -> None:
    """The reference's rules, minus those of the fields the port does not
    carry (escape hatches, wire-format declarations)."""
    if not spec.name or not isinstance(spec.name, str):
        raise ValueError(f"AlgorithmSpec needs a non-empty string name, got {spec.name!r}")
    if spec.momentum_store not in ("float32", "momentum_dtype"):
        raise ValueError(f"{spec.name}: momentum_store must be 'float32' or 'momentum_dtype'")
    if spec.direction_row is None:
        raise ValueError(f"{spec.name}: a direction_row is required")
    for stream, _ in spec.direction_row.aux:
        if stream not in DIRECTION_STREAMS:
            raise ValueError(f"{spec.name}: unknown direction stream {stream!r}; "
                             f"known: {DIRECTION_STREAMS}")
        if stream == "client_state" and not spec.needs_client_state:
            raise ValueError(f"{spec.name}: direction consumes 'client_state' but "
                             f"needs_client_state is False")
        if stream == "momentum" and not spec.needs_momentum_broadcast:
            raise ValueError(f"{spec.name}: direction consumes 'momentum' but "
                             f"needs_momentum_broadcast is False")
    if spec.needs_client_state and spec.state_update_fn is None:
        raise ValueError(f"{spec.name}: needs_client_state requires state_update_fn")
    if spec.client_state_uplink and not spec.needs_client_state:
        raise ValueError(f"{spec.name}: client_state_uplink without client state")
    if not spec.fold:
        raise ValueError(f"{spec.name}: empty fold")
    for p in spec.fold:
        if p.plane not in FOLD_PLANES:
            raise ValueError(f"{spec.name}: unknown fold plane {p.plane!r}; "
                             f"known: {FOLD_PLANES}")
        if p.plane == "state_delta" and not spec.needs_client_state:
            raise ValueError(f"{spec.name}: fold over state_delta without client state")
        if p.plane == "extra" and not spec.needs_full_grad:
            raise ValueError(f"{spec.name}: fold over extra without needs_full_grad")
    if not any(p.plane == "delta" for p in spec.fold):
        raise ValueError(f"{spec.name}: fold needs a pass over 'delta' (metrics and "
                         f"post-steps consume the cohort mean)")

    def identity(p):
        return (_is_static_zero(p.c_xd) and _is_static_zero(p.c_md)
                and _is_static_one(p.c_mm))

    if spec.server_post_fn is None and all(identity(p) for p in spec.fold):
        raise ValueError(f"{spec.name}: every fold pass is the identity (c_mm=1, c_md=0, "
                         f"c_xd=0) and there is no server_post_fn")


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


def server_init(size: int, momentum_dtype=torch.float32, device=None,
                needs_second_moment: bool = False) -> ServerState:
    """Allocate the flat server planes: zero momentum, round 0, and a zero
    f32 second moment iff ``needs_second_moment``."""
    sm = (torch.zeros((size,), dtype=torch.float32, device=device)
          if needs_second_moment else None)
    return ServerState(momentum=torch.zeros((size,), dtype=momentum_dtype, device=device),
                       round=torch.zeros((), dtype=torch.int32, device=device),
                       second_moment=sm)


def client_state_init(spec: AlgorithmSpec, num_clients: int, size: int,
                      device=None) -> Optional[torch.Tensor]:
    """The ``(N, P)`` f32 per-client state plane (zeros) iff the spec keeps
    per-client state, else None."""
    if not spec.needs_client_state:
        return None
    return torch.zeros((num_clients, size), dtype=torch.float32, device=device)


def describe_algorithm(spec: AlgorithmSpec) -> Dict[str, str]:
    """Human-readable routing summary of one spec, row for row the
    reference's (``fed_train --list-algos`` renders it)."""
    row = spec.direction_row
    terms = ["g"]
    if not _is_static_zero(row.c_x):
        terms.append("(x−x₀)")
    terms += [s for s, _ in row.aux]
    server = f"`server_update` ×{len(spec.fold)}"
    if spec.server_post_fn is not None:
        server += " + post"
    planes = [
        flag for flag, on in (
            ("client_state", spec.needs_client_state),
            ("momentum_bcast", spec.needs_momentum_broadcast),
            ("full_grad", spec.needs_full_grad),
            ("second_moment", spec.needs_second_moment),
        ) if on
    ] or ["—"]
    wire = spec.wire_uplink_planes
    return {
        "algorithm": spec.name,
        "local step": f"`fed_direction` affine: {' + '.join(terms)}",
        "server fold": server,
        "state planes": ", ".join(planes),
        "uplink": f"{len(wire)}×P ({'+'.join(wire)})",
        "wire": "f32",  # no spec declares a wire format; cfg.compression selects it
    }
