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

Two escape hatches replace a row where an algorithm is not affine, as in
the reference.  ``direction_fn(cfg, m, cst, x, x0, g) -> v`` replaces the
direction row: it runs in plain PyTorch, once per client row, on ``(P,)``
planes (``m`` the broadcast plane, ``cst`` the client's state row or
None, ``x0`` the round's anchor x_t), as the reference's vmapped client
sees them, and no ``fed_direction`` launch happens; the step is ``x ←
x − η_l·v`` in x's dtype.  ``server_fn(cfg, params, server, mean_delta,
mean_sd, mean_extra, n_active, eta_l) -> (params, server)`` replaces the
fold rows and the post-step: the engine takes the masked cohort mean of
each uplink plane (``uplink_planes``; None for a plane the spec does not
produce) from the fold kernel with neither x nor m written, one launch a
plane, and hands them over on the ``(P,)`` planes, γ·mean on the async
ring.  The engine owns the round counter: it advances it after every
round whatever ``server_fn`` returns for it.

A spec may declare its uplink's wire format, as in the reference:
``uplink_compression`` ("int8" / "bf16" / "topk") is the default the
engine takes when ``cfg.compression`` is None
(``repro_torch.core.compress.effective_compression``), and a top-k spec
declares ``needs_residual``, its error-feedback stream.  No builtin spec
declares one.

A spec is registered with ``register_algorithm`` — called, or as a
decorator on a zero-argument builder — and runs on every engine path (the
sync round, the async ring, the host store, cohort sharding) with no
engine change::

    @register_algorithm
    def _fedavgm():
        return AlgorithmSpec(
            name="fedavgm",
            fold=(FoldPass("delta", c_mm=lambda cfg, e, n: 1.0 - cfg.alpha,
                           c_md=_c_pseudo_grad, c_xd=0.0),),
            server_post_fn=_fedavgm_post,
        )

``python -m repro_torch.core.registry [--write]`` prints the routing table
of the registered specs (and writes it into ``kernels/README.md``).

The per-leaf tree path (``use_flat_plane=False``) has the reference's
generic interpreters over leaf trees instead of the kernels:
``tree_direction``, ``client_finalize`` (unused uplink planes
materialize as zeros) and ``tree_server_update``, with the tree forms of
the state allocation, ``tree_server_init`` and ``tree_client_state_init``.
There a ``direction_fn`` sees one client's leaf trees and a ``server_fn``
the cohort means as leaf trees, as in the reference (over a model group
the whole trees, gathered from the ranks' shares); a ``state_update_fn``
and a ``server_post_fn``, written on tensors, run leaf by leaf (every
builtin one is elementwise).

Coefficients are floats or callables: ``cfg -> float`` for direction rows,
``(cfg, eta_l, n_active) -> scalar`` for fold rows, where ``eta_l`` and
``n_active`` are device tensors (η_l decays per round, |S| is drawn), so a
callable's result stays on the device.  Static zeros and ones are
structural: they drop a kernel operand or skip an output write.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.utils.trees import tree_flatten_with_path, tree_leaves, tree_map, tree_unflatten

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


class ClientOutputs(NamedTuple):
    """A client's uplink on the per-leaf tree path, as leaf trees (leaves
    with a leading cohort axis for a cohort): ``delta`` = x_{i,K} − x_t,
    ``state_delta`` the per-client state update (SCAFFOLD's Δc_i, FedDyn's
    Δλ_i) and ``extra`` the full-batch gradient (MimeLite); a plane the
    spec does not use is zeros, as in the reference."""

    delta: Any
    state_delta: Any
    extra: Any


def _dir_coef(c: DirCoef, cfg) -> float:
    return float(c(cfg)) if callable(c) else float(c)  # repro: noqa REP003 -- a direction coefficient is a Python value of cfg


def _fold_coef(c: FoldCoef, cfg, eta_l, n_active):
    return c(cfg, eta_l, n_active) if callable(c) else c


def _is_static_zero(c) -> bool:
    return isinstance(c, (int, float)) and float(c) == 0.0  # repro: noqa REP003 -- isinstance-guarded Python scalar


def _is_static_one(c) -> bool:
    return isinstance(c, (int, float)) and float(c) == 1.0  # repro: noqa REP003 -- isinstance-guarded Python scalar


class AlgorithmSpec(NamedTuple):
    """One federated algorithm as data (see module docstring)."""

    name: str
    # --- (a) client direction ---
    direction_row: Optional[DirectionRow] = DirectionRow()
    direction_fn: Optional[Callable] = None  # (cfg, m, cst, x, x0, g) -> v
    # round-close per-client state update, or None (stateless):
    #   (cfg, x0, xK, cst, m, delta, eta_l) -> state_delta
    state_update_fn: Optional[Callable] = None
    # --- (b) server fold ---
    fold: Tuple[FoldPass, ...] = (FoldPass("delta"),)
    # (cfg, x, server, dmean, n_active, eta_l) -> (x, server)
    server_post_fn: Optional[Callable] = None
    # escape hatch replacing fold + post: (cfg, params, server, mean_delta,
    # mean_sd, mean_extra, n_active, eta_l) -> (params, server)
    server_fn: Optional[Callable] = None
    # --- (c) state-plane requirements ---
    needs_client_state: bool = False
    needs_momentum_broadcast: bool = False
    needs_full_grad: bool = False
    needs_second_moment: bool = False
    client_state_uplink: bool = False  # does Δstate ride the uplink (payload)
    # stored-momentum dtype policy: "float32", or "momentum_dtype" to honor
    # cfg.momentum_dtype (FedCM's broadcastable Δ_t)
    momentum_store: str = "float32"
    # --- (d) uplink wire format (repro_torch.core.compress) ---
    # the spec's default compression kind ("int8" / "bf16" / "topk", None:
    # f32); cfg.compression overrides it
    uplink_compression: Optional[str] = None
    # top-k's error-feedback residual rows, a per-client stream: a "topk"
    # spec must declare it, and only a "topk" spec may
    needs_residual: bool = False

    @property
    def uplink_planes(self) -> Tuple[str, ...]:
        """The ``(C, P)`` uplink planes a cohort produces: ``delta`` always,
        ``state_delta`` iff the spec keeps per-client state, ``extra`` iff
        it sends a full-batch gradient.  The ring's entries and the cohort
        shards carry these."""
        names = ["delta"]
        if self.needs_client_state and self.state_update_fn is not None:
            names.append("state_delta")
        if self.needs_full_grad:
            names.append("extra")
        return tuple(names)

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

    @property
    def fold_planes(self) -> Tuple[str, ...]:
        """The uplink planes the round close reads, in first-use order: those
        the fold rows name, or every uplink plane for a ``server_fn`` spec
        (it reads the mean of each).  Under cohort sharding these are the
        planes moved to column blocks."""
        if self.server_fn is not None:
            return self.uplink_planes
        return tuple(dict.fromkeys(p.plane for p in self.fold))

    def momentum_dtype(self, cfg) -> torch.dtype:
        """The dtype the server momentum plane is stored in."""
        if self.momentum_store == "momentum_dtype":
            return getattr(torch, cfg.momentum_dtype)
        return torch.float32

    def direction(self, cfg, m, cst, x, x0, g):
        """The escape hatch's local direction v on one client's ``(P,)``
        planes.  An affine row has no interpreter here: it runs in the
        ``fed_direction`` kernel (``kernels.fed_direction.ops``)."""
        if self.direction_fn is None:
            raise ValueError(f"{self.name}: an affine direction row runs in the "
                             f"fed_direction kernel (kernels.fed_direction.ops)")
        return self.direction_fn(cfg, m, cst, x, x0, g)

    def server_update(self, cfg, params, server, mean_delta, mean_sd, mean_extra, n_active,
                      eta_l, discount=1.0):
        """The ``server_fn`` escape hatch's round close on the cohort means
        (``(P,)`` f32, None for a plane the spec does not produce), each
        discounted by the async staleness weight γ (``discount``; the sync
        round's 1.0 multiplies nothing).  Fold rows have no interpreter
        here: they run in the ``server_update`` kernel
        (``kernels.server_update.ops.fused_fold``)."""
        if self.server_fn is None:
            raise ValueError(f"{self.name}: fold rows run in the server_update kernel "
                             f"(kernels.server_update.ops.fused_fold)")
        if not _is_static_one(discount):
            mean_delta, mean_sd, mean_extra = (None if a is None else discount * a
                                               for a in (mean_delta, mean_sd, mean_extra))
        return self.server_fn(cfg, params, server, mean_delta, mean_sd, mean_extra,
                              n_active, eta_l)

    # -------------------------------------------- the per-leaf tree path
    def tree_direction(self, cfg, m, cst, x, x0, g, group=None):
        """The local direction v over leaf trees (the reference's
        ``direction``): the affine row leaf by leaf in the reference's
        order, or the ``direction_fn`` on the trees.  ``x``, ``g`` and
        ``cst`` may lead with a cohort axis, against which ``m`` and ``x0``
        broadcast.  Over a model ``group`` (a ``core.flat.GroupPlane``) the
        trees are one client's shares: the ``direction_fn`` sees the whole
        leaf trees, gathered over the group, and this rank's share of its
        direction comes back; the affine row runs on the shares."""
        if self.direction_fn is not None:
            if group is not None:
                whole = [_whole_tree(group, t) for t in (m, cst, x, x0, g)]
                return _share_tree(group, self.direction_fn(cfg, *whole))
            return self.direction_fn(cfg, m, cst, x, x0, g)
        row = self.direction_row
        c_g, c_x = _dir_coef(row.c_g, cfg), _dir_coef(row.c_x, cfg)
        streams = {"momentum": m, "client_state": cst}
        aux = [(streams[s], _dir_coef(c, cfg)) for s, c in row.aux]
        aux = [(t, c) for t, c in aux if c != 0.0]  # static-zero streams drop
        trees = [g] + ([x, x0] if c_x != 0.0 else []) + [t for t, _ in aux]
        coefs = [c for _, c in aux]

        def leaf(g_l, *rest):
            v = c_g * g_l
            if c_x != 0.0:
                v = v + c_x * (rest[0] - rest[1])
                rest = rest[2:]
            for c_s, s_l in zip(coefs, rest):
                v = v + c_s * s_l
            return v

        return tree_map(leaf, *trees)

    def client_finalize(self, cfg, x0, xK, cst, m, eta_l, full_grad) -> ClientOutputs:
        """The uplink on the tree path: unused planes are zeros (the tree
        path aggregates them, as the reference's does), each leaf a
        zero-stride view (``zeros_view``) that holds no cohort-sized buffer.
        The state update runs leaf by leaf."""
        delta = tree_map(torch.sub, xK, x0)
        if self.state_update_fn is not None:
            sd = tree_map(lambda a, b, c, d, e: self.state_update_fn(cfg, a, b, c, d, e, eta_l),
                          x0, xK, cst, m, delta)
        else:
            sd = tree_map(zeros_view, xK)
        extra = full_grad if self.needs_full_grad else tree_map(zeros_view, xK)
        return ClientOutputs(delta, sd, extra)

    def tree_server_update(self, cfg, params, st, mean_delta, mean_sd, mean_extra, n_active,
                           eta_l, discount=1.0, group=None):
        """The round close over leaf trees (the reference's
        ``server_update``): the fold rows leaf by leaf, the momentum cast
        to its store dtype, the round counter advanced, then the post-step
        leaf by leaf; or the ``server_fn`` on the (γ-discounted) mean
        trees.  Over a model ``group`` the trees are a rank's shares: the
        ``server_fn`` sees the whole trees, gathered, and this rank's share
        of its params and server trees comes back; the fold rows and the
        post-step (elementwise) run on the shares."""
        if self.server_fn is not None:
            if not _is_static_one(discount):
                mean_delta, mean_sd, mean_extra = (
                    None if t is None else tree_map(lambda a: discount * a, t)
                    for t in (mean_delta, mean_sd, mean_extra))
            if group is not None:
                whole = functools.partial(_whole_tree, group)
                x, new = self.server_fn(
                    cfg, whole(params), st._replace(momentum=whole(st.momentum),
                                                    second_moment=whole(st.second_moment)),
                    whole(mean_delta), whole(mean_sd), whole(mean_extra), n_active, eta_l)
                return _share_tree(group, x), new._replace(
                    momentum=_share_tree(group, new.momentum),
                    second_moment=_share_tree(group, new.second_moment))
            return self.server_fn(cfg, params, st, mean_delta, mean_sd, mean_extra,
                                  n_active, eta_l)
        planes = {"delta": mean_delta, "state_delta": mean_sd, "extra": mean_extra}
        x, m = params, st.momentum
        dmean_delta = None
        for p in self.fold:
            dmean = planes[p.plane]
            if not _is_static_one(discount):
                dmean = tree_map(lambda a: discount * a, dmean)
            if p.plane == "delta":
                dmean_delta = dmean
            c_mm = _fold_coef(p.c_mm, cfg, eta_l, n_active)
            c_md = _fold_coef(p.c_md, cfg, eta_l, n_active)
            c_xd = _fold_coef(p.c_xd, cfg, eta_l, n_active)
            if not (_is_static_zero(p.c_md) and _is_static_one(p.c_mm)):
                if _is_static_zero(p.c_mm):
                    m = tree_map(lambda d: c_md * d, dmean)
                else:
                    m = tree_map(lambda mi, d: c_mm * mi + c_md * d, m, dmean)
            if not _is_static_zero(p.c_xd):
                x = tree_map(lambda xi, d: xi + c_xd * d, x, dmean)
        if self.momentum_store == "momentum_dtype":
            m = tree_map(lambda a: a.to(self.momentum_dtype(cfg)), m)
        new_st = st._replace(momentum=m, round=st.round + 1)
        if self.server_post_fn is None:
            return x, new_st
        xs, treedef = tree_flatten_with_path(x)
        ms, sms = tree_leaves(m), new_st.second_moment
        sms = [None] * len(ms) if sms is None else tree_leaves(sms)
        outs = [self.server_post_fn(cfg, xl, new_st._replace(momentum=ml, second_moment=sl),
                                    dl, n_active, eta_l)
                for (_, xl), ml, sl, dl in zip(xs, ms, sms, tree_leaves(dmean_delta))]
        x = tree_unflatten(treedef, [o[0] for o in outs])
        m = tree_unflatten(treedef, [o[1].momentum for o in outs])
        sm = (None if new_st.second_moment is None
              else tree_unflatten(treedef, [o[1].second_moment for o in outs]))
        return x, new_st._replace(momentum=m, second_moment=sm)


def zeros_view(like: torch.Tensor, shape=None) -> torch.Tensor:
    """Zeros of ``like``'s dtype and device in ``shape`` (default its own)
    as a zero-stride view of one element: a read-only plane of zeros that
    allocates nothing cohort-sized."""
    zero = torch.zeros((), dtype=like.dtype, device=like.device)
    return zero.expand(like.shape if shape is None else shape)


def _whole_tree(group, tree):
    """The whole tree whose share on this rank of ``group`` is ``tree``."""
    if tree is None:
        return None
    leaves, treedef = tree_flatten_with_path(tree)
    return tree_unflatten(treedef, group.gather_leaves([leaf for _, leaf in leaves]))


def _share_tree(group, tree):
    """This rank's share of the whole tree ``tree``."""
    if tree is None:
        return None
    leaves, treedef = tree_flatten_with_path(tree)
    return tree_unflatten(treedef, group.share_leaves([leaf for _, leaf in leaves]))


#: the reference's other name for the spec
Algorithm = AlgorithmSpec

_REGISTRY: Dict[str, AlgorithmSpec] = {}


def _validate(spec: AlgorithmSpec) -> None:
    """The reference's rules, with its messages."""
    if not spec.name or not isinstance(spec.name, str):
        raise ValueError(f"AlgorithmSpec needs a non-empty string name, got {spec.name!r}")
    if spec.momentum_store not in ("float32", "momentum_dtype"):
        raise ValueError(f"{spec.name}: momentum_store must be 'float32' or 'momentum_dtype'")
    if (spec.direction_row is None) == (spec.direction_fn is None):
        raise ValueError(f"{spec.name}: exactly one of direction_row / direction_fn required")
    if spec.direction_row is not None:
        for stream, _ in spec.direction_row.aux:
            if stream not in DIRECTION_STREAMS:
                raise ValueError(f"{spec.name}: unknown direction stream {stream!r}; "
                                 f"known: {DIRECTION_STREAMS}")
            if stream == "client_state" and not spec.needs_client_state:
                raise ValueError(f"{spec.name}: direction consumes 'client_state' but "
                                 f"needs_client_state is False — no plane would be "
                                 f"allocated")
            if stream == "momentum" and not spec.needs_momentum_broadcast:
                raise ValueError(f"{spec.name}: direction consumes 'momentum' but "
                                 f"needs_momentum_broadcast is False — payload accounting "
                                 f"would undercharge the downlink")
    if spec.needs_client_state and spec.state_update_fn is None:
        raise ValueError(f"{spec.name}: needs_client_state requires state_update_fn "
                         f"(how does the per-client plane evolve?)")
    if spec.client_state_uplink and not spec.needs_client_state:
        raise ValueError(f"{spec.name}: client_state_uplink without client state")
    if spec.uplink_compression not in (None, "int8", "bf16", "topk"):
        raise ValueError(f"{spec.name}: unknown uplink_compression "
                         f"{spec.uplink_compression!r}; known: int8 | bf16 | topk")
    if spec.uplink_compression == "topk" and not spec.needs_residual:
        raise ValueError(f"{spec.name}: uplink_compression='topk' without needs_residual "
                         f"— lossy sparsification needs the error-feedback residual "
                         f"stream or every uplink is silently biased (repro.core.compress)")
    if spec.needs_residual and spec.uplink_compression != "topk":
        raise ValueError(f"{spec.name}: needs_residual declared but uplink_compression is "
                         f"{spec.uplink_compression!r} — only 'topk' carries residuals")
    if spec.server_fn is not None:
        if spec.server_post_fn is not None:
            raise ValueError(f"{spec.name}: server_fn replaces fold+post — drop "
                             f"server_post_fn")
        return
    if not spec.fold:
        raise ValueError(f"{spec.name}: empty fold and no server_fn escape hatch")
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
                         f"c_xd=0) and there is no server_post_fn — the server would "
                         f"never move; give a pass real coefficients, or add "
                         f"server_post_fn / server_fn")


def register_algorithm(spec_or_builder=None, *, override: bool = False):
    """Validate and register an ``AlgorithmSpec``; returns it.  Three forms::

        register_algorithm(spec)                  # direct
        @register_algorithm                       # decorator on a zero-argument
        def _myalgo(): return AlgorithmSpec(...)  #   builder
        register_algorithm(spec, override=True)   # replace a registered name

    (``@register_algorithm(override=True)`` decorates too.)  A name already
    registered raises unless ``override=True``."""
    if spec_or_builder is None:
        return lambda sb: register_algorithm(sb, override=override)
    spec = spec_or_builder() if callable(spec_or_builder) else spec_or_builder
    if not isinstance(spec, AlgorithmSpec):
        raise TypeError(f"expected AlgorithmSpec, got {type(spec).__name__}")
    _validate(spec)
    if spec.name in _REGISTRY and not override:
        raise ValueError(f"algorithm {spec.name!r} already registered "
                         f"(pass override=True to replace)")
    _REGISTRY[spec.name] = spec
    return spec


def unregister_algorithm(name: str) -> None:
    """Remove a registered algorithm (a name not registered is ignored)."""
    _REGISTRY.pop(name, None)


def get_algorithm(name: str) -> AlgorithmSpec:
    if name not in _REGISTRY:
        raise KeyError(f"unknown federated algorithm {name!r}; registered: "
                       f"{sorted(_REGISTRY)} (see repro_torch.core.registry."
                       f"register_algorithm)")
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


def tree_server_init(params, momentum_dtype="float32",
                     needs_second_moment: bool = True) -> ServerState:
    """The reference's ``server_init(params, …)`` on the tree path: a zero
    momentum tree in ``momentum_dtype``, round 0, and a zero second moment
    in each leaf's dtype iff ``needs_second_moment``, on the params'
    device."""
    mdt = getattr(torch, momentum_dtype) if isinstance(momentum_dtype, str) else momentum_dtype
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    return ServerState(
        momentum=tree_map(lambda p: torch.zeros(p.shape, dtype=mdt, device=p.device), params),
        round=torch.zeros((), dtype=torch.int32, device=dev),
        second_moment=tree_map(torch.zeros_like, params) if needs_second_moment else None)


def tree_client_state_init(params, cfg):
    """The reference's ``client_state_init(params, cfg)`` on the tree path:
    stacked ``(N, …)`` zero leaves in each leaf's dtype iff the spec keeps
    per-client state on resident state, else None."""
    if not get_algorithm(cfg.algo).needs_client_state:
        return None
    if cfg.population_store != "resident":
        return None
    return tree_map(lambda p: torch.zeros((cfg.num_clients, *p.shape), dtype=p.dtype,
                                          device=p.device), params)


def describe_algorithm(spec: AlgorithmSpec) -> Dict[str, str]:
    """Human-readable routing summary of one spec: row for row the
    reference's for an affine spec; an escape hatch names what the port
    runs for it (``fed_train --list-algos`` and the ``kernels/README.md``
    table render it)."""
    if spec.direction_fn is not None:
        direction = "custom PyTorch (`direction_fn`, a client row at a time)"
    else:
        row = spec.direction_row
        terms = ["g"]
        if not _is_static_zero(row.c_x):
            terms.append("(x−x₀)")
        terms += [s for s, _ in row.aux]
        direction = f"`fed_direction` affine: {' + '.join(terms)}"
    if spec.server_fn is not None:
        server = f"`server_update` mean ×{len(spec.fold_planes)} + custom (`server_fn`)"
    else:
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
    comp = spec.uplink_compression or "f32"
    if spec.needs_residual:
        comp += " + residual"
    return {
        "algorithm": spec.name,
        "local step": direction,
        "server fold": server,
        "state planes": ", ".join(planes),
        "uplink": f"{len(wire)}×P ({'+'.join(wire)})",
        "wire": comp,  # the spec's default wire format (cfg.compression overrides it)
    }


def routing_table_md() -> str:
    """The registered specs' routing table as markdown, generated from the
    registry (``kernels/README.md`` embeds it; regenerate with ``python -m
    repro_torch.core.registry --write``)."""
    rows = [describe_algorithm(get_algorithm(n)) for n in list_algorithms()]
    cols = ["algorithm", "local step", "server fold", "state planes", "uplink", "wire"]
    widths = {c: max(len(c), *(len(r[c]) for r in rows)) for c in cols}

    def fmt(r):
        return "| " + " | ".join(r[c].ljust(widths[c]) for c in cols) + " |"

    sep = "|" + "|".join("-" * (widths[c] + 2) for c in cols) + "|"
    return "\n".join([fmt({c: c for c in cols}), sep] + [fmt(r) for r in rows])


README_BEGIN = "<!-- registry-routing:begin (generated by repro_torch.core.registry) -->"
README_END = "<!-- registry-routing:end -->"


def sync_readme(write: bool = False) -> bool:
    """True if ``kernels/README.md`` embeds the current routing table; with
    ``write=True`` rewrite the block between the markers in place."""
    from pathlib import Path

    import repro_torch.core.algorithms  # noqa: F401  (the builtin specs register on import)

    readme = Path(__file__).resolve().parents[1] / "kernels" / "README.md"
    text = readme.read_text()
    block = f"{README_BEGIN}\n{routing_table_md()}\n{README_END}"
    if README_BEGIN not in text or README_END not in text:
        if not write:
            return False
        raise RuntimeError(f"{readme}: routing-table markers missing")
    start = text.index(README_BEGIN)
    end = text.index(README_END) + len(README_END)
    if text[start:end] == block:
        return True
    if write:
        readme.write_text(text[:start] + block + text[end:])
        return True
    return False


def _main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="print (or sync into kernels/README.md) the registry's routing table")
    ap.add_argument("--write", action="store_true",
                    help="rewrite the README block between the markers")
    args = ap.parse_args(argv)
    # under ``python -m`` this file runs as __main__, a second module with
    # an empty registry: the canonical import is the one the specs fill
    import repro_torch.core.algorithms  # noqa: F401  (the builtin specs register on import)
    from repro_torch.core import registry as canonical

    print(canonical.routing_table_md())
    if args.write:
        canonical.sync_readme(write=True)
        print("\n(README block synced)")
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
