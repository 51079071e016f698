"""The port's algorithm registry against the reference's, spec by spec.

Every one of the eleven registered specs has the reference's direction
row, fold rows, state-plane flags, wire planes and routing row
(``describe_algorithm``); each post-step and state update computes what the
reference's computes on the same planes (f32, at ``RTOL``/``ATOL`` of
tests/_torch_parity.py); and ``_validate`` refuses what the reference's
refuses.
"""
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_parity import assert_close, port_cfg, ref_cfg
import repro.core.algorithms  # noqa: F401  (registers the reference's specs)
from repro.core import registry as ref_registry
from repro_torch.core import registry
from repro_torch.core.registry import (
    _dir_coef, _fold_coef, client_state_init, describe_algorithm, get_algorithm,
    list_algorithms, server_init,
)

torch.set_num_threads(1)

ALL_ALGOS = ("fedacg", "fedadagrad", "fedadam", "fedavg", "fedavgm", "fedcm", "feddyn",
             "fedprox", "fedyogi", "mimelite", "scaffold")
FLAGS = ("needs_client_state", "needs_momentum_broadcast", "needs_full_grad",
         "needs_second_moment", "client_state_uplink", "momentum_store")
POSTS = ("fedacg", "fedadagrad", "fedadam", "fedavgm", "feddyn", "fedyogi")
STATEFUL = ("feddyn", "scaffold")


def test_the_port_registers_the_reference_registry():
    assert list_algorithms() == ALL_ALGOS == ref_registry.list_algorithms()


@pytest.mark.parametrize("algo", ALL_ALGOS)
def test_describe_algorithm_rows_equal_the_reference(algo):
    assert describe_algorithm(get_algorithm(algo)) == \
        ref_registry.describe_algorithm(ref_registry.get_algorithm(algo))


@pytest.mark.parametrize("alpha", [0.1, 1.0])
@pytest.mark.parametrize("algo", ALL_ALGOS)
def test_spec_rows_and_flags_match_the_reference(algo, alpha):
    cfg = ref_cfg(algo=algo, alpha=alpha, eta_g=0.7, feddyn_alpha=0.02, fedprox_mu=0.05,
                  acg_lambda=0.8)
    pcfg = port_cfg(cfg)
    ref, got = ref_registry.get_algorithm(algo), get_algorithm(algo)
    r_row, p_row = ref.direction_row, got.direction_row
    assert _dir_coef(p_row.c_g, pcfg) == ref_registry._dir_coef(r_row.c_g, cfg)
    assert _dir_coef(p_row.c_x, pcfg) == ref_registry._dir_coef(r_row.c_x, cfg)
    assert [(s, _dir_coef(c, pcfg)) for s, c in p_row.aux] == \
        [(s, ref_registry._dir_coef(c, cfg)) for s, c in r_row.aux]
    assert len(got.fold) == len(ref.fold)
    for pp, rp in zip(got.fold, ref.fold):
        assert pp.plane == rp.plane
        for k in ("c_mm", "c_md", "c_xd"):
            a, b = getattr(pp, k), getattr(rp, k)
            # a static zero or one is structural (skips a write): same in both
            assert registry._is_static_zero(a) == ref_registry._is_static_zero(b), k
            assert registry._is_static_one(a) == ref_registry._is_static_one(b), k
            a = _fold_coef(a, pcfg, torch.tensor(0.05), torch.tensor(3.0))
            b = ref_registry._fold_coef(b, cfg, jnp.float32(0.05), jnp.float32(3.0))
            assert float(a) == float(b), k
    for f in FLAGS:
        assert getattr(got, f) == getattr(ref, f), f
    assert (got.server_post_fn is None) == (ref.server_post_fn is None)
    assert (got.state_update_fn is None) == (ref.state_update_fn is None)
    assert got.wire_uplink_planes == ref.wire_uplink_planes


@pytest.mark.parametrize("algo", ALL_ALGOS)
def test_allocation_follows_the_spec_flags(algo):
    spec = get_algorithm(algo)
    srv = server_init(7, spec.momentum_dtype(port_cfg(ref_cfg(algo=algo))),
                      needs_second_moment=spec.needs_second_moment)
    assert srv.momentum.shape == (7,) and int(srv.round) == 0
    assert (srv.second_moment is not None) == spec.needs_second_moment
    cst = client_state_init(spec, 5, 7)
    assert (cst is not None) == spec.needs_client_state
    for plane in (srv.second_moment, cst):
        if plane is not None:
            assert plane.dtype == torch.float32 and torch.count_nonzero(plane) == 0
    if cst is not None:
        assert cst.shape == (5, 7)


# ----------------------------------------------------------- post-steps and state updates
def _planes(seed, P=257, C=4):
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return {"x": n(P), "m": 0.1 * n(P), "v": (1e-3 * rng.random(P)).astype(np.float32),
            "dmean": 0.05 * n(P), "x0": n(P), "xK": n(C, P), "cst": 0.1 * n(C, P)}


@pytest.mark.parametrize("algo", POSTS)
def test_post_step_matches_the_reference(algo):
    """The spec's post-step on the post-fold planes: params and the second
    moment, reading the post-fold momentum."""
    cfg = ref_cfg(algo=algo, eta_g=0.03 if "ada" in algo or "yogi" in algo else 1.0)
    pcfg = port_cfg(cfg)
    p = _planes(1)
    ref_spec, spec = ref_registry.get_algorithm(algo), get_algorithm(algo)
    sm = p["v"] if spec.needs_second_moment else None
    rx, rsrv = ref_spec.server_post_fn(
        cfg, jnp.asarray(p["x"]),
        ref_registry.ServerState(momentum=jnp.asarray(p["m"]),
                                 second_moment=None if sm is None else jnp.asarray(sm),
                                 round=jnp.int32(1)),
        jnp.asarray(p["dmean"]), jnp.float32(3.0), jnp.float32(0.05))
    px, psrv = spec.server_post_fn(
        pcfg, torch.tensor(p["x"]),
        registry.ServerState(momentum=torch.tensor(p["m"]), round=torch.tensor(1),
                             second_moment=None if sm is None else torch.tensor(sm)),
        torch.tensor(p["dmean"]), torch.tensor(3.0), torch.tensor(0.05))
    assert_close(px, rx, what="params")
    assert_close(psrv.momentum, rsrv.momentum, what="momentum")
    assert (psrv.second_moment is None) == (rsrv.second_moment is None)
    if sm is not None:
        assert_close(psrv.second_moment, rsrv.second_moment, what="second moment")


@pytest.mark.parametrize("algo", STATEFUL)
def test_state_update_matches_the_reference(algo):
    """The per-client state delta on the ``(C, P)`` cohort planes, the
    broadcast (P,) momentum against per-client rows."""
    cfg = ref_cfg(algo=algo)
    p = _planes(2)
    delta = p["xK"] - p["x0"]
    ref = ref_registry.get_algorithm(algo).state_update_fn(
        cfg, jnp.asarray(p["x0"]), jnp.asarray(p["xK"]), jnp.asarray(p["cst"]),
        jnp.asarray(p["m"]), jnp.asarray(delta), jnp.float32(0.05))
    got = get_algorithm(algo).state_update_fn(
        port_cfg(cfg), torch.tensor(p["x0"]), torch.tensor(p["xK"]), torch.tensor(p["cst"]),
        torch.tensor(p["m"]), torch.tensor(delta), torch.tensor(0.05))
    assert got.shape == delta.shape
    assert_close(got, ref, what="state delta")


# ----------------------------------------------------------- validation
def _ok(m, **kw):
    return m.AlgorithmSpec(name="probe", **kw)


def _noop_update(*a):
    return a[5]


def _noop_post(cfg, x, srv, *a):
    return x, srv


BAD = {
    "empty-name": lambda m: m.AlgorithmSpec(name=""),
    "momentum-store": lambda m: _ok(m, momentum_store="bfloat16"),
    "no-direction-row": lambda m: _ok(m, direction_row=None),
    "unknown-stream": lambda m: _ok(m, direction_row=m.DirectionRow(aux=(("foo", 1.0),))),
    "client-state-stream-without-state": lambda m: _ok(
        m, direction_row=m.DirectionRow(aux=(("client_state", -1.0),))),
    "momentum-stream-without-broadcast": lambda m: _ok(
        m, direction_row=m.DirectionRow(aux=(("momentum", 1.0),))),
    "state-without-update": lambda m: _ok(m, needs_client_state=True),
    "uplink-without-state": lambda m: _ok(m, client_state_uplink=True),
    "empty-fold": lambda m: _ok(m, fold=()),
    "unknown-plane": lambda m: _ok(m, fold=(m.FoldPass("delta", c_xd=1.0),
                                            m.FoldPass("bar", c_md=1.0))),
    "state-plane-without-state": lambda m: _ok(
        m, fold=(m.FoldPass("delta", c_xd=1.0), m.FoldPass("state_delta", c_md=1.0))),
    "extra-plane-without-full-grad": lambda m: _ok(
        m, fold=(m.FoldPass("delta", c_xd=1.0), m.FoldPass("extra", c_md=1.0))),
    "no-delta-pass": lambda m: _ok(m, needs_full_grad=True,
                                   fold=(m.FoldPass("extra", c_md=1.0),)),
    "identity-fold-without-post": lambda m: _ok(m, fold=(m.FoldPass("delta"),)),
}
GOOD = {
    "plain": lambda m: _ok(m, fold=(m.FoldPass("delta", c_xd=1.0),)),
    "identity-fold-with-post": lambda m: _ok(m, fold=(m.FoldPass("delta"),),
                                             server_post_fn=_noop_post),
    "client-state": lambda m: _ok(
        m, direction_row=m.DirectionRow(aux=(("client_state", -1.0),)),
        state_update_fn=_noop_update, needs_client_state=True, client_state_uplink=True,
        fold=(m.FoldPass("delta", c_xd=1.0), m.FoldPass("state_delta", c_md=1.0))),
    "full-grad": lambda m: _ok(
        m, needs_full_grad=True,
        fold=(m.FoldPass("delta", c_xd=1.0), m.FoldPass("extra", c_md=1.0))),
}
MODULES = {"reference": ref_registry, "port": registry}


@pytest.mark.parametrize("case", list(BAD))
def test_validate_refuses_what_the_reference_refuses(case):
    for name, m in MODULES.items():
        with pytest.raises(ValueError):
            m._validate(BAD[case](m))


@pytest.mark.parametrize("case", list(GOOD))
def test_validate_accepts_what_the_reference_accepts(case):
    for m in MODULES.values():
        m._validate(GOOD[case](m))


def test_register_refuses_duplicates_and_non_specs():
    with pytest.raises(ValueError, match="already registered"):
        registry.register_algorithm(get_algorithm("fedavg"))
    with pytest.raises(TypeError):
        registry.register_algorithm(types.SimpleNamespace(name="x"))
