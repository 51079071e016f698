"""The specs the public-API tests register at runtime, in the port's terms.

Spawned ranks import this module by name, so it imports torch and the port
only (no JAX).  tests/test_torch_registry_api.py writes the same specs for
the reference and holds the two to each other.

* ``_test_damped`` — the reference's affine spec of tests/test_registry.py:
  damped SGD with a proximal pull, an EMA-free pseudo-gradient fold;
* ``_test_escape`` — both escape hatches: a normalized-gradient
  ``direction_fn`` (not elementwise: each client's g / ‖g‖) and an
  averaging ``server_fn``;
* ``_test_mixed`` — an affine direction with the averaging ``server_fn``
  (the reference's tests/test_cohort_shard.py spec);
* ``_test_escape_state`` — a ``server_fn`` over a SCAFFOLD-style client
  state: it reads the state-delta mean and moves the momentum.
"""
from __future__ import annotations

import contextlib

import torch

import repro_torch.core.algorithms  # noqa: F401  (the builtin specs register on import)
from repro_torch.core.registry import (
    AlgorithmSpec,
    DirectionRow,
    FoldPass,
    get_algorithm,
    register_algorithm,
    unregister_algorithm,
)
from repro_torch.utils.trees import tree_leaves, tree_map

NAMES = ("_test_damped", "_test_escape", "_test_mixed", "_test_escape_state")


def normalized_direction(cfg, m, cst, x, x0, g):
    """g / ‖g‖ over one client's plane, or over its leaf tree on the tree
    path (the reference's tests sum over the tree's leaves too)."""
    norm = torch.sqrt(sum(torch.sum(leaf * leaf) for leaf in tree_leaves(g))) + 1e-12
    return tree_map(lambda leaf: leaf / norm, g)


def averaging_server(cfg, params, server, mean_delta, mean_sd, mean_extra, n_active, eta_l):
    new = tree_map(lambda p, d: p + cfg.eta_g * d, params, mean_delta)
    return new, server._replace(round=server.round + 1)


def state_server(cfg, params, server, mean_delta, mean_sd, mean_extra, n_active, eta_l):
    m = server.momentum + mean_sd * (n_active / cfg.num_clients)
    return params + cfg.eta_g * mean_delta, server._replace(momentum=m, round=server.round + 1)


def specs():
    """The four specs, by name."""
    return {
        "_test_damped": AlgorithmSpec(
            name="_test_damped",
            direction_row=DirectionRow(c_g=0.7, c_x=0.05),
            fold=(FoldPass("delta", c_mm=0.0,
                           c_md=lambda cfg, e, n: -1.0 / (e * cfg.local_steps),
                           c_xd=lambda cfg, e, n: cfg.eta_g),)),
        "_test_escape": AlgorithmSpec(
            name="_test_escape", direction_row=None, direction_fn=normalized_direction,
            fold=(), server_fn=averaging_server),
        "_test_mixed": AlgorithmSpec(
            name="_test_mixed", direction_row=DirectionRow(), server_fn=averaging_server),
        "_test_escape_state": AlgorithmSpec(
            name="_test_escape_state",
            direction_row=DirectionRow(aux=(("client_state", -1.0), ("momentum", 1.0))),
            state_update_fn=get_algorithm("scaffold").state_update_fn,
            server_fn=state_server, needs_client_state=True, needs_momentum_broadcast=True,
            client_state_uplink=True),
    }


@contextlib.contextmanager
def registered(names=NAMES):
    """The specs ``names`` registered for the body, unregistered after it:
    nothing leaks into another test's view of the registry."""
    for name, spec in specs().items():
        if name in names:
            register_algorithm(spec, override=True)
    try:
        yield
    finally:
        for name in names:
            unregister_algorithm(name)
