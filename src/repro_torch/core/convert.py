"""Carry weights and state between numpy arrays and the port.

The tests build inputs with numpy and hand the same arrays to both
packages; the reference's outputs come back as numpy with ``np.asarray``
on its pytrees.  This module turns such arrays into the port's params and
cache trees and flat ``FedState``, and the port's state back into numpy
planes for comparison.  bf16 arrays (ml_dtypes on the numpy side) pass through f32,
which is exact.  ``tree_state_from_numpy`` / ``tree_state_to_numpy`` do the
same for the per-leaf tree path's state (``use_flat_plane=False``), whose
planes are trees of the params' structure.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import FedConfig
from repro_torch.core.compress import effective_compression, init_residuals
from repro_torch.core.engine import FedState
from repro_torch.core.flat import FlatSpec
from repro_torch.core.registry import (
    ServerState,
    client_state_init,
    get_algorithm,
    tree_client_state_init,
    tree_server_init,
)
from repro_torch.utils.trees import tree_map


def to_tensor(a, device="cpu", dtype=None) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.as_tensor(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.tensor(np.ascontiguousarray(a))
    return t.to(device=device, dtype=dtype or t.dtype)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """f32 numpy copy (bf16 widened exactly); integer tensors keep their type."""
    t = t.detach().cpu()
    if t.dtype.is_floating_point:
        t = t.to(torch.float32)
    return t.numpy()


def params_from_numpy(tree, device="cpu"):
    """numpy tree → tensor tree on ``device``, leaf for leaf in the tree's
    dtypes: the MLP's params (list of {"w", "b"} dicts), an LM params tree
    from the reference's ``model.init`` (decoder-only: stacked on the
    periods axis; encoder-decoder: the ``enc`` / ``dec`` stacks beside
    ``embed``, ``unembed``, ``enc_norm`` and ``dec_norm``), an LM cache
    tree, or an optimizer state such as AdamW's ``(step, m, v)`` tuple (the
    int32 step stays a 0-d int32 tensor; ``params_to_numpy`` carries it
    back).  bf16 leaves stay bf16."""
    return tree_map(lambda a: to_tensor(a, device), tree)


def params_to_numpy(tree):
    return tree_map(to_numpy, tree)


def _plane(spec: FlatSpec, a, batch_dims: int = 0) -> torch.Tensor:
    """An f32 plane from a flat numpy array (``(P,)``, or ``(N, P)`` with
    ``batch_dims=1``) or from a numpy tree of the params' structure (leaves
    stacked ``(N, …)`` with ``batch_dims=1``, as the reference stacks its
    client states)."""
    if isinstance(a, np.ndarray) and a.ndim == 1 + batch_dims:
        return to_tensor(a, dtype=torch.float32)
    return spec.ravel(params_from_numpy(a), batch_dims=batch_dims)


def state_from_numpy(params, cfg: FedConfig, *, momentum=None, round: int = 0,
                     residuals=None, client_states=None, second_moment=None,
                     device="cpu", generator: Optional[torch.Generator] = None):
    """Build the flat ``FedState`` from numpy arrays — how a reference
    state is carried into the port.

    ``params`` is a numpy params tree; ``momentum`` and ``second_moment`` a
    numpy tree of the same structure, a flat ``(P,)`` array, or None
    (zeros).  The momentum plane is stored in the spec's momentum dtype;
    the second moment (f32) exists iff the spec needs it.
    ``client_states`` is the reference's stacked ``(N, …)`` tree or an
    ``(N, P)`` array, or None (zeros); the plane exists iff the spec keeps
    per-client state.
    ``residuals`` is the ``(N, P)`` top-k error-feedback plane; when it is
    None and the run's uplink is top-k, the rows start at zero (as
    ``FederatedEngine.init`` does).  Returns ``(state, spec)``."""
    tree = params_from_numpy(params)
    spec = FlatSpec.from_tree(tree)
    algo = get_algorithm(cfg.algo)
    m_dt = algo.momentum_dtype(cfg)
    m = (torch.zeros(spec.size, dtype=m_dt) if momentum is None
         else _plane(spec, momentum).to(m_dt))
    sm = None
    if algo.needs_second_moment:
        sm = (torch.zeros(spec.size, dtype=torch.float32) if second_moment is None
              else _plane(spec, second_moment)).to(device)
    cst = client_state_init(algo, cfg.num_clients, spec.size, device)
    if cst is not None and client_states is not None:
        cst = _plane(spec, client_states, batch_dims=1).to(device)
    if residuals is not None:
        res = to_tensor(residuals, device, torch.float32)
    else:
        res = init_residuals(effective_compression(cfg, algo), cfg.num_clients, spec.size,
                             device)
    state = FedState(
        params=spec.ravel(tree).to(device),
        server=ServerState(momentum=m.to(device),
                           round=torch.tensor(round, dtype=torch.int32, device=device),
                           second_moment=sm),
        rng=generator,
        residuals=res,
        client_states=cst,
    )
    return state, spec


def state_to_numpy(state: FedState) -> Dict[str, np.ndarray]:
    """Flat planes of a port state: params ``(P,)``, momentum ``(P,)`` (f32),
    round counter, the ``(P,)`` second moment, and the ``(N, P)`` residual
    and client-state rows (each None where the run has none)."""
    def opt(t):
        return None if t is None else to_numpy(t)

    return {"params": to_numpy(state.params),
            "momentum": to_numpy(state.server.momentum),
            "round": int(state.server.round),
            "second_moment": opt(state.server.second_moment),
            "residuals": opt(state.residuals),
            "client_states": opt(state.client_states)}


def tree_state_from_numpy(params, cfg: FedConfig, *, momentum=None, round: int = 0,
                          client_states=None, second_moment=None, device="cpu",
                          generator: Optional[torch.Generator] = None) -> FedState:
    """The tree path's ``FedState`` from numpy trees — how the reference's
    tree ``FedState`` is carried into the port.  ``params`` keeps its leaf
    dtypes; ``momentum`` / ``second_moment`` (trees of the params'
    structure) and ``client_states`` (the reference's stacked ``(N, …)``
    tree) keep theirs, and each missing one is the reference's initial
    plane (``tree_server_init`` in ``cfg.momentum_dtype``,
    ``tree_client_state_init``), present iff the spec needs it."""
    tree = params_from_numpy(params, device)
    algo = get_algorithm(cfg.algo)
    server = tree_server_init(tree, cfg.momentum_dtype,
                              needs_second_moment=algo.needs_second_moment)
    if momentum is not None:
        server = server._replace(momentum=params_from_numpy(momentum, device))
    if second_moment is not None and algo.needs_second_moment:
        server = server._replace(second_moment=params_from_numpy(second_moment, device))
    server = server._replace(round=torch.tensor(round, dtype=torch.int32, device=device))
    cst = tree_client_state_init(tree, cfg)
    if cst is not None and client_states is not None:
        cst = params_from_numpy(client_states, device)
    return FedState(params=tree, server=server, rng=generator, client_states=cst)


def tree_state_to_numpy(state: FedState) -> Dict[str, object]:
    """numpy trees of a tree-path state: params, momentum, second moment
    and client states (None where the run has none; bf16 widened to f32)
    and the round counter."""
    def opt(t):
        return None if t is None else params_to_numpy(t)

    return {"params": params_to_numpy(state.params),
            "momentum": params_to_numpy(state.server.momentum),
            "round": int(state.server.round),
            "second_moment": opt(state.server.second_moment),
            "client_states": opt(state.client_states)}
