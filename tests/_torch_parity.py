"""Shared set-up of the port-vs-reference parity tests (tests/test_torch_*.py).

Everything is small: an MLP (8, 16, 16, 4), N = 6 clients, cohort 3, K = 2
local steps, batch 4.  Inputs are made with numpy from a seed and handed to
both packages; the reference runs on the CPU as its own tests run it (its
Pallas kernels in interpret mode, or its jnp route).

Tolerances (one table, stated once):

* ``RTOL`` 2e-5 / ``ATOL`` 1e-6 — the reference's own kernel sweeps use
  rtol 2e-5.  Elementwise kernels against their plain versions meet it
  with room; the round and the gradient need it because the MLP's matrix
  products sum in another order in PyTorch's CPU GEMM than in XLA's.
* ``ROUND_ATOL`` 1e-5 — three chained rounds compound that last-digit
  difference through K local steps and the momentum (values are O(1)).
* bf16 outputs are compared to within one bf16 ulp (``BF16_RTOL`` 2^-7):
  the two frameworks may round a value that sits on a tie boundary of an
  f32 difference apart to neighbouring bf16 values.
* Lossy uplink, round level (``FLIP_MAX`` 4): the port's delta plane and
  the reference's differ in the last digits, so a stochastic-rounding
  ``floor`` (int8), a round-to-nearest tie (bf16) or a k-th-place choice
  (top-k) can flip and move one element of one client by one quantum.  A
  round then passes when at most ``FLIP_MAX`` elements of a plane lie
  beyond ``RTOL``/``ATOL`` and each of them moved by less than the
  reference's largest step that round.  Each round starts from the
  reference's state, so a flip cannot compound into the next round.
"""
from __future__ import annotations

from dataclasses import fields, replace

import numpy as np
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import FedConfig as RefFedConfig
from repro.core.compress import plane_key, round_key
from repro.core.faults import _per_client_keys
from repro.core.registry import get_algorithm as ref_get_algorithm
from repro.core.engine import FederatedEngine as RefEngine
from repro.models.small import classification_loss as ref_classification_loss
from repro.models.small import mlp_classifier as ref_mlp_classifier
from repro_torch.configs.base import CompressionConfig, FaultConfig, FedConfig
from repro_torch.core.engine import FederatedEngine, RoundDraws
from repro_torch.core.flat import FlatSpec
from repro_torch.data.pipeline import FederatedData
from repro_torch.models.small import classification_loss, mlp_classifier

RTOL, ATOL = 2e-5, 1e-6
ROUND_ATOL = 1e-5
BF16_RTOL = 2.0 ** -7
FLIP_MAX = 4

DIMS = (8, 16, 16, 4)
N_CLIENTS, COHORT, K, B = 6, 3, 2, 4


def ref_cfg(participation="fixed", **kw) -> RefFedConfig:
    return RefFedConfig(num_clients=N_CLIENTS, cohort_size=COHORT, local_steps=K,
                        participation=participation, **kw)


def _copy(obj, cls):
    """``cls`` built from the same-named fields of the reference dataclass
    ``obj`` (None stays None)."""
    if obj is None:
        return None
    names = {f.name for f in fields(cls)}
    return cls(**{f.name: getattr(obj, f.name) for f in fields(obj) if f.name in names})


def port_cfg(cfg: RefFedConfig) -> FedConfig:
    """The port's FedConfig with the reference config's values (its fault
    and compression configs copied into the port's dataclasses)."""
    out = _copy(cfg, FedConfig)
    return replace(out, fault=_copy(cfg.fault, FaultConfig),
                   compression=_copy(cfg.compression, CompressionConfig))


def np_params(seed: int = 0, dims=DIMS):
    """A numpy params tree in the reference's layout (list of {"w", "b"})."""
    rng = np.random.default_rng(seed)
    return [{"w": (rng.normal(size=(dims[i], dims[i + 1])) / np.sqrt(dims[i])).astype(np.float32),
             "b": (0.1 * rng.normal(size=(dims[i + 1],))).astype(np.float32)}
            for i in range(len(dims) - 1)]


def jax_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def ref_engine(cfg: RefFedConfig):
    model = ref_mlp_classifier(DIMS)
    return RefEngine(cfg, ref_classification_loss(model.apply), batch_size=B), model


def client_data(seed: int = 1, n_per: int = 10):
    """Stacked per-client data ``(N, n_per, in)`` / ``(N, n_per)``."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N_CLIENTS, n_per, DIMS[0])).astype(np.float32)
    y = rng.integers(0, DIMS[-1], size=(N_CLIENTS, n_per)).astype(np.int32)
    return x, y


def ref_draws(eng, client_x, client_y, key, t=0):
    """The reference's own cohort + minibatch draws for one round, as numpy."""
    _, batches, ids, mask, _, _ = eng._sample_round(
        key, jnp.asarray(client_x), jnp.asarray(client_y), jnp.int32(t))
    return ({k: np.asarray(v) for k, v in batches.items()},
            np.asarray(ids), np.asarray(mask))


def torch_batches(batches, device="cpu"):
    return {"x": torch.tensor(np.array(batches["x"]), device=device),
            "y": torch.tensor(np.array(batches["y"]), device=device).long()}


def assert_close(actual, expected, rtol=RTOL, atol=ATOL, what=""):
    np.testing.assert_allclose(np.asarray(actual, np.float32),
                               np.asarray(expected, np.float32),
                               rtol=rtol, atol=atol, err_msg=what)


def ref_round_draws(cfg, t, ids, P) -> RoundDraws:
    """The reference's fault and int8 rounding draws for round ``t``,
    computed as its engine computes them, as a port ``RoundDraws``: the
    rounding draw of every wire plane the reference spec sends."""
    ids = jnp.asarray(ids)
    out = {}
    f = cfg.fault
    if f is not None:
        kt = jax.random.fold_in(jax.random.PRNGKey(f.seed), t)
        one_u = jax.vmap(lambda k: jax.random.uniform(k, ()))
        if f.drop_rate > 0:
            out["u_drop"] = one_u(_per_client_keys(kt, 1, ids))
        if f.deadline > 0:
            out["z_deadline"] = jax.vmap(lambda k: jax.random.normal(k, ()))(
                _per_client_keys(kt, 2, ids))
        if f.corrupt_rate > 0:
            out["u_corrupt"] = one_u(_per_client_keys(kt, 3, ids))
            if f.corrupt_mode == "noise":
                lk = jax.vmap(lambda k: jax.random.fold_in(k, 0))(_per_client_keys(kt, 4, ids))
                out["z_noise"] = jax.vmap(lambda k: jax.random.normal(k, (P,), jnp.float32))(lk)
    c = cfg.compression
    if c is not None and c.kind == "int8":
        fields = {"delta": "u", "state_delta": "u_state_delta", "extra": "u_extra"}
        for name in ref_get_algorithm(cfg.algo).wire_uplink_planes:
            out[fields[name]] = jax.random.uniform(plane_key(round_key(c, t), name),
                                                   (ids.shape[0], P), jnp.float32)
    return RoundDraws(**{k: torch.tensor(np.asarray(v)) for k, v in out.items()})


def count_flips(got, ref, prev, what):
    """Elements beyond RTOL/ATOL (floor flips); at most FLIP_MAX, each within
    the reference's largest step this round."""
    diff = np.abs(got - ref)
    beyond = diff > ATOL + RTOL * np.abs(ref)
    n = int(beyond.sum())
    assert n <= FLIP_MAX, f"{what}: {n} elements beyond tolerance (max diff {diff.max():.3e})"
    if n:
        step = float(np.abs(ref - prev).max())
        assert float(diff[beyond].max()) <= step, f"{what}: flip larger than a step"
    return n


def port_engine(pcfg):
    """The port's engine on the CPU for the parity MLP."""
    model = mlp_classifier(DIMS)
    spec = FlatSpec.from_tree(model.init(torch.Generator().manual_seed(0)))
    return FederatedEngine(pcfg, classification_loss(model.apply), spec, batch_size=B,
                           device="cpu")


def small_cfg(**kw) -> FedConfig:
    """The port's own config at the parity size (in-port contracts)."""
    return FedConfig(num_clients=N_CLIENTS, cohort_size=COHORT, local_steps=K,
                     participation="fixed", **kw)


def data_setup(cfg, seed=0):
    """(engine, initialized state, FederatedData) of the port on ``cfg``,
    with its own weights and draws from ``seed``."""
    cx, cy = client_data()
    data = FederatedData(cx.reshape(-1, DIMS[0]), cy.reshape(-1), cfg.num_clients, seed=seed,
                         device="cpu")
    model = mlp_classifier(DIMS)
    params = model.init(torch.Generator().manual_seed(seed))
    eng = FederatedEngine(cfg, classification_loss(model.apply), FlatSpec.from_tree(params),
                          batch_size=B, device="cpu")
    return eng, eng.init(params, torch.Generator().manual_seed(seed + 1)), data


def assert_states_equal(a, b):
    """Two port states equal bit for bit, plane for plane."""
    assert torch.equal(a.params, b.params)
    assert torch.equal(a.server.momentum, b.server.momentum)
    assert torch.equal(a.server.round, b.server.round)
    for x, y in ((a.server.second_moment, b.server.second_moment),
                 (a.client_states, b.client_states), (a.residuals, b.residuals)):
        assert (x is None) == (y is None)
        if x is not None:
            assert torch.equal(x, y)


# SSD scan (tests/test_torch_ssd.py): y sums up to 64 decayed terms of
# magnitude ~10 (x·dt·C·B), and the chunked and sequential forms reach them
# through different exp(cumsum) differences, so an absolute floor is needed
# beside RTOL; the reference's own tests compare its three forms at 2e-4.
SSD_RTOL, SSD_ATOL = 2e-5, 2e-5

# LM models (tests/test_torch_lm.py, reduced configs, f32): logits and caches
# pass through two layers of matrix products of width 256–512 (plus the
# 512-wide unembedding), each summed in another order by PyTorch's CPU GEMM
# than by XLA's; values are O(1).
LM_RTOL, LM_ATOL = 2e-5, 1e-5
