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
from repro_torch.core.convert import state_from_numpy, state_to_numpy
from repro_torch.core.engine import FederatedEngine, RoundDraws, RoundInputs, metrics_to_host
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


def ref_draw_chain(eng, client_x, client_y, key, n_rounds):
    """The reference's draws for ``n_rounds`` consecutive rounds from the
    run's initial key, as its round loops take them (``_sample_round``
    advances the key each round; the round counter is the round index):
    per round a dict of numpy ``batches``, ``ids``, ``mask``, ``n_clipped``
    and ``full`` (each cohort client's whole dataset)."""
    cx, cy = jnp.asarray(client_x), jnp.asarray(client_y)
    out = []
    for t in range(n_rounds):
        key, batches, ids, mask, full, n_clipped = eng._sample_round(key, cx, cy, jnp.int32(t))
        out.append({"batches": {k: np.asarray(v) for k, v in batches.items()},
                    "ids": np.asarray(ids), "mask": np.asarray(mask),
                    "n_clipped": np.asarray(n_clipped),
                    "full": {k: np.asarray(v) for k, v in full.items()}})
    return out


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
    kw.setdefault("participation", "fixed")
    return FedConfig(num_clients=N_CLIENTS, cohort_size=COHORT, local_steps=K, **kw)


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


# ---------------------------------------------------------------- state planes
# the nonzero start state of the algorithm and ring parity tests, and the
# reference's states as flat numpy planes


def like_params(seed, scale, stack=None, positive=False):
    """A numpy tree of the params' structure (leaves ``(stack, …)`` when
    ``stack`` is given)."""
    rng = np.random.default_rng(seed)
    lead = () if stack is None else (stack,)

    def draw(shape):
        a = rng.random(lead + shape) if positive else rng.normal(size=lead + shape)
        return (scale * a).astype(np.float32)

    return [{k: draw(v.shape) for k, v in layer.items()} for layer in np_params()]


def flat_tree(tree):
    """A params-structured tree as its flat ``(P,)`` plane."""
    leaves = jax.tree_util.tree_leaves(tree)
    return np.concatenate([np.asarray(l, np.float32).ravel() for l in leaves])


def flat_rows(tree):
    """A stacked ``(N, …)`` tree as its ``(N, P)`` plane."""
    leaves = jax.tree_util.tree_leaves(tree)
    return np.concatenate([np.asarray(l, np.float32).reshape(l.shape[0], -1)
                           for l in leaves], axis=1)


def ring_start():
    """The nonzero state both packages start the ring from, as numpy trees:
    momentum, a positive second moment and ``(N, …)`` client states."""
    return {"momentum": like_params(3, 0.05),
            "second_moment": like_params(4, 1e-3, positive=True),
            "client_states": like_params(5, 0.05, stack=N_CLIENTS)}


def ref_state_numpy(st):
    return {"params": flat_tree(st.params), "momentum": flat_tree(st.server.momentum),
            "second_moment": (None if st.server.second_moment is None
                              else flat_tree(st.server.second_moment)),
            "client_states": (None if st.client_states is None
                              else flat_rows(st.client_states)),
            "residuals": None if st.residuals is None else np.asarray(st.residuals),
            "round": int(st.server.round)}


# ---------------------------------------------------------------- async ring
# tests/test_torch_async*.py: the port's ring against the reference's
# run_rounds_async on the reference's draws
RING_METRICS = ("loss", "n_active", "delta_norm", "momentum_norm", "eta_l", "folded",
                "n_dropped", "n_quarantined", "quorum_skipped")


def ring_parity(algo, depth, stale, gamma, route="kernel", n_rounds=None, **cfg_kw):
    """The reference's ``run_rounds_async`` scan (``n_rounds`` launches,
    default D + 1) and its drain, and the port's ring on the same draws,
    from one nonzero start state.  Returns ``{"ref": …, "port": …}``, each
    with the numpy planes after the loop (``scan``) and after the drain
    (``drained``) and the loop's metrics, plus the start planes."""
    n_rounds = depth + 1 if n_rounds is None else n_rounds
    cfg = ref_cfg(algo=algo, use_fused_kernel=(route == "kernel"),
                  staleness_discount=gamma, **cfg_kw)
    eng, _ = ref_engine(cfg)
    start = ring_start()
    st = eng.init(jax_tree(np_params()), jax.random.PRNGKey(11))
    srv = st.server._replace(momentum=jax_tree(start["momentum"]))
    if srv.second_moment is not None:
        srv = srv._replace(second_moment=jax_tree(start["second_moment"]))
    st = st._replace(server=srv)
    if st.client_states is not None:
        st = st._replace(client_states=jax_tree(start["client_states"]))
    cx, cy = client_data()
    chain = ref_draw_chain(eng, cx, cy, st.rng, n_rounds)
    r_scan, pending, rm = eng._run_rounds_async(
        st, jnp.asarray(cx), jnp.asarray(cy), None, None, None, n_rounds=n_rounds,
        pipeline_depth=depth, staleness=stale, eval_every=0, predict_fn=None)
    ref = {"scan": ref_state_numpy(r_scan),  # read before the drain donates it
           "metrics": {f: np.asarray(getattr(rm, f), np.float32) for f in RING_METRICS}}
    ref["drained"] = ref_state_numpy(eng._drain_async(r_scan, pending, pipeline_depth=depth))

    pcfg = port_cfg(cfg)
    peng = port_engine(pcfg)
    pst, _ = state_from_numpy(np_params(), pcfg, momentum=start["momentum"],
                              second_moment=start["second_moment"],
                              client_states=start["client_states"])
    size = peng.spec.size
    inputs = iter([RoundInputs(
        torch_batches(d["batches"]), torch.tensor(d["ids"]), torch.tensor(d["mask"]),
        torch.tensor(d["n_clipped"]),
        torch_batches(d["full"]) if peng.algo.needs_full_grad else None,
        ref_round_draws(cfg, t, d["ids"], size)) for t, d in enumerate(chain)])
    p_scan, pm, p_pending = peng.run_rounds_async_on(
        pst, lambda _: next(inputs), n_rounds, pipeline_depth=depth, staleness=stale,
        drain=False)
    p_drained = peng.drain_async(p_scan, p_pending, depth)
    host = metrics_to_host(pm)
    port = {"scan": state_to_numpy(p_scan), "drained": state_to_numpy(p_drained),
            "metrics": {f: host[f] for f in RING_METRICS}, "pending": len(p_pending)}
    first = {"params": flat_tree(np_params()), "momentum": flat_tree(start["momentum"]),
             "client_states": flat_rows(start["client_states"])}
    return {"ref": ref, "port": port, "start": first, "draws": chain}


RING_CASES = [(algo, d, s, g) for algo in ("fedcm", "scaffold", "mimelite", "feddyn", "fedadam")
              for d, s, g in ((2, 1, 0.9), (3, 0, 1.0), (4, 2, 0.9))]


def assert_ring_states(r):
    """Every state plane of the port's ring against the reference's: after
    the loop (two folds, each of a cohort launched from the start state) at
    ``RTOL`` / ``ATOL``, after the drain at ``ROUND_ATOL``."""
    for phase, atol in (("scan", ATOL), ("drained", ROUND_ATOL)):
        for key in ("params", "momentum", "second_moment", "client_states"):
            got, want = r["port"][phase][key], r["ref"][phase][key]
            assert (got is None) == (want is None), (phase, key)
            if got is not None:
                assert_close(got, want, atol=atol, what=f"{phase} {key}")
        assert r["port"][phase]["round"] == r["ref"][phase]["round"]


def assert_ring_metrics(r):
    """The loop's metrics: counts and the fill / fold flags exactly, the
    rest at ``RTOL`` / ``ROUND_ATOL``."""
    got, want = r["port"]["metrics"], r["ref"]["metrics"]
    for f in RING_METRICS:
        if f in ("n_active", "folded", "n_dropped", "n_quarantined", "quorum_skipped"):
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)
        else:
            assert_close(got[f], want[f], atol=ROUND_ATOL, what=f)


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
