"""Port vs reference: FedCM over an LM — the reference's
``examples/federated_llm.py`` path, on reduced configs.

The seam is ``round_step(state, batches, ids, mask)``: the reference draws
the cohort and the LM minibatches (``{"x": tokens, "y": labels}``, each
``(C, K, B, S)``) from per-client corpora with ``jax.random``, and the same
draws go into both packages, which start from the reference's
``model.init(PRNGKey(0))`` weights.  The reference's loss is its
``model.loss_fn`` per client under its engine's ``vmap``; the port's is
``cohort_loss_fn`` over views of the ``(C, P)`` cohort plane.  Bounds
(tests/_torch_parity.py): the round's loss at ``LM_RTOL`` / ``LM_ATOL``,
params at ``RTOL`` / ``ROUND_ATOL``, momentum within ``GRAD_REL_L2``
relative L2 (the momentum is a mean of K-step deltas, i.e. of gradients,
which sum in another order on each side).

Also: the corpora and the chain are the reference's numpy bit for bit;
``cohort_loss_fn``'s rows are each row's own ``loss_fn`` bit for bit; the
engine's gradient through the leaf views is the slice route's plane bit for
bit; the data-driven rounds are deterministic.
"""
from dataclasses import fields
from functools import lru_cache

import numpy as np
import pytest
import torch

import jax

from _torch_parity import (
    GRAD_REL_L2, LM_ATOL, LM_RTOL, ROUND_ATOL, RTOL, assert_close, assert_states_equal,
    flat_tree, port_cfg, ref_draw_chain,
)
from repro.configs.base import FedConfig as RefFedConfig
from repro.configs.base import get_config as ref_get_config
from repro.configs.base import reduced as ref_reduced
from repro.core.engine import FederatedEngine as RefEngine
from repro.data.synthetic import make_markov_transition as ref_make_markov_transition
from repro.data.synthetic import make_synthetic_lm as ref_make_synthetic_lm
from repro.models import build_model as ref_build_model
from repro_torch.configs.base import ModelConfig, get_config, reduced
from repro_torch.core.convert import state_from_numpy, state_to_numpy
from repro_torch.core.engine import FederatedEngine, metrics_to_host
from repro_torch.core.flat import FlatSpec
from repro_torch.data import (
    CHAIN_VOCAB, LMFederatedData, federated_lm_corpora, make_markov_transition,
)
from repro_torch.models.model import build_model, cohort_loss_fn
from repro_torch.models.small import classification_loss, mlp_classifier
from repro_torch.utils.trees import tree_leaves, tree_map

torch.set_num_threads(1)

N, COHORT, K, B, S, N_SEQ = 6, 3, 2, 2, 32, 8
ROUND_CASES = [("llama3.2-1b", "kernel"), ("llama3.2-1b", "jnp"),
               ("mamba2-1.3b", "kernel"), ("dbrx-132b", "kernel")]


def port_model_cfg(rcfg) -> ModelConfig:
    names = {f.name for f in fields(ModelConfig)}
    return ModelConfig(**{f.name: getattr(rcfg, f.name) for f in fields(rcfg)
                          if f.name in names})


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ------------------------------------------------------------------- data
def test_markov_transition_is_the_references():
    for v, temp, seed in ((512, 0.3, 0), (37, 1.0, 104)):
        np.testing.assert_array_equal(make_markov_transition(v, temp, seed),
                                      ref_make_markov_transition(v, temp, seed))


@pytest.mark.parametrize("vocab", [512, 128256])
def test_corpora_are_the_examples(vocab):
    """``federated_lm_corpora`` against the example's loop over the
    reference's numpy, at the chain's vocabulary min(vocab, CHAIN_VOCAB)."""
    v = min(vocab, CHAIN_VOCAB)
    base = ref_make_markov_transition(v, temperature=0.3, seed=0)
    want = np.stack([ref_make_synthetic_lm(
        v, 17, 8, transition=0.6 * base + 0.4 * ref_make_markov_transition(
            v, temperature=0.3, seed=100 + c), seed=c) for c in range(3)])
    got = federated_lm_corpora(vocab, 3, 17, 8)
    assert got.dtype == want.dtype and got.shape == (3, 8, 17)
    np.testing.assert_array_equal(got, want)
    assert got.max() < v


def test_lm_federated_data_is_tokens_and_next_token_labels():
    toks = federated_lm_corpora(512, 4, 9, 5)
    data = LMFederatedData(toks, device="cpu")
    assert (data.num_clients, data.n_per_client) == (4, 5)
    assert data.client_x.dtype == torch.int64 and data.client_x.shape == (4, 5, 8)
    np.testing.assert_array_equal(data.client_x.numpy(), toks[..., :-1])
    np.testing.assert_array_equal(data.client_y.numpy(), toks[..., 1:])


# ------------------------------------------------------------------- loss
def _stacked_params(model, C, seed=0):
    """``C`` different weight rows stacked on a leading axis."""
    rows = [model.init(torch.Generator().manual_seed(seed + c)) for c in range(C)]
    return tree_map(lambda *xs: torch.stack(xs), *rows)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-1.3b", "dbrx-132b"])
def test_cohort_loss_rows_are_each_rows_own_loss(arch):
    """Losses and gradient rows of ``cohort_loss_fn`` against each row's own
    ``model.loss_fn`` and its gradient, bit for bit."""
    model = build_model(reduced(get_config(arch)))
    C = 2
    stacked = tree_map(lambda t: t.requires_grad_(True), _stacked_params(model, C))
    gen = torch.Generator().manual_seed(5)
    x = torch.randint(0, 512, (C, 2, 16), generator=gen)
    y = torch.randint(0, 512, (C, 2, 16), generator=gen)
    losses = cohort_loss_fn(model)(stacked, {"x": x, "y": y})
    assert losses.shape == (C,)
    grads = torch.autograd.grad(losses.sum(), tree_leaves(stacked))
    for c in range(C):
        row = tree_map(lambda t: t[c].detach().clone().requires_grad_(True), stacked)
        loss, _ = model.loss_fn(row, {"tokens": x[c], "labels": y[c]})
        assert torch.equal(losses[c], loss)
        for g, gr in zip(grads, torch.autograd.grad(loss, tree_leaves(row))):
            assert torch.equal(g[c], gr)


def test_cohort_loss_refuses_the_encoder_decoder():
    with pytest.raises(ValueError, match="decoder-only"):
        cohort_loss_fn(build_model(reduced(get_config("seamless-m4t-large-v2"))))


def _slice_route(eng, x, batch):
    """The gradient with respect to the whole plane (each leaf view's slice
    backward writes a zero plane, then they are summed)."""
    plane = x.detach().requires_grad_(True)
    with torch.enable_grad():
        losses = eng.loss_fn(eng.spec.unravel(plane), batch)
        (g,) = torch.autograd.grad(losses.sum(), plane)
    return losses.detach(), g


def _mlp_engine():
    model = mlp_classifier((8, 16, 16, 4))
    params = model.init(torch.Generator().manual_seed(0))
    return FederatedEngine(port_cfg(RefFedConfig(num_clients=N, cohort_size=COHORT)),
                           classification_loss(model.apply), FlatSpec.from_tree(params),
                           device="cpu"), params


@pytest.mark.parametrize("model_kind", ["mlp", "llama3.2-1b", "dbrx-132b"])
def test_value_and_grad_is_the_slice_routes_plane(model_kind):
    """The engine's gradient through the leaf views is ``torch.equal`` to
    the gradient with respect to the whole plane."""
    gen = torch.Generator().manual_seed(7)
    if model_kind == "mlp":
        eng, params = _mlp_engine()
        batch = {"x": torch.randn(COHORT, 4, 8, generator=gen),
                 "y": torch.randint(0, 4, (COHORT, 4), generator=gen)}
    else:
        model = build_model(reduced(get_config(model_kind)))
        params = model.init(torch.Generator().manual_seed(0))
        eng = FederatedEngine(port_cfg(RefFedConfig(num_clients=N, cohort_size=COHORT)),
                              cohort_loss_fn(model), FlatSpec.from_tree(params), device="cpu")
        batch = {"x": torch.randint(0, 512, (COHORT, 2, 16), generator=gen),
                 "y": torch.randint(0, 512, (COHORT, 2, 16), generator=gen)}
    x = eng.spec.ravel(params).expand(COHORT, -1).contiguous()
    x = x + 1e-3 * torch.randn(x.shape, generator=gen)  # rows differ
    loss, g = eng._value_and_grad(x, batch)
    loss_s, g_s = _slice_route(eng, x, batch)
    assert g.shape == x.shape and torch.equal(loss, loss_s) and torch.equal(g, g_s)
    assert bool(g.abs().sum(dim=1).gt(0).all())


# -------------------------------------------------------- rounds vs reference
def _ref_fed_cfg(route) -> RefFedConfig:
    return RefFedConfig(algo="fedcm", num_clients=N, cohort_size=COHORT, local_steps=K,
                        alpha=0.1, eta_l=0.05, weight_decay=1e-4, participation="fixed",
                        use_fused_kernel=(route == "kernel"))


@lru_cache(maxsize=None)
def _rounds(arch, route, n_rounds=3):
    """Both packages' states after each of ``n_rounds`` chained rounds on
    the reference's draws: per round the losses and the flat planes."""
    rcfg = ref_reduced(ref_get_config(arch))
    rmodel = ref_build_model(rcfg)
    rparams = rmodel.init(jax.random.PRNGKey(0))
    toks = federated_lm_corpora(rcfg.vocab_size, N, S + 1, N_SEQ)
    cx, cy = toks[..., :-1], toks[..., 1:]
    cfg = _ref_fed_cfg(route)

    def ref_loss(p, b):
        return rmodel.loss_fn(p, {"tokens": b["x"], "labels": b["y"]})[0]

    reng = RefEngine(cfg, ref_loss, batch_size=B)
    rst = reng.init(rparams, jax.random.PRNGKey(1))
    chain = ref_draw_chain(reng, cx, cy, rst.rng, n_rounds)

    model = build_model(port_model_cfg(rcfg))
    pcfg = port_cfg(cfg)
    pst, spec = state_from_numpy(_np(rparams), pcfg)
    peng = FederatedEngine(pcfg, cohort_loss_fn(model), spec, batch_size=B, device="cpu")
    out = []
    for d in chain:
        rst, rm = reng.round_step(rst, d["batches"], d["ids"], d["mask"])
        batches = {k: torch.tensor(np.array(v)).long() for k, v in d["batches"].items()}
        pst, pm = peng.round_step(pst, batches, torch.tensor(d["ids"]), torch.tensor(d["mask"]))
        port = state_to_numpy(pst)
        out.append({"ref_loss": float(rm.loss), "port_loss": float(metrics_to_host(pm)["loss"][0]),
                    "ref": {"params": flat_tree(rst.params),
                            "momentum": flat_tree(rst.server.momentum)},
                    "port": {"params": port["params"], "momentum": port["momentum"]},
                    "start": flat_tree(rparams)})
    return out


@pytest.mark.parametrize("n_rounds", [1, 3])
@pytest.mark.parametrize("arch,route", ROUND_CASES, ids=[f"{a}-{r}" for a, r in ROUND_CASES])
def test_rounds_match_reference(arch, route, n_rounds):
    """FedCM over the reduced LM: ``n_rounds`` chained rounds of the port on
    the reference's draws against the reference's ``round_step``."""
    rows = _rounds(arch, route)[:n_rounds]
    for r, row in enumerate(rows):
        assert np.isfinite(row["port_loss"])
        assert_close(row["port_loss"], row["ref_loss"], rtol=LM_RTOL, atol=LM_ATOL,
                     what=f"round {r} loss")
    last = rows[-1]
    assert_close(last["port"]["params"], last["ref"]["params"], rtol=RTOL, atol=ROUND_ATOL,
                 what="params")
    assert rel_l2(last["port"]["momentum"], last["ref"]["momentum"]) <= GRAD_REL_L2
    # the round moved the params: the comparison is not of two unchanged planes
    assert float(np.abs(last["ref"]["params"] - last["start"]).max()) > 10 * ROUND_ATOL


# ----------------------------------------------------- data-driven rounds
def _lm_engine(seed=0):
    model = build_model(reduced(get_config("llama3.2-1b")))
    params = model.init(torch.Generator().manual_seed(seed))
    cfg = port_cfg(_ref_fed_cfg("kernel"))
    eng = FederatedEngine(cfg, cohort_loss_fn(model), FlatSpec.from_tree(params),
                          batch_size=B, device="cpu")
    data = LMFederatedData(federated_lm_corpora(512, N, 17, N_SEQ), device="cpu")
    return eng, eng.init(params, torch.Generator().manual_seed(seed + 1)), data


def test_run_rounds_on_lm_data_is_deterministic():
    """``run_rounds`` over ``LMFederatedData`` from one seeded generator is
    bitwise the same twice, and bitwise ``run_round`` called round by
    round; its metrics are finite and count the fixed cohort."""
    eng, state, data = _lm_engine()
    a, ma = eng.run_rounds(state, data, 2)
    eng2, state2, _ = _lm_engine()
    b, mb = eng2.run_rounds(state2, data, 2)
    assert_states_equal(a, b)
    for x, y in zip(ma, mb):
        assert torch.equal(x, y)
    eng3, c, _ = _lm_engine()
    for _ in range(2):
        c, _ = eng3.run_round(c, data)
    assert_states_equal(a, c)
    host = metrics_to_host(ma)
    assert np.isfinite(host["loss"]).all() and list(host["n_active"]) == [COHORT, COHORT]
    assert int(a.server.round) == 2
