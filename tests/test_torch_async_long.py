"""Port vs reference over a whole run of the async ring, at the CLI's
default task: MimeLite at D = 2, S = 1, γ = 0.9 for 20 launches plus the
drain, N = 100 clients, Bernoulli 10 % participation (capacity 25), K = 10,
B = 50, MLP 32-128-128-10 (P = 22,026), Dirichlet 0.6 — the configuration
of ``chip_smoke.py``'s phase 4c.

The reference's ``run_rounds_async`` (its jnp route) and the port's loop
``run_rounds_async_on`` run on the reference's draws from the same weights;
every round's loss and the drained params and momentum are held at
``ROUND_ATOL``, and both reach the same test accuracy.  So whatever the ring
does to MimeLite over 20 rounds at this depth — its loss falls and rises
again as the discounted stale folds overshoot — the reference does too;
it is not a drift of the port that builds up fold by fold.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import (
    RTOL, ROUND_ATOL, assert_close, flat_tree, port_cfg, ref_draw_chain, torch_batches,
)
from repro.configs.base import FedConfig as RefFedConfig
from repro.core.engine import FederatedEngine as RefEngine
from repro.data import FederatedData as RefData
from repro.data import make_synthetic_classification as ref_synthetic
from repro.models.small import classification_loss as ref_classification_loss
from repro.models.small import mlp_classifier as ref_mlp_classifier
from repro_torch.core.convert import state_from_numpy, state_to_numpy
from repro_torch.core.engine import FederatedEngine, RoundDraws, RoundInputs, metrics_to_host
from repro_torch.core.flat import FlatSpec
from repro_torch.models.small import classification_loss, mlp_classifier

torch.set_num_threads(1)
DIMS = (32, 128, 128, 10)
ROUNDS, DEPTH, STALE, GAMMA = 20, 2, 1, 0.9


@pytest.fixture(scope="module")
def run():
    cfg = RefFedConfig(algo="mimelite", participation="bernoulli", use_fused_kernel=False,
                       staleness_discount=GAMMA)
    x_tr, y_tr, x_te, y_te = ref_synthetic(n_classes=10, dim=32, n_train=50_000,
                                           n_test=10_000, seed=0)
    data = RefData(x_tr, y_tr, cfg.num_clients, dirichlet_alpha=0.6, seed=0)
    model = ref_mlp_classifier(DIMS)
    eng = RefEngine(cfg, ref_classification_loss(model.apply), batch_size=50)
    params = model.init(jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.asarray, params)  # the scan donates the state
    st = eng.init(params, jax.random.PRNGKey(1))
    chain = ref_draw_chain(eng, np.asarray(data.client_x), np.asarray(data.client_y), st.rng,
                           ROUNDS)
    r_scan, pending, rm = eng._run_rounds_async(
        st, data.client_x, data.client_y, None, None, None, n_rounds=ROUNDS,
        pipeline_depth=DEPTH, staleness=STALE, eval_every=0, predict_fn=None)
    ref_loss = np.asarray(rm.loss, np.float32)
    r_end = eng._drain_async(r_scan, pending, pipeline_depth=DEPTH)
    ref = {"params": flat_tree(r_end.params), "momentum": flat_tree(r_end.server.momentum),
           "loss": ref_loss,
           "acc": float((np.asarray(model.apply(r_end.params, jnp.asarray(x_te))).argmax(-1)
                         == y_te).mean())}

    pcfg = port_cfg(cfg)
    pmodel = mlp_classifier(DIMS)
    spec = FlatSpec.from_tree(pmodel.init(torch.Generator().manual_seed(0)))
    peng = FederatedEngine(pcfg, classification_loss(pmodel.apply), spec, batch_size=50,
                           device="cpu")
    pst, _ = state_from_numpy(np_params, pcfg)
    inputs = iter([RoundInputs(torch_batches(d["batches"]), torch.tensor(d["ids"]),
                               torch.tensor(d["mask"]), torch.tensor(d["n_clipped"]),
                               torch_batches(d["full"]), RoundDraws()) for d in chain])
    p_end, pm, _ = peng.run_rounds_async_on(pst, lambda _: next(inputs), ROUNDS,
                                            pipeline_depth=DEPTH, staleness=STALE)
    logits = pmodel.apply(spec.unravel(p_end.params), torch.tensor(x_te))
    planes = state_to_numpy(p_end)
    port = {"params": planes["params"], "momentum": planes["momentum"],
            "loss": metrics_to_host(pm)["loss"],
            "acc": float((logits.argmax(-1).numpy() == y_te).mean())}
    return ref, port


@pytest.mark.parametrize("key", ["params", "momentum", "loss"])
def test_mimelite_ring_run_matches_reference(run, key):
    ref, port = run
    assert_close(port[key], ref[key], rtol=RTOL, atol=ROUND_ATOL, what=key)


def test_mimelite_ring_run_reaches_the_reference_accuracy(run):
    ref, port = run
    assert abs(port["acc"] - ref["acc"]) <= 2e-4  # at most two of 10,000 test points
