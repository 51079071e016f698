"""The GroupNorm CNN (``models/small.py`` ``cnn_classifier``) and its data
(``data/synthetic.py`` ``make_synthetic_images``) against the reference's.

The same numpy params (HWIO convolutions, the reference's layout) go into
both packages.  Logits, unbatched and cohort-batched, and each client's
gradient of a cohort-batched loss (the port's one backward against the
reference's ``vmap(grad)``) are held at ``CNN_RTOL`` 1e-5 / ``CNN_ATOL``
1e-6: the convolutions and the GroupNorm sum in another order in PyTorch
than in XLA.  That holds at hw 8, where SAME padding at stride 2 puts its
one element after each row, and at hw 7, where it puts one on each side.
Three FedCM rounds over the CNN on the reference's draws meet its
``round_step`` on both its routes at ``RTOL`` / ``ROUND_ATOL``
(tests/_torch_parity.py).  ``make_synthetic_images`` is the reference's
bit for bit.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import (
    ROUND_ATOL, assert_close, jax_tree, port_cfg, ref_cfg, ref_draws, ref_state_numpy,
    torch_batches,
)
from repro.core.engine import FederatedEngine as RefEngine
from repro.data.synthetic import make_synthetic_images as ref_make_synthetic_images
from repro.models.small import classification_loss as ref_classification_loss
from repro.models.small import cnn_classifier as ref_cnn_classifier
from repro_torch.core.convert import params_from_numpy, state_from_numpy, state_to_numpy
from repro_torch.core.engine import FederatedEngine
from repro_torch.core.flat import FlatSpec
from repro_torch.data.synthetic import make_synthetic_images
from repro_torch.models.small import classification_loss, cnn_classifier, same_pad

torch.set_num_threads(1)

CNN_RTOL, CNN_ATOL = 1e-5, 1e-6
CHANNELS, GROUPS = (8, 16), 4
C, B = 3, 4


def _np_params(hw, seed=0):
    """Numpy CNN params in the reference's layout, the FC sized to the last
    convolution's output (ceil(hw / 2) a layer)."""
    rng = np.random.default_rng(seed)
    params, c_in, side = {}, 3, hw
    for i, c_out in enumerate(CHANNELS):
        params[f"conv{i}"] = {
            "w": (rng.normal(size=(3, 3, c_in, c_out)) / np.sqrt(9 * c_in)).astype(np.float32),
            "gn_scale": (1 + 0.1 * rng.normal(size=c_out)).astype(np.float32),
            "gn_bias": (0.1 * rng.normal(size=c_out)).astype(np.float32)}
        c_in, side = c_out, -(-side // 2)
    params["fc"] = {"w": (rng.normal(size=(side * side * c_in, 10)) / 8).astype(np.float32),
                    "b": (0.1 * rng.normal(size=10)).astype(np.float32)}
    return params


def _stack(trees):
    return jax.tree_util.tree_map(lambda *a: np.stack(a), *trees)


def _models(hw):
    kw = dict(channels=CHANNELS, gn_groups=GROUPS, hw=hw)
    return ref_cnn_classifier(**kw), cnn_classifier(**kw)


def _images(shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("size,total,before", [(8, 1, 0), (4, 1, 0), (7, 2, 1), (2, 1, 0),
                                               (1, 2, 1)])
def test_same_padding_is_xlas(size, total, before):
    assert same_pad(size, 3, 2) == (before, total - before)


@pytest.mark.parametrize("hw", [8, 7])
def test_logits_match_the_reference(hw):
    ref, port = _models(hw)
    p = _np_params(hw)
    x = _images((5, hw, hw, 3))
    want = ref.apply(jax_tree(p), jnp.asarray(x))
    got = port.apply(params_from_numpy(p), torch.tensor(x))
    assert got.shape == (5, 10)
    assert_close(got, want, rtol=CNN_RTOL, atol=CNN_ATOL, what="logits")


@pytest.mark.parametrize("hw", [8, 7])
def test_cohort_batched_logits_are_each_clients(hw):
    """Cohort-batched params (a leading C on every leaf) and x (C, B, H, W,
    3): row c is the reference's apply of client c's params on its batch."""
    ref, port = _models(hw)
    ps = [_np_params(hw, seed) for seed in range(C)]
    x = _images((C, B, hw, hw, 3))
    got = port.apply(params_from_numpy(_stack(ps)), torch.tensor(x))
    assert got.shape == (C, B, 10)
    for c in range(C):
        want = ref.apply(jax_tree(ps[c]), jnp.asarray(x[c]))
        assert_close(got[c], want, rtol=CNN_RTOL, atol=CNN_ATOL, what=f"client {c}")


@pytest.mark.parametrize("hw", [8, 7])
def test_per_client_gradients_match_vmap_grad(hw):
    """One backward through the cohort-batched loss's sum gives each
    client's gradient: the reference's ``vmap(grad(loss))``, leaf by leaf."""
    ref, port = _models(hw)
    stacked = _stack([_np_params(hw, seed) for seed in range(C)])
    x = _images((C, B, hw, hw, 3))
    y = np.random.default_rng(2).integers(0, 10, size=(C, B)).astype(np.int32)
    want = jax.vmap(jax.grad(ref_classification_loss(ref.apply)))(
        jax_tree(stacked), {"x": jnp.asarray(x), "y": jnp.asarray(y)})
    params = params_from_numpy(stacked)
    leaves = [params[k][n] for k in sorted(params) for n in sorted(params[k])]
    for leaf in leaves:
        leaf.requires_grad_(True)
    losses = classification_loss(port.apply)(params, {"x": torch.tensor(x),
                                                      "y": torch.tensor(y).long()})
    assert losses.shape == (C,)
    grads = torch.autograd.grad(losses.sum(), leaves)
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0], grads):
        assert_close(g, w, rtol=CNN_RTOL, atol=CNN_ATOL, what=jax.tree_util.keystr(path))


def test_init_layout_is_the_references():
    """The default CNN (channels 32, 64; 8 GroupNorm groups; 8 × 8 × 3
    input): the reference's leaves, shapes and P = 22,058 (conv0 864 + 64,
    conv1 18,432 + 128, FC 2,560 + 10)."""
    ref = ref_cnn_classifier().init(jax.random.PRNGKey(0))
    port = cnn_classifier().init(torch.Generator().manual_seed(0))
    spec = FlatSpec.from_tree(port)
    assert spec.size == 22058
    want = [(jax.tree_util.keystr(p), tuple(l.shape))
            for p, l in jax.tree_util.tree_flatten_with_path(ref)[0]]
    assert [(l.path, l.shape) for l in spec.leaves] == want
    assert torch.equal(port["conv0"]["gn_scale"], torch.ones(32))
    assert torch.equal(port["fc"]["b"], torch.zeros(10))


def test_odd_hw_sizes_the_fc_by_the_convolutions():
    """At hw 7 the convolutions give 4 × 4, then 2 × 2: the port's FC takes
    2·2·16 inputs.  The reference's init takes 7 // 4 = 1 a side and its
    apply then fails (ROADMAP queue C)."""
    ref, port = _models(7)
    assert port.init(torch.Generator().manual_seed(0))["fc"]["w"].shape == (64, 10)
    rp = ref.init(jax.random.PRNGKey(0))
    assert rp["fc"]["w"].shape == (16, 10)
    with pytest.raises(TypeError):
        ref.apply(rp, jnp.zeros((1, 7, 7, 3)))


@pytest.mark.parametrize("kw", [dict(n_train=64, n_test=16), dict(n_classes=4, hw=7, channels=2,
                                                                 n_train=30, n_test=5, seed=3)])
def test_synthetic_images_are_the_references_bitwise(kw):
    got, want = make_synthetic_images(**kw), ref_make_synthetic_images(**kw)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- FedCM over the CNN
N_CLIENTS, COHORT, K = 6, 3, 2


def _client_images():
    x, y, _, _ = make_synthetic_images(n_train=N_CLIENTS * 10, n_test=1, seed=4)
    return x.reshape(N_CLIENTS, 10, 8, 8, 3), y.reshape(N_CLIENTS, 10)


@pytest.mark.parametrize("route", ["kernel", "jnp"])
def test_fedcm_rounds_over_the_cnn_match_the_reference(route):
    """Three FedCM rounds (bernoulli) on the reference's draws from one
    state with a nonzero momentum: the loss per round and params and
    momentum after them."""
    ref_model, port_model = _models(8)
    cfg = ref_cfg("bernoulli", algo="fedcm", use_fused_kernel=(route == "kernel"))
    reng = RefEngine(cfg, ref_classification_loss(ref_model.apply), batch_size=B)
    params = _np_params(8)
    mom = jax.tree_util.tree_map(
        lambda a: (0.01 * np.random.default_rng(5).normal(size=a.shape)).astype(np.float32),
        params)
    rst = reng.init(jax_tree(params), jax.random.PRNGKey(0))
    rst = rst._replace(server=rst.server._replace(momentum=jax_tree(mom)))
    pcfg = port_cfg(cfg)
    pst, spec = state_from_numpy(params, pcfg, momentum=mom)
    peng = FederatedEngine(pcfg, classification_loss(port_model.apply), spec, batch_size=B,
                           device="cpu")
    cx, cy = _client_images()
    ref_loss, port_loss = [], []
    for t in range(3):
        batches, ids, mask = ref_draws(reng, cx, cy, jax.random.PRNGKey(40 + t), t)
        rst, rm = reng.round_step(rst, jax.tree_util.tree_map(jnp.asarray, batches),
                                  jnp.asarray(ids), jnp.asarray(mask))
        pst, pm = peng.round_step(pst, torch_batches(batches), torch.tensor(ids),
                                  torch.tensor(mask))
        ref_loss.append(float(rm.loss))
        port_loss.append(float(pm.loss))
    assert_close(port_loss, ref_loss, atol=ROUND_ATOL, what="loss per round")
    ref, got = ref_state_numpy(rst), state_to_numpy(pst)
    assert got["round"] == ref["round"] == 3
    for key in ("params", "momentum"):
        assert_close(got[key], ref[key], atol=ROUND_ATOL, what=key)
