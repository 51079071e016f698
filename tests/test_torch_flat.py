"""Port vs reference: flat plane, data, model, registry and config.

Same inputs (numpy, from a seed) into both packages; tolerances as stated in
tests/_torch_parity.py.
"""
from dataclasses import fields

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import (
    DIMS, assert_close, jax_tree, np_params, port_cfg, ref_cfg,
)
from repro.configs import fedcm_paper as ref_paper
from repro.configs.base import FedConfig as RefFedConfig
from repro.core.engine import cohort_capacity as ref_cohort_capacity
from repro.core.engine import local_learning_rate as ref_local_learning_rate
from repro.core.flat import FlatSpec as RefFlatSpec
from repro.core.registry import _dir_coef as ref_dir_coef
from repro.core.registry import _fold_coef as ref_fold_coef
from repro.core.registry import get_algorithm as ref_get_algorithm
from repro.data.dirichlet import dirichlet_partition as ref_dirichlet_partition
from repro.data.pipeline import FederatedData as RefFederatedData
from repro.data.synthetic import make_synthetic_classification as ref_make_synthetic
from repro.models.small import classification_loss as ref_classification_loss
from repro.models.small import mlp_classifier as ref_mlp_classifier
from repro_torch.configs import fedcm_paper
from repro_torch.configs.base import FedConfig
from repro_torch.core.convert import (
    params_from_numpy, params_to_numpy, state_from_numpy, state_to_numpy, to_numpy,
)
from repro_torch.core.engine import (
    cohort_capacity, local_learning_rate, make_eval_fn, resolve_device, sample_cohort_ex,
)
from repro_torch.core.flat import FlatSpec
from repro_torch.core.registry import _dir_coef, _fold_coef, get_algorithm, list_algorithms
from repro_torch.data import FederatedData, dirichlet_partition, gather_round_batches
from repro_torch.data import make_synthetic_classification
from repro_torch.models.small import classification_loss, mlp_classifier

torch.set_num_threads(1)


# ---------------------------------------------------------------- flat plane
@pytest.mark.parametrize("dims", [DIMS, (32, 128, 128, 10)])
def test_flatspec_leaf_order_and_ravel_bytes_match_reference(dims):
    params = np_params(dims=dims)
    ref_spec = RefFlatSpec.from_tree(jax_tree(params))
    tree = params_from_numpy(params)
    spec = FlatSpec.from_tree(tree)
    assert [l.path for l in spec.leaves] == [l.path for l in ref_spec.leaves]
    assert [l.offset for l in spec.leaves] == [l.offset for l in ref_spec.leaves]
    assert spec.size == ref_spec.size and spec.nbytes == ref_spec.nbytes
    ref_plane = np.asarray(ref_spec.ravel(jax_tree(params)))
    assert spec.ravel(tree).numpy().tobytes() == ref_plane.tobytes()


def test_main_width_plane_layout():
    """The CLI model's plane: P = 22,026 in the order b, w per layer."""
    spec = FlatSpec.from_tree(params_from_numpy(np_params(dims=(32, 128, 128, 10))))
    assert spec.size == 22026
    assert [(l.path, l.shape) for l in spec.leaves] == [
        ("[0]['b']", (128,)), ("[0]['w']", (32, 128)), ("[1]['b']", (128,)),
        ("[1]['w']", (128, 128)), ("[2]['b']", (10,)), ("[2]['w']", (128, 10))]


def test_unravel_of_a_cohort_plane_gives_views_that_carry_grad():
    spec = FlatSpec.from_tree(params_from_numpy(np_params()))
    plane = torch.randn(3, spec.size, requires_grad=True)
    tree = spec.unravel(plane)
    assert tree[0]["w"].shape == (3, DIMS[0], DIMS[1])
    off = spec.leaves[1].offset  # [0]['w'] follows [0]['b']
    assert tree[0]["w"].data_ptr() == plane.data_ptr() + off * 4  # a view, no copy
    sum(l.sum() for layer in tree for l in layer.values()).backward()
    assert torch.equal(plane.grad, torch.ones_like(plane))
    back = spec.ravel(spec.unravel(plane.detach()), batch_dims=1)
    assert torch.equal(back, plane.detach())


def test_unravel_rejects_wrong_size_and_ravel_wrong_structure():
    spec = FlatSpec.from_tree(params_from_numpy(np_params()))
    with pytest.raises(ValueError):
        spec.unravel(torch.zeros(spec.size + 1))
    with pytest.raises(ValueError):
        spec.ravel(params_from_numpy(np_params())[:2])


# ---------------------------------------------------------------- data
@pytest.mark.parametrize("alpha", [0.1, 0.6, float("inf")])
def test_dirichlet_partition_matches_reference(alpha):
    y = np.random.default_rng(0).integers(0, 10, size=2000).astype(np.int32)
    ref = ref_dirichlet_partition(y, 20, alpha, seed=5)
    got = dirichlet_partition(y, 20, alpha, seed=5)
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def test_synthetic_data_matches_reference():
    for a, b in zip(make_synthetic_classification(n_train=500, n_test=100, seed=3),
                    ref_make_synthetic(n_train=500, n_test=100, seed=3)):
        np.testing.assert_array_equal(a, b)


def test_federated_data_matches_reference():
    x, y, _, _ = make_synthetic_classification(n_train=1000, n_test=10, seed=1)
    ref = RefFederatedData(x, y, 10, dirichlet_alpha=0.3, seed=2)
    got = FederatedData(x, y, 10, dirichlet_alpha=0.3, seed=2, device="cpu")
    assert got.n_per_client == ref.n_per_client
    np.testing.assert_array_equal(got.client_x.numpy(), np.asarray(ref.client_x))
    np.testing.assert_array_equal(got.client_y.numpy(), np.asarray(ref.client_y))


def test_gather_round_batches_with_injected_indices():
    rng = np.random.default_rng(0)
    cx = rng.normal(size=(6, 9, 4)).astype(np.float32)
    cy = rng.integers(0, 3, size=(6, 9)).astype(np.int32)
    ids = np.array([4, 0, 2])
    idx = rng.integers(0, 9, size=(3, 2, 5))
    got = gather_round_batches(torch.tensor(cx), torch.tensor(cy), None,
                               torch.tensor(ids), 2, 5, idx=torch.tensor(idx))
    np.testing.assert_array_equal(got["x"].numpy(), cx[ids[:, None, None], idx])
    np.testing.assert_array_equal(got["y"].numpy(), cy[ids[:, None, None], idx])


def test_gather_round_batches_draws_in_range_from_generator():
    cx, cy = torch.randn(6, 9, 4), torch.zeros(6, 9, dtype=torch.int32)
    a = gather_round_batches(cx, cy, torch.Generator().manual_seed(1), torch.arange(3), 2, 5)
    b = gather_round_batches(cx, cy, torch.Generator().manual_seed(1), torch.arange(3), 2, 5)
    assert a["x"].shape == (3, 2, 5, 4) and a["y"].shape == (3, 2, 5)
    assert torch.equal(a["x"], b["x"])


# ---------------------------------------------------------------- model
def _cohort_params(C, seed=0):
    rng = np.random.default_rng(seed)
    spec = RefFlatSpec.from_tree(jax_tree(np_params()))
    return (0.3 * rng.normal(size=(C, spec.size))).astype(np.float32), spec


def test_mlp_cohort_loss_and_gradient_plane_match_jax():
    """Per-client loss and the (C, P) gradient plane from ONE backward equal
    ``jax.vmap(jax.value_and_grad)`` of the reference's flat loss."""
    C, Bn = 4, 6
    planes, ref_spec = _cohort_params(C)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(C, Bn, DIMS[0])).astype(np.float32)
    y = rng.integers(0, DIMS[-1], size=(C, Bn)).astype(np.int32)
    ref_loss = ref_classification_loss(ref_mlp_classifier(DIMS).apply)

    def flat_loss(flat, xb, yb):
        return ref_loss(ref_spec.unravel(flat), {"x": xb, "y": yb})

    el, eg = jax.jit(jax.vmap(jax.value_and_grad(flat_loss)))(
        jnp.asarray(planes), jnp.asarray(x), jnp.asarray(y))
    spec = FlatSpec.from_tree(params_from_numpy(np_params()))
    loss_fn = classification_loss(mlp_classifier(DIMS).apply)
    plane = torch.tensor(planes, requires_grad=True)
    losses = loss_fn(spec.unravel(plane), {"x": torch.tensor(x), "y": torch.tensor(y)})
    (g,) = torch.autograd.grad(losses.sum(), plane)
    assert losses.shape == (C,)
    assert_close(losses.detach().numpy(), np.asarray(el), what="loss")
    assert_close(g.numpy(), np.asarray(eg), what="grad")


def test_mlp_unbatched_apply_matches_reference():
    params = np_params()
    x = np.random.default_rng(2).normal(size=(5, DIMS[0])).astype(np.float32)
    expected = ref_mlp_classifier(DIMS).apply(jax_tree(params), jnp.asarray(x))
    got = mlp_classifier(DIMS).apply(params_from_numpy(params), torch.tensor(x))
    assert_close(got.numpy(), np.asarray(expected))


def test_mlp_init_layout_and_scale():
    params = mlp_classifier((32, 128, 10)).init(torch.Generator().manual_seed(0))
    assert [tuple(l["w"].shape) for l in params] == [(32, 128), (128, 10)]
    assert all(torch.count_nonzero(l["b"]) == 0 for l in params)
    assert abs(float(params[0]["w"].std()) - 32 ** -0.5) < 0.02


def test_make_eval_fn_counts_hits_exactly():
    params = params_from_numpy(np_params())
    x = torch.randn(2500, DIMS[0])
    logits = mlp_classifier(DIMS).apply(params, x)
    y = logits.argmax(-1)
    y[:500] = (y[:500] + 1) % DIMS[-1]
    acc = make_eval_fn(mlp_classifier(DIMS).apply, batch_size=1000)(params, x, y)
    assert acc == pytest.approx(0.8, abs=1e-7)


# ---------------------------------------------------------------- registry / config
def test_fedconfig_copy_has_reference_defaults():
    ref_defaults = {f.name: f.default for f in fields(RefFedConfig)}
    for f in fields(FedConfig):
        assert f.name in ref_defaults, f.name
        assert f.default == ref_defaults[f.name], f.name
    assert FedConfig().eta_l_decay == 0.998 and FedConfig().weight_decay == 1e-3


def test_paper_settings_match_reference():
    for name in ("SETTING_I", "SETTING_II", "SCALED_I", "SCALED_II"):
        ref = getattr(ref_paper, name)
        got = getattr(fedcm_paper, name)
        for f in fields(FedConfig):
            assert getattr(got, f.name) == getattr(ref, f.name), (name, f.name)
    assert fedcm_paper.DIRICHLET_ALPHA == ref_paper.DIRICHLET_ALPHA


@pytest.mark.parametrize("algo", ["fedcm", "fedavg"])
@pytest.mark.parametrize("alpha", [0.1, 0.5, 1.0])
def test_registry_coefficients_match_reference(algo, alpha):
    cfg = ref_cfg(algo=algo, alpha=alpha, eta_g=0.7)
    pcfg = port_cfg(cfg)
    ref, got = ref_get_algorithm(algo), get_algorithm(algo)
    r_row, p_row = ref.direction_row, got.direction_row
    assert _dir_coef(p_row.c_g, pcfg) == ref_dir_coef(r_row.c_g, cfg)
    assert _dir_coef(p_row.c_x, pcfg) == ref_dir_coef(r_row.c_x, cfg)
    assert [(s, _dir_coef(c, pcfg)) for s, c in p_row.aux] == \
        [(s, ref_dir_coef(c, cfg)) for s, c in r_row.aux]
    assert len(got.fold) == len(ref.fold)
    for pp, rp in zip(got.fold, ref.fold):
        assert pp.plane == rp.plane
        for k in ("c_mm", "c_md", "c_xd"):
            a = _fold_coef(getattr(pp, k), pcfg, torch.tensor(0.05), torch.tensor(3.0))
            b = ref_fold_coef(getattr(rp, k), cfg, jnp.float32(0.05), jnp.float32(3.0))
            assert float(a) == pytest.approx(float(b), rel=1e-7), k
    assert got.needs_momentum_broadcast == ref.needs_momentum_broadcast
    assert got.momentum_store == ref.momentum_store
    assert ref.wire_uplink_planes == ("delta",)  # the port's payload: one delta plane up


def test_registry_lists_the_ported_specs():
    assert list_algorithms() == ("fedacg", "fedadagrad", "fedadam", "fedavg", "fedavgm",
                                 "fedcm", "feddyn", "fedprox", "fedyogi", "mimelite",
                                 "scaffold")
    with pytest.raises(KeyError):
        get_algorithm("fednova")


@pytest.mark.parametrize("participation, n, s", [
    ("fixed", 100, 10), ("bernoulli", 100, 10), ("bernoulli", 6, 3),
    ("bernoulli", 500, 10), ("fixed", 6, 3)])
def test_cohort_capacity_matches_reference(participation, n, s):
    cfg = RefFedConfig(participation=participation, num_clients=n, cohort_size=s)
    assert cohort_capacity(port_cfg(cfg)) == ref_cohort_capacity(cfg)


def test_local_learning_rate_matches_reference():
    cfg = RefFedConfig()
    for t in (0, 1, 7, 300, 3999):
        got = local_learning_rate(port_cfg(cfg), torch.tensor(t, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert float(got) == pytest.approx(float(ref_local_learning_rate(cfg, jnp.int32(t))),
                                           rel=2e-7)


@pytest.mark.parametrize("participation", ["fixed", "bernoulli"])
def test_sample_cohort_structure_and_rate(participation):
    cfg = FedConfig(num_clients=100, cohort_size=10, participation=participation)
    gen = torch.Generator().manual_seed(0)
    cap = cohort_capacity(cfg)
    actives = []
    for _ in range(400):
        ids, mask, clipped = sample_cohort_ex(gen, cfg, "cpu")
        assert ids.shape == mask.shape == (cap,)
        assert len(set(ids.tolist())) == cap and int(ids.max()) < 100
        k = int(mask.sum())
        assert torch.equal(mask, torch.arange(cap) < k)  # active rows first
        assert int(clipped) == 0
        actives.append(k)
    if participation == "fixed":
        assert set(actives) == {10}
    else:  # Binomial(100, 0.1): mean 10, sd 3 → sample mean within ~0.5
        assert 1 <= min(actives) and max(actives) <= cap
        assert abs(np.mean(actives) - 10.0) < 0.6


def test_convert_round_trips_and_stores_momentum_dtype():
    params = np_params()
    mom = [{k: np.full(v.shape, 0.5, np.float32) for k, v in l.items()} for l in params]
    cfg = FedConfig(momentum_dtype="bfloat16")
    state, spec = state_from_numpy(params, cfg, momentum=mom, round=4)
    assert state.server.momentum.dtype == torch.bfloat16
    out = state_to_numpy(state)
    assert out["round"] == 4 and out["momentum"].dtype == np.float32
    np.testing.assert_array_equal(out["params"], np.asarray(
        RefFlatSpec.from_tree(jax_tree(params)).ravel(jax_tree(params))))
    back = params_to_numpy(spec.unravel(state.params))
    for a, b in zip(back, params):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    fedavg_state, _ = state_from_numpy(params, FedConfig(algo="fedavg", momentum_dtype="bfloat16"))
    assert fedavg_state.server.momentum.dtype == torch.float32  # fedavg stores f32


def test_to_numpy_widens_bf16_exactly():
    t = torch.tensor([1.5, -2.25]).to(torch.bfloat16)
    assert to_numpy(t).dtype == np.float32
    np.testing.assert_array_equal(to_numpy(t), [1.5, -2.25])


def test_resolve_device_refuses_missing_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
