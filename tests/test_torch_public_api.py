"""The port's public surface against the reference's, and its examples.

* ``repro_torch.core`` exports the reference's ``repro.core.__all__`` but
  the one listed in its docstring (``NOT_PORTED``: ``FlatMaster``, which
  has no meaning on the port's f32 planes);
  ``repro_torch.models`` and ``repro_torch.data`` export the reference's;
* ``FlatSpec.view_leaf`` is the reference's view of a plane's leaf;
  ``masked_mean`` its ``_masked_pmean``; ``sample_cohort`` drops the clip
  count of ``sample_cohort_ex``;
* ``label_distribution`` / ``heterogeneity_score`` are the reference's bit
  for bit, and the score is monotone in the Dirichlet α (the reference's
  tests/test_data.py case);
* ``fed_direction``'s CPU route at FedCM's coefficients ``(η_l, α, 0,
  1−α)`` meets the blend oracle ``fedcm_step_ref`` at the reference
  test's cases and tolerances (tests/test_kernels.py: rtol / atol 3e-5 in
  f32, 2e-2 in bf16, 1e-6 at the hyper-parameter edges, bitwise for bf16
  x with f32 g and Δ), and the oracle is the reference's bit for bit;
* ``spawn_cohort`` has no default device;
* the four ``examples/torch`` scripts run with ``--device cpu`` at CI
  sizes and exit 0 (``lm_pretrain`` only if its loss fell).
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import RTOL, ATOL, assert_close, np_params, ref_cfg, ref_engine, small_cfg
import repro.core as ref_core
import repro.data as ref_data
import repro.models as ref_models
from repro.core.flat import FlatSpec as RefFlatSpec
from repro.data.dirichlet import dirichlet_partition as ref_dirichlet_partition
from repro.data.dirichlet import heterogeneity_score as ref_heterogeneity_score
from repro.data.dirichlet import label_distribution as ref_label_distribution
from repro.kernels.fedcm_update.ref import fedcm_step_ref as ref_fedcm_step_ref
import repro_torch.core as core
import repro_torch.data as data
import repro_torch.models as models
from repro_torch.core.engine import sample_cohort, sample_cohort_ex
from repro_torch.core.flat import FlatSpec, masked_mean
from repro_torch.data.dirichlet import dirichlet_partition, heterogeneity_score, label_distribution
from repro_torch.kernels.fed_direction.ops import fed_direction
from repro_torch.kernels.fedcm_update import fedcm_step_ref
from repro_torch.launch.mesh import spawn_cohort
from repro_torch.core.convert import params_from_numpy

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
RNG = np.random.default_rng(0)


# ---------------------------------------------------------------- exports
def test_core_exports_the_references_names_but_the_listed_ones():
    ref = set(ref_core.__all__)
    assert set(core.NOT_PORTED) <= ref
    assert set(core.__all__) == ref - set(core.NOT_PORTED)
    for name in core.__all__:
        assert getattr(core, name) is not None, name
    for name in core.NOT_PORTED:
        assert name in core.__doc__ and not hasattr(core, name), name
    assert "A.16 (d)" in core.__doc__  # the tree path names its ROADMAP item


def test_models_and_data_export_the_references_names():
    assert models.__all__ == ref_models.__all__ == ["build_model", "Model"]
    for name in ref_data.__all__:
        assert hasattr(data, name), name


def test_core_registry_names_are_the_registry_modules():
    from repro_torch.core import registry

    assert core.register_algorithm is registry.register_algorithm
    assert core.ALGORITHMS["fedcm"] is registry.get_algorithm("fedcm")


# ---------------------------------------------------------------- flat plane pieces
def test_view_leaf_is_the_references():
    params = np_params()
    spec = FlatSpec.from_tree(params_from_numpy(params))
    ref_spec = RefFlatSpec.from_tree(jax.tree_util.tree_map(jnp.asarray, params))
    plane = RNG.normal(size=(3, spec.size)).astype(np.float32)
    for i, leaf in enumerate(spec.leaves):
        for key in (i, leaf.path):
            got = spec.view_leaf(torch.tensor(plane), key)
            want = ref_spec.view_leaf(jnp.asarray(plane), key)
            assert got.shape == (3, *leaf.shape)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    one = spec.view_leaf(torch.tensor(plane[0]), 1)
    assert one.shape == spec.leaves[1].shape and one.data_ptr() != 0
    assert spec.view_leaf(torch.tensor(plane[0]), 0, torch.bfloat16).dtype == torch.bfloat16
    with pytest.raises(KeyError, match="paths") as e:
        spec.view_leaf(torch.tensor(plane), "[9]['w']")
    assert all(l.path in e.value.args[0] for l in spec.leaves)


def test_view_leaf_of_a_plane_is_a_view():
    spec = FlatSpec.from_tree(params_from_numpy(np_params()))
    plane = torch.zeros(spec.size)
    spec.view_leaf(plane, "[1]['b']").fill_(2.0)
    leaf = spec.leaves[[l.path for l in spec.leaves].index("[1]['b']")]
    assert plane[leaf.offset:leaf.offset + leaf.size].eq(2.0).all() and plane.sum() == 2 * leaf.size


@pytest.mark.parametrize("agg", ["float32", "bfloat16"])
def test_masked_mean_is_the_references_masked_pmean(agg):
    plane = RNG.normal(size=(5, 300)).astype(np.float32)
    w = np.array([1, 0, 1, 1, 0], np.float32)
    eng, _ = ref_engine(ref_cfg(use_fused_kernel=True, aggregate_dtype=agg))
    want = eng._masked_pmean(jnp.asarray(plane), jnp.asarray(w), jnp.float32(3.0))
    got = masked_mean(torch.tensor(plane), torch.tensor(w), torch.tensor(3.0),
                      getattr(torch, agg))
    tol = dict(rtol=RTOL, atol=ATOL) if agg == "float32" else dict(rtol=2.0 ** -7, atol=1e-6)
    assert_close(got, want, what=agg, **tol)


def test_sample_cohort_drops_the_clip_count():
    cfg = small_cfg(participation="bernoulli")
    ids, mask = sample_cohort(torch.Generator().manual_seed(3), cfg, "cpu")
    ids_ex, mask_ex, _ = sample_cohort_ex(torch.Generator().manual_seed(3), cfg, "cpu")
    assert torch.equal(ids, ids_ex) and torch.equal(mask, mask_ex)


# ---------------------------------------------------------------- dirichlet statistics
@pytest.mark.parametrize("alpha", [0.05, 0.6, float("inf")])
def test_label_statistics_are_the_references_bitwise(alpha):
    labels = np.random.default_rng(1).integers(0, 10, size=3000)
    parts = dirichlet_partition(labels, 20, alpha, seed=2)
    ref_parts = ref_dirichlet_partition(labels, 20, alpha, seed=2)
    for a, b in zip(parts, ref_parts):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(label_distribution(labels, parts, 10),
                                  ref_label_distribution(labels, ref_parts, 10))
    assert heterogeneity_score(labels, parts, 10) == ref_heterogeneity_score(labels, ref_parts,
                                                                             10)


def test_heterogeneity_monotone_in_alpha():
    """Smaller Dirichlet α ⇒ more heterogeneity (paper §C.1)."""
    labels = np.random.default_rng(0).integers(0, 10, size=20000)
    scores = [heterogeneity_score(labels, dirichlet_partition(labels, 50, a, seed=1), 10)
              for a in (0.05, 0.6, 10.0, float("inf"))]
    assert scores[0] > scores[1] > scores[2] > scores[3]
    assert scores[3] < 0.1


def test_label_distribution_rows_and_an_empty_client():
    labels = np.array([0, 1, 1, 2])
    dist = label_distribution(labels, [np.array([0, 1]), np.array([], np.int64)], 3)
    np.testing.assert_array_equal(dist, [[0.5, 0.5, 0.0], [0.0, 0.0, 0.0]])


# ---------------------------------------------------------------- the FedCM blend oracle
def _blend(alpha, eta):
    return torch.tensor([eta, alpha, 0.0, 1.0 - alpha], dtype=torch.float32)


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16 else dict(rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("n", [5, 1023, 64 * 1024 + 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fed_direction_reproduces_the_fedcm_blend(n, dtype):
    x, g, d = (torch.tensor(RNG.normal(size=n), dtype=torch.float32).to(dtype) for _ in range(3))
    out = fed_direction(x, g, [d], _blend(0.1, 0.05))
    ref = fedcm_step_ref(x, g, d, 0.1, 0.05)
    assert out.dtype == x.dtype
    np.testing.assert_allclose(out.float().numpy(), ref.float().numpy(), **_tol(dtype))


@pytest.mark.parametrize("alpha,eta", [(0.0, 0.1), (1.0, 0.1), (0.1, 0.0), (0.37, 1.3)])
def test_fedcm_blend_hyperparam_edges(alpha, eta):
    x, g, d = (torch.tensor(RNG.normal(size=333), dtype=torch.float32) for _ in range(3))
    np.testing.assert_allclose(fed_direction(x, g, [d], _blend(alpha, eta)).numpy(),
                               fedcm_step_ref(x, g, d, alpha, eta).numpy(), rtol=1e-6, atol=1e-6)


def test_fedcm_blend_bf16_params_keep_f32_momentum_precision():
    """bf16 x with f32 g and Δ: the blend runs in f32 and rounds once, so
    the local step equals the oracle bit for bit."""
    x = torch.tensor(RNG.normal(size=4097), dtype=torch.float32).to(torch.bfloat16)
    g = torch.tensor(RNG.normal(size=4097), dtype=torch.float32)
    d = torch.tensor(RNG.normal(size=4097) * 1e-3, dtype=torch.float32)
    out = fed_direction(x, g, [d], _blend(0.1, 0.05))
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, fedcm_step_ref(x, g, d, 0.1, 0.05))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fedcm_step_ref_is_the_references_bitwise(dtype):
    x, g, d = (RNG.normal(size=777).astype(np.float32) for _ in range(3))
    want = ref_fedcm_step_ref(jnp.asarray(x, dtype), jnp.asarray(g), jnp.asarray(d), 0.1, 0.05)
    got = fedcm_step_ref(torch.tensor(x).to(getattr(torch, dtype)), torch.tensor(g),
                         torch.tensor(d), 0.1, 0.05)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


# ---------------------------------------------------------------- spawn_cohort
def test_spawn_cohort_has_no_default_device():
    with pytest.raises(TypeError, match="device"):
        spawn_cohort(print, 1)


# ---------------------------------------------------------------- the examples
EXAMPLES = {
    "quickstart": [],
    "fed_comparison": ["--rounds", "3"],
    "serve_model-mamba2": ["--arch", "mamba2-1.3b"],
    "serve_model-gemma3": ["--arch", "gemma3-12b", "--gen", "48"],
    "lm_pretrain": ["--tiny", "--steps", "30", "--batch", "8", "--seq", "64"],
}


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_example_runs_on_the_cpu(name):
    script = ROOT / "examples" / "torch" / f"{name.split('-')[0]}.py"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "2"}
    out = subprocess.run([sys.executable, str(script), *EXAMPLES[name], "--device", "cpu"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    assert out.stdout.strip()
    if name == "lm_pretrain":
        assert "→" in out.stdout.splitlines()[-1]


def test_examples_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device would run")
    script = ROOT / "examples" / "torch" / "quickstart.py"
    out = subprocess.run([sys.executable, str(script)], cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "CUDA is not available" in out.stderr
