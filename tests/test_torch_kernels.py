"""Port vs reference: the kernels of the round (local step, dense fold,
dequant fold), and their dispatch.

On the CPU each wrapper runs its plain PyTorch version (``ref.py``); these
tests hold that version to the reference's Pallas kernels run in interpret
mode (``repro.kernels.*.kernel`` with ``interpret=True``) on the same
numpy inputs.  The CUDA kernels themselves run only on a card, where
``chip_smoke.py`` holds them against the same plain versions.  The dispatch
tests check that a non-CPU request goes to the kernel or raises, and never
falls back to the plain version.

Tolerance: ``RTOL`` 2e-5 (the reference's own kernel sweeps) for f32; one
bf16 ulp for bf16 outputs (tests/_torch_parity.py).
"""
import ctypes

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import ATOL, BF16_RTOL, RTOL, assert_close, ref_cfg, port_cfg
from repro.kernels.fed_direction.kernel import fed_direction_flat as ref_fed_direction
from repro.kernels.fed_direction.ops import flat_direction_step as ref_flat_direction_step
from repro.kernels.server_update.kernel import server_update_flat as ref_server_update
from repro.kernels.server_update.ops import fused_fold as ref_fused_fold
from repro.core.compress import QPlane as RefQPlane
from repro.core.registry import get_algorithm as ref_get_algorithm
from repro_torch.core.compress import quantize_int8, sparsify_topk
from repro_torch.core.registry import get_algorithm
from repro_torch.kernels import build, coef_vector
from repro_torch.kernels.fed_direction import kernel as fd_kernel
from repro_torch.kernels.fed_direction.ops import fed_direction, flat_direction_step
from repro_torch.kernels.server_update import kernel as su_kernel
from repro_torch.kernels.server_update.ops import (
    dequant_server_step, fused_fold, fused_server_step,
)
from repro_torch.kernels.server_update.ref import server_update_ref
from repro_torch.core.convert import to_numpy

torch.set_num_threads(1)

BF16 = jnp.bfloat16
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (BF16, torch.bfloat16)}


def _np(rng, shape, scale=1.0):
    return (scale * rng.normal(size=shape)).astype(np.float32)


def _pair(a, dtype):
    """The same numpy array as a reference array and a port tensor of dtype."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(a, jd), torch.tensor(a).to(td)


def _tol(dtype):
    return dict(rtol=BF16_RTOL, atol=ATOL) if dtype == "bfloat16" else dict(rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------- fed_direction
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_aux", [0, 1, 2, 3])
def test_fed_direction_plain_matches_reference_kernel(n_aux, dtype):
    rng = np.random.default_rng(10 + n_aux)
    P = 1000  # not a multiple of the TPU block or of 8: a ragged edge
    x, g = _np(rng, P), _np(rng, P)
    auxes = [_np(rng, P) for _ in range(n_aux)]
    coefs = np.array([0.1, 0.3, 0.02, 0.9, -0.4, 0.25][:3 + n_aux], np.float32)
    jx, tx = _pair(x, dtype)
    jg, tg = _pair(g, dtype)
    ja = [jnp.asarray(a) for a in auxes]
    expected = ref_fed_direction(jx, jg, tuple(ja), jnp.asarray(coefs), interpret=True)
    got = fed_direction(tx, tg, [torch.tensor(a) for a in auxes], torch.tensor(coefs))
    assert got.dtype == tx.dtype
    assert_close(to_numpy(got), np.asarray(expected, np.float32), **_tol(dtype))


@pytest.mark.parametrize("n_aux", [1, 2])
def test_fed_direction_cohort_plane_with_broadcast_aux(n_aux):
    """One launch over a (C, P) plane with a (P,) broadcast aux equals the
    reference's per-client launches."""
    rng = np.random.default_rng(1)
    C, P = 3, 257
    x, g, m = _np(rng, (C, P)), _np(rng, (C, P)), _np(rng, P)
    per_client = _np(rng, (C, P))
    coefs = np.array([0.1, 0.1, 0.0, 0.9, -0.5][:3 + n_aux], np.float32)
    taux = [torch.tensor(m), torch.tensor(per_client)][:n_aux]
    got = to_numpy(fed_direction(torch.tensor(x), torch.tensor(g), taux, torch.tensor(coefs)))
    for c in range(C):
        aux = [jnp.asarray(m), jnp.asarray(per_client[c])][:n_aux]
        expected = ref_fed_direction(jnp.asarray(x[c]), jnp.asarray(g[c]), tuple(aux),
                                     jnp.asarray(coefs), interpret=True)
        assert_close(got[c], np.asarray(expected))


OTHER_ALGOS = ("fedprox", "fedavgm", "fedacg", "fedadam", "fedadagrad", "fedyogi", "mimelite",
               "scaffold", "feddyn")


@pytest.mark.parametrize("algo, alpha", [("fedcm", 0.1), ("fedcm", 1.0), ("fedavg", 0.1)]
                         + [(a, 0.1) for a in OTHER_ALGOS])
def test_flat_direction_step_matches_reference_dispatch(algo, alpha):
    """The spec's direction row through the reference's Pallas kernel and
    the port's plain version: SCAFFOLD's client-state aux before the
    broadcast one, FedDyn's and FedProx's proximal c_x on a drifted x."""
    cfg = ref_cfg(algo=algo, alpha=alpha, feddyn_alpha=0.3, fedprox_mu=0.2)
    rng = np.random.default_rng(2)
    P = 300
    x, g, m = _np(rng, P), _np(rng, P), _np(rng, P)
    cst, x0 = _np(rng, P), _np(rng, P)
    expected = ref_flat_direction_step(ref_get_algorithm(algo), cfg, jnp.asarray(x), jnp.asarray(g),
                                       jnp.asarray(m), jnp.asarray(cst), jnp.asarray(x0),
                                       jnp.float32(0.05))
    got = flat_direction_step(get_algorithm(algo), port_cfg(cfg), torch.tensor(x),
                              torch.tensor(g), torch.tensor(m), torch.tensor(cst),
                              torch.tensor(x0), torch.tensor(0.05))
    assert_close(to_numpy(got), np.asarray(expected))


# ---------------------------------------------------------------- server_update
@pytest.mark.parametrize("m_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("write_x, write_m", [(True, True), (True, False),
                                              (False, True), (False, False)])
def test_server_update_plain_matches_reference_kernel(write_x, write_m, m_dtype):
    rng = np.random.default_rng(20)
    C, P = 5, 700
    deltas = _np(rng, (C, P), 1e-2)
    mask = np.array([1, 0, 1, 1, 0], np.float32)
    wn = mask / mask.sum()
    x, m = _np(rng, P), _np(rng, P)
    coefs = np.array([0.9, -0.5, 1.0, 0.8], np.float32)
    jm, tm = _pair(m, m_dtype)
    ex = ref_server_update(jnp.asarray(deltas), jnp.asarray(wn), jnp.asarray(x), jm,
                           jnp.asarray(coefs), interpret=True, write_x=write_x, write_m=write_m)
    got = server_update_ref(torch.tensor(deltas), torch.tensor(wn), torch.tensor(x), tm,
                            torch.tensor(coefs), write_x=write_x, write_m=write_m)
    for name, e, a in zip(("x", "m", "mean"), ex, got):
        assert (e is None) == (a is None), name
        if e is not None:
            tol = _tol(m_dtype) if name == "m" else {}
            assert_close(to_numpy(a), np.asarray(e, np.float32), what=name, **tol)
    if write_m:
        assert got[1].dtype == tm.dtype


def test_server_update_sum_is_ascending_and_deterministic():
    """The plain version sums the cohort row by row in ascending order — the
    kernel's order — and repeats bitwise."""
    rng = np.random.default_rng(3)
    d = torch.tensor(_np(rng, (7, 129)))
    wn = torch.full((7,), 1.0 / 7)
    z = torch.zeros(129)
    coefs = torch.tensor([0.0, 1.0, 1.0, 1.0])
    a = server_update_ref(d, wn, z, z, coefs)
    b = server_update_ref(d, wn, z, z, coefs)
    expect = torch.zeros(129)
    for c in range(7):
        expect = expect + d[c] * wn[c]
    assert torch.equal(a[2], expect)
    assert all(torch.equal(u, v) for u, v in zip(a, b))


@pytest.mark.parametrize("algo", ["fedcm", "fedavg", *OTHER_ALGOS])
@pytest.mark.parametrize("aggregate_dtype", ["float32", "bfloat16"])
def test_fused_fold_matches_reference(algo, aggregate_dtype):
    """Every fold row of the spec, one launch each, over the planes it
    names: SCAFFOLD's and MimeLite's second row writes the momentum only,
    the post-step specs' row writes no params."""
    cfg = ref_cfg(algo=algo, aggregate_dtype=aggregate_dtype)
    rng = np.random.default_rng(4)
    C, P = 4, 333
    deltas = _np(rng, (C, P), 1e-2)
    mask = np.array([1, 1, 0, 1], np.float32)
    n = mask.sum()
    x, m = _np(rng, P), _np(rng, P)
    planes = {"delta": deltas, "state_delta": _np(rng, (C, P), 1e-2),
              "extra": _np(rng, (C, P), 1e-1)}
    ex = ref_fused_fold(ref_get_algorithm(algo), cfg,
                        {k: jnp.asarray(v) for k, v in planes.items()},
                        jnp.asarray(mask / n), jnp.float32(n), jnp.asarray(x),
                        jnp.asarray(m), jnp.float32(0.07))
    got = fused_fold(get_algorithm(algo), port_cfg(cfg),
                     {k: torch.tensor(v) for k, v in planes.items()},
                     torch.tensor(mask / n), torch.tensor(n), torch.tensor(x),
                     torch.tensor(m), torch.tensor(0.07, dtype=torch.float32))
    for name, e, a in zip(("x", "m", "mean"), ex, got):
        assert_close(to_numpy(a), np.asarray(e, np.float32), what=name)


def test_fused_fold_refuses_compressed_plane():
    """The fold takes the compressed uplink it can stream — a QPlane (int8,
    or bf16 with unit scales) goes through the dequant fold and matches the
    reference's ``fused_fold`` on the same representation — and refuses
    the sparse top-k representation, which must be densified first."""
    cfg = ref_cfg()
    rng = np.random.default_rng(5)
    C, P = 4, 333
    plane = _np(rng, (C, P), 1e-2)
    u = np.asarray(jax.random.uniform(jax.random.PRNGKey(1), (C, P), jnp.float32))
    rep = quantize_int8(torch.tensor(plane), torch.tensor(u))
    mask = np.array([1, 1, 0, 1], np.float32)
    n = mask.sum()
    x, m = _np(rng, P), _np(rng, P)
    ex = ref_fused_fold(ref_get_algorithm("fedcm"), cfg,
                        {"delta": RefQPlane(q=jnp.asarray(rep.q.numpy()),
                                            scale=jnp.asarray(rep.scale.numpy()))},
                        jnp.asarray(mask / n), jnp.float32(n), jnp.asarray(x),
                        jnp.asarray(m), jnp.float32(0.07))
    got = fused_fold(get_algorithm("fedcm"), port_cfg(cfg), {"delta": rep},
                     torch.tensor(mask / n), torch.tensor(n), torch.tensor(x),
                     torch.tensor(m), torch.tensor(0.07, dtype=torch.float32))
    for name, e, a in zip(("x", "m", "mean"), ex, got):
        assert_close(to_numpy(a), np.asarray(e, np.float32), what=name)
    z = torch.zeros(8)
    sparse = sparsify_topk(torch.ones(2, 8), 2)
    with pytest.raises(TypeError, match="TopKPlane"):
        fused_fold(get_algorithm("fedcm"), port_cfg(cfg), {"delta": sparse},
                   torch.ones(2) / 2, torch.tensor(2.0), z, z, torch.tensor(0.1))


def test_coef_vector_keeps_device_tensors():
    eta = torch.tensor(0.05)
    v = coef_vector([eta, 0.1, -1.0 / (eta * 10), 1.0], eta.device)
    assert v.dtype == torch.float32 and v.shape == (4,)
    assert torch.equal(v, torch.tensor([0.05, 0.1, -2.0, 1.0]))


# ---------------------------------------------------------------- dispatch
def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_cpu_tensors_never_reach_the_loader(monkeypatch):
    def boom():
        raise AssertionError("the CPU route must not build or load a kernel")

    monkeypatch.setattr(fd_kernel.KERNEL, "load", boom)
    monkeypatch.setattr(su_kernel.KERNEL, "load", boom)
    monkeypatch.setattr(su_kernel.DEQUANT_KERNEL, "load", boom)
    x = torch.ones(4, 10)
    fed_direction(x, x, [torch.ones(10)], torch.tensor([0.1, 1.0, 0.0, 0.5]))
    fused_server_step(x, torch.ones(4) / 4, torch.ones(10), torch.ones(10), 0.0, -1.0, 1.0)
    dequant_server_step(torch.ones(4, 10, dtype=torch.int8), torch.ones(4), torch.ones(4) / 4,
                        torch.ones(10), torch.ones(10), 0.0, -1.0, 1.0)


def test_non_cpu_request_raises_when_the_loader_fails(monkeypatch):
    """A request on a non-CPU device goes to the kernel; when the kernel
    cannot be built or loaded the error propagates — no plain fallback."""
    def fail_load():
        raise RuntimeError("nvcc failed (simulated)")

    monkeypatch.setattr(fd_kernel.KERNEL, "load", fail_load)
    monkeypatch.setattr(su_kernel.KERNEL, "load", fail_load)
    monkeypatch.setattr(su_kernel.DEQUANT_KERNEL, "load", fail_load)
    x = _meta(4, 10)
    with pytest.raises(RuntimeError, match="simulated"):
        fed_direction(x, x, [_meta(10)], _meta(4))
    with pytest.raises(RuntimeError, match="simulated"):
        fused_server_step(x, _meta(4), _meta(10), _meta(10), 0.0, -1.0, 1.0)
    with pytest.raises(RuntimeError, match="simulated"):
        dequant_server_step(_meta(4, 10, dtype=torch.int8), _meta(4, 1), _meta(4), _meta(10),
                            _meta(10), 0.0, -1.0, 1.0)


def test_non_cuda_device_is_refused_after_loading(monkeypatch):
    """With a loadable kernel, operands that are not CUDA tensors are refused
    before any launch."""
    calls = []
    monkeypatch.setattr(fd_kernel.KERNEL, "load", lambda: (lambda *a: calls.append(a) or 0))
    monkeypatch.setattr(su_kernel.KERNEL, "load", lambda: (lambda *a: calls.append(a) or 0))
    monkeypatch.setattr(su_kernel.DEQUANT_KERNEL, "load",
                        lambda: (lambda *a: calls.append(a) or 0))
    x = _meta(4, 10)
    with pytest.raises(ValueError, match="CUDA"):
        fd_kernel.fed_direction_flat(x, x, [_meta(10)], _meta(4))
    with pytest.raises(ValueError, match="CUDA"):
        su_kernel.server_update_flat(x, _meta(4), _meta(10), _meta(10), _meta(4))
    with pytest.raises(ValueError, match="CUDA"):
        su_kernel.dequant_update_flat(_meta(4, 10, dtype=torch.int8), _meta(4), _meta(4),
                                      _meta(10), _meta(10), _meta(4))
    assert calls == []


@pytest.mark.parametrize("case", ["dtype", "shape", "aux_shape", "coefs", "too_many_aux",
                                  "noncontiguous"])
def test_fed_direction_wrapper_validates_before_loading(monkeypatch, case):
    def boom():
        raise AssertionError("validation must come before loading")

    monkeypatch.setattr(fd_kernel.KERNEL, "load", boom)
    x, g, aux, coefs = _meta(4, 10), _meta(4, 10), [_meta(10)], _meta(4)
    if case == "dtype":
        x = g = _meta(4, 10, dtype=torch.float16)
    elif case == "shape":
        g = _meta(4, 11)
    elif case == "aux_shape":
        aux = [_meta(9)]
    elif case == "coefs":
        coefs = _meta(5)
    elif case == "too_many_aux":
        aux, coefs = [_meta(10)] * 4, _meta(7)
    else:
        x = _meta(10, 4).t()
        g = _meta(4, 10)
    with pytest.raises(ValueError):
        fd_kernel.fed_direction_flat(x, g, aux, coefs)


@pytest.mark.parametrize("case", ["deltas_dim", "wn_shape", "m_dtype_mismatch", "x_dtype"])
def test_server_update_wrapper_validates_before_loading(monkeypatch, case):
    def boom():
        raise AssertionError("validation must come before loading")

    monkeypatch.setattr(su_kernel.KERNEL, "load", boom)
    d, wn, x, m, kw = _meta(4, 10), _meta(4), _meta(10), _meta(10), {}
    if case == "deltas_dim":
        d = _meta(40)
    elif case == "wn_shape":
        wn = _meta(5)
    elif case == "m_dtype_mismatch":
        kw = {"m_dtype": torch.bfloat16}
    else:
        x = _meta(10, dtype=torch.float64)
    with pytest.raises(ValueError):
        su_kernel.server_update_flat(d, wn, x, m, _meta(4), **kw)


@pytest.mark.parametrize("case", ["q_dtype", "q_dim", "scale_shape", "scale_dtype",
                                  "noncontiguous", "m_dtype_mismatch"])
def test_dequant_update_wrapper_validates_before_loading(monkeypatch, case):
    def boom():
        raise AssertionError("validation must come before loading")

    monkeypatch.setattr(su_kernel.DEQUANT_KERNEL, "load", boom)
    q, sc, wn, x, m, kw = _meta(4, 10, dtype=torch.int8), _meta(4, 1), _meta(4), _meta(10), \
        _meta(10), {}
    if case == "q_dtype":
        q = _meta(4, 10)
    elif case == "q_dim":
        q = _meta(40, dtype=torch.int8)
    elif case == "scale_shape":
        sc = _meta(5)
    elif case == "scale_dtype":
        sc = _meta(4, dtype=torch.bfloat16)
    elif case == "noncontiguous":
        q = _meta(10, 4, dtype=torch.int8).t()
    else:
        kw = {"m_dtype": torch.bfloat16}
    with pytest.raises(ValueError):
        su_kernel.dequant_update_flat(q, sc, wn, x, m, _meta(4), **kw)


def test_dequant_update_binds_its_own_entry_point_and_counter():
    """The dequant fold is a second entry point of the server_update source
    (one build), counted apart from the dense fold."""
    dq, su = su_kernel.DEQUANT_KERNEL, su_kernel.KERNEL
    assert dq is not su and dq.source == su.source == "server_update"
    assert (dq.name, dq.symbol) == ("dequant_update", "dequant_update_launch")
    assert len(dq.argtypes) == len(su.argtypes) + 1  # the scale pointer
    src = (build.CSRC / "server_update.cu").read_text()
    assert 'extern "C" int dequant_update_launch(' in src
    assert 'extern "C" int server_update_launch(' in src


def test_fold_bindings_take_the_launch_plan():
    """Both fold entry points take the plan (tile, rows, stages, grid,
    shared bytes) as five C ints between the write flags and the device."""
    for binding, n_ptr in ((su_kernel.KERNEL, 8), (su_kernel.DEQUANT_KERNEL, 9)):
        types = binding.argtypes
        assert types[:n_ptr] == [ctypes.c_void_p] * n_ptr
        assert types[n_ptr:n_ptr + 2] == [ctypes.c_int, ctypes.c_longlong]  # C, P
        assert types[n_ptr + 2:] == [ctypes.c_int] * 11 + [ctypes.c_void_p]
    plan = su_kernel.fold_plan(25, 22026, 4, 132, 232448)
    assert len(plan.args()) == 5 and all(isinstance(v, int) for v in plan.args())


@pytest.mark.parametrize("case", ["C", "P", "itemsize", "sm_count", "smem_limit"])
def test_fold_plan_refuses_a_request_it_cannot_plan(case):
    kw = dict(C=25, P=22026, itemsize=4, sm_count=132, smem_limit=232448)
    if case == "C":
        kw["C"] = 0
    elif case == "P":
        kw["P"] = -1
    elif case == "itemsize":
        kw["itemsize"] = 3
    elif case == "sm_count":
        kw["sm_count"] = 0
    else:
        kw["smem_limit"] = 1024  # no room for one row's slot
    with pytest.raises(ValueError):
        su_kernel.fold_plan(**kw)


def test_launch_raises_on_cuda_error_and_counts_only_successes():
    k = build.NativeKernel("fed_direction", "fed_direction_launch", [])
    k._err = lambda code: b"simulated failure"
    with pytest.raises(RuntimeError, match="simulated failure"):
        k.launch(lambda *a: 700)
    assert k.launches == 0
    k.launch(lambda *a: 0)
    assert k.launches == 1


def test_build_names_library_by_source_hash_and_needs_nvcc(monkeypatch, tmp_path):
    a = build.library_path("fed_direction")
    assert a.parent == build.BUILD_DIR and a.name.startswith("fed_direction-")
    assert a != build.library_path("server_update")
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-lineinfo",))
    assert build.library_path("fed_direction") != a  # flags are part of the key
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc_path()
