"""Port vs reference: the SSD scan kernel's plain version, and its dispatch.

On the CPU ``repro_torch.kernels.ssd_scan.ops.ssd`` runs its plain version
(``ref.ssd_chunked_ref``, the port of ``repro.models.mamba2.ssd_chunked``).
These tests hold it, and the port's ``ssd_sequential_ref``, to the
reference's Pallas kernel in interpret mode (``repro.kernels.ssd_scan.ops``),
to the reference's ``ssd_chunked`` and to its ``ssd_sequential_ref``, on the
same numpy inputs, for S < chunk, S = chunk and S not a multiple of the
chunk; y and the final state are both checked.  The CUDA kernel runs only on
a card, where ``chip_smoke.py`` holds it against the same plain version.

Tolerance: ``SSD_RTOL``/``SSD_ATOL`` (tests/_torch_parity.py): the chunked
and sequential forms sum the same terms in different orders and through
exp(cumsum) differences; one bf16 ulp for bf16 outputs.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_parity import BF16_RTOL, SSD_ATOL, SSD_RTOL, assert_close
from repro.kernels.ssd_scan.ops import ssd as ref_ssd_pallas
from repro.kernels.ssd_scan.ref import ssd_sequential_ref as ref_ssd_sequential
from repro.models.mamba2 import ssd_chunked as ref_ssd_chunked
from repro_torch.core.convert import to_numpy
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.kernels.ssd_scan.ops import ssd
from repro_torch.kernels.ssd_scan.ref import ssd_chunked_ref, ssd_sequential_ref

torch.set_num_threads(1)

CHUNK = 16
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(seed, B, S, H, P, N, dtype="float32"):
    """x, B, C normal; dt = softplus(normal − 2) (the model's range); A =
    −(1..H) (the model's −exp(A_log) at init)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(B, S, H)) - 2.0)).astype(np.float32)
    A = -np.arange(1, H + 1, dtype=np.float32)
    Bm = rng.normal(size=(B, S, N)).astype(np.float32)
    Cm = rng.normal(size=(B, S, N)).astype(np.float32)
    jd, td = DTYPES[dtype]
    ref = (jnp.asarray(x, jd), jnp.asarray(dt), jnp.asarray(A), jnp.asarray(Bm, jd),
           jnp.asarray(Cm, jd))
    port = (torch.tensor(x).to(td), torch.tensor(dt), torch.tensor(A), torch.tensor(Bm).to(td),
            torch.tensor(Cm).to(td))
    return ref, port


def _check(got, expected, y_dtype="float32"):
    (y, st), (ey, est) = got, expected
    y_tol = dict(rtol=BF16_RTOL, atol=SSD_ATOL) if y_dtype == "bfloat16" else \
        dict(rtol=SSD_RTOL, atol=SSD_ATOL)
    assert_close(to_numpy(y), np.asarray(ey, np.float32), what="y", **y_tol)
    assert_close(to_numpy(st), np.asarray(est, np.float32), what="state",
                 rtol=SSD_RTOL, atol=SSD_ATOL)


LENGTHS = {"S<chunk": 11, "S=chunk": CHUNK, "ragged": 37}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", LENGTHS.values(), ids=LENGTHS.keys())
def test_plain_matches_reference_pallas_kernel(S, dtype):
    ref_in, port_in = _inputs(S, 2, S, 4, 8, 16, dtype)
    got = ssd(*port_in, chunk=CHUNK)
    assert got[0].dtype == port_in[0].dtype and got[1].dtype == torch.float32
    assert tuple(got[1].shape) == (2, 4, 8, 16)
    _check(got, ref_ssd_pallas(*ref_in, chunk=CHUNK), dtype)


@pytest.mark.parametrize("S", LENGTHS.values(), ids=LENGTHS.keys())
def test_plain_matches_reference_chunked(S):
    ref_in, port_in = _inputs(S + 1, 2, S, 4, 8, 16)
    _check(ssd(*port_in, chunk=CHUNK), ref_ssd_chunked(*ref_in, chunk=CHUNK))


@pytest.mark.parametrize("S", LENGTHS.values(), ids=LENGTHS.keys())
def test_plain_matches_reference_sequential(S):
    ref_in, port_in = _inputs(S + 2, 2, S, 4, 8, 16)
    _check(ssd(*port_in, chunk=CHUNK), ref_ssd_sequential(*ref_in))


@pytest.mark.parametrize("S", LENGTHS.values(), ids=LENGTHS.keys())
def test_port_sequential_matches_reference_sequential(S):
    ref_in, port_in = _inputs(S + 3, 2, S, 4, 8, 16)
    _check(ssd_sequential_ref(*port_in), ref_ssd_sequential(*ref_in))


def test_strided_inputs_match_contiguous_ones():
    """The model hands the scan slices of its conv output (batch and
    sequence strided, innermost dims contiguous), as the kernel reads them."""
    _, (x, dt, A, Bm, Cm) = _inputs(9, 2, 21, 4, 8, 16)
    packed = torch.cat([x.reshape(2, 21, 32), Bm, Cm], dim=-1)  # (B, S, H·P + 2N)
    xs = packed[..., :32].reshape(2, 21, 4, 8)
    Bs, Cs = packed[..., 32:48], packed[..., 48:]
    assert not xs.is_contiguous() and xs.stride(2) == 8 and Bs.stride(2) == 1
    for a, b in zip(ssd(xs, dt, A, Bs, Cs, chunk=CHUNK), ssd_chunked_ref(x, dt, A, Bm, Cm, CHUNK)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------- dispatch
def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _meta_inputs(B=2, S=10, H=4, P=8, N=16):
    return (_meta(B, S, H, P), _meta(B, S, H), _meta(H), _meta(B, S, N), _meta(B, S, N))


def test_cpu_tensors_never_reach_the_loader(monkeypatch):
    def boom():
        raise AssertionError("the CPU route must not build or load a kernel")

    monkeypatch.setattr(ssd_kernel.KERNEL, "load", boom)
    _, port_in = _inputs(1, 1, 5, 2, 4, 4)
    ssd(*port_in, chunk=4)


def test_non_cpu_request_raises_when_the_loader_fails(monkeypatch):
    def fail_load():
        raise RuntimeError("nvcc failed (simulated)")

    monkeypatch.setattr(ssd_kernel.KERNEL, "load", fail_load)
    with pytest.raises(RuntimeError, match="simulated"):
        ssd(*_meta_inputs(), chunk=8)


def test_non_cuda_device_is_refused_after_loading(monkeypatch):
    calls = []
    monkeypatch.setattr(ssd_kernel.KERNEL, "load", lambda: (lambda *a: calls.append(a) or 0))
    with pytest.raises(ValueError, match="CUDA"):
        ssd_kernel.ssd_scan(*_meta_inputs(), chunk=8)
    assert calls == []


@pytest.mark.parametrize("case", ["x_rank", "dt_shape", "A_shape", "bc_shape", "head_dim",
                                  "state", "chunk", "bc_dtype", "dt_dtype", "x_inner_stride",
                                  "bc_inner_stride"])
def test_wrapper_validates_before_loading(monkeypatch, case):
    def boom():
        raise AssertionError("validation must come before loading")

    monkeypatch.setattr(ssd_kernel.KERNEL, "load", boom)
    x, dt, A, Bm, Cm = _meta_inputs()
    chunk = 8
    if case == "x_rank":
        x = _meta(2, 10, 32)
    elif case == "dt_shape":
        dt = _meta(2, 10, 5)
    elif case == "A_shape":
        A = _meta(5)
    elif case == "bc_shape":
        Cm = _meta(2, 10, 17)
    elif case == "head_dim":
        x = _meta(2, 10, 4, 65)
    elif case == "state":
        Bm = Cm = _meta(2, 10, 129)
    elif case == "chunk":
        chunk = 65
    elif case == "bc_dtype":
        Bm = _meta(2, 10, 16, dtype=torch.bfloat16)
    elif case == "dt_dtype":
        dt = _meta(2, 10, 4, dtype=torch.bfloat16)
    elif case == "x_inner_stride":
        x = _meta(2, 10, 8, 4).transpose(2, 3)
    else:
        Bm = _meta(2, 16, 10).transpose(1, 2)
    with pytest.raises(ValueError):
        ssd_kernel.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
