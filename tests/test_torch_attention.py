"""Port vs reference: the flash-attention kernel's plain version, and its
dispatch.

On the CPU ``repro_torch.kernels.flash_attention.ops.flash_attention`` runs
its plain version (``ref.py``).  These tests hold it to the reference's
Pallas kernel run in interpret mode (``repro.kernels.flash_attention.ops``,
as the reference's own tests run it) and to the reference's
``flash_attention_ref``, on the same numpy inputs.  The CUDA kernel runs
only on a card, where ``chip_smoke.py`` holds it against the same plain
version.

Shapes for the Pallas comparison leave every row at least one key: the
Pallas kernel masks with a finite −1e30, so a row that keeps no key inside
a live tile comes out as a mean of V, where ``flash_attention_ref`` (and the
port) give 0 (ROADMAP queue C); ``test_fully_masked_rows_are_zero`` pins
that difference.  Tolerances: tests/_torch_parity.py (``RTOL``/``ATOL`` for
f32, one bf16 ulp for bf16 outputs).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_parity import ATOL, BF16_RTOL, RTOL, assert_close
from repro.kernels.flash_attention.ops import flash_attention as ref_flash_pallas
from repro.kernels.flash_attention.ref import flash_attention_ref as ref_flash_ref
from repro_torch.core.convert import to_numpy
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(seed, B, Sq, Skv, H, Hkv, hd, dtype):
    rng = np.random.default_rng(seed)
    jd, td = DTYPES[dtype]
    arrs = [rng.normal(size=shape).astype(np.float32)
            for shape in ((B, Sq, H, hd), (B, Skv, Hkv, hd), (B, Skv, Hkv, hd))]
    return [jnp.asarray(a, jd) for a in arrs], [torch.tensor(a).to(td) for a in arrs]


def _tol(dtype):
    return dict(rtol=BF16_RTOL, atol=ATOL) if dtype == "bfloat16" else dict(rtol=RTOL, atol=ATOL)


# (B, Sq, Skv, H, Hkv, hd, causal, window, q_offset): GQA and MHA, causal with
# and without a window, q_offset > 0, lengths not multiples of 8
CASES = [
    (2, 13, 13, 8, 2, 32, True, None, 0),
    (2, 13, 13, 4, 4, 32, True, None, 0),
    (1, 21, 21, 8, 2, 32, True, 5, 0),
    (2, 11, 29, 8, 2, 32, True, None, 9),
    (1, 11, 29, 4, 4, 64, True, 7, 9),
    (2, 19, 9, 8, 2, 32, False, None, 0),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_plain_matches_reference_pallas_kernel(case, dtype):
    B, Sq, Skv, H, Hkv, hd, causal, window, q_offset = case
    (jq, jk, jv), (tq, tk, tv) = _inputs(sum(case[:6]), B, Sq, Skv, H, Hkv, hd, dtype)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    expected = ref_flash_pallas(jq, jk, jv, **kw)
    got = flash_attention(tq, tk, tv, **kw)
    assert got.dtype == tq.dtype and tuple(got.shape) == (B, Sq, H, hd)
    assert_close(to_numpy(got), np.asarray(expected, np.float32), **_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_plain_matches_reference_oracle(case, dtype):
    B, Sq, Skv, H, Hkv, hd, causal, window, q_offset = case
    (jq, jk, jv), (tq, tk, tv) = _inputs(sum(case[:6]) + 1, B, Sq, Skv, H, Hkv, hd, dtype)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    expected = ref_flash_ref(jq, jk, jv, **kw)
    got = flash_attention(tq, tk, tv, **kw)
    assert_close(to_numpy(got), np.asarray(expected, np.float32), **_tol(dtype))


def test_explicit_scale_is_applied():
    (jq, jk, jv), (tq, tk, tv) = _inputs(5, 1, 9, 9, 4, 2, 32, "float32")
    expected = ref_flash_ref(jq, jk, jv, scale=0.3)
    assert_close(to_numpy(flash_attention(tq, tk, tv, scale=0.3)), np.asarray(expected))


def test_fully_masked_rows_are_zero():
    """Causal + window + q_offset leave rows 7–15 no key (Sq=16, Skv=8,
    q_offset=20, window=20).  The port gives them 0, as
    ``flash_attention_ref`` does; the Pallas kernel gives the mean of V
    over the masked keys (its −1e30 mask), the route difference noted in
    ROADMAP queue C."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(7, 1, 16, 8, 4, 2, 32, "float32")
    kw = dict(causal=True, window=20, q_offset=20)
    got = to_numpy(flash_attention(tq, tk, tv, **kw))
    assert_close(got, np.asarray(ref_flash_ref(jq, jk, jv, **kw)))
    assert np.all(got[:, 7:] == 0.0) and np.all(np.abs(got[:, :7]).sum(-1) > 0)
    pallas = np.asarray(ref_flash_pallas(jq, jk, jv, **kw))
    v_mean = np.asarray(jv).mean(axis=1)  # (B, Hkv, hd) over the 8 keys
    assert_close(pallas[:, 7:], np.repeat(v_mean, 2, axis=1)[:, None].repeat(9, axis=1),
                 rtol=1e-5, atol=1e-6)


def test_plain_version_is_the_ops_route_on_cpu():
    _, (tq, tk, tv) = _inputs(3, 2, 10, 10, 4, 2, 32, "float32")
    assert torch.equal(flash_attention(tq, tk, tv, window=4),
                       flash_attention_ref(tq, tk, tv, window=4))


# ---------------------------------------------------------------- dispatch
def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_cpu_tensors_never_reach_the_loader(monkeypatch):
    def boom():
        raise AssertionError("the CPU route must not build or load a kernel")

    monkeypatch.setattr(fa_kernel.KERNEL, "load", boom)
    _, (tq, tk, tv) = _inputs(1, 1, 4, 4, 2, 1, 8, "float32")
    flash_attention(tq, tk, tv)


def test_non_cpu_request_raises_when_the_loader_fails(monkeypatch):
    def fail_load():
        raise RuntimeError("nvcc failed (simulated)")

    monkeypatch.setattr(fa_kernel.KERNEL, "load", fail_load)
    q, kv = _meta(1, 4, 2, 8), _meta(1, 4, 1, 8)
    with pytest.raises(RuntimeError, match="simulated"):
        flash_attention(q, kv, kv)


def test_non_cuda_device_is_refused_after_loading(monkeypatch):
    calls = []
    monkeypatch.setattr(fa_kernel.KERNEL, "load", lambda: (lambda *a: calls.append(a) or 0))
    q, kv = _meta(1, 4, 2, 8), _meta(1, 4, 1, 8)
    with pytest.raises(ValueError, match="CUDA"):
        fa_kernel.flash_attention_bshd(q, kv, kv)
    assert calls == []


@pytest.mark.parametrize("case", ["rank", "kv_shape", "groups", "head_dim", "dtype",
                                  "mixed_dtype", "noncontiguous", "window"])
def test_wrapper_validates_before_loading(monkeypatch, case):
    def boom():
        raise AssertionError("validation must come before loading")

    monkeypatch.setattr(fa_kernel.KERNEL, "load", boom)
    q, k, v, kw = _meta(2, 8, 4, 16), _meta(2, 6, 2, 16), _meta(2, 6, 2, 16), {}
    if case == "rank":
        q = _meta(8, 4, 16)
    elif case == "kv_shape":
        v = _meta(2, 7, 2, 16)
    elif case == "groups":
        k = v = _meta(2, 6, 3, 16)
    elif case == "head_dim":
        q, k, v = _meta(2, 8, 4, 160), _meta(2, 6, 2, 160), _meta(2, 6, 2, 160)
    elif case == "dtype":
        q, k, v = (_meta(*t.shape, dtype=torch.float16) for t in (q, k, v))
    elif case == "mixed_dtype":
        k = _meta(2, 6, 2, 16, dtype=torch.bfloat16)
    elif case == "noncontiguous":
        q = _meta(2, 4, 8, 16).transpose(1, 2)
    else:
        kw = {"window": 0}
    with pytest.raises(ValueError):
        fa_kernel.flash_attention_bshd(q, k, v, **kw)
