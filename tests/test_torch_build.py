"""The kernel build cache and the two LM kernels' wrappers, on the CPU (no
``nvcc`` needed).

* ``build.library_path`` names a library by a hash of its source, every
  shared header ``csrc/*.cuh`` and the flags, so editing a header that a
  source includes rebuilds it instead of loading a stale library.
* ``flash_attention_bshd`` and ``ssd_scan`` validate their operands before
  they build or load anything, and refuse tensors that are not on a CUDA
  device after loading, without calling the kernel: they launch or raise,
  in either dtype (the bf16 route runs the tensor cores, the f32 route the
  CUDA cores).
"""
import shutil

import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel


def test_library_path_tracks_every_header(monkeypatch, tmp_path):
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n')
    (tmp_path / "a.cuh").write_text("// a\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    first = build.library_path("k")
    assert first == build.library_path("k")  # unchanged sources: the same library
    (tmp_path / "a.cuh").write_text("// a, edited\n")
    edited = build.library_path("k")
    assert edited != first
    (tmp_path / "b.cuh").write_text("// b\n")
    added = build.library_path("k")
    assert added not in (first, edited)
    (tmp_path / "b.cuh").rename(tmp_path / "c.cuh")  # a header's name is part of the key
    assert build.library_path("k") != added
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n// edited\n')
    assert build.library_path("k") not in (first, edited, added)


def test_lm_sources_share_a_header_that_the_cache_sees(monkeypatch, tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    headers = sorted(p.name for p in csrc.glob("*.cuh"))
    assert headers, "the shared tensor-core header is missing"
    for name in ("flash_attention", "ssd_scan"):
        text = (csrc / f"{name}.cu").read_text()
        assert any(f'#include "{h}"' in text for h in headers), name
    monkeypatch.setattr(build, "CSRC", csrc)
    before = {n: build.library_path(n) for n in ("flash_attention", "ssd_scan")}
    header = csrc / headers[0]
    header.write_text(header.read_text() + "\n// edited\n")
    assert all(build.library_path(n) != p for n, p in before.items())


def _meta(*shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _operands(wrapper, dtype, bad=False):
    """Operands of one call on the meta device (neither CPU nor CUDA);
    ``bad`` breaks one shape."""
    if wrapper == "flash_attention":
        q, kv = _meta(2, 8, 4, 16, dtype=dtype), _meta(2, 6, 2, 16, dtype=dtype)
        v = _meta(2, 7, 2, 16, dtype=dtype) if bad else kv
        return fa_kernel.KERNEL, lambda: fa_kernel.flash_attention_bshd(q, kv, v)
    x = _meta(1, 40, 4, 16, dtype=dtype)
    dt, A = _meta(1, 40, 4, dtype=torch.float32), _meta(4, dtype=torch.float32)
    bm = _meta(1, 40, 8, dtype=dtype)
    cm = _meta(1, 41, 8, dtype=dtype) if bad else bm
    return ssd_kernel.KERNEL, lambda: ssd_kernel.ssd_scan(x, dt, A, bm, cm, chunk=16)


WRAPPERS = [(w, d) for w in ("flash_attention", "ssd_scan")
            for d in (torch.float32, torch.bfloat16)]


@pytest.mark.parametrize("wrapper,dtype", WRAPPERS, ids=lambda v: str(v).split(".")[-1])
def test_wrapper_validates_before_loading(monkeypatch, wrapper, dtype):
    binding, call = _operands(wrapper, dtype, bad=True)

    def boom():
        raise AssertionError("validation must come before loading")

    monkeypatch.setattr(binding, "load", boom)
    with pytest.raises(ValueError):
        call()


@pytest.mark.parametrize("wrapper,dtype", WRAPPERS, ids=lambda v: str(v).split(".")[-1])
def test_wrapper_refuses_non_cuda_tensors_after_loading(monkeypatch, wrapper, dtype):
    binding, call = _operands(wrapper, dtype)
    calls = []
    monkeypatch.setattr(binding, "load", lambda: (lambda *a: calls.append(a) or 0))
    with pytest.raises(ValueError, match="CUDA"):
        call()
    assert calls == [] and binding.launches == 0
