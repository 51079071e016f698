"""The split-bf16 design of the bf16 routes of ``csrc/flash_attention.cu``
and ``csrc/ssd_scan.cu``, pinned on the CPU.

Both kernels multiply on the tensor cores (bf16 × bf16, f32 accumulators).
An operand that is bf16 already (q, k, v, x, B, C) enters as it is: the
product of two bf16 values is exact in f32.  An f32 operand (flash's P; the
SSD's decay-weighted scores M, its input weights W and its state) enters as
n bf16 pieces, ``hi = bf16(v)``, ``lo = bf16(v − hi)``, ..., one product per
piece summed in f32.  These tests emulate exactly those products in
PyTorch (f32 matrix products of bf16-valued operands) and hold the result
to the kernels' plain versions (``flash_attention_ref``, ``ssd_chunked_ref``)
with the tolerance ``chip_smoke.py`` holds the kernels to on the card
(``LM_KERNEL_TOL``, read from there): two pieces stay within it, one piece
does not — so the split cannot be dropped without a failing test.

What the emulation leaves out changes f32 rounding only: the kernel's
online softmax over 64-key tiles (here one softmax over the row), its warp
scan (here ``torch.cumsum``) and its summation order.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.ssd_scan.ref import ssd_chunked_ref

torch.set_num_threads(1)

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)  # stdlib imports only at module level
LM_KERNEL_TOL = chip_smoke.LM_KERNEL_TOL

BF16, F32 = torch.bfloat16, torch.float32


def _within(actual, expected, dtype: str) -> bool:
    return chip_smoke.close_to(torch, actual, expected, *LM_KERNEL_TOL[dtype])


def _pieces(v: torch.Tensor, n: int):
    """v (f32) as n bf16-valued f32 tensors whose sum approximates v."""
    out, rest = [], v
    for _ in range(n):
        piece = rest.to(BF16).to(F32)
        out.append(piece)
        rest = rest - piece
    return out


def _split_matmul(a: torch.Tensor, b: torch.Tensor, n: int) -> torch.Tensor:
    """a @ b with a (f32) cut into n bf16 pieces and b bf16-valued: one f32
    product per piece, summed in f32, as the tensor cores do."""
    out = None
    for piece in _pieces(a, n):
        prod = piece @ b
        out = prod if out is None else out + prod
    return out


# ---------------------------------------------------------------- flash attention
def _flash_tensor_cores(q, k, v, n: int) -> torch.Tensor:
    """Causal attention as the bf16 route computes it: S = Q·Kᵀ exact in
    f32, P = exp(S − m) in f32, l summed from the unrounded P, O = P·V with
    P in n pieces, then O / l rounded once to bf16."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    qh = q.to(F32).transpose(1, 2)  # (B, H, S, hd), bf16-valued
    kh = k.to(F32).transpose(1, 2).repeat_interleave(G, dim=1)
    vh = v.to(F32).transpose(1, 2).repeat_interleave(G, dim=1)
    s = (qh @ kh.transpose(-1, -2)) * hd ** -0.5
    s = s.masked_fill(~torch.ones((S, S), dtype=torch.bool).tril(), float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    o = _split_matmul(p, vh, n) / p.sum(dim=-1, keepdim=True)
    return o.transpose(1, 2).to(BF16)


def _flash_inputs(seed: int):
    rng = np.random.default_rng(seed)
    B, S, H, Hkv, hd = 1, 256, 4, 2, 64
    return [torch.tensor(rng.normal(size=(B, S, h, hd)).astype(np.float32)).to(BF16)
            for h in (H, Hkv, Hkv)]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("pieces", [1, 2])
def test_flash_pv_needs_two_pieces_of_p(pieces, seed):
    q, k, v = _flash_inputs(seed)
    plain = flash_attention_ref(q, k, v, causal=True)
    got = _flash_tensor_cores(q, k, v, pieces)
    assert _within(got, plain, "bfloat16") == (pieces == 2)


# ---------------------------------------------------------------- SSD scan
def _ssd_tensor_cores(x, dt, A, Bm, Cm, L: int, n: int):
    """The bf16 route's chunk loop: CB = C·Bᵀ exact; per chunk
    yᵀ = exp(dAcs_i)·state·Cᵀ + xᵀ·Mᵀ and state ← exp(dAcs_last)·state +
    Wᵀ·B, with the f32 operands M, W and state in n pieces."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    nc = S // L
    xc = x.to(F32).reshape(Bsz, nc, L, H, P)
    dtc = dt.reshape(Bsz, nc, L, H)
    Bc = Bm.to(F32).reshape(Bsz, nc, L, N)
    Cc = Cm.to(F32).reshape(Bsz, nc, L, N)
    dacs = torch.cumsum(dtc * A, dim=2)  # (B, nc, L, H)
    tri = torch.ones((L, L), dtype=torch.bool).tril()
    state = torch.zeros((Bsz, H, P, N))
    ys = []
    for c in range(nc):
        d = dacs[:, c].transpose(1, 2)  # (B, H, L)
        dtj = dtc[:, c].transpose(1, 2)  # (B, H, L)
        cb = (Cc[:, c] @ Bc[:, c].transpose(-1, -2))[:, None]  # (B, 1, i, j)
        seg = (d[..., :, None] - d[..., None, :]).masked_fill(~tri, float("-inf"))
        M = cb * torch.exp(seg) * dtj[..., None, :]  # (B, H, i, j)
        xh = xc[:, c].transpose(1, 2)  # (B, H, L, P), bf16-valued
        y_off = _split_matmul(state, Cc[:, c][:, None].transpose(-1, -2), n)  # (B, H, P, i)
        y = y_off.transpose(-1, -2) * torch.exp(d)[..., None] + _split_matmul(M, xh, n)
        ys.append(y.transpose(1, 2))  # (B, L, H, P)
        last = d[..., -1:]  # (B, H, 1)
        W = (torch.exp(last - d) * dtj)[..., None] * xh  # (B, H, L, P)
        state = torch.exp(last)[..., None] * state + _split_matmul(
            W.transpose(-1, -2), Bc[:, c][:, None], n)
    return torch.cat(ys, dim=1).to(BF16), state


def _ssd_inputs(seed: int):
    """As chip_smoke.py draws them: x, B, C normal in bf16, dt =
    softplus(normal − 4), A = −(1..H)."""
    rng = np.random.default_rng(seed)
    B, S, H, P, N = 1, 256, 8, 64, 128
    x = torch.tensor(rng.normal(size=(B, S, H, P)).astype(np.float32)).to(BF16)
    dt = torch.nn.functional.softplus(torch.tensor(rng.normal(size=(B, S, H)) - 4.0).float())
    A = -torch.arange(1, H + 1, dtype=F32)
    Bm, Cm = (torch.tensor(rng.normal(size=(B, S, N)).astype(np.float32)).to(BF16)
              for _ in range(2))
    return x, dt, A, Bm, Cm


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("pieces", [1, 2])
def test_ssd_products_need_two_pieces_of_each_f32_operand(pieces, seed):
    x, dt, A, Bm, Cm = _ssd_inputs(seed)
    y_plain, state_plain = ssd_chunked_ref(x, dt, A, Bm, Cm, 64)
    y, state = _ssd_tensor_cores(x, dt, A, Bm, Cm, 64, pieces)
    assert y.shape == y_plain.shape and state.shape == state_plain.shape
    assert _within(y, y_plain, "bfloat16") == (pieces == 2)
    assert _within(state, state_plain, "float32") == (pieces == 2)
