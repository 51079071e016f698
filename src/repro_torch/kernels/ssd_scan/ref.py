"""Plain PyTorch versions of the SSD scan kernel.

``ssd_chunked_ref`` is the port of ``repro.models.mamba2.ssd_chunked``, the
chunked algorithm the kernel mirrors (quadratic within a chunk of L steps,
a rank-N state recurrence across chunks), and is the kernel's plain
version.  ``ssd_sequential_ref`` is the port of
``repro.kernels.ssd_scan.ref.ssd_sequential_ref``, the O(S) recurrence that
defines the scan, kept as a second oracle:

    h_t = exp(dt_t · A) · h_{t−1} + dt_t · x_t ⊗ B_t
    y_t = C_t · h_t

Shapes: x (B, S, H, P); dt (B, S, H) f32 (post-softplus); A (H,) f32
(negative); Bm, Cm (B, S, N), shared by every head.  Both return
y (B, S, H, P) in x's dtype and the final state (B, H, P, N) in f32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def ssd_chunked_ref(x, dt, A, Bm, Cm, chunk: int):
    Bsz, S, H, Pd = x.shape
    N = Bm.shape[-1]
    L = chunk
    pad = (-S) % L
    if pad:  # dt = 0 on the padded steps: identity steps
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    Sp = S + pad
    nc = Sp // L
    f32 = torch.float32

    xc = x.reshape(Bsz, nc, L, H, Pd).to(f32)
    dtc = dt.reshape(Bsz, nc, L, H).to(f32)
    Bc = Bm.reshape(Bsz, nc, L, N).to(f32)
    Cc = Cm.reshape(Bsz, nc, L, N).to(f32)

    dA = dtc * A[None, None, None, :]  # (B, nc, L, H) negative
    dAcs = torch.cumsum(dA, dim=2)  # inclusive cumsum within the chunk

    # ---- intra-chunk (masked quadratic)
    seg = dAcs[:, :, :, None, :] - dAcs[:, :, None, :, :]  # (B, nc, i, j, H)
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    # the reference's where(mask, exp(seg), 0), with the mask applied before
    # the exp: the same values, but exp(seg) above the diagonal (positive
    # exponents) can overflow to inf, and its gradient 0·inf would be NaN
    Lmat = torch.exp(torch.where(mask[None, None, :, :, None], seg,
                                 torch.full((), -math.inf, dtype=f32, device=x.device)))
    CB = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    scores = CB[..., None] * Lmat  # (B, nc, i, j, H)
    xdt = xc * dtc[..., None]  # (B, nc, L, H, P)
    y_diag = torch.einsum("bcijh,bcjhp->bcihp", scores, xdt)

    # ---- chunk states
    decay_to_end = torch.exp(dAcs[:, :, -1:, :] - dAcs)  # (B, nc, L, H)
    states = torch.einsum("bcln,bclh,bclhp->bchpn", Bc, decay_to_end * dtc, xc)

    # ---- inter-chunk recurrence
    chunk_decay = torch.exp(dAcs[:, :, -1, :])  # (B, nc, H)
    state = torch.zeros((Bsz, H, Pd, N), dtype=f32, device=x.device)
    state_in = []
    for c in range(nc):
        state_in.append(state)  # the state entering chunk c
        state = states[:, c] + chunk_decay[:, c, :, None, None] * state
    state_in = torch.stack(state_in, dim=1)  # (B, nc, H, P, N)

    # ---- off-diagonal contribution
    in_decay = torch.exp(dAcs)  # decay from the chunk start to position i
    y_off = torch.einsum("bcin,bchpn->bcihp", Cc, state_in) * in_decay[..., None]

    y = (y_diag + y_off).reshape(Bsz, Sp, H, Pd)
    return y[:, :S].to(x.dtype), state


def ssd_sequential_ref(x, dt, A, Bm, Cm):
    Bsz, S, H, Pd = x.shape
    N = Bm.shape[-1]
    f32 = torch.float32
    h = torch.zeros((Bsz, H, Pd, N), dtype=f32, device=x.device)
    ys = []
    for t in range(S):
        dA = torch.exp(dt[:, t].to(f32) * A[None, :])  # (B, H)
        upd = (dt[:, t, :, None].to(f32) * x[:, t].to(f32))[..., None] \
            * Bm[:, t, None, None, :].to(f32)  # (B, H, P, N)
        h = dA[..., None, None] * h + upd
        ys.append(torch.einsum("bhpn,bn->bhp", h, Cm[:, t].to(f32)))
    y = torch.stack(ys, dim=1) if ys else torch.zeros((Bsz, 0, H, Pd), dtype=f32,
                                                       device=x.device)
    return y.to(x.dtype), h
