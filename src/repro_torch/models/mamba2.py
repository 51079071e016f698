"""Mamba2 (SSD — state-space duality, arXiv:2405.21060) block (counterpart
of ``repro.models.mamba2``).

Prefill with ``use_kernels``: the chunked SSD scan through
``repro_torch.kernels.ssd_scan`` (the CUDA kernel on the card; on the CPU
its plain version).  Without it, and always in training (the kernel has no
backward), the plain ``ssd_chunked_ref`` directly, the port of the
reference's ``ssd_chunked``.  Decode: the O(1) recurrent state update.

Shapes (single group, G=1, as in the released mamba2 configs):
  x_in   (B, S, D)
  z,x    (B, S, d_inner)            d_inner = expand * D
  B,C    (B, S, N)                  N = ssm_state
  dt     (B, S, H)                  H = d_inner / head_dim
  state  (B, H, P, N)               P = head_dim

Over a model group (``parallel``) each rank holds the SSD heads ``[r·H/N,
(r+1)·H/N)`` (``repro_torch.sharding.rules.mamba_split``): its z, x and dt
columns of ``w_in`` with B's and C's whole, its x channels of the conv with
B's and C's whole, its d_inner rows of ``w_out`` and entries of ``norm_z``;
``A_log``, ``D_skip`` and ``dt_bias`` stay whole and the block reads its
heads' entries.  The shapes above then hold with H and d_inner the rank's.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan.ops import ssd
from repro_torch.kernels.ssd_scan.ref import ssd_chunked_ref
from repro_torch.models.layers import Keep, ParallelContext, dense_init, keep_whole, split


def init_mamba2(generator, cfg, dtype=torch.float32, lead: Sequence[int] = (),
                device=None, keep: Keep = keep_whole) -> Dict[str, torch.Tensor]:
    D = cfg.d_model
    d_inner = cfg.ssm_expand * D
    N = cfg.ssm_state
    H = cfg.ssm_heads
    k = cfg.ssm_conv
    conv_ch = d_inner + 2 * N
    f32 = torch.float32
    # softplus-inverse of dt drawn log-uniformly in [1e-3, 1e-1]
    u = torch.rand((*lead, H), generator=generator, dtype=f32, device=device)
    log_dt = math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3))
    dt_bias = torch.log(torch.expm1(torch.exp(log_dt)))
    p = {
        # in_proj packs [z, x, B, C, dt]
        "w_in": dense_init(generator, (*lead, D, 2 * d_inner + 2 * N + H), in_axis_size=D,
                           dtype=dtype, device=device),
        "conv_w": dense_init(generator, (*lead, k, conv_ch), in_axis_size=k, dtype=dtype,
                             device=device),
        "conv_b": torch.zeros((*lead, conv_ch), dtype=dtype, device=device),
        "A_log": torch.log(torch.arange(1, H + 1, dtype=f32, device=device)).expand(
            *lead, H).clone(),
        "D_skip": torch.ones((*lead, H), dtype=f32, device=device),
        "dt_bias": dt_bias,
        "w_out": dense_init(generator, (*lead, d_inner, D), in_axis_size=d_inner, dtype=dtype,
                            device=device),
        "norm_z": torch.zeros((*lead, d_inner), dtype=dtype, device=device),  # gated RMSNorm
    }
    return {name: keep((name,), leaf) for name, leaf in p.items()}


def local_heads(cfg, parallel: Optional[ParallelContext]) -> int:
    """The SSD heads a rank holds: H / N when the group's size divides
    them (the rule's guard), else all H."""
    H = cfg.ssm_heads
    if parallel is None or H % parallel.size or H < parallel.size:
        return H
    return H // parallel.size


def _split_proj(h: torch.Tensor, d_inner: int, N: int, H: int):
    """``[z | x, B, C | dt]`` of the in-projection (a rank's widths over a group)."""
    z = h[..., :d_inner]
    xBC = h[..., d_inner:2 * d_inner + 2 * N]
    dt = h[..., 2 * d_inner + 2 * N:]
    if dt.shape[-1] != H:
        raise ValueError(f"in_proj width {h.shape[-1]} does not match the config")
    return z, xBC, dt


def _causal_conv(xBC, conv_w, conv_b, conv_state=None):
    """Depthwise causal conv, kernel k.  xBC: (B,S,C); conv_w: (k,C).

    With ``conv_state`` (B, k-1, C) (decode) it is prepended.  Returns
    (silu(out) (B,S,C), new conv state = the last k-1 raw inputs)."""
    k = conv_w.shape[0]
    if conv_state is not None:
        xfull = torch.cat([conv_state.to(xBC.dtype), xBC], dim=1)
    else:
        xfull = F.pad(xBC, (0, 0, k - 1, 0))
    S = xBC.shape[1]
    out = torch.zeros_like(xBC)
    for i in range(k):  # k is tiny (4): unrolled taps
        out = out + xfull[:, i:i + S, :] * conv_w[i][None, None].to(xBC.dtype)
    out = out + conv_b[None, None].to(xBC.dtype)
    return F.silu(out), xfull[:, -(k - 1):, :]


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` = logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def ssd_decode_step(state, x_t, dt_t, A, B_t, C_t):
    """One recurrent step.  state (B,H,P,N); x_t (B,H,P); dt_t (B,H);
    B_t,C_t (B,N).  Returns (y_t (B,H,P) f32, new_state)."""
    f32 = torch.float32
    dA = torch.exp(dt_t.to(f32) * A[None, :])  # (B,H)
    inp = (dt_t[..., None].to(f32) * x_t.to(f32))[..., None] * B_t[:, None, None, :].to(f32)
    new_state = dA[..., None, None] * state + inp  # (B,H,P,N)
    y = torch.einsum("bhpn,bn->bhp", new_state, C_t.to(f32))
    return y, new_state


def mamba2_block(
    params: Dict[str, torch.Tensor],
    x: torch.Tensor,
    *,
    cfg,
    state: Optional[Dict[str, torch.Tensor]] = None,  # decode: {"ssm", "conv"}
    return_state: bool = False,  # prefill: emit the final recurrent state
    use_kernels: bool = True,  # prefill: the SSD kernel, else the plain scan
    parallel: Optional[ParallelContext] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
    """Returns (out (B,S,D), new_state or None).

    Over a group the scan (the SSD kernel in prefill, the recurrent step in
    decode) runs on the rank's heads; the gated RMSNorm's mean over the
    whole d_inner joins the ranks' f32 sums of squares with one
    ``all_reduce``, and one more sums the partial outputs of ``w_out``.  A
    group whose size does not divide the heads holds the block whole: it
    runs whole on every rank with no collective, counted in
    ``parallel.counts["mamba_whole"]``."""
    Bsz, S, D = x.shape
    d_whole = cfg.ssm_expand * D
    d_inner = params["w_out"].shape[-2]  # this rank's channels
    Pd, N = cfg.ssm_head_dim, cfg.ssm_state
    H = d_inner // Pd
    sharded = split(parallel, d_inner, d_whole)
    heads = slice(parallel.rank * H, (parallel.rank + 1) * H) if sharded else slice(None)
    if parallel is not None and not sharded:
        parallel.counts["mamba_whole"] += 1
    if sharded:
        x = parallel.copy_in(x)

    h = torch.matmul(x, params["w_in"].to(x.dtype))
    z, xBC, dt = _split_proj(h, d_inner, N, H)
    dt = _softplus(dt.to(torch.float32) + params["dt_bias"][heads][None, None])
    # (H,) f32: a bf16 A_log (the dry-run's Knobs.param_dtype) takes its exp
    # in bf16 and is promoted, as the reference's f32 products promote it
    A = (-torch.exp(params["A_log"][heads])).to(torch.float32)

    if state is None:
        xBC_raw = xBC
        xBC, _ = _causal_conv(xBC, params["conv_w"], params["conv_b"])
        xs = xBC[..., :d_inner].reshape(Bsz, S, H, Pd)
        Bm = xBC[..., d_inner:d_inner + N]
        Cm = xBC[..., d_inner + N:]
        scan = ssd if use_kernels else ssd_chunked_ref
        y, final_state = scan(xs, dt, A, Bm, Cm, chunk=cfg.ssm_chunk)
        new_state = None
        if return_state:
            k = cfg.ssm_conv
            # conv state = the last (k-1) RAW xBC inputs, left-padded when the
            # prefill segment is shorter than k-1; a copy, since a view would
            # keep the whole (B, S, ·) input projection alive with the cache
            tail = xBC_raw[:, max(0, S - (k - 1)):].clone()
            if tail.shape[1] < k - 1:
                tail = F.pad(tail, (0, 0, k - 1 - tail.shape[1], 0))
            new_state = {"ssm": final_state, "conv": tail}
    else:
        xBC, conv_state = _causal_conv(xBC, params["conv_w"], params["conv_b"],
                                       conv_state=state["conv"])
        xs = xBC[..., :d_inner].reshape(Bsz, S, H, Pd)
        Bm = xBC[..., d_inner:d_inner + N]
        Cm = xBC[..., d_inner + N:]
        # S == 1 in decode
        y, ssm_state = ssd_decode_step(state["ssm"], xs[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0])
        y = y[:, None]  # (B,1,H,P)
        new_state = {"ssm": ssm_state, "conv": conv_state}

    y = y.to(x.dtype) + params["D_skip"][heads][None, None, :, None].to(x.dtype) * xs
    y = y.reshape(Bsz, S, d_inner)
    # gated RMSNorm: norm(y * silu(z)), its mean over the whole d_inner
    g = y * F.silu(z)
    gf = g.to(torch.float32)
    if sharded:
        # the variance is replicated and scales each rank's own channels:
        # its gradient is summed over the group (``copy_in``) like an input's
        var = parallel.copy_in(parallel.sum(gf.square().sum(dim=-1, keepdim=True))) / d_whole
    else:
        var = gf.square().mean(dim=-1, keepdim=True)
    g = (gf * torch.rsqrt(var + 1e-6) * (1.0 + params["norm_z"].to(torch.float32))).to(x.dtype)
    out = torch.matmul(g, params["w_out"].to(x.dtype))
    if sharded:
        out = parallel.sum(out)
    return out, new_state


def init_mamba2_state(cfg, batch: int, dtype=torch.float32, lead: Sequence[int] = (),
                      device=None, parallel: Optional[ParallelContext] = None
                      ) -> Dict[str, torch.Tensor]:
    """Zero SSM state ``(…, B, H, P, N)`` and conv state ``(…, B, k−1,
    d_inner + 2N)``; over a group H and d_inner are the rank's
    (``local_heads``), B's and C's conv channels whole."""
    H = local_heads(cfg, parallel)
    conv_ch = cfg.ssm_expand * cfg.d_model * H // cfg.ssm_heads + 2 * cfg.ssm_state
    return {
        "ssm": torch.zeros((*lead, batch, H, cfg.ssm_head_dim, cfg.ssm_state),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros((*lead, batch, cfg.ssm_conv - 1, conv_ch), dtype=dtype,
                            device=device),
    }
