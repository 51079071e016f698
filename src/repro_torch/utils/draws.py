"""Counter-based random draws, keyed like the reference's ``fold_in`` chains.

The reference keys every fault and rounding draw on
``fold_in(PRNGKey(seed), absolute round t)``, then on a stream index, then
on a client id.  That makes a draw independent of the order of the cohort,
the same after a kill and resume (the round counter rides the state), and
free of host reads.  PyTorch cannot reproduce threefry, so the port keeps
the keying and replaces the generator: a pure integer hash of
``(seed, t, stream, id, element index)`` in plain PyTorch ops.

* ``t`` is the device round counter (a 0-d tensor); it is never read back
  to the host, so a round stays free of syncs.
* Every value is held in ``[0, 2^32)`` inside int64, and a 32-bit product
  is taken as two 16-bit partial products, so no int64 product ever wraps:
  the CPU and CUDA give the same bits.
* The hash is murmur3's 32-bit finalizer applied along the chain.  A
  uniform is the top 24 bits of the hash times 2^-24 — exactly
  representable, in [0, 1).  Normals are Box–Muller on two uniforms
  (element indices 2j and 2j+1); their last bits may differ between
  devices, as ``log`` and ``cos`` are rounded by different libraries.

Parity tests inject the reference's own draws in place of these; the hash
itself is checked statistically (tests/test_torch_compress.py).
"""
from __future__ import annotations

import math
from typing import Optional, Union

import torch

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x·c mod 2^32`` for ``x`` in [0, 2^32) with no int64 overflow: the
    constant is split into 16-bit halves, so each product is < 2^48."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _fmix(x: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finalizer (a bijection with full avalanche)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def row_keys(seed: int, t: Union[int, torch.Tensor], stream: int,
             ids: torch.Tensor) -> torch.Tensor:
    """(C,) int64 keys in [0, 2^32) of ``(seed, t, stream, id)``, on ids'
    device; ``t`` may be a device tensor (never read back) or an int."""
    dev = ids.device
    k = _fmix(torch.full((), (seed & _M32) ^ ((seed >> 32) & _M32), dtype=torch.int64,
                         device=dev))
    t = torch.as_tensor(t, device=dev).to(torch.int64) & _M32
    k = _fmix(k ^ t)
    k = _fmix(k ^ (stream & _M32))
    return _fmix(k ^ (ids.to(torch.int64) & _M32))


def bits(seed: int, t, stream: int, ids: torch.Tensor, n: int) -> torch.Tensor:
    """(C, n) int64 hash values in [0, 2^32): element j of row c hashes
    ``(seed, t, stream, ids[c], j)``."""
    k = row_keys(seed, t, stream, ids)[:, None]
    j = torch.arange(n, dtype=torch.int64, device=ids.device)[None, :]
    return _fmix(_fmix(j ^ k) ^ _fmix(k ^ 0x9E3779B9))


def uniform(seed: int, t, stream: int, ids: torch.Tensor,
            n: Optional[int] = None) -> torch.Tensor:
    """f32 uniforms in [0, 1): ``(C,)`` if ``n`` is None (element 0), else
    ``(C, n)``."""
    u = (bits(seed, t, stream, ids, 1 if n is None else n) >> 8).to(torch.float32) \
        * (2.0 ** -24)
    return u[:, 0] if n is None else u


def normal(seed: int, t, stream: int, ids: torch.Tensor,
           n: Optional[int] = None) -> torch.Tensor:
    """f32 standard normals by Box–Muller: ``(C,)`` if ``n`` is None, else
    ``(C, n)``."""
    u = (bits(seed, t, stream, ids, 2 * (1 if n is None else n)) >> 8).to(torch.float32) \
        * (2.0 ** -24)
    u1, u2 = u[:, 0::2], u[:, 1::2]
    z = torch.sqrt(-2.0 * torch.log1p(-u1)) * torch.cos((2.0 * math.pi) * u2)
    return z[:, 0] if n is None else z
