"""The FedCM blend oracle: no kernel, the counterpart of the reference's
retired ``fedcm_update`` package.

The per-local-step blend ``x ← x − η_l·(α·g + (1−α)·Δ)`` launches through
``kernels/fed_direction`` with the coefficients ``(η_l, α, 0, 1−α)``; only
the plain oracle ``ref.fedcm_step_ref`` is here, which pins that route to
Algorithm 2 lines 8–9 independently of ``fed_direction``'s own
``ref.py``.  It sits on no path.
"""
from repro_torch.kernels.fedcm_update.ref import fedcm_step_ref

__all__ = ["fedcm_step_ref"]
