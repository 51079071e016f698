"""Public SSD wrapper (the contract of ``repro.kernels.ssd_scan.ops.ssd``).

Routing is by device: tensors on the CPU take the plain version
(``ref.ssd_chunked_ref``); CUDA tensors take the kernel, which launches or
raises.
"""
from __future__ import annotations

from repro_torch.kernels.ssd_scan import kernel
from repro_torch.kernels.ssd_scan.ref import ssd_chunked_ref


def ssd(x, dt, A, Bm, Cm, chunk: int = 128):
    """x (B,S,H,P); dt (B,S,H) post-softplus f32; A (H,) f32; Bm/Cm (B,S,N).

    Returns (y (B,S,H,P) in x's dtype, final_state (B,H,P,N) f32)."""
    if x.device.type == "cpu":
        return ssd_chunked_ref(x, dt, A, Bm, Cm, chunk)
    return kernel.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
