"""PyTorch / CUDA port of the FedCM federated trainer.

The package mirrors ``repro`` module for module (``repro_torch/core/engine.py``
is the counterpart of ``repro/core/engine.py``, and so on) and imports
nothing of it: the JAX package is the reference this one is tested against.

Ported so far: the round on the flat parameter plane for all eleven
registered algorithms (FedCM, paper Algorithm 2, and its baselines) with the
lossy uplink, synchronous or on the async ring, with per-client state on the
device or in a host population store; the local step and the server folds
as hand-written CUDA kernels (``repro_torch/csrc``); LM serving (prefill →
decode) for all ten archs (the dense, moe, ssm, hybrid and vlm decoder-only
families and the encoder-decoder), with flash attention and the SSD scan as
CUDA kernels; LM training (``repro_torch.launch.train``: autograd on the
plain route, AdamW from ``repro_torch.optim``); whole-run
snapshots with kill and resume
(``repro_torch.checkpoint``, the reference's msgpack layout); and the
fleet loop (``repro_torch.fleet``): publication of each snapshot's params,
hot-swap serving, per-round telemetry and a health endpoint; cohort
sharding and model-parallel serving on ``torch.distributed`` groups
(``repro_torch.launch.mesh``); and the public API (``repro_torch.core``,
``repro_torch.models``, ``repro_torch.data``): algorithms registered at
runtime, affine or with ``direction_fn`` / ``server_fn`` escape hatches,
the GroupNorm CNN (``models.small.cnn_classifier``) and the counterparts
of the reference's examples (``examples/torch/``).  Entry points run on
``cuda`` unless the caller passes ``device="cpu"`` (``spawn_cohort``
takes no default device); on the CPU every kernel wrapper uses its plain
PyTorch version.
"""
from repro_torch import checkpoint, fleet

__all__ = ["checkpoint", "fleet"]
