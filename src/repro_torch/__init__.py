"""PyTorch / CUDA port of the FedCM federated trainer.

The package mirrors ``repro`` module for module (``repro_torch/core/engine.py``
is the counterpart of ``repro/core/engine.py``, and so on) and imports
nothing of it: the JAX package is the reference this one is tested against.

Ported so far: the round on the flat parameter plane for all eleven
registered algorithms (FedCM, paper Algorithm 2, and its baselines) with the
lossy uplink, synchronous or on the async ring, with per-client state on the
device or in a host population store; the local step and the server folds
as hand-written CUDA kernels (``repro_torch/csrc``); and LM serving
(prefill → decode) for the dense and ssm families, with flash attention and
the SSD scan as CUDA kernels.  Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``; on the CPU every kernel wrapper uses its
plain PyTorch version.
"""
