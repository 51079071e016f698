"""Snapshots of whole federated runs and of published params, in the
reference's msgpack layout (``repro_torch.checkpoint.ckpt``)."""
from repro_torch.checkpoint.ckpt import (
    latest_step,
    load_checkpoint,
    load_fed_run,
    load_flat,
    save_checkpoint,
    save_fed_run,
)

__all__ = [
    "latest_step",
    "load_checkpoint",
    "load_fed_run",
    "load_flat",
    "save_checkpoint",
    "save_fed_run",
]
