"""Cohort-parallel layout rules: the padded cohort length and the group's size.

Counterpart of the cohort part of ``repro.sharding.rules``
(``padded_cohort``, ``cohort_axis_size``).  Where the reference shards the
cohort over a ``("clients",)`` mesh axis, the port shards it over the ranks
of a ``torch.distributed`` process group, one process a shard; rank r owns
rows ``[r·C_loc, (r+1)·C_loc)`` of the padded cohort.  The rest of the
reference module (the TPU-pod mesh rules) is ROADMAP A.16.
"""
from __future__ import annotations

import torch.distributed as dist


def cohort_axis_size(group) -> int:
    """Validate a cohort process group and return its size (the number of
    shards).  ``group`` is a ``torch.distributed`` process group of this
    process (``dist.group.WORLD`` for the default one)."""
    if not dist.is_initialized():
        raise ValueError("the cohort-parallel engine needs an initialized process group; "
                         "start the ranks with repro_torch.launch.mesh.spawn_cohort "
                         "(CLI: --cohort-shard N)")
    if group is None or dist.get_rank(group) < 0:
        raise ValueError(f"this process is not a member of the cohort group {group!r}")
    return dist.get_world_size(group)


def padded_cohort(capacity: int, n_shards: int) -> int:
    """The padded cohort length: ``capacity`` rounded up to a multiple of
    ``n_shards`` so every rank owns the same number of rows.  Pad rows carry
    zero fold weight (``repro_torch.core.flat.pad_cohort``)."""
    return -(-capacity // n_shards) * n_shards
