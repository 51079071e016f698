"""Which architecture runs which workload shape (counterpart of the gate in
``repro.launch.dryrun``): ``long_500k`` (B = 1 against a 524,288-deep
cache) is served only by the sub-quadratic archs, ``LONG_OK``;
``skip_reason`` gives the reference's message for the others.

The dry-run itself (each rank's shapes, bytes and collective census of a
mesh layout, computed from ``sharding.rules`` without the cards) is
ROADMAP A.16 (d) 6.
"""
from __future__ import annotations

from typing import Optional

# long_500k: sub-quadratic archs only
LONG_OK = {"mamba2-1.3b", "zamba2-7b", "gemma3-12b", "starcoder2-7b"}


def skip_reason(arch: str, shape_name: str) -> Optional[str]:
    """Why ``arch`` does not run ``shape_name``, or None when it does."""
    if shape_name == "long_500k" and arch not in LONG_OK:
        return "full-attention family: long_500k requires sub-quadratic attention (DESIGN.md §6)"
    return None
