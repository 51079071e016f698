"""Cohort-parallel layout rules (``repro_torch.sharding.rules``)."""
from repro_torch.sharding.rules import cohort_axis_size, padded_cohort

__all__ = ["cohort_axis_size", "padded_cohort"]
