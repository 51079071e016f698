"""Mechanical guards of the port's conventions.

Counterpart of ``repro.analysis``, in two layers:

* ``repro_torch.analysis.lint`` — an AST linter over ``src/repro_torch``
  (and, for the import boundary, ``examples/torch`` and ``chip_smoke.py``):
  rules REP001–REP005, inline ``# repro: noqa`` suppression with a reason,
  a checked-in baseline.  ``python -m repro_torch.analysis.lint``.
* ``repro_torch.analysis.trace`` — the round's runtime contracts on tiny
  problems: state planes updated in place, no host transfer in a resident
  round, f32 planes under bf16 params, the ordered scattered fold.
  ``python -m repro_torch.analysis.trace [--quick] [--device cpu]``.

Both exit non-zero on any finding or failed contract.
"""
