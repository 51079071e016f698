"""Fleet subsystem: continuous rounds → serving, with telemetry + health.

Counterpart of ``repro.fleet``, the round-to-serving loop of the production
FL service:

  * ``telemetry``  — append-only fsync-atomic JSONL store, one row/round
  * ``publisher``  — atomic versioned model publication + watch()
  * ``health``     — /healthz, /metrics, /telemetry/tail HTTP endpoint
  * ``driver``     — FleetDriver wiring it into ``fed_train --serve``
  * ``check``      — CLI asserting a replayed telemetry stream's invariants
"""
from repro_torch.fleet.health import FleetStatus, HealthServer, probe
from repro_torch.fleet.publisher import (
    ModelPublisher,
    ParamsWatch,
    load_published,
    read_pointer,
    watch,
)
from repro_torch.fleet.telemetry import (
    FAULT_COUNTERS,
    ROUND_FIELDS,
    TELEMETRY_SCHEMA,
    TelemetryStore,
    events,
    replay,
    round_rows,
)

__all__ = [
    "FAULT_COUNTERS",
    "FleetStatus",
    "HealthServer",
    "ModelPublisher",
    "ParamsWatch",
    "ROUND_FIELDS",
    "TELEMETRY_SCHEMA",
    "TelemetryStore",
    "events",
    "load_published",
    "probe",
    "read_pointer",
    "replay",
    "round_rows",
    "watch",
]
