"""Append-only, fsync-atomic JSONL telemetry store — one row per round.

Counterpart of ``repro.fleet.telemetry``, copied near-verbatim (stdlib only):
the schema is the contract between the two packages, so a stream either one
writes replays in the other.

Production FL is a *service*: operators watch per-round health live
(rounds/s, cohort size, the fault counters, eval curves at cadence,
checkpoint publications) rather than reading a benchmark artifact after
the fact.  This store is the machine-checkable record of that stream.

Layout (one JSON object per line):

  line 0   header   {"schema": TELEMETRY_SCHEMA, "kind": "fleet-telemetry",
                     "created_unix": ..., "meta": {...}}
  line 1+  rows     {"event": "round", "round": 3, ...}        (per round)
                    {"event": "publish", "version": 2, ...}    (per publish)
                    {"event": "health_probe", "status": 200, ...}
                    {"event": "serve_summary", "swaps": 3, ...} (at stop)

Durability contract: every ``append`` is ``write + flush + fsync`` of one
``\\n``-terminated line on an ``O_APPEND`` descriptor, so a kill at ANY
point leaves at most one torn final line.  ``replay`` tolerates exactly
that — a non-parsing or unterminated final line is dropped and reported
via ``truncated=True``, never raised — which is what makes the file a
valid resume/CI artifact after a preemption (same contract as ckpt.py's
tmp+fsync+rename, adapted to an append-only stream).

Schema versioning: readers MUST check ``header["schema"]``; bumping
``TELEMETRY_SCHEMA`` is the signal that row fields changed meaning.  The
per-round field set is exported as ``ROUND_FIELDS`` / ``FAULT_COUNTERS``
so the driver's rows and the tests name one set.
"""
from __future__ import annotations

import json
import os
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

#: bump on any change to row field semantics; replay() refuses mismatches
TELEMETRY_SCHEMA = 1

#: the RoundMetrics degradation counters a round row carries — brought
#: off the device once per chunk (one transfer, not one per round).  Kept
#: in one place so the driver's rows and the tests name the same set.
FAULT_COUNTERS: Tuple[str, ...] = (
    "n_clipped", "n_dropped", "n_quarantined", "n_retries", "quorum_skipped",
)

#: full per-round row schema (event == "round").  ``eval_acc`` is null on
#: off-cadence rounds; ``published_version`` is null on rounds without a
#: checkpoint publication.  ``uplink_bytes`` is the round's TOTAL uplink
#: payload in bytes (active clients × per-client wire bytes) AFTER wire
#: compression (repro_torch.core.compress) — the operator-visible record that a
#: compression config actually shrank the wire.  Additive: rows stay
#: schema-1 (existing readers key by name).
ROUND_FIELDS: Tuple[str, ...] = (
    "event", "round", "t_unix", "rounds_per_s", "cohort", "loss",
    "eval_acc", "published_version", "uplink_bytes",
) + FAULT_COUNTERS


class TelemetryStore:
    """Writer half.  Create (or resume) a JSONL stream and append rows.

    ``resume=True`` appends to an existing file after validating its
    header (schema mismatch raises); otherwise an existing file is
    truncated and a fresh header written.  ``tail(n)`` returns the last
    ``n`` rows appended by THIS process (in-memory ring; the health
    endpoint serves it without touching the file)."""

    def __init__(self, path: str, *, meta: Optional[Dict[str, Any]] = None,
                 resume: bool = False, tail_size: int = 256) -> None:
        self.path = str(path)
        self._tail: deque = deque(maxlen=tail_size)
        os.makedirs(os.path.dirname(os.path.abspath(self.path)), exist_ok=True)
        if resume and os.path.exists(self.path):
            header, _, _ = replay(self.path)
            self.header = header
            self._fd = os.open(self.path, os.O_WRONLY | os.O_APPEND)
        else:
            self.header = {
                "schema": TELEMETRY_SCHEMA,
                "kind": "fleet-telemetry",
                "created_unix": time.time(),
                "meta": dict(meta or {}),
            }
            self._fd = os.open(
                self.path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC | os.O_APPEND,
                0o644,
            )
            self._write_line(self.header)

    def _write_line(self, obj: Dict[str, Any]) -> None:
        data = (json.dumps(obj, separators=(",", ":"),
                           allow_nan=False) + "\n").encode()
        os.write(self._fd, data)
        os.fsync(self._fd)

    def append(self, row: Dict[str, Any]) -> None:
        """Append one row durably (write+fsync of a single line)."""
        if self._fd is None:
            raise ValueError("telemetry store is closed")
        self._write_line(row)
        self._tail.append(row)

    def round_row(self, **kw: Any) -> Dict[str, Any]:
        """Build + append a schema-complete per-round row: every field in
        ``ROUND_FIELDS`` present (missing → None), unknown kwargs refused
        so the row schema cannot silently drift from the exported one."""
        unknown = set(kw) - set(ROUND_FIELDS)
        if unknown:
            raise ValueError(f"unknown round-row fields: {sorted(unknown)}")
        row = {f: kw.get(f) for f in ROUND_FIELDS}
        row["event"] = "round"
        if row.get("t_unix") is None:
            row["t_unix"] = time.time()
        self.append(row)
        return row

    def event(self, kind: str, **kw: Any) -> Dict[str, Any]:
        row = {"event": kind, "t_unix": time.time(), **kw}
        self.append(row)
        return row

    def tail(self, n: int = 32) -> List[Dict[str, Any]]:
        return list(self._tail)[-max(0, int(n)):]

    def close(self) -> None:
        if self._fd is not None:
            os.fsync(self._fd)
            os.close(self._fd)
            self._fd = None

    def __enter__(self) -> "TelemetryStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def replay(path: str) -> Tuple[Dict[str, Any], List[Dict[str, Any]], bool]:
    """Read a telemetry stream back → ``(header, rows, truncated)``.

    Tolerant of exactly the failure the writer can leave behind: a torn
    FINAL line (unterminated, or terminated-but-unparseable after a torn
    write raced a kill) is dropped and reported as ``truncated=True``.  A
    torn line anywhere ELSE — or a header with the wrong schema/kind —
    is corruption, not preemption, and raises."""
    with open(path, "rb") as f:
        raw = f.read()
    lines = raw.split(b"\n")
    # a well-formed file ends "…}\n" → final split element is empty; a
    # torn final line shows up as a non-empty last element
    unterminated = lines and lines[-1] != b""
    if lines and lines[-1] == b"":
        lines = lines[:-1]
    if not lines:
        raise ValueError(f"{path}: empty telemetry file (no header)")
    parsed: List[Dict[str, Any]] = []
    truncated = False
    for i, line in enumerate(lines):
        is_last = i == len(lines) - 1
        try:
            parsed.append(json.loads(line))
        except (json.JSONDecodeError, UnicodeDecodeError):
            if is_last:
                truncated = True
                break
            raise ValueError(
                f"{path}: corrupt (non-final) telemetry line {i}"
            ) from None
        if is_last and unterminated:
            # parsed but never fsync-terminated: the durability contract
            # only covers complete lines — treat it as torn
            parsed.pop()
            truncated = True
    if not parsed:
        raise ValueError(f"{path}: header line is torn — nothing to replay")
    header, rows = parsed[0], parsed[1:]
    if header.get("kind") != "fleet-telemetry":
        raise ValueError(f"{path}: not a fleet telemetry stream: {header!r}")
    if header.get("schema") != TELEMETRY_SCHEMA:
        raise ValueError(
            f"{path}: telemetry schema {header.get('schema')!r} != "
            f"reader schema {TELEMETRY_SCHEMA}"
        )
    return header, rows, truncated


def round_rows(rows: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """The per-round subset of a replayed stream, in append order."""
    return [r for r in rows if r.get("event") == "round"]


def events(rows: List[Dict[str, Any]], kind: str) -> List[Dict[str, Any]]:
    return [r for r in rows if r.get("event") == kind]
