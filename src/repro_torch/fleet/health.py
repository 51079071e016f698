"""Operator-facing health endpoint for a running fleet (stdlib only).

Counterpart of ``repro.fleet.health``, copied near-verbatim.

A tiny ``http.server`` served from a daemon thread; three routes:

  ``/healthz``          round liveness: 200 when the last completed round
                        is younger than the deadline, 503 when the driver
                        has gone quiet (or no round finished yet).  JSON
                        body either way.
  ``/metrics``          Prometheus text exposition of the counters an
                        operator alerts on (fault counters, rounds/s,
                        served/published model versions, swap count).
  ``/telemetry/tail``   last N telemetry rows as JSON (``?n=K``, default
                        32) — served from the store's in-memory ring, no
                        file reads on the request path.

State flows one way: the driver (and the serving thread) push updates
into a ``FleetStatus`` under its lock; request handlers only ever read a
consistent snapshot.  Nothing here touches torch or the card — the endpoint can
never perturb the round (telemetry is observation-only).
"""
from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlparse


class FleetStatus:
    """Thread-safe mutable status snapshot shared driver ↔ endpoint."""

    #: counter fields exported to /metrics (monotone totals over the run)
    COUNTERS = ("n_clipped", "n_dropped", "n_quarantined", "n_retries",
                "quorum_skipped")

    def __init__(self, *, deadline_s: float = 120.0) -> None:
        self._lock = threading.Lock()
        self.started_unix = time.time()
        self.deadline_s = float(deadline_s)
        self.last_round: Optional[int] = None
        self.last_round_unix: Optional[float] = None
        self.rounds_total = 0
        self.rounds_per_s: Optional[float] = None
        self.cohort: Optional[int] = None
        self.counters: Dict[str, float] = {k: 0.0 for k in self.COUNTERS}
        self.published_version = 0
        self.served_version = 0
        self.swaps = 0
        self.serve_steps = 0
        self.eval_acc: Optional[float] = None
        #: last round's total uplink bytes (cohort × per-client wire
        #: bytes) AFTER wire compression — what a fleet operator alerts
        #: on when a compression config regresses (silently shipping f32)
        self.uplink_bytes: Optional[float] = None

    def update(self, **kw: Any) -> None:
        with self._lock:
            for k, v in kw.items():
                if not hasattr(self, k):
                    raise AttributeError(f"unknown status field {k!r}")
                setattr(self, k, v)

    def bump_counters(self, deltas: Dict[str, float]) -> None:
        with self._lock:
            for k, v in deltas.items():
                self.counters[k] = self.counters.get(k, 0.0) + float(v)

    def round_done(self, rnd: int, **kw: Any) -> None:
        with self._lock:
            self.last_round = int(rnd)
            self.last_round_unix = time.time()
            self.rounds_total += 1
            for k, v in kw.items():
                setattr(self, k, v)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            now = time.time()
            age = (now - self.last_round_unix
                   if self.last_round_unix is not None else None)
            fresh = age is not None and age < self.deadline_s
            return {
                "status": "ok" if fresh else "stale",
                "uptime_s": round(now - self.started_unix, 3),
                "last_round": self.last_round,
                "last_round_age_s": round(age, 3) if age is not None else None,
                "round_deadline_s": self.deadline_s,
                "rounds_total": self.rounds_total,
                "rounds_per_s": self.rounds_per_s,
                "cohort": self.cohort,
                "eval_acc": self.eval_acc,
                "uplink_bytes": self.uplink_bytes,
                "counters": dict(self.counters),
                "published_version": self.published_version,
                "served_version": self.served_version,
                "swaps": self.swaps,
                "serve_steps": self.serve_steps,
            }


def _prometheus(snap: Dict[str, Any]) -> str:
    lines = []

    def emit(name: str, value, help_: str) -> None:
        if value is None:
            return
        lines.append(f"# HELP fleet_{name} {help_}")
        lines.append(f"# TYPE fleet_{name} gauge")
        lines.append(f"fleet_{name} {float(value)}")

    emit("up", 1.0 if snap["status"] == "ok" else 0.0,
         "1 when the last round is within the liveness deadline")
    emit("rounds_total", snap["rounds_total"], "completed training rounds")
    emit("last_round_age_seconds", snap["last_round_age_s"],
         "seconds since the last completed round")
    emit("rounds_per_second", snap["rounds_per_s"],
         "round throughput of the most recent fused chunk")
    emit("cohort_size", snap["cohort"], "active cohort of the last round")
    emit("eval_accuracy", snap["eval_acc"], "last cadence eval accuracy")
    emit("uplink_bytes", snap["uplink_bytes"],
         "total uplink payload bytes of the last round, after wire compression")
    for k, v in snap["counters"].items():
        emit(f"{k}_total", v, f"cumulative RoundMetrics.{k} over the run")
    emit("published_model_version", snap["published_version"],
         "latest version published to the serving ring")
    emit("served_model_version", snap["served_version"],
         "version the serving loop currently decodes against")
    emit("hot_swaps_total", snap["swaps"],
         "checkpoint hot-swaps taken by the serving loop")
    emit("serve_steps_total", snap["serve_steps"],
         "decode steps executed by the serving loop")
    return "\n".join(lines) + "\n"


class _Handler(BaseHTTPRequestHandler):
    # injected by make_health_server via type()
    status: FleetStatus
    tail_fn: Callable[[int], List[Dict[str, Any]]]

    def log_message(self, fmt, *args):  # silence per-request stderr spam
        pass

    def _send(self, code: int, body: str, ctype: str) -> None:
        data = body.encode()
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self) -> None:  # noqa: N802 (http.server API)
        url = urlparse(self.path)
        snap = self.status.snapshot()
        if url.path == "/healthz":
            code = 200 if snap["status"] == "ok" else 503
            self._send(code, json.dumps(snap, indent=1), "application/json")
        elif url.path == "/metrics":
            self._send(200, _prometheus(snap), "text/plain; version=0.0.4")
        elif url.path == "/telemetry/tail":
            q = parse_qs(url.query)
            try:
                n = int(q.get("n", ["32"])[0])
            except ValueError:
                self._send(400, '{"error": "n must be an integer"}',
                           "application/json")
                return
            self._send(200, json.dumps(self.tail_fn(n), indent=1),
                       "application/json")
        else:
            self._send(404, '{"error": "unknown route", "routes": '
                            '["/healthz", "/metrics", "/telemetry/tail"]}',
                       "application/json")


class HealthServer:
    """``ThreadingHTTPServer`` on a daemon thread; ``port=0`` binds an
    ephemeral port (read it back from ``.port`` — how tests and the
    driver's self-probe find the endpoint)."""

    def __init__(self, status: FleetStatus,
                 tail_fn: Optional[Callable[[int], List[Dict]]] = None,
                 *, host: str = "127.0.0.1", port: int = 0) -> None:
        handler = type("FleetHandler", (_Handler,), {
            "status": status, "tail_fn": tail_fn or (lambda n: []),
        })
        self._server = ThreadingHTTPServer((host, port), handler)
        self._server.daemon_threads = True
        self.host = host
        self.port = int(self._server.server_address[1])
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="fleet-health", daemon=True
        )
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5)


def probe(url: str, route: str = "/healthz",
          timeout: float = 5.0) -> Tuple[int, Dict[str, Any]]:
    """GET ``url + route`` → ``(http_status, parsed_body)``.  Accepts the
    503-stale response without raising (that IS the signal)."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url + route, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())
