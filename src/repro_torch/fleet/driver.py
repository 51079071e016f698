"""Fleet driver: glue between the federated round loop and the serving path.

Counterpart of ``repro.fleet.driver``.  ``fed_train --serve`` owns the main
thread (the round chunks — the compute); a ``FleetDriver`` owns everything
around it:

  * the append-only telemetry store (one row per round, from the chunk's
    stacked ``RoundMetrics`` brought to the host in ONE transfer, shared
    with the driver's own log),
  * atomic model publication (``ModelPublisher``: versioned payloads +
    LATEST pointer + bounded retention ring),
  * a serving thread running ``repro_torch.launch.serve.serve_loop`` that
    continuously runs inference steps against the latest published params,
    hot-swapping new versions at step boundaries,
  * the operator health endpoint (``/healthz``, ``/metrics``,
    ``/telemetry/tail``) fed from a shared ``FleetStatus``.

Everything here is observation-only: the driver never touches ``FedState``
or the training generator, and on the card the serving thread runs on its
own ``torch.cuda.Stream``, loading each published version onto the device
on that stream and synchronising it before the first step that uses it —
so a ``--serve`` run's params are bitwise those of the same run without
``--serve``.  The serving thread shares the interpreter with the round,
which is Python launching kernels: its steps are paced (``step_sleep_s``)
and it synchronises its stream once per session.

Lifecycle::

    fleet = FleetDriver(ckpt_dir=..., meta={...})
    fleet.publish(0, params)                    # version 1: the init params
    fleet.start_serving(model.apply, template=params, batch_x=xb)
    for each chunk:
        state, ms = engine.run_rounds(...)
        fleet.record_chunk(start_round=r0, host=metrics_to_host(ms), ...)
        at snapshot boundaries: fleet.publish(r, params)
    summary = fleet.stop()                      # drains swaps, self-probes
                                                # /healthz, writes the
                                                # serve_summary row, closes
"""
from __future__ import annotations

import contextlib
import os
import subprocess
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core.engine import metrics_to_host
from repro_torch.fleet.health import FleetStatus, HealthServer, probe
from repro_torch.fleet.publisher import ModelPublisher, ParamsWatch
from repro_torch.fleet.telemetry import FAULT_COUNTERS, TelemetryStore
from repro_torch.launch.serve import serve_loop


def _git_rev() -> Optional[str]:
    """Best-effort short rev for the telemetry header (None outside a git
    checkout)."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=10,
            cwd=os.path.dirname(os.path.abspath(__file__)),
        )
        return out.stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        return None


class _StreamWatch:
    """A ``ParamsWatch`` whose loads run on the serving stream: a new
    version's host-to-device copies are enqueued there and the stream is
    synchronised before ``poll`` returns, so the version is complete on the
    device before the first step that uses it."""

    def __init__(self, watcher: ParamsWatch, stream) -> None:
        self.watcher = watcher
        self.stream = stream

    def poll(self):
        with torch.cuda.stream(self.stream):
            got = self.watcher.poll()
        if got is not None:
            self.stream.synchronize()
        return got


class FleetDriver:
    """See module docstring.  All methods are called from the training
    (main) thread except the serving loop, which runs on its own daemon
    thread and shares only ``FleetStatus`` (locked) and the publisher
    directory (atomic pointer protocol) with it."""

    def __init__(
        self,
        *,
        ckpt_dir: str,
        telemetry_path: Optional[str] = None,
        publish_dir: Optional[str] = None,
        retain: int = 4,
        deadline_s: float = 120.0,
        health_port: int = 0,
        meta: Optional[Dict[str, Any]] = None,
    ) -> None:
        self.ckpt_dir = str(ckpt_dir)
        self.publish_dir = publish_dir or os.path.join(self.ckpt_dir, "publish")
        self.telemetry = TelemetryStore(
            telemetry_path or os.path.join(self.ckpt_dir, "telemetry.jsonl"),
            meta={"rev": _git_rev(), "deadline_s": float(deadline_s), **(meta or {})},
        )
        self.publisher = ModelPublisher(self.publish_dir, retain=retain)
        self.status = FleetStatus(deadline_s=deadline_s)
        self.health = HealthServer(self.status, self.telemetry.tail, port=health_port)
        self._stop = threading.Event()
        self._serve_thread: Optional[threading.Thread] = None
        self._serve_result: Dict[str, Any] = {}
        self._closed = False

    # ------------------------------------------------------------- publish
    def publish(self, step: int, params: Any) -> int:
        """Atomically publish ``params`` (a model params tree — NOT the whole
        FedState; the serving thread restores it through the model's
        template) and record the publication."""
        version = self.publisher.publish(params, step=int(step))
        self.status.update(published_version=version)
        self.telemetry.event("publish", version=version, step=int(step))
        return version

    # ------------------------------------------------------------- serving
    def start_serving(
        self,
        apply_fn: Any,
        *,
        template: Any,
        batch_x: torch.Tensor,
        steps_per_session: int = 256,
        step_sleep_s: float = 0.002,
        idle_sleep_s: float = 0.0,
    ) -> None:
        """Start the serving thread: continuous inference ("decode") steps
        ``argmax(apply_fn(params, batch_x))`` against the latest published
        params, on ``batch_x``'s device (``template`` is a params tree on
        that device).  Requires at least one prior ``publish`` — random
        init never serves."""
        if self._serve_thread is not None:
            raise RuntimeError("serving thread already started")
        device = batch_x.device
        watcher = ParamsWatch(self.publish_dir, template=template)
        if device.type == "cuda":
            stream = torch.cuda.Stream(device)
            # the batch was written on the training stream: order after it
            stream.wait_stream(torch.cuda.current_stream(device))
            provider = _StreamWatch(watcher, stream)
        else:
            stream, provider = None, watcher

        def on_stream():
            return torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()

        with on_stream():
            x = batch_x.clone()
        got = provider.poll()
        if got is None:
            raise FileNotFoundError(
                f"{self.publish_dir}: publish() the initial params before start_serving()")
        version, params, _ = got
        self.status.update(served_version=version)

        @torch.no_grad()
        def decode_step(p, st, i):
            with on_stream():
                return torch.argmax(apply_fn(p, x), dim=-1)

        def end_session(p, st):
            # one synchronisation per session, not per step
            if stream is not None:
                stream.synchronize()

        def on_swap(v: int, stats) -> None:
            self.status.update(served_version=v, swaps=stats.swaps, serve_steps=stats.steps)

        def run() -> None:
            try:
                if stream is not None:
                    torch.cuda.set_device(device)  # this thread's cuBLAS handle on that card
                _, stats = serve_loop(
                    params, decode_step,
                    end_session=end_session,
                    params_provider=provider,
                    steps_per_session=int(steps_per_session),
                    max_sessions=None,
                    stop_event=self._stop,
                    on_swap=on_swap,
                    idle_sleep_s=float(idle_sleep_s),
                    step_sleep_s=float(step_sleep_s),
                    version=version,
                )
                if stream is not None:
                    stream.synchronize()
            except BaseException as e:  # stop() re-raises it on the main thread
                self._serve_result["error"] = e
                raise
            self.status.update(served_version=stats.served_version,
                               swaps=stats.swaps, serve_steps=stats.steps)
            self._serve_result["stats"] = stats

        self._serve_thread = threading.Thread(target=run, name="fleet-serve", daemon=True)
        self._serve_thread.start()

    # ----------------------------------------------------------- telemetry
    def record_chunk(
        self,
        *,
        start_round: int,
        host: Optional[Dict[str, np.ndarray]] = None,
        ms: Any = None,
        seconds: float,
        eval_acc: Optional[float] = None,
        published_version: Optional[int] = None,
    ) -> Dict[str, np.ndarray]:
        """Fold one chunk's stacked ``RoundMetrics`` into telemetry, one row
        per round.  Pass ``host`` when the caller already fetched the chunk's
        metrics (``metrics_to_host`` — fed_train does, so its one transfer
        per chunk serves its log and the telemetry alike); else pass the
        device-side ``ms`` and the transfer happens here.  ``eval_acc`` (the
        chunk-end cadence eval) and ``published_version`` (the publication
        that followed the chunk, if any) attach to the chunk's LAST round.
        Returns the host-side metrics dict."""
        if host is None:
            host = metrics_to_host(ms)
        n = len(host["loss"])
        rps = round(n / max(seconds, 1e-9), 4)
        for i in range(n):
            last = i == n - 1
            counters = {k: float(host[k][i]) for k in FAULT_COUNTERS if k in host}
            self.telemetry.round_row(
                round=start_round + i + 1,
                rounds_per_s=rps,
                cohort=int(host["n_active"][i]),
                loss=round(float(host["loss"][i]), 6),
                eval_acc=(round(float(eval_acc), 6)
                          if (last and eval_acc is not None) else None),
                published_version=published_version if last else None,
                uplink_bytes=(float(host["bytes_up"][i]) if "bytes_up" in host else None),
                **counters,
            )
        self.status.bump_counters({k: float(np.sum(host[k])) for k in FAULT_COUNTERS
                                   if k in host})
        self.status.round_done(
            start_round + n,
            rounds_per_s=rps,
            cohort=int(host["n_active"][-1]),
            eval_acc=(float(eval_acc) if eval_acc is not None else self.status.eval_acc),
            uplink_bytes=(float(host["bytes_up"][-1]) if "bytes_up" in host else None),
        )
        return host

    # ------------------------------------------------------------ shutdown
    def drain_swaps(self, timeout_s: float = 10.0) -> bool:
        """Wait until the serving thread has swapped onto the newest
        published version (so a publish in the run's final chunk is
        observed under decode load before shutdown)."""
        target = self.publisher.version
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            if self.status.snapshot()["served_version"] >= target:
                return True
            time.sleep(0.01)
        return False

    def stop(self) -> Dict[str, Any]:
        """Drain, stop serving, self-probe /healthz while the endpoint is
        live, write the ``serve_summary`` + ``health_probe`` telemetry rows,
        and close everything.  Returns the summary dict."""
        if self._closed:
            raise RuntimeError("fleet driver already stopped")
        drained = self.drain_swaps()
        stats = None
        if self._serve_thread is not None:
            self._stop.set()
            self._serve_thread.join(timeout=30)
            error = self._serve_result.get("error")
            if error is not None or self._serve_thread.is_alive():
                self.telemetry.close()
                self.health.stop()
                self._closed = True
                raise RuntimeError("the serving thread failed" if error is not None
                                   else "the serving thread did not stop within 30 s") from error
            stats = self._serve_result.get("stats")
        summary: Dict[str, Any] = {"drained": drained}
        if stats is not None:
            summary.update(
                steps=stats.steps, sessions=stats.sessions,
                swaps=stats.swaps, swaps_mid_session=stats.swaps_mid_session,
                swap_steps=stats.swap_steps[:128],
                versions=stats.versions[:128],
                served_version=stats.served_version,
                t_active_s=round(stats.t_active_s, 3),
            )
        self.telemetry.event("serve_summary", **summary)
        code, body = probe(self.health.url)
        self.telemetry.event(
            "health_probe", status=code,
            last_round_age_s=body.get("last_round_age_s"),
            rounds_total=body.get("rounds_total"),
            served_version=body.get("served_version"),
        )
        summary["health_status"] = code
        summary["health"] = body
        self.telemetry.close()
        self.health.stop()
        self._closed = True
        return summary
