"""Minimal structured metric logging (CSV / stdout), no external deps."""
from __future__ import annotations

import csv
import sys
import time
from typing import Any, Dict, Iterable, List, Optional


class MetricLogger:
    """Collects rows of metrics; prints to stdout and optionally writes CSV.

    Usage::

        log = MetricLogger(["round", "algo", "test_acc"], csv_path="out.csv")
        log.log(round=0, algo="fedcm", test_acc=0.21)
        log.close()
    """

    def __init__(
        self,
        fields: Iterable[str],
        csv_path: Optional[str] = None,
        echo: bool = True,
        echo_every: int = 1,
    ) -> None:
        self.fields: List[str] = list(fields)
        self.rows: List[Dict[str, Any]] = []
        self.echo = echo
        self.echo_every = max(1, echo_every)
        self._t0 = time.time()
        self._csv_file = None
        self._writer = None
        if csv_path is not None:
            self._csv_file = open(csv_path, "w", newline="")
            self._writer = csv.DictWriter(self._csv_file, fieldnames=self.fields)
            self._writer.writeheader()

    def log(self, **kwargs: Any) -> None:
        row = {k: kwargs.get(k) for k in self.fields}
        self.rows.append(row)
        if self._writer is not None:
            self._writer.writerow(row)
            self._csv_file.flush()
        if self.echo and (len(self.rows) - 1) % self.echo_every == 0:
            msg = " ".join(
                f"{k}={_fmt(row[k])}" for k in self.fields if row[k] is not None
            )
            print(f"[{time.time() - self._t0:8.1f}s] {msg}", file=sys.stderr)

    def last(self) -> Dict[str, Any]:
        return self.rows[-1]

    def column(self, field: str) -> List[Any]:
        return [r[field] for r in self.rows]

    def close(self) -> None:
        if self._csv_file is not None:
            self._csv_file.close()
            self._csv_file = None
            self._writer = None


def _fmt(v: Any) -> str:
    if isinstance(v, float):
        return f"{v:.4f}"
    return str(v)
