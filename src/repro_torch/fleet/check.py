"""Replay-based telemetry checker — the fleet CI smoke's assertion half.

Counterpart of ``repro.fleet.check``, copied near-verbatim.

``fed_train --serve`` leaves a telemetry JSONL behind; this CLI replays
it (through the same ``replay()`` reader operators would use) and asserts
the invariants the subsystem promises:

  * header schema matches, stream replays (torn final line tolerated),
  * >= ``--min-rounds`` round rows with strictly increasing round index,
  * published versions strictly monotone,
  * >= ``--min-swaps`` hot-swaps taken WHILE DECODE WAS ACTIVE
    (``serve_summary.swaps_mid_session`` — a swap at step>0 of a serving
    session, i.e. between two decode steps of a live session),
  * with ``--require-health``: the in-run /healthz self-probe returned
    200 with a last-round age inside the liveness deadline.

Exit 0 when everything holds, 1 with a named failure otherwise::

    PYTHONPATH=src python -m repro_torch.fleet.check telemetry.jsonl \
        --min-rounds 6 --min-swaps 2 --require-health
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List

from repro_torch.fleet.telemetry import events, replay, round_rows


def check(path: str, *, min_rounds: int = 1, min_swaps: int = 0,
          require_health: bool = False) -> List[str]:
    """Returns a list of human-readable failures (empty = pass)."""
    fails: List[str] = []
    try:
        header, rows, truncated = replay(path)
    except (OSError, ValueError) as e:
        return [f"replay failed: {e}"]
    rnds = round_rows(rows)
    if len(rnds) < min_rounds:
        fails.append(f"only {len(rnds)} round rows (need >= {min_rounds})")
    idx = [r["round"] for r in rnds]
    if any(b <= a for a, b in zip(idx, idx[1:])):
        fails.append(f"round indices not strictly increasing: {idx}")
    if any(r.get("rounds_per_s") is None or r["rounds_per_s"] <= 0
           for r in rnds):
        fails.append("round row missing a positive rounds_per_s")
    # wire accounting: every round must report what it actually shipped
    # per client — None or 0 means the engine's payload accounting broke
    # (a compression regression would also show up here as f32-sized rows)
    if any(r.get("uplink_bytes") is None or r["uplink_bytes"] <= 0
           for r in rnds):
        fails.append("round row missing positive uplink_bytes")
    pubs = [e["version"] for e in events(rows, "publish")]
    if any(b <= a for a, b in zip(pubs, pubs[1:])):
        fails.append(f"published versions not strictly monotone: {pubs}")
    summaries = events(rows, "serve_summary")
    if min_swaps > 0:
        if not summaries:
            fails.append("no serve_summary row (serving never ran?)")
        else:
            s = summaries[-1]
            live = s.get("swaps_mid_session", 0)
            if live < min_swaps:
                fails.append(
                    f"{live} hot-swaps under decode load "
                    f"(need >= {min_swaps}; total swaps: {s.get('swaps', 0)})"
                )
            versions = s.get("versions", [])
            if any(b <= a for a, b in zip(versions, versions[1:])):
                fails.append(f"served versions not strictly monotone: {versions}")
    if require_health:
        probes = events(rows, "health_probe")
        ok = [p for p in probes if p.get("status") == 200]
        if not ok:
            fails.append(
                f"no 200 health probe (probes: "
                f"{[p.get('status') for p in probes]})"
            )
        else:
            age = ok[-1].get("last_round_age_s")
            deadline = header.get("meta", {}).get("deadline_s")
            if age is None:
                fails.append("health probe carried no last-round age")
            elif deadline is not None and age >= deadline:
                fails.append(
                    f"health probe age {age}s is past the {deadline}s deadline"
                )
    if truncated:
        # informational, not a failure — a preempted run's artifact is
        # still valid up to its last complete row
        print(f"note: {path} ends in a torn final line (tolerated)",
              file=sys.stderr)
    return fails


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("path")
    ap.add_argument("--min-rounds", type=int, default=1)
    ap.add_argument("--min-swaps", type=int, default=0)
    ap.add_argument("--require-health", action="store_true")
    ap.add_argument("--json", default="",
                    help="also write a {passed, failures, n_rounds} report")
    args = ap.parse_args(argv)
    fails = check(args.path, min_rounds=args.min_rounds,
                  min_swaps=args.min_swaps,
                  require_health=args.require_health)
    if args.json:
        header, rows, _ = replay(args.path)
        with open(args.json, "w") as f:
            json.dump({"passed": not fails, "failures": fails,
                       "n_rounds": len(round_rows(rows)),
                       "rev": header.get("meta", {}).get("rev")}, f, indent=1)
    if fails:
        for msg in fails:
            print(f"FAIL: {msg}", file=sys.stderr)
        return 1
    print(f"ok: {args.path} replays clean")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
