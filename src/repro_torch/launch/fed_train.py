"""Federated training driver of the port: FedCM and every registered baseline.

Counterpart of ``repro.launch.fed_train`` run with ``--fused-kernel``:
Dirichlet-partitioned synthetic classification, an MLP 32-128-128-10, the
paper's scaled Setting I defaults, every local step and server fold through
the hand-written CUDA kernels.  ``--algo`` takes any registered algorithm
(``--list-algos`` prints each one's state planes, kernel routing and
uplink bytes).  ``--uplink-compress`` sends the uplink as int8, bf16 or
top-k, and the ``--fault-*`` flags inject drops, stragglers, corrupted
uplinks (quarantined before the fold) and host-store failures.
``--pipeline-depth`` / ``--staleness`` (or ``--async``) run the async
ring; ``--population-store host`` keeps per-client state in a host store
and streams each sampled client's shard (``StreamingClientData``), so
``--clients 1000000`` is a literal setting.  ``--ckpt-every`` writes an
atomic whole-run snapshot (``repro_torch.checkpoint``) every N rounds,
``--resume`` continues the latest one bitwise and ``--die-after`` kills the
run (exit code 75) right after a snapshot; ``--serve`` adds the fleet loop
(``repro_torch.fleet``): each snapshot's params are published, a serving
thread hot-swaps them, one telemetry row a round, and a health endpoint.
``--cohort-shard N`` spawns N ranks that shard each cohort between them
(``repro_torch.launch.mesh``): NCCL on ``cuda:0`` … ``cuda:N−1``, or gloo
with ``--device cpu``; rank 0 prints the log, line for line the unsharded
run's, and under ``--serve`` runs the fleet loop while the others step.
``--no-flat-plane`` runs the per-leaf tree path (the reference's oracle
route, no kernel launched); it refuses what the reference refuses there,
and the snapshot and fleet flags.  Runs on ``cuda`` and raises when there is no GPU, unless ``--device cpu``
asks for the CPU (the kernels' plain versions).

    PYTHONPATH=src python -m repro_torch.launch.fed_train --algo fedcm \
        --clients 100 --cohort 10 --rounds 100 --dirichlet 0.6
    PYTHONPATH=src python -m repro_torch.launch.fed_train --algo scaffold \
        --uplink-compress int8 --fault-drop-rate 0.1 --fault-corrupt-rate 0.1
    PYTHONPATH=src python -m repro_torch.launch.fed_train --pipeline-depth 2 --staleness 1 \
        --staleness-discount 0.9
    PYTHONPATH=src python -m repro_torch.launch.fed_train --population-store host \
        --clients 1000000 --algo scaffold --availability zipf --dropout-rate 0.1
    PYTHONPATH=src python -m repro_torch.launch.fed_train --rounds 20 --ckpt-every 10 \
        --ckpt-dir runs/a --die-after 10          # exits 75; add --resume to go on
    PYTHONPATH=src python -m repro_torch.launch.fed_train --rounds 20 --ckpt-every 5 \
        --ckpt-dir runs/fleet --serve
    PYTHONPATH=src python -m repro_torch.launch.fed_train --cohort-shard 4 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.fed_train --no-flat-plane --algo scaffold
    PYTHONPATH=src python -m repro_torch.launch.fed_train --list-algos
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import latest_step, load_fed_run, save_fed_run
from repro_torch.configs.base import CompressionConfig, FaultConfig, FedConfig
from repro_torch.core.compress import (
    effective_compression, uplink_bytes_per_client, validate_compression,
)
from repro_torch.core.engine import (
    FederatedEngine,
    make_eval_fn,
    metrics_to_host,
    resolve_device,
)
from repro_torch.core.flat import FlatSpec
from repro_torch.core.registry import describe_algorithm, get_algorithm, list_algorithms
from repro_torch.data import FederatedData, StreamingClientData, make_synthetic_classification
from repro_torch.data.population import AVAILABILITY_PROCESSES, POPULATION_STORES
from repro_torch.launch.mesh import RankFailure, spawn_cohort
from repro_torch.models.small import classification_loss, mlp_classifier
from repro_torch.utils.metrics import MetricLogger

PREEMPTED = 75  # --die-after's exit code
# a sharded run's world: each collective may wait this long for a slow or
# dead rank, and the whole run may take this long
SHARD_TIMEOUT_S = 600.0
SHARD_DEADLINE_S = 7 * 24 * 3600.0


def build_federated(cfg: FedConfig, dirichlet: float, *, dim: int = 32, n_classes: int = 10,
                    n_train: int = 50_000, n_test: int = 10_000, batch_size: int = 50,
                    hidden: int = 128, seed: int = 0, device="cuda"):
    """What ``run_federated`` builds before its first round: ``(data, model,
    params, engine, x_test, y_test)``, the clients' data on ``device`` (or
    streamed from the host store), the MLP and its params drawn on the CPU
    from ``seed``, the engine, and the test set on ``device``.  The
    dry-run of the main path (``launch.fed_dryrun.run_classifier``) builds
    the same on fake tensors."""
    if cfg.population_store == "host":
        data = StreamingClientData(cfg.num_clients, dim=dim, n_classes=n_classes, seed=seed)
        x_te, y_te = data.test_set(min(n_test, 2_000))
    else:
        x_tr, y_tr, x_te, y_te = make_synthetic_classification(
            n_classes=n_classes, dim=dim, n_train=n_train, n_test=n_test, seed=seed
        )
        data = FederatedData(x_tr, y_tr, cfg.num_clients, dirichlet_alpha=dirichlet,
                             seed=seed, device=device)
    model = mlp_classifier((dim, hidden, hidden, n_classes))
    params = model.init(torch.Generator().manual_seed(seed))
    eng = FederatedEngine(cfg, classification_loss(model.apply), FlatSpec.from_tree(params),
                          batch_size=batch_size, device=device)
    return (data, model, params, eng, torch.as_tensor(x_te, device=device),
            torch.as_tensor(y_te, device=device).long())


def run_federated(
    cfg: FedConfig,
    dirichlet: float,
    *,
    dim: int = 32,
    n_classes: int = 10,
    n_train: int = 50_000,
    n_test: int = 10_000,
    batch_size: int = 50,
    hidden: int = 128,
    eval_every: int = 25,
    seed: int = 0,
    echo: bool = True,
    device="cuda",
    async_pipeline: bool = False,
    ckpt_every: int = 0,
    ckpt_dir: str = "",
    resume: bool = False,
    die_after: int = 0,
    serve: bool = False,
    health_port: int = 0,
    round_deadline_s: float = 120.0,
    telemetry_path: str = "",
    publish_retain: int = 4,
):
    """Returns (final_test_acc, history MetricLogger).

    Sync: rounds run in chunks of ``eval_every``; after each chunk the test
    set is evaluated and the chunk's last round is logged.  Async (the ring,
    when ``async_pipeline`` or ``cfg.pipeline_depth > 1`` or
    ``cfg.staleness > 0``): one ``run_rounds_async`` call evaluates on the
    cadence inside the loop and logs each evaluated round; with the host
    store it evaluates once, at the end.  Under ``population_store="host"``
    the clients' shards stream from ``StreamingClientData`` (label skew
    replaces the Dirichlet partition) and its iid test split is the test
    set.  Weights are drawn on the CPU from ``seed`` (so they do not depend
    on the device) and the round draws from a generator on ``device``
    seeded with ``seed + 1``.

    Sync only: ``ckpt_every`` > 0 writes an atomic whole-run snapshot
    (``save_fed_run``: the state, the generator, the host stores) to
    ``ckpt_dir`` every N rounds, with the chunks aligned to the snapshot
    boundaries; ``resume`` restores the latest one (``restore_run``) and
    continues the trajectory bitwise; ``die_after`` R ends the process with
    exit code 75 right after the first snapshot at round ≥ R.  ``serve``
    adds the fleet loop (``repro_torch.fleet.FleetDriver``): version 1 is
    the params entering the run, each snapshot's params are published, a
    serving thread hot-swaps them between inference steps, one telemetry
    row a round and a health endpoint.  Fleet is observation-only: the
    params are bitwise those of the same run without it.

    ``cfg.cohort_shard`` > 0: this process is one rank of a cohort world
    (``main`` spawns them; the state is replicated), and rank 0 alone
    writes the snapshots, every rank passing a barrier after each; a
    resume reads the same file on every rank.  Under ``serve`` rank 0 is
    also the fleet (the publisher, the serving thread, the telemetry and
    the health endpoint); the other ranks only step."""
    dev = resolve_device(device)
    data, model, params, eng, x_te_t, y_te_t = build_federated(
        cfg, dirichlet, dim=dim, n_classes=n_classes, n_train=n_train, n_test=n_test,
        batch_size=batch_size, hidden=hidden, seed=seed, device=dev)
    spec = eng.spec
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    state = eng.init(params, gen)
    evaluate = make_eval_fn(model.apply)

    log = MetricLogger(
        ["round", "algo", "loss", "test_acc", "n_active", "mb_down", "mb_up",
         "dropped", "quar", "retries", "qskip"],
        echo=echo, echo_every=1,
    )

    def log_row(r, host, i, acc, upto):
        """Log round ``r`` from row ``i`` of the host metrics; the fault
        counters sum rows ``[0, upto)`` (the chunk, or the run so far)."""
        log.log(round=r, algo=cfg.algo, loss=round(float(host["loss"][i]), 4),
                test_acc=round(acc, 4), n_active=int(host["n_active"][i]),
                mb_down=round(float(host["bytes_down"][i]) / 2**20, 2),
                mb_up=round(float(host["bytes_up"][i]) / 2**20, 2),
                dropped=int(host["n_dropped"][:upto].sum()),
                quar=int(host["n_quarantined"][:upto].sum()),
                retries=int(host["n_retries"][:upto].sum()),
                qskip=int(host["quorum_skipped"][:upto].sum()))

    if async_pipeline or cfg.pipeline_depth > 1 or cfg.staleness > 0:
        if ckpt_every > 0 or resume or serve:
            raise ValueError("snapshots, resume and the fleet loop run on sync rounds; "
                             "the async ring has no snapshot of the cohorts in flight")
        if cfg.population_store == "host":
            # the host loop has no in-loop eval: evaluate once at the end
            state, ms = eng.run_rounds_async(state, data, cfg.rounds)
            acc = evaluate(eng.params_tree(state), x_te_t, y_te_t)
            host = metrics_to_host(ms)
            log_row(cfg.rounds, host, -1, acc, cfg.rounds)
            return acc, log
        state, ms = eng.run_rounds_async(state, data, cfg.rounds, eval_every=eval_every,
                                         eval_data=(x_te_t, y_te_t), predict_fn=model.apply)
        host = metrics_to_host(ms)  # one transfer for the whole run
        acc = 0.0
        for i in np.flatnonzero(host["eval_acc"] >= 0.0):
            acc = float(host["eval_acc"][i])
            log_row(int(i) + 1, host, i, acc, i + 1)
        if cfg.pipeline_depth > 1 or cfg.rounds % eval_every:
            # the drain folded the cohorts still in flight after the last
            # in-loop eval (or the run ended off the cadence)
            acc = evaluate(eng.params_tree(state), x_te_t, y_te_t)
        return acc, log
    acc, r = 0.0, 0
    if resume:
        state, r = restore_run(eng, state, ckpt_dir, seed)
    fleet = None
    if serve and eng.cohort_rank == 0:
        from repro_torch.fleet.driver import FleetDriver

        fleet = FleetDriver(
            ckpt_dir=ckpt_dir, telemetry_path=telemetry_path or None, retain=publish_retain,
            deadline_s=round_deadline_s, health_port=health_port,
            meta={"algo": cfg.algo, "rounds": cfg.rounds, "num_clients": cfg.num_clients,
                  "cohort_size": cfg.cohort_size, "ckpt_every": ckpt_every, "resumed_at": r})
        # version 1 = the params entering the run: the serving thread never
        # serves unpublished (random) weights
        fleet.publish(r, spec.unravel(state.params.cpu()))
        fleet.start_serving(model.apply, template=spec.unravel(state.params),
                            batch_x=x_te_t[:min(128, x_te_t.shape[0])])
        print(f"fleet: serving + health at {fleet.health.url} "
              f"(telemetry: {fleet.telemetry.path})")
    while r < cfg.rounds:
        chunk = min(eval_every, cfg.rounds - r)
        if ckpt_every > 0:
            # chunks end on snapshot boundaries, so a resumed run runs the
            # same chunks relative to the absolute round
            chunk = min(chunk, ckpt_every * (r // ckpt_every + 1) - r)
        t0 = time.perf_counter()
        state, ms = eng.run_rounds(state, data, chunk)
        host = metrics_to_host(ms)  # one transfer per chunk, for the log and telemetry
        dt = time.perf_counter() - t0
        r += chunk
        acc = evaluate(eng.params_tree(state), x_te_t, y_te_t)
        version = None
        snapshot = ckpt_every > 0 and (r % ckpt_every == 0 or r >= cfg.rounds)
        if snapshot:
            if eng.cohort_rank == 0:
                save_fed_run(ckpt_dir, r, state, spec, population=_inner(eng.population),
                             residuals=_inner(eng.residual_population))
            if eng.cohort_group is not None:
                dist.barrier(eng.cohort_group)
            if fleet is not None:
                version = fleet.publish(r, spec.unravel(state.params.cpu()))
        if fleet is not None:
            fleet.record_chunk(start_round=r - chunk, host=host, seconds=dt, eval_acc=acc,
                               published_version=version)
        log_row(r, host, -1, acc, chunk)
        if snapshot and 0 < die_after <= r:
            # preemption: no clean-up, no atexit; the snapshot just written
            # (and the telemetry rows, already fsynced) is all a resume has
            os._exit(PREEMPTED)
    if fleet is not None:
        summary = fleet.stop()
        print(f"fleet: {summary.get('swaps', 0)} hot-swaps "
              f"({summary.get('swaps_mid_session', 0)} under decode load) over "
              f"{summary.get('steps', 0)} decode steps; health={summary.get('health_status')}")
    return acc, log


def _inner(store):
    """The plain store under a ``FaultyStore`` (None stays None)."""
    return getattr(store, "inner", store)


def restore_run(eng: FederatedEngine, state, ckpt_dir: str, seed: int):
    """Restore the latest snapshot of ``ckpt_dir`` into ``eng`` →
    ``(state, round)``.  ``state`` (the fresh ``eng.init``) fixes the planes
    and the device.  Store rows are assigned straight into the engine's
    stores, past any ``FaultyStore``, so the restore itself cannot fail.  A
    snapshot the reference wrote carries a threefry key that torch cannot
    continue: the generator is then seeded from ``seed`` and the round, and
    the draws from there on are the port's own."""
    step = latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"--resume: no checkpoints in {ckpt_dir!r}")
    state, population, residuals, meta = load_fed_run(ckpt_dir, step, state, eng.spec,
                                                      num_clients=eng.cfg.num_clients)
    for name, store, rows in (("population", eng.population, population),
                              ("residuals", eng.residual_population, residuals)):
        if store is None:
            continue
        if rows is None:
            raise ValueError(f"--resume: {ckpt_dir}/step_{step}.msgpack has no {name} "
                             f"store, which this run keeps on the host")
        _inner(store)._rows = rows._rows
    if state.rng is None:
        gen = torch.Generator(device=state.params.device)
        gen.manual_seed(seed + 1 + step)
        print(f"--resume: {ckpt_dir}/step_{step}.msgpack carries the reference's threefry "
              f"key, which torch cannot continue; the draws from round {step} on are the "
              f"port's own (generator seeded with {seed + 1 + step})")
        state = state._replace(rng=gen)
    return state, int(meta["step"])


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if n < 1024 or unit == "GiB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{n:.0f} B"
        n /= 1024
    return f"{n:.1f} GiB"


def list_algos_text(dim: int = 32, hidden: int = 128, n_classes: int = 10,
                    compression: "CompressionConfig | None" = None) -> str:
    """One line per registered algorithm: the routing row of
    ``describe_algorithm`` (local step, server fold, state planes, uplink
    planes) and the per-client uplink bytes a round for this driver's
    model, priced by the engine's own accounting under ``compression``."""
    P = FlatSpec.from_tree(mlp_classifier((dim, hidden, hidden, n_classes)).init(
        torch.Generator().manual_seed(0))).size
    rows = []
    for n in list_algorithms():
        spec = get_algorithm(n)
        r = describe_algorithm(spec)
        comp = compression or effective_compression(FedConfig(), spec)
        up = uplink_bytes_per_client(comp, spec.wire_uplink_planes, P, P * 4)
        r["uplink bytes/round"] = f"{_fmt_bytes(up)}/client"
        rows.append(r)
    cols = ["algorithm", "local step", "server fold", "state planes", "uplink",
            "uplink bytes/round"]
    widths = {c: max(len(c), *(len(r[c]) for r in rows)) for c in cols}
    lines = ["  ".join(c.ljust(widths[c]) for c in cols)]
    lines += ["  ".join(r[c].ljust(widths[c]) for c in cols) for r in rows]
    wire = "f32 wire" if compression is None else f"{compression.kind} wire"
    lines.append(f"(P = {P:,} params: mlp {dim}-{hidden}-{hidden}-{n_classes}, {wire})")
    return "\n".join(lines)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--algo", default="fedcm", choices=list_algorithms())
    ap.add_argument("--list-algos", action="store_true",
                    help="print every registered algorithm (state planes, kernel "
                         "routing, uplink bytes) and exit")
    ap.add_argument("--clients", "--num-clients", dest="clients", type=int, default=100)
    ap.add_argument("--cohort", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=100)
    ap.add_argument("--local-steps", type=int, default=10)
    ap.add_argument("--alpha", type=float, default=0.1)
    ap.add_argument("--eta-l", type=float, default=0.1)
    ap.add_argument("--eta-g", type=float, default=1.0)
    ap.add_argument("--dirichlet", type=float, default=0.6,
                    help="label-skew concentration; inf = IID")
    ap.add_argument("--participation", default="bernoulli", choices=["fixed", "bernoulli"])
    ap.add_argument("--eval-every", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; the run raises if it is cuda and there "
                         "is no GPU (pass --device cpu for the CPU)")
    ap.add_argument("--pipeline-depth", type=int, default=1,
                    help="cohorts in flight (>1 runs the async ring; a fold is "
                         "depth-1 rounds stale)")
    ap.add_argument("--staleness", type=int, default=0,
                    help="rounds of momentum staleness the clients descend against "
                         "(>0 runs the async ring)")
    ap.add_argument("--staleness-discount", type=float, default=1.0,
                    help="fold weight γ per round of staleness (a fold weighs "
                         "γ^(depth-1))")
    ap.add_argument("--async", dest="async_pipeline", action="store_true",
                    help="run the async ring even at depth 1 / staleness 0")
    ap.add_argument("--population-store", default="resident", choices=list(POPULATION_STORES),
                    help="'host' keeps per-client state in a host store (gathered and "
                         "scattered per cohort; no (N, P) device plane) and streams "
                         "each sampled client's shard")
    ap.add_argument("--availability", default="uniform", choices=list(AVAILABILITY_PROCESSES),
                    help="client availability process of the cohort sampler")
    ap.add_argument("--zipf-exponent", type=float, default=1.1,
                    help="skew s of the zipf availability process (w_i ∝ (i+1)^-s)")
    ap.add_argument("--dropout-rate", type=float, default=0.0,
                    help="per-round straggler probability: sampled clients drop out "
                         "of the cohort's mask at this rate")
    ap.add_argument("--uplink-compress", default="none",
                    choices=["none", "int8", "bf16", "topk"],
                    help="wire-compress client uplinks (repro_torch.core.compress): "
                         "stochastic-rounded int8 (+per-row f32 scale), bf16, or "
                         "top-k sparsification with error-feedback residuals")
    ap.add_argument("--topk-frac", type=float, default=0.01,
                    help="fraction of plane coordinates top-k keeps "
                         "(only with --uplink-compress topk)")
    fault = ap.add_argument_group(
        "fault injection / degradation",
        "any nonzero rate builds a FaultConfig (seeded, reproducible); "
        "quarantine of non-finite uplinks is on whenever a FaultConfig is")
    fault.add_argument("--fault-drop-rate", type=float, default=0.0,
                       help="per-client per-round uplink drop probability")
    fault.add_argument("--fault-corrupt-rate", type=float, default=0.0,
                       help="per-client per-round payload corruption probability")
    fault.add_argument("--fault-corrupt-mode", default="nan",
                       choices=["nan", "inf", "noise"],
                       help="corruption model: NaN/Inf row fill, or scaled noise "
                            "added to the delta plane")
    fault.add_argument("--fault-noise-scale", type=float, default=1.0,
                       help="noise corruption magnitude (x |value| stddev)")
    fault.add_argument("--fault-deadline", type=float, default=0.0,
                       help="straggler deadline (log-normal compute-time model; "
                            ">0 drops clients exceeding it)")
    fault.add_argument("--fault-store-failure-rate", type=float, default=0.0,
                       help="transient host-store gather/scatter failure probability "
                            "(retried with capped exponential backoff)")
    fault.add_argument("--fault-seed", type=int, default=0,
                       help="seed of the fault draws (independent of --seed)")
    fault.add_argument("--quarantine-norm-mult", type=float, default=0.0,
                       help=">0 also quarantines uplinks whose delta norm exceeds "
                            "mult x the cohort median")
    ap.add_argument("--min-quorum", type=int, default=0,
                    help="skip the server fold (params carried unchanged) when "
                         "surviving clients fall below this count")
    ap.add_argument("--allow-empty-cohort", action="store_true",
                    help="let dropout empty the cohort entirely (the fold "
                         "degrades to a guarded no-op round) instead of the "
                         "legacy keep-first-client guard")
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="write an atomic whole-run snapshot (state, generator, host "
                         "stores) every N rounds; sync rounds only")
    ap.add_argument("--ckpt-dir", default="",
                    help="snapshot directory (needed with --ckpt-every / --resume)")
    ap.add_argument("--resume", action="store_true",
                    help="restore the latest snapshot from --ckpt-dir and continue "
                         "the trajectory bitwise")
    ap.add_argument("--die-after", type=int, default=0,
                    help="exit with code 75 right after the first snapshot at round "
                         ">= N (pair with --resume in a second run)")
    fleet = ap.add_argument_group(
        "fleet serving",
        "--serve runs the round-to-serving loop: a serving thread runs inference "
        "against the latest published params (published at every --ckpt-every "
        "snapshot, hot-swapped between steps), a /healthz /metrics /telemetry/tail "
        "endpoint, and an append-only telemetry JSONL with one row a round")
    fleet.add_argument("--serve", action="store_true",
                       help="serving + health + telemetry beside the round loop (needs "
                            "--ckpt-every and --ckpt-dir: publication rides the snapshots)")
    fleet.add_argument("--health-port", type=int, default=0,
                       help="health endpoint port (0 = ephemeral; printed at start-up)")
    fleet.add_argument("--round-deadline", type=float, default=120.0,
                       help="/healthz liveness deadline: 503 once the last round is "
                            "older than this many seconds")
    fleet.add_argument("--telemetry", default="",
                       help="telemetry JSONL path (default <ckpt-dir>/telemetry.jsonl)")
    fleet.add_argument("--publish-retain", type=int, default=4,
                       help="published versions kept on disk (>= 2)")
    ap.add_argument("--flat-plane", action=argparse.BooleanOptionalAction,
                    default=FedConfig.use_flat_plane,
                    help="carry params/momentum/client state on the flat (P,) plane "
                         "(--no-flat-plane keeps the per-leaf tree path, which launches "
                         "no kernel)")
    ap.add_argument("--cohort-shard", type=int, default=0,
                    help="shard each cohort over N ranks, one process each: NCCL on "
                         "cuda:0..N-1, or gloo with --device cpu; 0 = one process")
    return ap


def check_flags(ap: argparse.ArgumentParser, args: argparse.Namespace) -> None:
    """The reference CLI's refusals of flag combinations (``ap.error``,
    exit code 2)."""
    use_async = args.async_pipeline or args.pipeline_depth > 1 or args.staleness > 0
    if args.ckpt_every > 0 and use_async:
        ap.error("--ckpt-every snapshots between sync round chunks; the async ring "
                 "has no snapshot of the cohorts in flight — drop --async / "
                 "--pipeline-depth / --staleness")
    if (args.ckpt_every > 0 or args.resume) and not args.ckpt_dir:
        ap.error("--ckpt-every / --resume need --ckpt-dir")
    if args.die_after > 0 and args.ckpt_every <= 0:
        ap.error("--die-after kills AFTER a snapshot — add --ckpt-every")
    if args.resume and args.ckpt_every <= 0:
        ap.error("--resume continues a snapshotted run — add --ckpt-every")
    if args.serve and args.ckpt_every <= 0:
        ap.error("--serve publishes at snapshot boundaries — add --ckpt-every N "
                 "--ckpt-dir DIR")
    if args.serve and not args.ckpt_dir:
        ap.error("--serve needs --ckpt-dir (publisher + telemetry live under it)")
    if args.publish_retain < 2:
        ap.error("--publish-retain must be >= 2: the publication ring must outlive a "
                 "reader's just-resolved version")
    if args.cohort_shard < 0:
        ap.error("--cohort-shard must be >= 0")
    if args.population_store == "host" and args.cohort_shard > 0:
        ap.error("--population-store host is a single-device host loop; it does not "
                 "compose with --cohort-shard")
    if args.cohort_shard > 0 and not args.flat_plane:
        ap.error("--cohort-shard shards the flat (C, P) uplink planes — drop --no-flat-plane")
    if args.population_store == "host" and not args.flat_plane:
        ap.error("--population-store host gathers/scatters flat (C, P) state rows — drop "
                 "--no-flat-plane")
    if (args.ckpt_every > 0 or args.resume or args.serve) and not args.flat_plane:
        ap.error("--ckpt-every / --resume / --serve snapshot the flat plane; the tree "
                 "path's snapshot is not ported — drop --no-flat-plane")


def resolve_config(args: argparse.Namespace) -> FedConfig:
    """argv → FedConfig.  Any nonzero fault rate (the host store's failure
    rate included, or the norm fence) builds a FaultConfig; all defaults keep
    ``fault=None``.  ``--uplink-compress
    none`` keeps ``compression=None``; the rounding stream is seeded with
    ``--seed``."""
    fault = None
    if (args.fault_drop_rate > 0.0 or args.fault_corrupt_rate > 0.0
            or args.fault_deadline > 0.0 or args.fault_store_failure_rate > 0.0
            or args.quarantine_norm_mult > 0.0):
        fault = FaultConfig(
            drop_rate=args.fault_drop_rate, deadline=args.fault_deadline,
            corrupt_rate=args.fault_corrupt_rate, corrupt_mode=args.fault_corrupt_mode,
            noise_scale=args.fault_noise_scale,
            store_failure_rate=args.fault_store_failure_rate,
            quarantine_norm_mult=args.quarantine_norm_mult, seed=args.fault_seed,
        )
    compression = None
    if args.uplink_compress != "none":
        compression = CompressionConfig(kind=args.uplink_compress,
                                        topk_frac=args.topk_frac, seed=args.seed)
        validate_compression(compression)
    return FedConfig(
        algo=args.algo, num_clients=args.clients, cohort_size=args.cohort,
        local_steps=args.local_steps, alpha=args.alpha, eta_l=args.eta_l,
        eta_g=args.eta_g, participation=args.participation, rounds=args.rounds,
        seed=args.seed, pipeline_depth=args.pipeline_depth, staleness=args.staleness,
        staleness_discount=args.staleness_discount,
        population_store=args.population_store, availability=args.availability,
        zipf_exponent=args.zipf_exponent, dropout_rate=args.dropout_rate,
        fault=fault, min_quorum=args.min_quorum,
        allow_empty_cohort=args.allow_empty_cohort, compression=compression,
        cohort_shard=args.cohort_shard, use_flat_plane=args.flat_plane,
    )


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    cfg = resolve_config(args)
    if args.list_algos:
        print(list_algos_text(compression=cfg.compression))
        return 0
    check_flags(ap, args)
    if args.cohort_shard > 0:
        resolve_device(args.device)
        try:
            acc = spawn_cohort(_shard_main, args.cohort_shard,
                               args=(sys.argv[1:] if argv is None else list(argv),),
                               device=args.device, timeout_s=SHARD_TIMEOUT_S,
                               deadline_s=SHARD_DEADLINE_S)[0]
        except RankFailure as e:
            if not e.errors and PREEMPTED in e.exitcodes.values():
                # --die-after: a rank leaves only past the barrier that
                # follows the snapshot's write
                return PREEMPTED
            raise
    else:
        acc = _run(args, cfg, args.device)
    print(f"\n{args.algo}: final test accuracy = {acc:.4f}")
    return 0


def _run(args, cfg: FedConfig, device, echo: bool = True) -> float:
    acc, _ = run_federated(cfg, args.dirichlet, eval_every=args.eval_every,
                           seed=args.seed, device=device, echo=echo,
                           async_pipeline=args.async_pipeline,
                           ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir,
                           resume=args.resume, die_after=args.die_after,
                           serve=args.serve, health_port=args.health_port,
                           round_deadline_s=args.round_deadline,
                           telemetry_path=args.telemetry,
                           publish_retain=args.publish_retain)
    return acc


def _shard_main(rank: int, device, argv) -> float:
    """One rank of ``--cohort-shard N``: the same run on this rank's
    device, the log on rank 0 only."""
    args = build_parser().parse_args(argv)
    return _run(args, resolve_config(args), device, echo=rank == 0)


if __name__ == "__main__":
    raise SystemExit(main())
