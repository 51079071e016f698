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
``--clients 1000000`` is a literal setting.  Runs on ``cuda`` and raises
when there is no GPU, unless ``--device cpu`` asks for the CPU (the
kernels' plain versions).

    PYTHONPATH=src python -m repro_torch.launch.fed_train --algo fedcm \
        --clients 100 --cohort 10 --rounds 100 --dirichlet 0.6
    PYTHONPATH=src python -m repro_torch.launch.fed_train --algo scaffold \
        --uplink-compress int8 --fault-drop-rate 0.1 --fault-corrupt-rate 0.1
    PYTHONPATH=src python -m repro_torch.launch.fed_train --pipeline-depth 2 --staleness 1 \
        --staleness-discount 0.9
    PYTHONPATH=src python -m repro_torch.launch.fed_train --population-store host \
        --clients 1000000 --algo scaffold --availability zipf --dropout-rate 0.1
    PYTHONPATH=src python -m repro_torch.launch.fed_train --list-algos
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs.base import CompressionConfig, FaultConfig, FedConfig
from repro_torch.core.compress import uplink_bytes_per_client, validate_compression
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
from repro_torch.models.small import classification_loss, mlp_classifier
from repro_torch.utils.metrics import MetricLogger


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
    seeded with ``seed + 1``."""
    dev = resolve_device(device)
    if cfg.population_store == "host":
        data = StreamingClientData(cfg.num_clients, dim=dim, n_classes=n_classes, seed=seed)
        x_te, y_te = data.test_set(min(n_test, 2_000))
    else:
        x_tr, y_tr, x_te, y_te = make_synthetic_classification(
            n_classes=n_classes, dim=dim, n_train=n_train, n_test=n_test, seed=seed
        )
        data = FederatedData(x_tr, y_tr, cfg.num_clients, dirichlet_alpha=dirichlet,
                             seed=seed, device=dev)
    model = mlp_classifier((dim, hidden, hidden, n_classes))
    params = model.init(torch.Generator().manual_seed(seed))
    spec = FlatSpec.from_tree(params)
    eng = FederatedEngine(cfg, classification_loss(model.apply), spec,
                          batch_size=batch_size, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    state = eng.init(params, gen)
    evaluate = make_eval_fn(model.apply)
    x_te_t = torch.as_tensor(x_te, device=dev)
    y_te_t = torch.as_tensor(y_te, device=dev).long()

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
        if cfg.population_store == "host":
            # the host loop has no in-loop eval: evaluate once at the end
            state, ms = eng.run_rounds_async(state, data, cfg.rounds)
            acc = evaluate(spec.unravel(state.params), x_te_t, y_te_t)
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
            acc = evaluate(spec.unravel(state.params), x_te_t, y_te_t)
        return acc, log
    acc, r = 0.0, 0
    while r < cfg.rounds:
        chunk = min(eval_every, cfg.rounds - r)
        state, ms = eng.run_rounds(state, data, chunk)
        host = metrics_to_host(ms)  # one transfer per chunk
        r += chunk
        acc = evaluate(spec.unravel(state.params), x_te_t, y_te_t)
        log_row(r, host, -1, acc, chunk)
    return acc, log


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
        up = uplink_bytes_per_client(compression, spec.wire_uplink_planes, P, P * 4)
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
    return ap


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
        fault=fault, min_quorum=args.min_quorum, compression=compression,
    )


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    cfg = resolve_config(args)
    if args.list_algos:
        print(list_algos_text(compression=cfg.compression))
        return 0
    acc, _ = run_federated(cfg, args.dirichlet, eval_every=args.eval_every,
                           seed=args.seed, device=args.device,
                           async_pipeline=args.async_pipeline)
    print(f"\n{args.algo}: final test accuracy = {acc:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
