"""FedCM over a transformer LM: the port's counterpart of the reference's
``examples/federated_llm.py``.

Each client is an organization holding a corpus with its own token
distribution: client c's Markov chain is 0.6 × a shared base chain + 0.4 ×
its own (``repro_torch.data.federated_lm_corpora``).  FedCM federates a
decoder-only LM across them through ``FederatedEngine``: each local step is
one backward through the model (the plain route, under autograd) for every
client of the cohort and one ``fed_direction`` launch over the ``(C, P)``
cohort plane, each round one ``server_update`` launch.  The batches are
``LMFederatedData``'s ``{"x": tokens, "y": labels}``, and the model's
``loss_fn`` meets the engine's contract through ``cohort_loss_fn``.

``main`` runs the example: reduced llama3.2-1b, 8 clients, a fixed cohort
of 3, K = 4, batch 4 × 64 tokens, 20 rounds; it prints every fifth round
and exits non-zero unless the loss has fallen.  Runs on ``cuda`` and
raises when there is no GPU, unless ``--device cpu`` asks for the CPU (the
kernels' plain versions).

``--model-parallel N`` (``run(..., model_parallel=N)``) makes each client a
model group of N ranks, the reference's ``fed_dryrun`` layout: each rank
draws its share of the weights (``sharding.shard.init_params_sharded``),
holds its share's columns of every ``(C, P)`` plane and runs the same round
on the same draws (each rank's generator seeded alike), launching
``fed_direction`` K times and ``server_update`` once a round on its share
(``core.engine``'s ``model_group``).  N ranks run on ``cuda:0`` …
``cuda:N−1`` over NCCL, or on the CPU over gloo with ``--device cpu``;
rank 0 prints.

``--cohort-shard D`` with it (``run(..., model_parallel=N, cohort_shard=D)``)
is the reference's ``fed_dryrun`` layout whole: D·N ranks on a D × N grid
(``launch.mesh.make_grid``), the cohort split over each data group and
each client over each model group.  A rank draws the whole cohort, runs
its ``(C_loc, P_r)`` rows' local steps (``fed_direction`` K times a round)
and folds over its data group on its share's columns (``scatter_fold``:
one ``server_update`` launch a round on its ``(C_pad, ceil(P_r/D))``
block).  ``--cohort-shard D`` alone shards the cohort of unsharded clients.

    PYTHONPATH=src python -m repro_torch.launch.federated_llm --device cpu
    PYTHONPATH=src python -m repro_torch.launch.federated_llm --device cpu --model-parallel 2
    PYTHONPATH=src python -m repro_torch.launch.federated_llm --device cpu --model-parallel 2 \\
        --cohort-shard 2
"""
from __future__ import annotations

import argparse
import math
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch

from repro_torch.configs.base import FedConfig, get_config, reduced
from repro_torch.core.engine import FederatedEngine, metrics_to_host, resolve_device, synchronize
from repro_torch.core.flat import FlatSpec
from repro_torch.data.pipeline import LMFederatedData, federated_lm_corpora
from repro_torch.kernels import launch_counts, launches_since
from repro_torch.launch.mesh import make_grid, make_model_group, spawn_cohort
from repro_torch.launch.steps import make_parallel
from repro_torch.models.layers import ParallelContext
from repro_torch.models.model import build_model, cohort_loss_fn
from repro_torch.sharding.rules import check_model_parallel
from repro_torch.sharding.shard import group_plane, init_params_sharded

N_SEQS = 256  # sequences in each client's corpus
# the example's FedCM settings: momentum α, server step η_g, weight decay
ALPHA, ETA_G, WEIGHT_DECAY = 0.1, 1.0, 1e-4
METRICS = ("loss", "momentum_norm", "delta_norm", "n_active", "n_dropped", "n_quarantined")
# a model group's collectives wait this long for a rank (its share may still
# be drawing), and the whole world this long
MP_TIMEOUT_S, MP_DEADLINE_S = 600.0, 3600.0


@dataclass
class FedLMResult:
    """One ``run``: the config's name, the flat plane's size P (the whole
    model's under a group), each round's metrics on the host (``METRICS``),
    each round's wall ms (synchronized with the device at both ends), and
    the peak device memory over the run in bytes (None on the CPU).
    ``by_rank`` has, for each rank of a model group (one entry unsharded),
    its share's plane size, peak bytes, kernel launches over the rounds,
    round metrics and its model group's collectives over the run
    (``ParallelContext.counts``; none unsharded)."""

    arch: str
    n_params: int
    rounds: List[Dict[str, float]]
    round_ms: List[float]
    peak_bytes: Optional[int]
    by_rank: List[Dict[str, Any]] = field(default_factory=list)


def run(cfg, *, n_clients: int = 8, cohort: int = 3, local_steps: int = 4, batch: int = 4,
        seq: int = 64, rounds: int = 20, eta_l: float = 0.05, seed: int = 0,
        device="cuda", model_parallel: int = 1, cohort_shard: int = 0,
        parallel: Optional[ParallelContext] = None, cohort_group=None,
        variant: Optional[Dict[str, Any]] = None) -> FedLMResult:
    """FedCM over the LM ``cfg`` for ``rounds`` rounds (a fixed cohort;
    ``ALPHA``, ``ETA_G`` and ``WEIGHT_DECAY``; ``variant`` sets any other
    ``FedConfig`` field: a ``fault``, ``use_flat_plane=False``, ``algo``).
    The weights are drawn on ``device`` from ``seed``, the cohorts and
    minibatches from a generator on ``device`` seeded with ``seed + 1``.
    ``model_parallel`` > 1 or ``cohort_shard`` > 1 (and no ``parallel`` /
    ``cohort_group``) spawns the ranks of a model group, of a cohort group
    or of a ``cohort_shard`` × ``model_parallel`` grid and returns rank 0's
    result with every rank's ``by_rank`` entry; ``parallel`` runs this
    rank's share of a model group, ``cohort_group`` its rows of the
    cohort."""
    kw = dict(n_clients=n_clients, cohort=cohort, local_steps=local_steps, batch=batch,
              seq=seq, rounds=rounds, eta_l=eta_l, seed=seed, variant=variant)
    if parallel is None and cohort_group is None and max(model_parallel, cohort_shard) > 1:
        return run_model_parallel(cfg, model_parallel, device, cohort_shard=cohort_shard, **kw)
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    fed = fed_config(n_clients=n_clients, cohort=cohort, local_steps=local_steps, eta_l=eta_l,
                     rounds=rounds, **(variant or {}))
    data = LMFederatedData(federated_lm_corpora(cfg.vocab_size, n_clients, seq + 1, N_SEQS),
                           device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    if parallel is None:
        params = build_model(cfg).init(gen)
    else:
        check_model_parallel(cfg, parallel.size)
        # the kept slices wait on the host while whole leaves are drawn on the card
        params = init_params_sharded(gen, cfg, parallel.rank, parallel.size,
                                     stage="cpu" if dev.type == "cuda" else None)
    eng, spec, group = build_engine(cfg, fed, params, batch=batch, device=dev,
                                    parallel=parallel, cohort_group=cohort_group)
    rng = torch.Generator(device=dev)
    rng.manual_seed(seed + 1)  # alike on every rank: the same cohorts and minibatches
    state = eng.init(params, rng)
    del params  # the engine holds the flat plane
    before = launch_counts()
    per_round, round_ms = [], []
    for _ in range(rounds):
        synchronize(dev)
        t0 = time.perf_counter()
        state, m = eng.run_round(state, data)
        synchronize(dev)
        round_ms.append((time.perf_counter() - t0) * 1e3)
        host = metrics_to_host(m)
        per_round.append({k: float(host[k][0]) for k in METRICS})
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    mine = {"share_params": spec.size, "peak_bytes": peak, "launches": launches_since(before),
            "rounds": per_round,
            "collectives": {} if parallel is None else dict(parallel.counts)}
    return FedLMResult(cfg.name, spec.size if group is None else group.whole_size, per_round,
                       round_ms, peak, [mine])


def fed_config(*, n_clients: int, cohort: int, local_steps: int, eta_l: float, rounds: int,
               **variant) -> FedConfig:
    """The example's FedCM round: a fixed cohort, ``ALPHA``, ``ETA_G`` and
    ``WEIGHT_DECAY``; ``variant`` sets any other field (the dry-run's
    ``algo``, ``momentum_dtype``, ``aggregate_dtype``)."""
    return FedConfig(**{**dict(algo="fedcm", num_clients=n_clients, cohort_size=cohort,
                               local_steps=local_steps, alpha=ALPHA, eta_l=eta_l, eta_g=ETA_G,
                               weight_decay=WEIGHT_DECAY, rounds=rounds,
                               participation="fixed"), **variant})


def build_engine(cfg, fed: FedConfig, params, *, batch: int, device,
                 parallel: Optional[ParallelContext] = None, cohort_group=None):
    """``(engine, spec, group plane or None)`` of ``run``'s round over
    ``params``, this rank's share under ``parallel`` (its plane: the
    share's columns, ``sharding.shard.group_plane``), its rows of the
    cohort under ``cohort_group``; the launcher and the dry-run
    (``launch.fed_dryrun``) build the round alike."""
    spec = FlatSpec.from_tree(params)
    group = None if parallel is None else group_plane(spec, cfg, parallel)
    eng = FederatedEngine(fed, cohort_loss_fn(build_model(cfg), parallel), spec,
                          batch_size=batch, device=device, cohort_group=cohort_group,
                          model_group=group)
    return eng, spec, group


def run_model_parallel(cfg, n: int, device, cohort_shard: int = 0, **kw) -> FedLMResult:
    """``run`` in the spawned ranks of a model group of ``n``, or of a
    ``cohort_shard`` × ``n`` grid (NCCL on a card a rank, gloo on the CPU);
    rank 0's result with every rank's ``by_rank`` entry.  Raises unless
    every rank saw the same round metrics."""
    check_model_parallel(cfg, n)
    resolve_device(device)
    data = max(cohort_shard, 1)
    results = spawn_cohort(_model_parallel_rank, data * n, args=(cfg, kw, data, n),
                           device=device, timeout_s=MP_TIMEOUT_S, deadline_s=MP_DEADLINE_S)
    for r, res in enumerate(results):
        if res.rounds != results[0].rounds:
            raise RuntimeError(f"rank {r} of the model group saw round metrics {res.rounds}, "
                               f"rank 0 {results[0].rounds}")
    results[0].by_rank = [res.by_rank[0] for res in results]
    return results[0]


def _model_parallel_rank(rank: int, device, cfg, kw, data: int, n: int) -> FedLMResult:
    if data == 1:
        return run(cfg, device=str(device), parallel=make_model_group(), **kw)
    model_group, data_group = make_grid(data, n)
    parallel = make_parallel(model_group) if n > 1 else None
    return run(cfg, device=str(device), parallel=parallel, cohort_group=data_group, **kw)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--model-parallel", type=int, default=1, metavar="N",
                    help="each client a model group of N ranks: one card a rank over NCCL, "
                         "or gloo ranks with --device cpu (default 1: unsharded)")
    ap.add_argument("--cohort-shard", type=int, default=0, metavar="D",
                    help="split the cohort over D ranks (with --model-parallel N: a D x N "
                         "grid of D*N ranks; default 0: unsharded)")
    return ap


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.model_parallel < 1:
        ap.error(f"--model-parallel must be >= 1, got {args.model_parallel}")
    if args.cohort_shard < 0:
        ap.error(f"--cohort-shard must be >= 0, got {args.cohort_shard}")
    cfg = reduced(get_config("llama3.2-1b"))
    n_clients = 8
    res = run(cfg, n_clients=n_clients, device=args.device, model_parallel=args.model_parallel,
              cohort_shard=args.cohort_shard)
    print(f"federated {res.arch} ({res.n_params / 1e6:.1f}M params) across {n_clients} "
          f"heterogeneous corpora with FedCM\n")
    for r, m in enumerate(res.rounds):
        if (r + 1) % 5 == 0:
            print(f"round {r + 1:3d}  local-loss={m['loss']:.4f}  "
                  f"|Δ_t|={m['momentum_norm']:.4f}  active={int(m['n_active'])}")
    first, last = res.rounds[0]["loss"], res.rounds[-1]["loss"]
    print(f"\nloss {first:.3f} → {last:.3f} (uniform {math.log(cfg.vocab_size):.3f})")
    return 0 if last < first else 1


if __name__ == "__main__":
    raise SystemExit(main())
