"""Centralized LM training CLI of the port (counterpart of
``repro.launch.train``).

Trains any ``--arch`` (reduced by default; ``--full`` is the published
widths) on synthetic Markov-chain LM data with AdamW and a warmup-cosine
schedule, through ``repro_torch.launch.steps`` (the plain route: no kernel
has a backward), with ``--ckpt-dir`` snapshots and resume, logging
``step, loss, grad_norm, tok_per_s`` every ``--log-every`` steps.

Two differences from the reference.  Data come from the chain over the
first ``min(vocab, CHAIN_VOCAB)`` token ids (512), as the serving CLI's
prompts do: the reference draws a dense (vocab, vocab) chain, 131.6 GB at
llama3.2-1b's vocabulary (ROADMAP queue C); at the reduced configs' vocab
of 512 the two draw the same data.  An encoder-decoder arch's source frames are drawn
from a ``torch.Generator`` seeded from ``--seed`` and the step (the
reference folds the step into its threefry key).  A resumed run skips the
batches of the steps before its snapshot, so it continues the straight
run's data.  Runs on ``cuda`` and raises when there is no GPU, unless
``--device cpu`` asks for the CPU.  ``--remat`` is the period's
rematerialisation (``none``, the default; ``full``; ``dots``: the weight
products' outputs kept).

``--model-parallel N`` trains on N ranks of a model group
(``repro_torch.launch.mesh``; the reference's mesh with a ``"model"`` axis
of N and a data axis of 1, ``--data-parallel`` below): each rank draws
its share of the weights (``sharding.shard.init_params_sharded``, bitwise
its slice of the unsharded draw), steps its share through ``build_train_step(cfg, knobs,
parallel)`` on the same batches, and rank 0 logs; every rank's loss and
grad norm are the same.  N ranks run on ``cuda:0`` … ``cuda:N−1`` over
NCCL, or on the CPU over gloo with ``--device cpu``.

``--data-parallel D`` adds the data axis: D·N ranks on a D × N grid
(``launch.mesh.make_grid``, the reference's ``("data", "model")`` mesh:
rank ``d·N + m``), each storing its FSDP slice of its model share
(``sharding.shard.init_params_sharded(..., data=D, data_rank=d)``) and
stepping its data row's block of B/D rows of each batch; the model gathers
each period's slices as it uses them (``models.layers.fsdp_gather``).  The
batch must be a multiple of D.

``--ckpt-dir`` under a group or a grid writes the file an unsharded run
writes, ``step_<N>.msgpack`` of ``{"params", "opt"}`` in the reference's
layout: rank 0 gathers and joins the shares leaf by leaf and writes it
(``checkpoint.ckpt.save_checkpoint_shares``), so host memory bounds the
model that can be snapshotted; a resumed rank reads the file and takes its
share (``load_checkpoint(..., take=)``), on any grid shape or none.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 20 \\
        --batch 4 --seq 32 --log-every 5
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b --full \\
        --batch 8 --seq 512 --steps 30 --warmup 5 --log-every 5
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --model-parallel 2 \\
        --steps 10 --batch 4 --seq 32 --log-every 5
    PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-7b --full \\
        --model-parallel 4 --remat dots --batch 8 --seq 512 --steps 10 --warmup 2
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --data-parallel 2 \\
        --model-parallel 2 --steps 10 --batch 4 --seq 32 --ckpt-dir /tmp/g --ckpt-every 5
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch

from repro_torch.checkpoint.ckpt import (
    latest_step, load_checkpoint, save_checkpoint, save_checkpoint_shares,
)
from repro_torch.configs.base import ARCH_IDS, get_config, reduced
from repro_torch.core.engine import resolve_device, synchronize
from repro_torch.data.pipeline import lm_batch_iterator
from repro_torch.data.synthetic import CHAIN_VOCAB, make_synthetic_lm, source_frames
from repro_torch.kernels import launch_counts, launches_since
from repro_torch.launch.mesh import make_grid, spawn_cohort
from repro_torch.launch.steps import Knobs, build_train_step, make_parallel
from repro_torch.models.layers import ParallelContext
from repro_torch.models.transformer import REMATS
from repro_torch.optim.optimizers import warmup_cosine
from repro_torch.sharding.rules import check_model_parallel
from repro_torch.sharding.shard import (
    init_params_sharded, param_shapes, snapshot_join, snapshot_take,
)
from repro_torch.utils.metrics import MetricLogger
from repro_torch.utils.trees import tree_leaves

N_SEQS = 2048
# a model group's collectives wait this long for a rank (its share may still
# be drawing), and the whole world this long
MP_TIMEOUT_S, MP_DEADLINE_S = 600.0, 3600.0


@dataclass
class TrainResult:
    """One ``run``: the config's name, its parameter count by top-level key
    of the params tree (``embed``, ``periods``, ``enc``, ...; the whole
    model's under a group), the first step run (> 0 after a resume), each
    step's loss and grad norm and wall seconds (synchronized with the
    device at both ends), the logged rows, and the peak device memory in
    bytes (None on the CPU).  ``by_rank`` has, for each rank of a model
    group (one entry unsharded), its losses, grad norms, peak bytes and
    kernel launches over the steps."""

    arch: str
    param_counts: Dict[str, int]
    start_step: int
    losses: List[float]
    grad_norms: List[float]
    step_s: List[float]
    rows: List[dict]
    peak_bytes: Optional[int]
    by_rank: List[Dict[str, Any]] = field(default_factory=list)


def _config(args: argparse.Namespace):
    cfg = get_config(args.arch)
    return cfg if args.full else reduced(cfg)


def check_model_parallel_args(args: argparse.Namespace, cfg, world: int) -> None:
    """Refuse what a model group of ``world`` ranks does not train: an
    expert count the group does not divide (``check_model_parallel``), and
    a batch that ``--data-parallel`` does not divide."""
    data = getattr(args, "data_parallel", 1)
    if args.batch % data:
        raise ValueError(f"--batch {args.batch} does not split over --data-parallel {data}")
    if world > 1:
        check_model_parallel(cfg, world)


def run(args: argparse.Namespace, cfg=None, echo: bool = True,
        parallel: Optional[ParallelContext] = None) -> TrainResult:
    """Train for ``args``; ``cfg`` trains that config in place of
    ``--arch``'s (``--full`` / reduced).  With ``args.model_parallel`` > 1
    (and no ``parallel``) the ranks of a model group are spawned and rank
    0's result comes back, with every rank's in ``by_rank``; ``parallel``
    trains this rank's share of that group."""
    cfg = _config(args) if cfg is None else cfg
    if parallel is None and getattr(args, "model_parallel", 1) * getattr(
            args, "data_parallel", 1) > 1:
        return run_model_parallel(args, cfg)
    device = resolve_device(args.device)
    if cfg.is_encoder_decoder and echo:
        print("(enc-dec arch: tokens drive the decoder; src embeds are synthetic, drawn from a "
              "torch.Generator seeded from --seed and the step)")
    sched = warmup_cosine(args.lr, args.warmup, args.steps)
    knobs = Knobs(remat=getattr(args, "remat", "none"), learning_rate=sched)
    step_fn = (build_train_step(cfg, knobs) if parallel is None
               else build_train_step(cfg, knobs, parallel))
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    if parallel is None:
        params = step_fn.model.init(gen)
    else:
        check_model_parallel_args(args, cfg, parallel.size)
        # the kept slices wait on the host while whole leaves are drawn on the card
        params = init_params_sharded(gen, cfg, parallel.rank, parallel.size,
                                     stage="cpu" if device.type == "cuda" else None,
                                     data=parallel.data_size, data_rank=parallel.data_rank)
    opt_state = step_fn.opt.init(params)
    n_data, d = (1, 0) if parallel is None else (parallel.data_size, parallel.data_rank)
    rows = slice(d * args.batch // n_data, (d + 1) * args.batch // n_data)

    start_step = 0
    if args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        take = None if parallel is None else snapshot_take(
            cfg, parallel.rank, parallel.size, parallel.data_rank, parallel.data_size)
        tree, meta = load_checkpoint(args.ckpt_dir, None, {"params": params, "opt": opt_state},
                                     take)
        params, opt_state = tree["params"], tree["opt"]
        start_step = int(meta.get("step", 0))
        if echo:
            print(f"resumed from step {start_step}")

    toks = make_synthetic_lm(vocab_size=min(cfg.vocab_size, CHAIN_VOCAB), seq_len=args.seq + 1,
                             n_seqs=N_SEQS, seed=args.seed)
    it = lm_batch_iterator(toks, args.batch, seed=args.seed, device=device)
    for _ in range(start_step):  # the batches the snapshot's steps took
        next(it)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    before = launch_counts()
    log = MetricLogger(["step", "loss", "grad_norm", "tok_per_s"], echo=echo)
    losses, norms, times = [], [], []
    toks_since, t_since = 0, 0.0
    metrics = None
    for step in range(start_step, args.steps):
        batch = next(it)
        if cfg.is_encoder_decoder:
            src = source_frames(args.batch, args.seq, cfg.d_model, args.seed * 1_000_003 + step,
                                device)
            batch = {"src_embeds": src,
                     "tgt_tokens": batch["tokens"], "labels": batch["labels"]}
        if n_data > 1:  # this data row's block of the batch
            batch = {k: v[rows] for k, v in batch.items()}
        synchronize(device)
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn.fn(params, opt_state, batch)
        synchronize(device)
        times.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
        toks_since += args.batch * args.seq
        t_since += times[-1]
        if (step + 1) % args.log_every == 0 or step == args.steps - 1:
            log.log(step=step + 1, loss=losses[-1], grad_norm=norms[-1],
                    tok_per_s=round(toks_since / max(t_since, 1e-9)))
            toks_since, t_since = 0, 0.0
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            tree = {"params": params, "opt": opt_state}
            if parallel is None:
                save_checkpoint(args.ckpt_dir, step + 1, tree)
            else:
                save_checkpoint_shares(args.ckpt_dir, step + 1, tree, snapshot_join(
                    cfg, parallel.size, parallel.data_size))
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    if echo and metrics is not None:
        print(f"final loss: {losses[-1]:.4f}")
    whole = params if parallel is None else param_shapes(cfg)
    counts = {k: sum(t.numel() for t in tree_leaves(v)) for k, v in whole.items()}
    mine = {"losses": losses, "grad_norms": norms, "peak_bytes": peak,
            "launches": launches_since(before)}
    return TrainResult(cfg.name, counts, start_step, losses, norms, times, log.rows, peak,
                       [mine])


def run_model_parallel(args: argparse.Namespace, cfg) -> TrainResult:
    """``--model-parallel N`` (and ``--data-parallel D``): ``run`` in D·N
    spawned ranks of a model group or a D × N grid (NCCL on D·N cards, gloo
    with ``--device cpu``); rank 0's result with every rank's ``by_rank``
    entry.  Raises unless every rank saw the same losses and grad norms."""
    check_model_parallel_args(args, cfg, args.model_parallel)
    resolve_device(args.device)
    world = args.model_parallel * getattr(args, "data_parallel", 1)
    results = spawn_cohort(_model_parallel_rank, world, args=(args, cfg),
                           device=args.device, timeout_s=MP_TIMEOUT_S, deadline_s=MP_DEADLINE_S)
    first = results[0]
    for r, res in enumerate(results):
        if (res.losses, res.grad_norms) != (first.losses, first.grad_norms):
            raise RuntimeError(f"rank {r} of the model group saw losses {res.losses} / grad "
                               f"norms {res.grad_norms}, rank 0 {first.losses} / "
                               f"{first.grad_norms}")
    first.by_rank = [res.by_rank[0] for res in results]
    return first


def _model_parallel_rank(rank: int, device, args: argparse.Namespace, cfg) -> TrainResult:
    """One rank of ``--model-parallel N`` (a grid's with ``--data-parallel
    D`` > 1): ``run`` on this rank's device; rank 0 logs."""
    args = argparse.Namespace(**{**vars(args), "device": str(device)})
    grid = make_grid(getattr(args, "data_parallel", 1), args.model_parallel)
    return run(args, cfg, echo=rank == 0, parallel=make_parallel(*grid, cfg=cfg))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="llama3.2-1b", choices=ARCH_IDS)
    ap.add_argument("--full", action="store_true", help="the published widths (else reduced)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--remat", default="none", choices=REMATS,
                    help="each period's rematerialisation in backward (dots: the weight "
                         "products' outputs kept)")
    ap.add_argument("--model-parallel", type=int, default=1, metavar="N",
                    help="train on N ranks of a model group: one card a rank over NCCL, or "
                         "gloo ranks with --device cpu (default 1: unsharded)")
    ap.add_argument("--data-parallel", type=int, default=1, metavar="D",
                    help="train on a D x N grid of D*N ranks (N: --model-parallel): each rank "
                         "its FSDP slice of its model share and B/D rows of each batch "
                         "(default 1)")
    return ap


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    for flag in ("model_parallel", "data_parallel"):
        if getattr(args, flag) < 1:
            ap.error(f"--{flag.replace('_', '-')} must be >= 1, got {getattr(args, flag)}")
    if args.batch % args.data_parallel:
        ap.error(f"--batch {args.batch} does not split over --data-parallel "
                 f"{args.data_parallel}")
    run(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
