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
``--device cpu`` asks for the CPU.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 20 \\
        --batch 4 --seq 32 --log-every 5
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b --full \\
        --batch 8 --seq 512 --steps 30 --warmup 5 --log-every 5
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch

from repro_torch.checkpoint.ckpt import latest_step, load_checkpoint, save_checkpoint
from repro_torch.configs.base import ARCH_IDS, get_config, reduced
from repro_torch.core.engine import resolve_device, synchronize
from repro_torch.data.pipeline import lm_batch_iterator
from repro_torch.data.synthetic import CHAIN_VOCAB, make_synthetic_lm, source_frames
from repro_torch.launch.steps import Knobs, build_train_step
from repro_torch.optim.optimizers import warmup_cosine
from repro_torch.utils.metrics import MetricLogger
from repro_torch.utils.trees import tree_leaves

N_SEQS = 2048


@dataclass
class TrainResult:
    """One ``run``: the config's name, its parameter count by top-level key
    of the params tree (``embed``, ``periods``, ``enc``, ...), the first
    step run (> 0 after a resume), each step's loss and grad norm and wall
    seconds (synchronized with the device at both ends), the logged rows,
    and the peak device memory in bytes (None on the CPU)."""

    arch: str
    param_counts: Dict[str, int]
    start_step: int
    losses: List[float]
    grad_norms: List[float]
    step_s: List[float]
    rows: List[dict]
    peak_bytes: Optional[int]


def run(args: argparse.Namespace, cfg=None, echo: bool = True) -> TrainResult:
    """Train for ``args``; ``cfg`` trains that config in place of
    ``--arch``'s (``--full`` / reduced)."""
    device = resolve_device(args.device)
    if cfg is None:
        cfg = get_config(args.arch)
        if not args.full:
            cfg = reduced(cfg)
    if cfg.is_encoder_decoder and echo:
        print("(enc-dec arch: tokens drive the decoder; src embeds are synthetic, drawn from a "
              "torch.Generator seeded from --seed and the step)")
    sched = warmup_cosine(args.lr, args.warmup, args.steps)
    step_fn = build_train_step(cfg, Knobs(remat="none", learning_rate=sched))
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    params = step_fn.model.init(gen)
    opt_state = step_fn.opt.init(params)

    start_step = 0
    if args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        tree, meta = load_checkpoint(args.ckpt_dir, None, {"params": params, "opt": opt_state})
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
            save_checkpoint(args.ckpt_dir, step + 1, {"params": params, "opt": opt_state})
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    if echo and metrics is not None:
        print(f"final loss: {losses[-1]:.4f}")
    counts = {k: sum(t.numel() for t in tree_leaves(v)) for k, v in params.items()}
    return TrainResult(cfg.name, counts, start_step, losses, norms, times, log.rows, peak)


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
    return ap


def main(argv=None) -> int:
    run(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
