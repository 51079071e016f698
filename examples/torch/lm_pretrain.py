"""End-to-end LM pre-training driver: a ~100M model for a few hundred steps.

    PYTHONPATH=src python examples/torch/lm_pretrain.py            # ~100M params
    PYTHONPATH=src python examples/torch/lm_pretrain.py --tiny     # CI-sized
    PYTHONPATH=src python examples/torch/lm_pretrain.py --tiny --device cpu

The counterpart of examples/lm_pretrain.py: a llama3-family config scaled
to ~100M params, trained on synthetic Markov-chain LM data through the
port's train step (``repro_torch.launch.steps``: AdamW, warmup-cosine,
gradient clipping), and it exits 1 unless the loss fell.  ``--device``
defaults to cuda, which raises without a GPU.
"""
import argparse
import math
import time
from dataclasses import replace

import torch

from repro_torch.configs.base import get_config
from repro_torch.core.engine import resolve_device, synchronize
from repro_torch.data import lm_batch_iterator, make_synthetic_lm
from repro_torch.launch.steps import Knobs, build_train_step
from repro_torch.optim.optimizers import warmup_cosine
from repro_torch.utils.trees import tree_leaves


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--tiny", action="store_true", help="2-layer CI variant")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    base = get_config("llama3.2-1b")
    if args.tiny:
        cfg = replace(base, name="llama3-tiny", n_layers=2, d_model=128, n_heads=4,
                      n_kv_heads=2, head_dim=32, d_ff=512, vocab_size=512,
                      dtype="float32", param_dtype="float32")
        args.steps = min(args.steps, 60)
    else:
        # ~100M: 12L, d=640, 10 heads, vocab 8192
        cfg = replace(base, name="llama3-100m", n_layers=12, d_model=640, n_heads=10,
                      n_kv_heads=5, head_dim=64, d_ff=2560, vocab_size=8192,
                      dtype="float32", param_dtype="float32")

    sched = warmup_cosine(3e-4, 30, args.steps)
    step = build_train_step(cfg, Knobs(remat="none", learning_rate=sched))
    params = step.model.init(torch.Generator(device=dev).manual_seed(0))
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"config {cfg.name}: ~{n_params/1e6:.1f}M params")
    opt_state = step.opt.init(params)

    toks = make_synthetic_lm(cfg.vocab_size, args.seq + 1, n_seqs=4096, temperature=0.3)
    it = lm_batch_iterator(toks, args.batch, device=dev)

    first_loss, t0 = None, time.time()
    for i in range(args.steps):
        params, opt_state, m = step.fn(params, opt_state, next(it))
        if i == 0:
            first_loss = float(m["loss"])
        if (i + 1) % 25 == 0:
            synchronize(dev)
            toks_s = args.batch * args.seq * 25 / (time.time() - t0)
            print(f"step {i+1:4d}  loss={float(m['loss']):.4f}  "
                  f"grad_norm={float(m['grad_norm']):.3f}  {toks_s:,.0f} tok/s")
            t0 = time.time()

    final = float(m["loss"])
    print(f"\nloss {first_loss:.3f} → {final:.3f} (uniform = {math.log(cfg.vocab_size):.3f})")
    if not final < first_loss:
        print("training must reduce loss")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
