"""Serving driver of the port: batched prefill → decode with a KV/SSM cache
(counterpart of ``repro.launch.serve``).

A batch of prompts is prefilled in one forward pass, which emits the cache
(prefill attention and the SSD scan go through the hand-written CUDA
kernels); the cache is merged into a ``prompt + gen`` buffer and tokens
are decoded step by step.  Greedy sampling (temperature 0) by default;
``--temperature`` samples from the softmax with a ``torch.Generator``.
``serve_loop`` is the reusable decode loop with step-boundary hot-swaps of
the served params, copied from the reference.

Weights are random, drawn from ``--seed`` on the serving device (f32, the
reference's ``param_dtype``; each use casts them to the activation dtype,
bf16 at full width).  Prompts come from the
synthetic Markov chain over the first ``min(vocab, 512)`` token ids: the
reference draws a dense (vocab, vocab) chain, 131.6 GB at llama3.2-1b's
vocabulary (ROADMAP queue C); at the reduced configs' vocab of 512 the two
draw the same prompts.  Runs on ``cuda`` and raises when there is no GPU,
unless ``--device cpu`` asks for the CPU (the kernels' plain versions).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b \
        --batch 4 --prompt-len 32 --gen 32 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b --full \
        --batch 4 --prompt-len 1024 --gen 32
"""
from __future__ import annotations

import argparse
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import REFERENCE_ARCH_IDS, get_config, reduced
from repro_torch.core.engine import resolve_device
from repro_torch.data.synthetic import make_synthetic_lm
from repro_torch.models.model import build_model
from repro_torch.utils.trees import tree_map

PROMPT_VOCAB = 512  # prompts draw from the chain over the first 512 token ids


@dataclass
class ServeStats:
    """What the serving loop did."""

    steps: int = 0  # decode steps executed
    sessions: int = 0  # completed sessions (prefill→gen sequences)
    swaps: int = 0  # hot-swaps taken (any step boundary)
    swaps_mid_session: int = 0  # swaps taken while a session was decoding
    swap_steps: List[int] = field(default_factory=list)  # global step at swap
    versions: List[int] = field(default_factory=list)  # version per swap
    served_version: int = 0  # version of the params currently served
    t_active_s: float = 0.0  # wall time spent inside sessions


def serve_loop(
    params: Any,
    decode_step: Callable[[Any, Any, int], Any],
    *,
    begin_session: Optional[Callable[[Any, int], Any]] = None,
    end_session: Optional[Callable[[Any, Any], None]] = None,
    params_provider: Optional[Any] = None,
    steps_per_session: int,
    max_sessions: Optional[int] = 1,
    stop_event: Optional[threading.Event] = None,
    on_swap: Optional[Callable[[int, ServeStats], None]] = None,
    on_step: Optional[Callable[[ServeStats], None]] = None,
    idle_sleep_s: float = 0.0,
    step_sleep_s: float = 0.0,
    version: int = 0,
) -> Tuple[Any, ServeStats]:
    """Run serving sessions, hot-swapping params between decode steps.

    ``decode_step(params, state, i)`` advances one decode step;
    ``begin_session(params, s)`` builds a fresh session state (prefill);
    ``end_session(params, state)`` closes one.  ``params_provider.poll()``
    — when given — is called before EVERY decode step and returns ``None``
    (unchanged) or a complete ``(version, params, meta)``; the swap is one
    reference assignment at the step boundary, so a decode step runs
    against exactly one version.  Runs until ``max_sessions`` sessions
    completed (``None`` = forever) or ``stop_event`` is set (checked between
    steps).  Returns the final (possibly swapped) params and the stats."""
    stats = ServeStats(served_version=version)

    def _swap(step_in_session: int) -> None:
        nonlocal params
        if params_provider is None:
            return
        got = params_provider.poll()
        if got is None:
            return
        new_version, new_params, _meta = got
        params = new_params
        stats.served_version = new_version
        stats.swaps += 1
        if step_in_session > 0:
            stats.swaps_mid_session += 1
        stats.swap_steps.append(stats.steps)
        stats.versions.append(new_version)
        if on_swap is not None:
            on_swap(new_version, stats)

    while max_sessions is None or stats.sessions < max_sessions:
        if stop_event is not None and stop_event.is_set():
            break
        t0 = time.perf_counter()
        _swap(0)
        state = begin_session(params, stats.sessions) if begin_session else None
        for i in range(steps_per_session):
            if stop_event is not None and stop_event.is_set():
                break
            if i > 0:
                _swap(i)
            state = decode_step(params, state, i)
            stats.steps += 1
            if on_step is not None:
                on_step(stats)
            if step_sleep_s > 0:
                time.sleep(step_sleep_s)
        else:
            if end_session is not None:
                end_session(params, state)
            stats.sessions += 1
        stats.t_active_s += time.perf_counter() - t0
        if idle_sleep_s > 0:
            time.sleep(idle_sleep_s)
    return params, stats


@dataclass
class ServeResult:
    """One ``run``: the served config's name, the last session's generated
    tokens ``(B, gen)``, the loop's stats, and the wall seconds of each
    session's prefill and decode (synchronized with the device at both
    ends)."""

    arch: str
    tokens: np.ndarray
    stats: ServeStats
    prefill_s: List[float]
    decode_s: List[float]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def merge(dst: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """Copy a prefill cache leaf into the leading part of its decode buffer
    (k/v: the first S positions; ssm/conv states: the whole leaf), as the
    reference's ``merge`` does with ``dynamic_update_slice``."""
    dst[tuple(slice(0, n) for n in src.shape)].copy_(src)
    return dst


def run(args: argparse.Namespace) -> ServeResult:
    """Build the model and prompts for ``args`` and serve ``args.sessions``
    sessions of ``args.gen`` tokens."""
    if args.ckpt or args.follow:
        raise NotImplementedError("--ckpt / --follow serve published params: the checkpoint "
                                  "and fleet layers are not ported yet (ROADMAP A.12, A.13)")
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if not args.full:
        cfg = reduced(cfg)
    model = build_model(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    params = model.init(gen)
    prompts = torch.as_tensor(
        make_synthetic_lm(min(cfg.vocab_size, PROMPT_VOCAB), args.prompt_len, args.batch,
                          seed=args.seed), dtype=torch.long, device=device)
    max_len = args.prompt_len + args.gen

    def sample(lg, generator):
        last = lg[:, -1].to(torch.float32)
        if args.temperature <= 0:
            return torch.argmax(last, dim=-1)[:, None]
        probs = torch.softmax(last / args.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)

    prefill_s: List[float] = []
    decode_s: List[float] = []
    last = {"gen": None}

    def begin_session(p, s):
        _sync(device)
        t0 = time.perf_counter()
        logits, pre_cache, _ = model.apply(p, prompts, return_cache=True)
        _sync(device)
        prefill_s.append(time.perf_counter() - t0)
        cache = tree_map(merge, model.init_cache(p, args.batch, max_len), pre_cache)
        generator = torch.Generator(device=device)
        generator.manual_seed(args.seed + 1 + s)
        tok = sample(logits, generator)
        _sync(device)
        return {"tok": tok, "cache": cache, "gen": generator, "out": [tok],
                "t0": time.perf_counter()}

    def decode_step(p, st, i):
        logits, cache = model.decode_step(p, st["tok"], st["cache"], args.prompt_len + i)
        tok = sample(logits, st["gen"])
        st["out"].append(tok)
        return {**st, "tok": tok, "cache": cache}

    def end_session(p, st):
        _sync(device)
        decode_s.append(time.perf_counter() - st["t0"])
        last["gen"] = torch.cat(st["out"], dim=1).cpu().numpy()

    _, stats = serve_loop(params, decode_step, begin_session=begin_session,
                          end_session=end_session, steps_per_session=args.gen - 1,
                          max_sessions=args.sessions)
    return ServeResult(cfg.name, last["gen"], stats, prefill_s, decode_s)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="llama3.2-1b", choices=REFERENCE_ARCH_IDS,
                    help="llama3.2-1b and mamba2-1.3b are ported; the others raise")
    ap.add_argument("--full", action="store_true", help="the published widths (else reduced)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", default="", help="not ported yet (ROADMAP A.12); raises")
    ap.add_argument("--follow", action="store_true", help="not ported yet (ROADMAP A.13); raises")
    ap.add_argument("--sessions", type=int, default=1,
                    help="prefill→decode sessions to run")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    res = run(args)
    n = max(res.stats.sessions, 1)
    t_prefill, t_decode = sum(res.prefill_s) / n, sum(res.decode_s) / n
    print(f"arch={res.arch} batch={args.batch} prompt={args.prompt_len} "
          f"gen={args.gen} sessions={res.stats.sessions}")
    print(f"prefill: {t_prefill*1e3:.1f} ms  "
          f"({args.batch*args.prompt_len/max(t_prefill,1e-9):.0f} tok/s)")
    print(f"decode:  {t_decode*1e3:.1f} ms  "
          f"({args.batch*(args.gen-1)/max(t_decode,1e-9):.0f} tok/s)")
    print("sample generations (first 16 tokens):")
    for b in range(min(args.batch, 4)):
        print("  ", res.tokens[b, :16].tolist())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
