"""Serving driver of the port: batched prefill → decode with a KV/SSM cache
(counterpart of ``repro.launch.serve``).

A batch of prompts is prefilled in one forward pass, which emits the cache
(prefill attention and the SSD scan go through the hand-written CUDA
kernels); the cache is merged into a buffer of ``--cache-len`` positions
(default ``prompt + gen``) and tokens are decoded step by step.
``--shape NAME`` takes the batch and the cache length from a workload
shape (``configs.base.SHAPES``; long_500k, B 1 against a 524,288-deep
cache, only for the sub-quadratic archs, ``launch.dryrun.LONG_OK``).
Greedy sampling (temperature 0) by default; ``--temperature`` samples
from the softmax with a ``torch.Generator``.
``serve_loop`` is the reusable decode loop with step-boundary hot-swaps of
the served params, copied from the reference.

The encoder-decoder (seamless-m4t-large-v2) serves as the reference's
``_serve_encdec`` does: one session that encodes ``(batch, prompt_len,
d_model)`` source frames once (the encoder's attention through the
flash-attention kernel), precomputes each decoder layer's cross-attention
K/V, and decodes ``--gen`` greedy tokens from BOS 0 at positions 0 … gen−1.
Its frames come from a ``torch.Generator`` seeded from ``--seed`` (the
reference draws them with threefry); ``--ckpt`` serves published params,
``--follow`` is refused.

``--ckpt DIR`` serves published params (``repro_torch.fleet.publisher``
layout: ``LATEST.json`` + ``step_<v>.msgpack``, from either package) in
place of random init, and ``--ckpt DIR/step_<v>.msgpack`` one version of
them; ``--follow`` keeps watching the directory and hot-swaps each new
version between decode steps, so a decode step runs against exactly one
complete version.

``--model-parallel N`` serves any of the ten archs on N ranks of a model
group (``repro_torch.launch.mesh``; the reference's mesh with a ``"model"``
axis of N and data axes of 1): each rank draws its share of the weights
(``repro_torch.sharding.shard.init_params_sharded``, bitwise its slice of
the unsharded draw), runs ``run`` on the same prompts (the encoder-decoder:
the same seeded source frames) with its heads, SSD heads, hidden columns,
experts and vocabulary rows, and every rank feeds the same token (at
``--temperature`` > 0 rank 0 draws it and broadcasts it; the
encoder-decoder's greedy token is broadcast from rank 0 at every step);
rank 0's session lines are printed.  N ranks run on ``cuda:0`` …
``cuda:N−1`` over NCCL, or on the CPU over gloo with ``--device cpu``.
``--ckpt`` under a group: each rank loads the published version and keeps
its share of it (``sharding.shard.snapshot_take``); with ``--follow`` rank
0 alone polls the pointer and broadcasts the version at every step
boundary, and every rank loads exactly that one
(``fleet.publisher.GroupParamsWatch``), so every rank swaps at the same
decode step.

``--data-parallel D`` adds the grid's data axis (the reference's
``("data", "model")`` mesh): D·N ranks, ``make_grid(D, N)``, each drawing
its share in the ``--serve-params`` layout (``fsdp``: sliced over the data
ranks as training stores it; ``replicated``: only the MoE expert banks
sliced over data).  Where D divides ``--batch`` each data row serves its
block of the rows (every rank draws the same prompts and keeps its block;
a MoE routes each row's tokens at its own capacity), and rank 0's lines
report the whole batch, gathered over the data ranks.  Where it does not
(long_500k's B = 1) every rank serves every row and holds a contiguous
1/D slab of each attention cache's sequence (``merge_prefill``; the
decode attention combines the slabs over the data group,
``models.layers.attend_slabs``).  Under ``--follow`` the watch spans the
world, so every rank swaps at the same step.

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
    PYTHONPATH=src python -m repro_torch.launch.serve --ckpt runs/pub --follow \
        --sessions 8
    PYTHONPATH=src python -m repro_torch.launch.serve --arch chameleon-34b --full \
        --model-parallel 4 --batch 4 --prompt-len 1024 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b --full \
        --shape long_500k --prompt-len 32768 --data-parallel 2 --model-parallel 2
"""
from __future__ import annotations

import argparse
import os
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import ARCH_IDS, SHAPES, get_config, reduced
from repro_torch.core.engine import resolve_device, synchronize
from repro_torch.data.synthetic import CHAIN_VOCAB, make_synthetic_lm, source_frames
from repro_torch.launch.dryrun import skip_reason
from repro_torch.launch.mesh import make_grid, make_model_group, spawn_cohort
from repro_torch.launch.steps import (
    SERVE_PARAMS, Knobs, build_prefill_step, make_parallel, param_mode,
)
from repro_torch.models import encdec
from repro_torch.models.layers import ParallelContext, seq_split
from repro_torch.models.model import build_model
from repro_torch.sharding.rules import _keys, check_model_parallel, row_block, serve_splits_batch
from repro_torch.sharding.shard import fsdp_map, init_params_sharded, snapshot_take
from repro_torch.utils.trees import tree_flatten_with_path, tree_leaves, tree_map

# a model group's collectives wait this long for a rank (its weights may
# still be drawing), and the whole world this long
MP_TIMEOUT_S, MP_DEADLINE_S = 600.0, 3600.0


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
    tokens ``(B, gen)`` (on a grid that splits the batch, every data row's,
    gathered), the loop's stats, the wall seconds of each session's prefill
    and decode (synchronized with the device at both ends), whether every
    logit that was sampled from was finite, and whether the config is the
    encoder-decoder (its prefill is the encode)."""

    arch: str
    tokens: np.ndarray
    stats: ServeStats
    prefill_s: List[float]
    decode_s: List[float]
    finite: bool
    encoder_decoder: bool = False


def merge(dst: torch.Tensor, src: torch.Tensor, start: Optional[int] = None) -> torch.Tensor:
    """Copy a prefill cache leaf into the leading part of its decode buffer
    (k/v: the first S positions; ssm/conv states: the whole leaf), as the
    reference's ``merge`` does with ``dynamic_update_slice``.  With
    ``start``, a stacked k/v leaf ``(n, B, S, Hkv, hd)`` whose buffer is the
    slab of the sequence from ``start`` on: the prompt's positions that
    fall in the slab, to its front."""
    if start is None:
        dst[tuple(slice(0, n) for n in src.shape)].copy_(src)
        return dst
    n = max(0, min(src.shape[2] - start, dst.shape[2]))
    dst[:, :, :n].copy_(src[:, :, start:start + n])
    return dst


def merge_prefill(cache: Any, pre: Any, parallel: Optional[ParallelContext] = None) -> Any:
    """The prefill's cache ``pre`` merged into the decode buffers ``cache``
    (``init_cache``'s), leaf for leaf (``merge``); where a grid's data group
    splits the sequence each attention leaf takes its slab's part of the
    prompt (``ParallelContext.slab_start``), the mamba states all of theirs."""
    if not seq_split(parallel):
        return tree_map(merge, cache, pre)
    for (path, dst), src in zip(tree_flatten_with_path(cache)[0], tree_leaves(pre)):
        slab = _keys(path)[-1] in ("k", "v")
        merge(dst, src, parallel.slab_start(dst.shape[2]) if slab else None)
    return cache


def load_ckpt_params(path: str, template: Any, *, follow: bool = False, cfg=None,
                     parallel: Optional[ParallelContext] = None, mode: str = "train"):
    """Resolve ``--ckpt`` → ``(version, params, provider-or-None)``.

    ``path`` is a publisher directory (``LATEST.json`` pointer) or a single
    ``step_<v>.msgpack`` payload file from one; ``template`` (the model's
    params tree) fixes the structure and the device.  On a model group or a
    grid (``parallel``, ``cfg`` the served config, ``mode`` the layout of
    ``Knobs.serve_params``) ``template`` is the rank's share, each rank
    keeps its share of the published version, and the directory's watch is
    the world's (``GroupParamsWatch``): on a grid the data group's gathers
    need every rank to swap at the same step to the same version."""
    from repro_torch.fleet.publisher import GroupParamsWatch, ParamsWatch, load_published

    take = None if parallel is None else snapshot_take(
        cfg, parallel.rank, parallel.size, parallel.data_rank, parallel.data_size, mode)
    if os.path.isdir(path):
        if parallel is None:
            watcher = ParamsWatch(path, template=template)
        else:
            group = parallel.group if parallel.data_size == 1 else dist.group.WORLD
            watcher = GroupParamsWatch(path, template, group, take=take)
        try:
            got = watcher.poll()
        except KeyError as e:
            raise SystemExit(
                f"--ckpt {path}: published params do not match this serving model's "
                f"template ({e}) — the directory was published by a different model "
                f"(e.g. a fed_train classifier run, not --arch)") from e
        if got is None:
            raise FileNotFoundError(f"--ckpt {path}: no LATEST.json — nothing published yet")
        version, params, _ = got
        return version, params, (watcher if follow else None)
    d, name = os.path.split(path)
    if not (name.startswith("step_") and name.endswith(".msgpack")):
        raise ValueError(f"--ckpt {path}: expected a publisher directory or a "
                         f"step_<version>.msgpack payload")
    version, params, _ = load_published(d, template, int(name[len("step_"):-len(".msgpack")]),
                                        take)
    return version, params, None


def _rows(batch: int, parallel: Optional[ParallelContext]) -> slice:
    """The rows of the served batch this rank serves: its data row's block
    where a grid's data group splits the batch, else all of them."""
    if parallel is None or parallel.data_size == 1 or parallel.seq_split:
        return slice(0, batch)
    lo, n = row_block(batch, parallel.data_size, parallel.data_rank)
    return slice(lo, lo + n)


def share_token(tok: torch.Tensor, parallel: Optional[ParallelContext]) -> torch.Tensor:
    """Every rank of ``tok``'s rows takes one rank's draw, written into
    ``tok``: over the model group from its first rank, or, where a grid's
    data group splits the sequence (every rank serves every row), over the
    world from rank 0."""
    if parallel is None:
        return tok
    if seq_split(parallel):
        dist.broadcast(tok, src=0)
    else:
        dist.broadcast(tok, src=dist.get_global_rank(parallel.group, 0), group=parallel.group)
    return tok


def gather_rows(t: torch.Tensor, parallel: Optional[ParallelContext]) -> torch.Tensor:
    """The whole batch's rows of ``t`` (this rank's rows first dimension):
    on a grid that splits the batch, every data row's block joined in data
    rank order (an ``all_gather`` over the data group); else ``t``."""
    if parallel is None or parallel.data_size == 1 or parallel.seq_split:
        return t
    parts = [torch.empty_like(t) for _ in range(parallel.data_size)]
    dist.all_gather(parts, t.contiguous(), group=parallel.data_group)
    return torch.cat(parts)


class SessionSteps:
    """A decoder-only serving session's device work, with no host read, as
    ``run`` serves it and the dry-run (``launch.dryrun``) runs it on fake
    tensors: ``begin`` prefills ``prompts`` (this rank's rows), merges
    their cache into ``init_cache``'s buffers of ``cache_len`` positions
    and samples the first token; ``step`` decodes one token; ``tokens``
    joins a session's tokens (every data row's on a grid that splits the
    batch).  ``finite`` is a device flag, cleared by any non-finite logit
    sampled from.  ``on_logits`` and ``feed`` are ``run``'s hooks."""

    def __init__(self, model, parallel: Optional[ParallelContext], prompts: torch.Tensor,
                 batch: int, cache_len: int, *, temperature: float = 0.0,
                 on_logits: Optional[Callable[[int, int, torch.Tensor], None]] = None,
                 feed: Optional[torch.Tensor] = None) -> None:
        self.model, self.parallel, self.prompts = model, parallel, prompts
        self.batch, self.cache_len, self.temperature = batch, cache_len, temperature
        self.on_logits, self.feed = on_logits, feed
        self.prefill = build_prefill_step(model, parallel)
        self.finite = torch.ones((), dtype=torch.bool, device=prompts.device)

    def sample(self, last, generator, s, i):
        """The next token from the last position's logits ``(rows, V)``; over
        a group one rank draws it and every rank of its rows takes it
        (``share_token``)."""
        last = last.to(torch.float32)
        self.finite.logical_and_(torch.isfinite(last).all())
        if self.on_logits is not None:
            self.on_logits(s, i, last)
        if self.temperature <= 0:
            return torch.argmax(last, dim=-1)[:, None]
        probs = torch.softmax(last / self.temperature, dim=-1)
        return share_token(torch.multinomial(probs, 1, generator=generator), self.parallel)

    def _fed_or(self, tok, i):
        return tok if self.feed is None else self.feed[:, i:i + 1]

    def begin(self, p, s: int, generator, after_prefill: Optional[Callable[[], None]] = None):
        """Session ``s``'s state after its prefill; ``after_prefill()`` is
        called once the prefill is queued (``run`` times it there)."""
        logits, pre_cache = self.prefill(p, self.prompts)
        if after_prefill is not None:
            after_prefill()
        cache = merge_prefill(self.model.init_cache(p, self.batch, self.cache_len, self.parallel),
                              pre_cache, self.parallel)
        del pre_cache
        tok = self.sample(logits, generator, s, 0)
        return {"tok": self._fed_or(tok, 0), "cache": cache, "gen": generator, "out": [tok],
                "session": s}

    def step(self, p, st, i: int):
        """The state after decode step ``i`` of the session."""
        logits, cache = self.model.decode_step(p, st["tok"], st["cache"],
                                               self.prompts.shape[1] + i, self.parallel)
        tok = self.sample(logits[:, -1], st["gen"], st["session"], i + 1)
        st["out"].append(tok)
        return {**st, "tok": self._fed_or(tok, i + 1), "cache": cache}

    def tokens(self, st) -> torch.Tensor:
        """The session's tokens so far, ``(B, steps + 1)``."""
        return gather_rows(torch.cat(st["out"], dim=1), self.parallel)


def _serve_encdec(model, params, args, device, version: int,
                  src: Optional[torch.Tensor],
                  parallel: Optional[ParallelContext] = None) -> ServeResult:
    """One session: encode the source frames once, build the cross cache,
    decode ``args.gen`` greedy tokens from BOS 0 into a self cache of
    ``--cache-len`` positions (default ``gen``).  The prefill time is the
    encode time (the cross K/V included).  Over a group every rank encodes
    the same frames on its heads, and each step's token is one rank's
    (``share_token``); on a grid each data row encodes its rows, or every
    rank all of them with its slab of the source and of the self cache."""
    cfg = model.cfg
    if src is None:
        src = source_frames(args.batch, args.prompt_len, cfg.d_model, args.seed + 2, device)
    rows = _rows(args.batch, parallel)
    src = src[rows]
    finite = torch.ones((), dtype=torch.bool, device=device)
    synchronize(device)
    t0 = time.perf_counter()
    enc_out = encdec.encode(params, src.to(device), cfg=cfg, use_kernels=True,
                            parallel=parallel)
    cache = model.init_cache(params, args.batch, args.cache_len or args.gen, enc_out=enc_out,
                             parallel=parallel)
    synchronize(device)
    t_enc = time.perf_counter() - t0
    tok = torch.zeros((src.shape[0], 1), dtype=torch.long, device=device)  # BOS
    outs = []
    t0 = time.perf_counter()
    for i in range(args.gen):
        logits, cache = model.decode_step(params, tok, cache, i, parallel)
        last = logits[:, -1].to(torch.float32)
        finite.logical_and_(torch.isfinite(last).all())
        tok = share_token(torch.argmax(last, dim=-1)[:, None], parallel)
        outs.append(tok)
    synchronize(device)
    t_dec = time.perf_counter() - t0
    stats = ServeStats(steps=args.gen, sessions=1, served_version=version, t_active_s=t_enc + t_dec)
    tokens = gather_rows(torch.cat(outs, dim=1), parallel)
    return ServeResult(cfg.name, tokens.cpu().numpy(), stats, [t_enc], [t_dec],
                       bool(finite), encoder_decoder=True)


def with_shape(args: argparse.Namespace) -> argparse.Namespace:
    """``args`` with ``--shape``'s batch and cache length (``SHAPES``) in
    place of ``--batch`` / ``--cache-len``; refuses an arch that the shape
    does not serve (``launch.dryrun.skip_reason``: long_500k is the
    sub-quadratic archs', ``LONG_OK``)."""
    name = getattr(args, "shape", None)
    if not name:
        return args
    if name not in SHAPES:
        raise ValueError(f"unknown --shape {name!r}; known: {sorted(SHAPES)}")
    reason = skip_reason(args.arch, name)
    if reason is not None:
        raise ValueError(f"--shape {name} for {args.arch}: {reason}")
    shape = SHAPES[name]
    return argparse.Namespace(**{**vars(args), "batch": shape.global_batch,
                                 "cache_len": shape.seq_len})


def check_model_parallel_args(args: argparse.Namespace, cfg, world: int,
                              data: Optional[int] = None) -> None:
    """Refuse what a model group of ``world`` > 1 ranks does not serve: an
    expert count the group does not divide (``check_model_parallel``); and
    what a grid's data group of ``--data-parallel`` D ranks does not split:
    a batch D divides neither into rows nor, falling back to the caches'
    sequence, by a cache length (and an encoder-decoder's source length)
    that D divides.  Refuses a cache shorter than a session."""
    need = args.gen if cfg.is_encoder_decoder else args.prompt_len + args.gen
    cache_len = args.cache_len or need
    if cache_len < need:
        raise ValueError(f"--cache-len {cache_len} is shorter than a session's "
                         f"{'--gen' if cfg.is_encoder_decoder else '--prompt-len + --gen'} "
                         f"({need})")
    data = getattr(args, "data_parallel", 1) if data is None else data
    if data > 1 and not serve_splits_batch(args.batch, data):
        lengths = [("--cache-len", cache_len)]
        if cfg.is_encoder_decoder:
            lengths.append(("source length (--prompt-len)", args.prompt_len))
        for what, n in lengths:
            if n % data:
                raise ValueError(
                    f"--batch {args.batch} does not split over --data-parallel {data}, nor "
                    f"does the {what} {n} into {data} slabs of the caches' sequence")
    if world > 1:
        check_model_parallel(cfg, world)


def serve_config(args: argparse.Namespace):
    """``--arch``'s config: published with ``--full``, else reduced."""
    cfg = get_config(args.arch)
    return cfg if args.full else reduced(cfg)


def serve_knobs(args: argparse.Namespace) -> Knobs:
    """The step knobs ``args`` sets: ``--serve-params``, the params' layout
    on a grid."""
    return Knobs(serve_params=args.serve_params)


def grid_context(args: argparse.Namespace, cfg) -> ParallelContext:
    """This rank's context for serving ``args`` on its world of
    ``--data-parallel`` D × ``--model-parallel`` M ranks: the model group
    of the world at D = 1 (``make_model_group``), else a grid
    (``make_grid``) whose shares are in the ``serve_knobs`` layout and
    whose data group splits the batch or the caches' sequence."""
    data, model = getattr(args, "data_parallel", 1), args.model_parallel
    if data == 1:
        return make_model_group(model)
    return make_parallel(*make_grid(data, model), cfg=cfg, knobs=serve_knobs(args),
                         batch=with_shape(args).batch)


def run(args: argparse.Namespace, on_step: Optional[Callable[[ServeStats], None]] = None,
        cfg=None, src_embeds: Optional[torch.Tensor] = None,
        parallel: Optional[ParallelContext] = None, *,
        on_logits: Optional[Callable[[int, int, torch.Tensor], None]] = None,
        feed: Optional[np.ndarray] = None) -> ServeResult:
    """Build the model and prompts for ``args`` and serve ``args.sessions``
    sessions of ``args.gen`` tokens; ``on_step`` is ``serve_loop``'s
    per-step callback.  ``cfg`` serves that config in place of ``--arch``'s
    (``--full`` / reduced): a published one cut in depth, say.  An
    encoder-decoder serves one session of ``src_embeds`` (default: the
    seeded ``source_frames``).  ``parallel`` serves this rank's share of a
    model group or a grid (every rank of the world calls ``run`` alike;
    ``grid_context``).

    Two hooks of a comparison, decoder-only: ``on_logits(session, step,
    logits)`` sees each sampled-from ``(rows, V)`` of the rank's rows (step
    0 the prefill's), and ``feed`` (``(B, gen)`` tokens) is fed at each
    step in place of the sampled token, which is still returned."""
    args = with_shape(args)
    device = resolve_device(args.device)
    if cfg is None:
        cfg = serve_config(args)
    if cfg.is_encoder_decoder and args.follow:
        raise ValueError("--follow is not served for the encoder-decoder: it runs one session")
    check_model_parallel_args(args, cfg, 1 if parallel is None else parallel.size,
                              1 if parallel is None else parallel.data_size)
    mode = param_mode(serve_knobs(args))
    if parallel is not None and parallel.data_size > 1:
        if parallel.seq_split == serve_splits_batch(args.batch, parallel.data_size):
            has, wants = ("sequence", "batch") if parallel.seq_split else ("batch", "sequence")
            raise ValueError(f"the grid's context splits the {has} but --batch {args.batch} on "
                             f"{parallel.data_size} data ranks wants the {wants} split")
        if parallel.fsdp != fsdp_map(cfg, parallel.size, parallel.data_size, mode):
            raise ValueError(f"the grid's context stores another layout than --serve-params "
                             f"{args.serve_params}'s (make_parallel(..., knobs=))")
    model = build_model(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    if parallel is None:
        params = model.init(gen)
    else:
        # the kept slices wait on the host while whole leaves are drawn on the card
        params = init_params_sharded(gen, cfg, parallel.rank, parallel.size,
                                     stage="cpu" if device.type == "cuda" else None,
                                     data=parallel.data_size, data_rank=parallel.data_rank,
                                     mode=mode)
    version, provider = 0, None
    if args.ckpt:
        version, params, provider = load_ckpt_params(args.ckpt, params, follow=args.follow,
                                                     cfg=cfg, parallel=parallel, mode=mode)
        if parallel is None or dist.get_rank() == 0:
            print(f"serving published params: version {version} from {args.ckpt}")
    if cfg.is_encoder_decoder:
        return _serve_encdec(model, params, args, device, version, src_embeds, parallel)
    rows = _rows(args.batch, parallel)
    prompts = torch.as_tensor(
        make_synthetic_lm(min(cfg.vocab_size, CHAIN_VOCAB), args.prompt_len, args.batch,
                          seed=args.seed)[rows], dtype=torch.long, device=device)
    fed = None if feed is None else torch.as_tensor(np.asarray(feed)[rows], dtype=torch.long,
                                                    device=device)
    session = SessionSteps(model, parallel, prompts, args.batch,
                           args.cache_len or args.prompt_len + args.gen,
                           temperature=args.temperature, on_logits=on_logits, feed=fed)
    prefill_s: List[float] = []
    decode_s: List[float] = []
    last = {"gen": None}

    def begin_session(p, s):
        synchronize(device)
        t0 = time.perf_counter()

        def timed():
            synchronize(device)
            prefill_s.append(time.perf_counter() - t0)

        generator = torch.Generator(device=device)
        generator.manual_seed(args.seed + 1 + s)
        st = session.begin(p, s, generator, after_prefill=timed)
        synchronize(device)
        return {**st, "t0": time.perf_counter()}

    def end_session(p, st):
        synchronize(device)
        decode_s.append(time.perf_counter() - st["t0"])
        last["gen"] = session.tokens(st).cpu().numpy()
        del st["cache"]  # freed before the next session's prefill allocates its own

    _, stats = serve_loop(params, session.step, begin_session=begin_session,
                          end_session=end_session, params_provider=provider,
                          steps_per_session=args.gen - 1, max_sessions=args.sessions,
                          on_step=on_step, version=version)
    return ServeResult(cfg.name, last["gen"], stats, prefill_s, decode_s,
                       bool(session.finite))


def run_model_parallel(args: argparse.Namespace, argv: List[str]) -> List[ServeResult]:
    """``--model-parallel N`` and ``--data-parallel D``: ``run`` in D·N
    spawned ranks of a model group or a D × N grid (NCCL on D·N cards, gloo
    with ``--device cpu``); their results in rank order.  ``argv`` is the
    command line each rank parses."""
    args = with_shape(args)
    check_model_parallel_args(args, serve_config(args), args.model_parallel)
    resolve_device(args.device)
    return spawn_cohort(_model_parallel_rank, args.data_parallel * args.model_parallel,
                        args=(argv,), device=args.device, timeout_s=MP_TIMEOUT_S,
                        deadline_s=MP_DEADLINE_S)


def _model_parallel_rank(rank: int, device, argv: List[str]) -> ServeResult:
    """One rank of ``--model-parallel N`` / ``--data-parallel D``: ``run`` on
    this rank's device."""
    args = build_parser().parse_args(argv)
    args.device = str(device)
    cfg = serve_config(args)
    return run(args, cfg=cfg, parallel=grid_context(args, cfg))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="llama3.2-1b", choices=ARCH_IDS,
                    help="any of the ten archs; seamless-m4t-large-v2 (encoder-decoder) "
                         "encodes --prompt-len source frames and decodes --gen tokens in "
                         "one session")
    ap.add_argument("--full", action="store_true", help="the published widths (else reduced)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--cache-len", type=int, default=0, metavar="N",
                    help="positions of the decode cache (default 0: --prompt-len + --gen; "
                         "the encoder-decoder: --gen); at least that")
    ap.add_argument("--shape", default="", choices=["", *SHAPES],
                    help="take --batch and --cache-len from a workload shape (long_500k: "
                         "B 1 against a 524,288-deep cache, the sub-quadratic archs only)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", default="",
                    help="serve published params (a publisher directory or one of its "
                         "step_<v>.msgpack files) instead of random init")
    ap.add_argument("--follow", action="store_true",
                    help="with --ckpt DIR: keep watching for new published versions and "
                         "hot-swap them between decode steps")
    ap.add_argument("--sessions", type=int, default=1,
                    help="prefill→decode sessions to run")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--model-parallel", type=int, default=1, metavar="N",
                    help="serve the model on N ranks of a model group: one card a rank over "
                         "NCCL, or gloo ranks with --device cpu (default 1: unsharded)")
    ap.add_argument("--data-parallel", type=int, default=1, metavar="D",
                    help="D rows of --model-parallel ranks, a D x N grid: each data row serves "
                         "its block of the batch, or, where D does not divide --batch, every "
                         "rank serves every row and holds a 1/D slab of each attention cache's "
                         "sequence (default 1)")
    ap.add_argument("--serve-params", default="fsdp", choices=tuple(SERVE_PARAMS),
                    help="the params' layout on a grid: fsdp (default) stores them as training "
                         "does, sliced over the data ranks and gathered a period at a time; "
                         "replicated keeps only the MoE expert banks sliced over data")
    return ap


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.follow and not args.ckpt:
        ap.error("--follow watches the --ckpt directory — add --ckpt DIR")
    if args.model_parallel < 1:
        ap.error(f"--model-parallel must be >= 1, got {args.model_parallel}")
    if args.data_parallel < 1:
        ap.error(f"--data-parallel must be >= 1, got {args.data_parallel}")
    try:
        args = with_shape(args)
        if args.model_parallel * args.data_parallel > 1:
            res = run_model_parallel(args, sys.argv[1:] if argv is None else list(argv))[0]
        else:
            res = run(args)
    except ValueError as e:  # an option this arch does not serve
        ap.error(str(e))
    if res.encoder_decoder:
        t_enc, t_dec = res.prefill_s[0], res.decode_s[0]
        print(f"encdec arch={res.arch}: encode {t_enc*1e3:.1f}ms, decode {t_dec*1e3:.1f}ms "
              f"({args.batch*args.gen/max(t_dec,1e-9):.0f} tok/s)")
        print("sample:", res.tokens[0, :16].tolist())
        return 0
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
