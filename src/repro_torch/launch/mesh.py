"""The cohort group, the model group and the ranks behind them: one process a shard.

Counterpart of ``repro.launch.mesh.make_cohort_mesh`` and of the model axis
of its production mesh.  The reference runs the cohort-parallel round, and
the model-parallel prefill and decode, as one SPMD program over a device
mesh; the port runs one process a shard, joined by a ``torch.distributed``
process group.  ``spawn_cohort`` starts the ranks (of either kind of world),
and ``make_cohort_group`` / ``make_model_group`` give the engine / the
model the group inside each of them; ``make_grid`` splits a world of
``data · model`` ranks into the reference's ``("data", "model")`` mesh, a
model group a row and a data group a column.

Backends: NCCL when the ranks are on distinct cards (rank r on ``cuda:r``);
gloo when the ranks run on the CPU, or when the caller asks for it, which
is how ranks that share one card are joined (gloo stages CUDA tensors
through the host).  Nothing switches backend on its own.

Every world has a timeout on its collectives (``timeout_s``: a rank that
died leaves the others blocked in a collective only that long) and a
deadline on its join (``deadline_s``), past which every rank is killed; a
rank that fails ends the world at once.

    results = spawn_cohort(fn, 4, args=(...), device="cpu")   # gloo
    results = spawn_cohort(fn, 2, device="cuda")              # NCCL, cuda:0-1
    results = spawn_cohort(fn, 4, device="cuda", backend="gloo")  # cuda:0 shared

``device`` is required: no world starts on the CPU unless the caller asks.

``fn(rank, device, *args)`` runs in rank ``rank`` after the group is up, on
``device`` (a ``torch.device``); it must be importable by name (spawned
ranks re-import its module) and return a picklable value, which
``spawn_cohort`` returns in rank order.

The production layouts (counterpart of ``make_production_mesh``): the
reference's single-pod ``(16, 16)`` mesh is a grid of data 16 × model 16,
and its multi-pod ``(2, 16, 16)`` one data 32 × model 16, since its FSDP
axes are ``(pod, data)``: the pod folds into the data axis.
``make_production_grid`` / ``make_test_grid`` give ``(data, model)``, and
``fake_world(data, model, rank)`` runs one rank of such a grid in this
process alone: torch's fake process group (which sends nothing) with the
grid's groups over it, for a dry-run (``launch.dryrun``).

The card's constants, which the dry-run's roofline reads, are the NVIDIA
H100 SXM's (80 GB, 700 W power limit; the figures ``PERF.md`` bounds every
kernel with), in place of the reference's TPU v5e ones.
"""
from __future__ import annotations

import contextlib
import datetime
import math
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.launch.steps import make_parallel
from repro_torch.sharding.rules import cohort_axis_size

BACKENDS = ("nccl", "gloo")

# NVIDIA H100 SXM (80 GB HBM3, 700 W power limit), per card
PEAK_FLOPS_BF16 = 989e12  # FLOP/s, bf16 tensor cores, dense
PEAK_FLOPS_F32 = 67e12  # FLOP/s, f32 outside the tensor cores
HBM_BW = 3.35e12  # bytes/s
NVLINK_BW = 450e9  # bytes/s each direction (NVLink 4, 18 links)
HBM_BYTES = 85_017_493_504  # "80 GB": torch.cuda.get_device_properties(0).total_memory
# torch's cuBLAS workspaces on sm_90 (CUBLAS_WORKSPACE_CONFIG and
# CUBLASLT_WORKSPACE_SIZE unset), each taken from the caching allocator:
# one a thread (and stream) that runs a cuBLAS GEMM, one a thread that runs
# a cuBLASLt GEMM with a bias epilogue
CUBLAS_WORKSPACE_BYTES = 4096 * 8 * 1024
CUBLASLT_WORKSPACE_BYTES = 1024 * 1024

SINGLE_POD_SHAPE = (16, 16)  # the reference's (data, model) mesh: 256 cards
MULTI_POD_SHAPE = (2, 16, 16)  # its (pod, data, model) mesh: 512 cards


class RankFailure(RuntimeError):
    """A rank of a cohort world raised, exited without a result or outlived
    the deadline.  ``exitcodes`` maps each rank that ended without a result
    or a traceback to its exit code (negative: killed by the launcher when
    the world failed), ``errors`` each rank that raised to its traceback."""

    def __init__(self, msg: str, exitcodes: Dict[int, Optional[int]], errors: Dict[int, str]):
        super().__init__(msg)
        self.exitcodes = exitcodes
        self.errors = errors


def resolve_backend(device, backend: Optional[str]) -> str:
    """The world's backend: NCCL for ranks on cards, gloo on the CPU, or
    the caller's explicit choice (gloo for ranks that share a card)."""
    dev = torch.device(device)
    if backend is None:
        return "gloo" if dev.type == "cpu" else "nccl"
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; known: {BACKENDS}")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend joins ranks on CUDA cards; ranks on the CPU "
                         "use gloo")
    return backend


def check_cards(n_shards: int, device, backend: str) -> None:
    """Refuse a world that asks for more cards than are visible (NCCL puts
    one rank on a card), or a CUDA world on a machine with none."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    need = n_shards if backend == "nccl" else 1
    if need > visible:
        raise ValueError(
            f"cohort group wants {need} CUDA card{'s' if need > 1 else ''} for "
            f"{n_shards} {backend} ranks but only {visible} are visible (ranks that share "
            f"one card: backend='gloo'; on the CPU: device='cpu')")


def rank_device(rank: int, device, backend: str) -> torch.device:
    """Rank ``rank``'s device: the CPU, ``cuda:rank`` under NCCL, or the
    cards in turn under gloo (``cuda:0`` for every rank on a one-card
    machine)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if backend == "nccl":
        return torch.device("cuda", rank)
    return torch.device("cuda", rank % torch.cuda.device_count())


def make_cohort_group(n_shards: int = 0):
    """The process group the cohort-parallel engine shards over: the
    default group of this rank's world, whose size must be ``n_shards`` (0:
    any size).  Raises when no world is up, naming how to start one."""
    if not dist.is_initialized():
        raise ValueError(
            f"cohort_shard={n_shards} needs a process group of {n_shards} ranks and none "
            f"is initialized; start the ranks with repro_torch.launch.mesh.spawn_cohort "
            f"(CLI: --cohort-shard {n_shards}) or pass cohort_group=")
    group = dist.group.WORLD
    size = cohort_axis_size(group)
    if n_shards and size != n_shards:
        raise ValueError(f"cohort_shard={n_shards} but the process group has {size} ranks")
    return group


def make_model_group(n_ranks: int = 0):
    """The model group of this rank's world (``steps.make_parallel`` of the
    default group), whose size must be ``n_ranks`` (0: any size).
    Raises when no world is up, naming how to start one."""
    if not dist.is_initialized():
        raise ValueError(
            f"a model group of {n_ranks} ranks needs an initialized process group; start "
            f"the ranks with repro_torch.launch.mesh.spawn_cohort (CLI: serve "
            f"--model-parallel {n_ranks})")
    ctx = make_parallel(dist.group.WORLD)
    if n_ranks and ctx.size != n_ranks:
        raise ValueError(f"model group of {n_ranks} ranks but the process group has "
                         f"{ctx.size}")
    return ctx


def make_grid(data: int, model: int):
    """This rank's ``(model group, data group)`` on a grid of ``data`` ×
    ``model`` ranks, the reference's ``("data", "model")`` mesh: world rank
    ``r = d·model + m`` sits in model row d (ranks ``d·model`` …
    ``d·model + model − 1``) and data column m (ranks m, model + m, …).
    Every rank creates every row's and every column's group, rows first,
    in the same order, as ``torch.distributed.new_group`` requires; a group
    that spans the world is the default group, so ``data = 1`` gives
    ``make_model_group``'s group and ``model = 1`` ``make_cohort_group``'s.
    Raises unless the world has ``data · model`` ranks."""
    if not dist.is_initialized():
        raise ValueError(
            f"a {data} x {model} grid needs an initialized process group of {data * model} "
            f"ranks; start them with repro_torch.launch.mesh.spawn_cohort")
    world, rank = dist.get_world_size(), dist.get_rank()
    if data < 1 or model < 1 or world != data * model:
        raise ValueError(f"a {data} x {model} grid needs {data * model} ranks, the process "
                         f"group has {world}")

    def groups(members):
        made = [dist.group.WORLD if len(m) == world else dist.new_group(m) for m in members]
        return next(g for g, m in zip(made, members) if rank in m)

    model_group = groups([list(range(d * model, (d + 1) * model)) for d in range(data)])
    data_group = groups([list(range(m, world, model)) for m in range(model)])
    return model_group, data_group


def make_production_grid(multi_pod: bool = False) -> Tuple[int, int]:
    """``(data, model)`` of the reference's production mesh: single pod 16
    × 16, multi-pod (2 × 16) × 16 (its FSDP axes are ``(pod, data)``)."""
    shape = MULTI_POD_SHAPE if multi_pod else SINGLE_POD_SHAPE
    return math.prod(shape[:-1]), shape[-1]


def make_test_grid(data: int = 1, model: int = 1, ranks: Optional[int] = None
                   ) -> Tuple[int, int]:
    """``(data, model)`` clamped to the ``ranks`` there are (default: the
    visible cards, at least 1), as the reference's ``make_test_mesh``
    clamps to its devices: data first, then model to what is left."""
    if ranks is None:
        ranks = torch.cuda.device_count() if torch.cuda.is_available() else 1
    n = max(1, ranks)
    data = min(data, n)
    return data, min(model, max(1, n // data))


@contextlib.contextmanager
def fake_world(data: int, model: int, rank: int = 0) -> Iterator[Tuple[Any, Any]]:
    """Act as world rank ``rank`` of a ``data`` × ``model`` grid in this
    process alone: a fake process group of ``data · model`` ranks (no other
    process, no card; a collective returns at once with its output's shape
    and moves nothing), the grid's groups over it (``make_grid``), and
    everything torn down on exit.  Yields ``(model group, data group)``.
    Refuses to start while a process group is up."""
    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group is already initialized in this "
                           "process; a fake world runs alone")
    world = data * model
    if data < 1 or model < 1 or not 0 <= rank < world:
        raise ValueError(f"fake_world: rank {rank} of a {data} x {model} grid")
    # registers torch's "fake" backend: every collective returns at once, moving nothing
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world)
    try:
        yield make_grid(data, model)
    finally:
        dist.destroy_process_group()


def _rank_main(rank, n_shards, backend, device, init_method, timeout_s, fn, args, results):
    """A rank's body: join the world, run ``fn``, report its result (or
    its traceback) and leave the world."""
    try:
        torch.set_num_threads(1)
        dev = rank_device(rank, device, backend)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=init_method, world_size=n_shards,
                                rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = fn(rank, dev, *args)
        finally:
            dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 — reported to the launcher, then re-raised
        results.put((rank, False, traceback.format_exc()))
        raise
    results.put((rank, True, out))


def _kill(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.kill()
    for p in procs:
        p.join(5)


def spawn_cohort(fn: Callable, n_shards: int, args: Sequence[Any] = (), *, device,
                 backend: Optional[str] = None, timeout_s: float = 60.0,
                 deadline_s: float = 600.0) -> List[Any]:
    """Run ``fn(rank, device, *args)`` in ``n_shards`` spawned ranks on
    ``device`` ("cpu" or "cuda"; no default) joined by a process group (a ``file://`` store in a fresh temporary
    directory), and return their results in rank order.  ``timeout_s``
    bounds each collective, ``deadline_s`` the whole world.  Raises
    ``RankFailure`` when a rank raises or exits without a result (the
    others are killed at once) or the deadline passes (all are killed)."""
    if n_shards < 1:
        raise ValueError(f"a cohort world needs n_shards >= 1, got {n_shards}")
    backend = resolve_backend(device, backend)
    check_cards(n_shards, device, backend)
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="cohort_")
    init_method = f"file://{os.path.join(tmp, 'store')}"
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, n_shards, backend, str(device), init_method, timeout_s, fn,
                               tuple(args), results))
             for r in range(n_shards)]
    out: Dict[int, Any] = {}
    errors: Dict[int, str] = {}
    end = time.monotonic() + deadline_s
    try:
        for p in procs:
            p.start()
        late = False
        while len(out) < n_shards and not errors:
            try:
                rank, ok, value = results.get(timeout=0.2)
            except queue.Empty:
                late = time.monotonic() > end
                # a rank that ended with code 0 put its result before it exited
                if late or any(p.exitcode not in (None, 0) and r not in out
                               for r, p in enumerate(procs)):
                    break
                continue
            (out if ok else errors)[rank] = value
        if len(out) < n_shards:
            # a rank raised, ended without a result, or the deadline passed:
            # take what the others report within a moment, then end the world
            stop = time.monotonic() + 1.0
            while time.monotonic() < stop and len(out) + len(errors) < n_shards:
                try:
                    rank, ok, value = results.get(timeout=0.1)
                except queue.Empty:
                    continue
                (out if ok else errors)[rank] = value
            _kill(procs)
            ended = {r: p.exitcode for r, p in enumerate(procs)
                     if r not in out and r not in errors}
            what = [f"passed its {deadline_s:g} s deadline"] if late else []
            if errors:
                what.append(f"rank(s) {sorted(errors)} raised")
            if ended:
                what.append(f"rank(s) {sorted(ended)} exited without a result (exit codes "
                            f"{ended})")
            raise RankFailure(f"cohort world of {n_shards} ranks: " + "; ".join(what)
                              + _errors_text(errors), exitcodes=ended, errors=errors)
        for p in procs:
            p.join(max(1.0, end - time.monotonic()))
        return [out[r] for r in range(n_shards)]
    finally:
        _kill(procs)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)


def _errors_text(errors: Dict[int, str]) -> str:
    return "".join(f"\n--- rank {r} ---\n{tb}" for r, tb in sorted(errors.items()))
