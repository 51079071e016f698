"""Layer 2 — the round's runtime contracts, checked on tiny problems.

Counterpart of ``repro.analysis.trace``.  Where ``repro_torch.analysis.lint``
reads source, this module runs the real round loops (``run_rounds`` and
``run_rounds_async``; resident and host-store state; the cohort sharded
over 2 gloo ranks; bf16 params) on a tiny problem and holds each entry to
the contracts that only show at run time:

(a) **state updated in place** (the reference's donation): from round 2
    on no state plane is allocated again — params, momentum, second
    moment, client states and top-k residuals each keep their storage
    (``data_ptr`` after every fold, on either device), and the caller's
    input state is left as it was.  On the card a 20-round run also
    holds no more allocations at its end than a 2-round run
    (``torch.cuda.memory_stats``).
(b) **no host transfer in a resident round** (the reference's
    ``transfer_guard``): the rounds run under a ``TorchDispatchMode`` that
    fails on ``aten._local_scalar_dense`` (``.item()``, ``float(t)``, …)
    and on any copy to the host, and on the card also under
    ``torch.cuda.set_sync_debug_mode("error")``.  The store entries cross
    the host boundary by design: n/a, as in the reference.
(c) **the retrace budget** has no counterpart: eager PyTorch traces
    nothing.
(d) **f32 planes under bf16 params**: with bf16 model leaves and default
    momentum, every plane the round carries is f32.
(e) **the ordered scattered fold**: the cohort-sharded round calls
    ``all_to_all_single`` and never ``reduce_scatter`` /
    ``reduce_scatter_tensor``, which would reduce each rank's rows first
    and re-associate the f32 sum (breaking sharded ≡ unsharded).  The
    ``torch.distributed`` calls are recorded on the gloo group; the
    grid's FSDP train step reduce-scatters by design and is not a round.

CLI: ``python -m repro_torch.analysis.trace [--quick] [--device cuda|cpu]
[--json PATH]`` exits non-zero if any contract fails.  ``--quick`` runs
the two resident entries.  The device defaults to ``cuda``.
"""
from __future__ import annotations

import argparse
import json
import sys
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

#: the collectives a sharded round may not call
FORBIDDEN_COLLECTIVES = ("reduce_scatter", "reduce_scatter_tensor")
RECORDED_COLLECTIVES = ("all_to_all_single", "all_gather", "all_gather_into_tensor",
                        "all_reduce", "broadcast") + FORBIDDEN_COLLECTIVES


# ------------------------------------------------------------------ report
@dataclass
class ContractReport:
    path: str
    in_place_ok: Optional[bool] = None
    host_ok: Optional[bool] = None
    f32_planes_ok: Optional[bool] = None
    collectives_ok: Optional[bool] = None
    notes: List[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        checks = (self.in_place_ok, self.host_ok, self.f32_planes_ok, self.collectives_ok)
        return all(c is not False for c in checks)

    def summary(self) -> str:
        def mark(v):
            return "—" if v is None else ("ok" if v else "FAIL")

        return (f"{self.path:<26} in_place={mark(self.in_place_ok)} "
                f"host={mark(self.host_ok)} f32_planes={mark(self.f32_planes_ok)} "
                f"collectives={mark(self.collectives_ok)}"
                + (f"  # {'; '.join(self.notes)}" if self.notes else ""))


# ------------------------------------------------------------------ problem
def tiny_problem(algo: str = "fedcm", *, bf16: bool = False, device="cpu", **cfg_kw):
    """A minimal engine + data + fresh-state factory (the reference's
    ``tiny_problem``): 8 clients, cohort 3, K 2, an (8, 16, 4) MLP."""
    from repro_torch.configs.base import FedConfig
    from repro_torch.core.engine import FederatedEngine
    from repro_torch.core.flat import FlatSpec
    from repro_torch.data import FederatedData, make_synthetic_classification
    from repro_torch.models.small import classification_loss, mlp_classifier
    from repro_torch.utils.trees import tree_map

    dev = torch.device(device)
    x, y, *_ = make_synthetic_classification(n_classes=4, dim=8, n_train=400, n_test=8)
    base = dict(algo=algo, num_clients=8, cohort_size=3, local_steps=2, participation="fixed")
    base.update(cfg_kw)
    cfg = FedConfig(**base)
    model = mlp_classifier((8, 16, 4))
    params = model.init(torch.Generator().manual_seed(0))
    if bf16:
        params = tree_map(lambda a: a.to(torch.bfloat16), params)
    eng = FederatedEngine(cfg, classification_loss(model.apply), FlatSpec.from_tree(params),
                          batch_size=8, device=dev)
    data = FederatedData(x, y, cfg.num_clients, seed=0, device=dev)

    def fresh():
        gen = torch.Generator(device=dev)
        gen.manual_seed(1)
        return eng.init(params, gen)

    return eng, data, fresh


# ------------------------------------------------------------------ (a)
def state_planes(state) -> Dict[str, torch.Tensor]:
    """Every plane the run's state carries, by name (None ones left out)."""
    planes = {"params": state.params, "momentum": state.server.momentum,
              "second_moment": state.server.second_moment,
              "client_states": state.client_states, "residuals": state.residuals}
    return {k: t for k, t in planes.items() if t is not None}


def plane_storage(state) -> Dict[str, int]:
    """``data_ptr`` of every state plane the run carries."""
    return {k: t.data_ptr() for k, t in state_planes(state).items()}


def record_folds(eng) -> List[Dict[str, int]]:
    """Wrap ``eng._fold`` to record ``plane_storage`` after every fold;
    returns the (growing) list of records."""
    seen: List[Dict[str, int]] = []
    fold = eng._fold

    def recorded(*args, **kwargs):
        out = fold(*args, **kwargs)
        seen.append(plane_storage(out[0]))
        return out

    eng._fold = recorded
    return seen


def in_place_violations(records: Sequence[Dict[str, int]]) -> List[str]:
    """Planes whose storage changed after the first fold."""
    bad = []
    for i, rec in enumerate(records[1:], start=2):
        for k, ptr in rec.items():
            if records[0].get(k) != ptr:
                bad.append(f"{k} reallocated at fold {i}")
    return bad


def _snapshot(state) -> Dict[str, torch.Tensor]:
    return {k: t.clone() for k, t in state_planes(state).items()}


def _intact(state, snap) -> List[str]:
    now = state_planes(state)
    return [f"the caller's {k} changed" for k, t in snap.items() if not torch.equal(now[k], t)]


def _live_allocations(device) -> int:
    return torch.cuda.memory_stats(device)["allocation.all.current"]


# ------------------------------------------------------------------ (b)
class HostTransferGuard(TorchDispatchMode):
    """Fails on every op that reads a tensor back to the host:
    ``aten._local_scalar_dense`` (``.item()``, ``float(t)``, ``bool(t)``)
    and a copy from a CUDA tensor to the CPU."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = str(func.overloadpacket)
        if "_local_scalar_dense" in name:
            raise RuntimeError(f"host read inside a round: {func}")
        out = func(*args, **kwargs)
        if name.endswith(("_to_copy", "copy_")):
            src = args[1] if name.endswith("copy_") and len(args) > 1 else args[0]
            dst = out if isinstance(out, torch.Tensor) else None
            if (isinstance(src, torch.Tensor) and dst is not None
                    and src.device.type == "cuda" and dst.device.type == "cpu"):
                raise RuntimeError(f"copy to the host inside a round: {func}")
        return out


def check_no_host_transfer(run: Callable[[], object], device) -> Tuple[bool, str]:
    """Run ``run`` under ``HostTransferGuard`` (and, on the card, under
    ``set_sync_debug_mode("error")``)."""
    on_card = torch.device(device).type == "cuda"
    try:
        if on_card:
            torch.cuda.synchronize(device)
            torch.cuda.set_sync_debug_mode("error")
        try:
            with HostTransferGuard():
                run()
        finally:
            if on_card:
                torch.cuda.set_sync_debug_mode("default")
        return True, ""
    except Exception as e:  # the finding
        return False, f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"


# ------------------------------------------------------------------ (d)
def f32_plane_violations(state) -> List[str]:
    """Planes of ``state`` that are not f32."""
    return [f"{k} is {t.dtype}" for k, t in state_planes(state).items()
            if t.dtype != torch.float32]


# ------------------------------------------------------------------ (e)
class CollectiveRecorder:
    """Records the ``torch.distributed`` collectives called while it is
    active (by name); a forbidden one is recorded and refused."""

    def __init__(self):
        self.calls: List[str] = []
        self._saved: Dict[str, Callable] = {}

    def __enter__(self):
        for name in RECORDED_COLLECTIVES:
            real = getattr(dist, name, None)
            if real is None:
                continue
            self._saved[name] = real

            def wrapper(*args, _name=name, _real=real, **kwargs):
                self.calls.append(_name)
                if _name in FORBIDDEN_COLLECTIVES:
                    raise RuntimeError(f"the sharded fold called dist.{_name}")
                return _real(*args, **kwargs)

            setattr(dist, name, wrapper)
        return self

    def __exit__(self, *exc):
        for name, real in self._saved.items():
            setattr(dist, name, real)
        return False


def collective_violations(calls: Sequence[str]) -> List[str]:
    bad = [f"called {c}" for c in sorted(set(calls)) if c in FORBIDDEN_COLLECTIVES]
    if "all_to_all_single" not in calls:
        bad.append("no all_to_all_single: the fold did not move rows to column blocks")
    return bad


def _sharded_rank(rank, device, n_rounds, fold_hook):
    """One rank of the sharded entry: the tiny problem's rounds with the
    collectives recorded.  Returns ``(calls, error)``."""
    eng, data, fresh = tiny_problem("fedcm", device=device, cohort_shard=dist.get_world_size())
    if fold_hook is not None:
        fold_hook(eng)
    with CollectiveRecorder() as rec:
        try:
            eng.run_rounds(fresh(), data, n_rounds)
            err = ""
        except RuntimeError as e:
            err = str(e)
    return rec.calls, err


def reduce_scatter_fold(eng) -> None:
    """A planted break for (e): the fold pre-reduces with
    ``reduce_scatter_tensor`` before the real fold runs."""
    fold = eng._fold

    def broken(state, entry, *args, **kwargs):
        out = torch.empty_like(entry.delta[:1].reshape(-1))
        dist.reduce_scatter_tensor(out, entry.delta.reshape(-1), group=eng.cohort_group)
        return fold(state, entry, *args, **kwargs)

    eng._fold = broken


# ------------------------------------------------------------------ matrix
@dataclass(frozen=True)
class MatrixEntry:
    name: str
    mode: str  # "sync" | "async"
    cfg: Dict[str, object]
    algo: str = "fedcm"
    store: bool = False
    sharded: bool = False
    bf16: bool = False


def _topk():
    from repro_torch.configs.base import CompressionConfig

    return CompressionConfig(kind="topk", topk_frac=0.25, seed=0)


MATRIX: Sequence[MatrixEntry] = (
    MatrixEntry("sync/resident", "sync", {"compression": "topk"}, algo="scaffold"),
    MatrixEntry("async/resident", "async", {"compression": "topk"}, algo="scaffold"),
    MatrixEntry("sync/resident/adaptive", "sync", {}, algo="fedadam"),
    MatrixEntry("async/resident/adaptive", "async", {}, algo="fedadam"),
    MatrixEntry("sync/bf16", "sync", {}, bf16=True),
    MatrixEntry("sync/store", "sync", {"population_store": "host"}, algo="scaffold",
                store=True),
    MatrixEntry("async/store", "async", {"population_store": "host"}, algo="scaffold",
                store=True),
    MatrixEntry("sync/sharded", "sync", {}, sharded=True),
)

#: the fast subset the CPU tests run
QUICK = ("sync/resident", "async/resident")


def _entry_cfg(entry: MatrixEntry) -> Dict[str, object]:
    return {k: (_topk() if v == "topk" else v) for k, v in entry.cfg.items()}


def _runner(entry: MatrixEntry, eng, data, n: int) -> Callable:
    if entry.mode == "sync":
        return lambda st: eng.run_rounds(st, data, n)
    return lambda st: eng.run_rounds_async(st, data, n, pipeline_depth=2, staleness=1)


def check_entry(entry: MatrixEntry, device="cpu", fold_hook=None,
                n_rounds: int = 4) -> ContractReport:
    """Run one matrix entry and hold it to its contracts.  ``fold_hook(eng)``
    may replace the engine's fold first (the tests plant breaks so)."""
    rep = ContractReport(entry.name)
    if entry.sharded:
        return _check_sharded(entry, rep, device, fold_hook, n_rounds)
    eng, data, fresh = tiny_problem(entry.algo, bf16=entry.bf16, device=device,
                                    **_entry_cfg(entry))
    if fold_hook is not None:
        fold_hook(eng)
    run = _runner(entry, eng, data, n_rounds)
    start = fresh()
    snap = _snapshot(start)
    records = record_folds(eng)
    state, _ = run(start)
    # (d) on every entry: the planes the run carries
    bad = f32_plane_violations(state)
    rep.f32_planes_ok = not bad
    rep.notes += bad
    if entry.store:
        rep.notes.append("(a)/(b) n/a: the host store crosses the host boundary by design")
        return rep
    # (a) in place from the second fold on; the caller's state intact
    bad = in_place_violations(records) + _intact(start, snap)
    if torch.device(device).type == "cuda":
        bad += _allocation_growth(entry, eng, data, fresh, device)
    rep.in_place_ok = not bad and len(records) >= 2
    rep.notes += bad
    # (b) a guarded run from a fresh state (the first one built the kernels)
    st = fresh()
    rep.host_ok, why = check_no_host_transfer(lambda: run(st), device)
    if why:
        rep.notes.append(why)
    return rep


def _allocation_growth(entry, eng, data, fresh, device) -> List[str]:
    """On the card: the live allocations a 20-round run leaves behind equal a
    2-round run's (nothing per round survives but the stacked metrics)."""
    held = []
    for n in (2, 20):
        st = fresh()
        torch.cuda.synchronize(device)
        before = _live_allocations(device)
        out = _runner(entry, eng, data, n)(st)
        torch.cuda.synchronize(device)
        held.append(_live_allocations(device) - before)
        del out
    return [] if held[0] == held[1] else [f"live allocations after 2 / 20 rounds: {held}"]


def _check_sharded(entry, rep, device, fold_hook, n_rounds) -> ContractReport:
    from repro_torch.launch.mesh import spawn_cohort

    results = spawn_cohort(_sharded_rank, 2, args=(n_rounds, fold_hook), device=str(device),
                           backend="gloo", timeout_s=60.0, deadline_s=300.0)
    bad = []
    for rank, (calls, err) in enumerate(results):
        bad += [f"rank {rank}: {b}" for b in collective_violations(calls)]
        if err:
            bad.append(f"rank {rank}: {err}")
    rep.collectives_ok = not bad
    rep.notes += sorted(set(bad))
    rep.notes.append("(a)/(b) on the resident entries")
    return rep


def run_matrix(quick: bool = False, device="cpu",
               entries: Optional[Sequence[MatrixEntry]] = None) -> List[ContractReport]:
    todo = entries if entries is not None else [
        e for e in MATRIX if not quick or e.name in QUICK]
    # a sharded entry's ranks take seconds each to start: they start first, in a
    # thread that waits on them, and the other entries run meanwhile
    with ThreadPoolExecutor(1) as pool:
        started = {e.name: pool.submit(check_entry, e, device) for e in todo if e.sharded}
        done = {e.name: check_entry(e, device) for e in todo if not e.sharded}
        done.update({name: f.result() for name, f in started.items()})
    return [done[e.name] for e in todo]


# ------------------------------------------------------------------ CLI
def _main(argv=None) -> int:
    from repro_torch.analysis import trace as canonical

    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis.trace",
                                 description="The round's runtime contracts (Layer 2).")
    ap.add_argument("--quick", action="store_true", help="the two resident entries only")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without a card)")
    ap.add_argument("--json", type=__import__("pathlib").Path, default=None,
                    help="write the reports as JSON")
    args = ap.parse_args(argv)
    from repro_torch.core.engine import resolve_device

    device = resolve_device(args.device)
    reports = canonical.run_matrix(quick=args.quick, device=device)
    for r in reports:
        print(r.summary())
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps([vars(r) for r in reports], indent=2,
                                        default=str) + "\n")
    bad = [r for r in reports if not r.ok]
    print(f"repro_torch.analysis.trace: {len(reports) - len(bad)}/{len(reports)} "
          f"contract entries clean on {device}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(_main())
