#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and PyTorch built for CUDA; imports nothing of
JAX or of the JAX package.  Phases, each of which exits non-zero on failure:

1. device check — CUDA present, the card's name and power limit from
   ``nvidia-smi``, TF32 off for matmuls and convolutions;
2. build — the two sources of ``src/repro_torch/csrc`` compiled for
   sm_90a, one ``nvcc`` per source, in parallel; the three kernels bound
   (``server_update.cu`` holds the dense fold and the dequant fold);
3. kernels vs plain — each kernel against its plain PyTorch version on the
   card, at the main path's plane (C, P) = (25, 22026) and at a ResNet-18
   sized plane (25, 11173962, ragged on purpose): ``fed_direction`` at
   n_aux 0–3 for f32 and bf16 x, ``server_update`` at all four
   write_x/write_m combinations for f32 and bf16 momentum, and
   ``dequant_update`` for int8 and bf16 q × f32 and bf16 momentum × the
   four write combinations; the folds are launched twice and required
   bitwise equal (determinism), the dequant fold bitwise equal to its
   plain version too.  Times are CUDA-event medians of 21 samples of a
   CUDA-graph replay, so they are device time without the host's launch
   cost; ``eager_ms`` is the time per call when Python launches each
   call, which is what the main path pays;
4. main path — ``repro_torch.launch.fed_train.run_federated`` with FedCM at
   the CLI defaults (N=100, cohort 10 Bernoulli → capacity 25, K=10, B=50,
   MLP 32-128-128-10) for 20 rounds, eval every 5, uncompressed, then with
   ``--uplink-compress int8``, then ``topk``, then with drops 0.1 + NaN
   corruption 0.1 + quarantine; each run with the launch counts set to 0
   just before and read just after.  Then, for each of these paths, the
   mean seconds per round of 20 further rounds of an engine, whose
   metrics are checked (wire bytes, fault counters); and the device time
   of one uncompressed round with the host's launch gaps removed (the
   device's busy share).  ``--profile`` (not part of the default run)
   adds device time by kernel over 5 rounds;
5. card vs CPU — three rounds from one converted state with the same
   injected ids, masks and minibatch indices on ``cuda`` and on ``cpu``;
   then three rounds under int8 + faults, each started on both devices
   from the card's state, with the hash draws (the same bits on both) and
   the floor flips of the int8 rounding counted;
6. summary — the ``nvidia-smi`` line, one JSON line ``{"kernels": [...]}``
   and, last, ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
MAIN_C, MAIN_P = 25, 22026
BIG_C, BIG_P = 25, 11_173_962
ROUNDS, EVAL_EVERY, K = 20, 5, 10
PARITY_RTOL, PARITY_ATOL = 2e-5, 1e-5  # tests/_torch_parity.py (three rounds)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------- timing
def graph_ms(torch, fn, reps: int, samples: int = 21) -> float:
    """Median device ms per call: ``reps`` calls captured in a CUDA graph,
    each sample one replay timed with CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del graph
    return statistics.median(times)


def eager_ms(torch, fn, iters: int = 50) -> float:
    """ms per call when Python launches each call (host cost included)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: int, flops: int):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(torch, a, b) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def within(torch, actual, expected) -> bool:
    rtol = 2.0 ** -7 if expected.dtype == torch.bfloat16 else 1e-6
    return bool(torch.allclose(actual.float(), expected.float(), rtol=rtol, atol=1e-6))


# ---------------------------------------------------------------------- phase 3
def check_fed_direction(torch, fd_kernel, fd_ref, C, P, n_aux, dtype, gen):
    dev = "cuda"
    x = torch.randn((C, P), generator=gen, device=dev).to(dtype)
    g = torch.randn((C, P), generator=gen, device=dev).to(dtype)
    # Δ_t-like broadcast f32, per-client f32, broadcast bf16
    pool = [torch.randn((P,), generator=gen, device=dev),
            torch.randn((C, P), generator=gen, device=dev),
            torch.randn((P,), generator=gen, device=dev).to(torch.bfloat16)]
    auxes = pool[:n_aux]
    coefs = torch.tensor([0.1, 0.3, 0.01, 0.7, -0.2, 0.05][:3 + n_aux],
                         dtype=torch.float32, device=dev)
    out = fd_kernel.fed_direction_flat(x, g, auxes, coefs)
    ref = fd_ref.fed_direction_ref(x, g, auxes, coefs)
    torch.cuda.synchronize()
    err = max_err(torch, out, ref)
    ok = within(torch, out, ref)
    n = C * P
    nbytes = (x.numel() * x.element_size() + g.numel() * g.element_size()
              + sum(a.numel() * a.element_size() for a in auxes)
              + coefs.numel() * 4 + out.numel() * out.element_size())
    b_ms, b_by = bound(nbytes, n * (5 + 2 * n_aux))
    reps = 20 if n < 10_000_000 else 5
    ms = graph_ms(torch, lambda: fd_kernel.fed_direction_flat(x, g, auxes, coefs), reps)
    plain = graph_ms(torch, lambda: fd_ref.fed_direction_ref(x, g, auxes, coefs), reps)
    eager = eager_ms(torch, lambda: fd_kernel.fed_direction_flat(x, g, auxes, coefs),
                     50 if n < 10_000_000 else 5)
    return {"C": C, "P": P, "n_aux": n_aux, "x": str(dtype).split(".")[-1],
            "max_abs_err": err, "ok": ok, "ms": ms, "plain_ms": plain,
            "eager_ms": eager, "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes}


def check_server_update(torch, su_kernel, su_ref, C, P, write_x, write_m, m_dtype, gen):
    dev = "cuda"
    deltas = torch.randn((C, P), generator=gen, device=dev) * 1e-2
    mask = torch.arange(C, device=dev) < (C * 2) // 5
    wn = mask.float() / mask.float().sum()
    x = torch.randn((P,), generator=gen, device=dev)
    m = torch.randn((P,), generator=gen, device=dev).to(m_dtype)
    coefs = torch.tensor([0.0, -1.0, 1.0, 1.0], dtype=torch.float32, device=dev)

    def run():
        return su_kernel.server_update_flat(deltas, wn, x, m, coefs,
                                            write_x=write_x, write_m=write_m)

    out1 = run()
    out2 = run()
    ref = su_ref.server_update_ref(deltas, wn, x, m, coefs, write_x=write_x, write_m=write_m)
    torch.cuda.synchronize()
    deterministic = all((a is None and b is None) or torch.equal(a, b)
                        for a, b in zip(out1, out2))
    err, ok = 0.0, True
    for a, b in zip(out1, ref):
        if (a is None) != (b is None):
            ok = False
        elif a is not None:
            err = max(err, max_err(torch, a, b))
            ok = ok and within(torch, a, b)
    nbytes = (deltas.numel() * 4 + C * 4 + 16 + P * 4  # deltas, wn, coefs, mean
              + (2 * P * 4 if write_x else 0)
              + (2 * P * m.element_size() if write_m else 0))
    flops = 2 * C * P + P + (2 * P if write_x else 0) + (3 * P if write_m else 0)
    b_ms, b_by = bound(nbytes, flops)
    reps = 20 if C * P < 10_000_000 else 5
    ms = graph_ms(torch, run, reps)
    plain = graph_ms(torch, lambda: su_ref.server_update_ref(
        deltas, wn, x, m, coefs, write_x=write_x, write_m=write_m), reps)
    eager = eager_ms(torch, run, 50 if C * P < 10_000_000 else 5)
    return {"C": C, "P": P, "write_x": write_x, "write_m": write_m,
            "m": str(m_dtype).split(".")[-1], "max_abs_err": err, "ok": ok,
            "deterministic": deterministic, "ms": ms, "plain_ms": plain,
            "eager_ms": eager, "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes}


def check_dequant_update(torch, su_kernel, su_ref, C, P, q_kind, write_x, write_m, m_dtype,
                         gen):
    dev = "cuda"
    if q_kind == "int8":
        q = torch.randint(-127, 128, (C, P), generator=gen, device=dev, dtype=torch.int8)
        scale = torch.rand((C, 1), generator=gen, device=dev) * 1e-3
    else:
        q = (torch.randn((C, P), generator=gen, device=dev) * 1e-2).to(torch.bfloat16)
        scale = torch.ones((C, 1), device=dev)
    mask = torch.arange(C, device=dev) < (C * 2) // 5
    wn = mask.float() / mask.float().sum()
    x = torch.randn((P,), generator=gen, device=dev)
    m = torch.randn((P,), generator=gen, device=dev).to(m_dtype)
    coefs = torch.tensor([0.0, -1.0, 1.0, 1.0], dtype=torch.float32, device=dev)

    def run():
        return su_kernel.dequant_update_flat(q, scale, wn, x, m, coefs,
                                             write_x=write_x, write_m=write_m)

    def plain():
        return su_ref.dequant_server_update_ref(q, scale, wn, x, m, coefs,
                                                write_x=write_x, write_m=write_m)

    out1 = run()
    out2 = run()
    ref = plain()
    torch.cuda.synchronize()
    deterministic = all((a is None and b is None) or torch.equal(a, b)
                        for a, b in zip(out1, out2))
    err, ok = 0.0, True
    for a, b in zip(out1, ref):
        if (a is None) != (b is None):
            ok = False
        elif a is not None:
            err = max(err, max_err(torch, a, b))
            ok = ok and torch.equal(a, b)  # bitwise: the same f32 operations
    nbytes = (q.numel() * q.element_size() + 2 * C * 4 + 16 + P * 4  # q, scale, wn, coefs, mean
              + (2 * P * 4 if write_x else 0)
              + (2 * P * m.element_size() if write_m else 0))
    flops = 3 * C * P + P + (2 * P if write_x else 0) + (3 * P if write_m else 0)
    b_ms, b_by = bound(nbytes, flops)
    reps = 20 if C * P < 10_000_000 else 5
    ms = graph_ms(torch, run, reps)
    plain_ms = graph_ms(torch, plain, reps)
    eager = eager_ms(torch, run, 50 if C * P < 10_000_000 else 5)
    return {"C": C, "P": P, "q": q_kind, "write_x": write_x, "write_m": write_m,
            "m": str(m_dtype).split(".")[-1], "max_abs_err": err, "ok": ok,
            "deterministic": deterministic, "ms": ms, "plain_ms": plain_ms,
            "eager_ms": eager, "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes}


# ---------------------------------------------------------------------- phase 5
def card_vs_cpu(torch, np):
    from repro_torch.configs.base import FedConfig
    from repro_torch.core.convert import params_to_numpy, state_from_numpy, state_to_numpy
    from repro_torch.core.engine import FederatedEngine, cohort_capacity
    from repro_torch.data import FederatedData, gather_round_batches, make_synthetic_classification
    from repro_torch.models.small import classification_loss, mlp_classifier

    cfg = FedConfig(participation="bernoulli")
    cap = cohort_capacity(cfg)
    x_tr, y_tr, _, _ = make_synthetic_classification(n_train=20_000, n_test=10, seed=3)
    model = mlp_classifier((32, 128, 128, 10))
    params = params_to_numpy(model.init(torch.Generator().manual_seed(3)))
    rng = np.random.default_rng(3)
    draws = []
    for _ in range(3):
        ids = rng.permutation(cfg.num_clients)[:cap]
        mask = np.arange(cap) < rng.binomial(cfg.num_clients, 0.1)
        draws.append((ids, mask))
    out = {}
    for dev in ("cuda", "cpu"):
        data = FederatedData(x_tr, y_tr, cfg.num_clients, dirichlet_alpha=0.6, seed=3, device=dev)
        idx_rng = np.random.default_rng(4)
        state, spec = state_from_numpy(params, cfg, device=dev)
        eng = FederatedEngine(cfg, classification_loss(model.apply), spec, device=dev)
        for ids, mask in draws:
            idx = idx_rng.integers(0, data.n_per_client, size=(cap, cfg.local_steps, 50))
            ids_t = torch.as_tensor(ids, device=dev)
            batches = gather_round_batches(data.client_x, data.client_y, None, ids_t,
                                           cfg.local_steps, 50, idx=torch.as_tensor(idx))
            state, _ = eng.round_step(state, batches, ids_t, torch.as_tensor(mask, device=dev))
        out[dev] = state_to_numpy(state)
    res = {}
    for key in ("params", "momentum"):
        a, b = out["cuda"][key], out["cpu"][key]
        res[key] = float(np.max(np.abs(a - b)))
        if not np.allclose(a, b, rtol=PARITY_RTOL, atol=PARITY_ATOL):
            fail(f"card vs CPU: {key} differ beyond rtol {PARITY_RTOL} atol "
                 f"{PARITY_ATOL} (max abs diff {res[key]:.3e})")
    return res


def card_vs_cpu_lossy(torch, np):
    """Three rounds under int8 + drops + NaN corruption + quarantine, with
    the port's own hash draws.  Each round starts on both devices from the
    card's state, with the same ids, masks and minibatch indices, so a
    floor flip of the stochastic rounding cannot compound.  The int8 planes
    of both devices are recorded: every element may differ by at most one
    level (a flip), and params / momentum may differ beyond the parity
    tolerance only by the flips' quanta."""
    import repro_torch.core.engine as engine_mod
    from repro_torch.configs.base import CompressionConfig, FaultConfig, FedConfig
    from repro_torch.core.compress import COMPRESS_STREAM, PLANE_STREAMS
    from repro_torch.core.convert import params_to_numpy, state_from_numpy
    from repro_torch.core.engine import FederatedEngine, cohort_capacity, local_learning_rate
    from repro_torch.data import FederatedData, gather_round_batches, make_synthetic_classification
    from repro_torch.models.small import classification_loss, mlp_classifier
    from repro_torch.utils import draws

    cfg = FedConfig(participation="bernoulli",
                    compression=CompressionConfig(kind="int8", seed=0),
                    fault=FaultConfig(drop_rate=0.1, corrupt_rate=0.1, corrupt_mode="nan", seed=0))
    cap = cohort_capacity(cfg)
    ids = torch.arange(cap) * 4
    for stream, n in ((1, None), (3, None), (COMPRESS_STREAM + PLANE_STREAMS["delta"], MAIN_P)):
        on_card = draws.uniform(0, torch.tensor(7, device="cuda"), stream, ids.cuda(), n)
        if not torch.equal(on_card.cpu(), draws.uniform(0, torch.tensor(7), stream, ids, n)):
            fail(f"hash draws of stream {stream} differ between the card and the CPU")

    x_tr, y_tr, _, _ = make_synthetic_classification(n_train=20_000, n_test=10, seed=3)
    model = mlp_classifier((32, 128, 128, 10))
    params = params_to_numpy(model.init(torch.Generator().manual_seed(3)))
    state, spec = state_from_numpy(params, cfg, device="cuda")
    data, engs = {}, {}
    for dev in ("cuda", "cpu"):
        data[dev] = FederatedData(x_tr, y_tr, cfg.num_clients, dirichlet_alpha=0.6, seed=3,
                                  device=dev)
        engs[dev] = FederatedEngine(cfg, classification_loss(model.apply), spec, device=dev)
    recorded = {}
    original = engine_mod.compress_plane

    def recording(comp, plane, u=None):
        rep = original(comp, plane, u)
        recorded[plane.device.type] = rep
        return rep

    rng = np.random.default_rng(5)
    rows = []
    engine_mod.compress_plane = recording
    try:
        for t in range(3):
            ids_np = rng.permutation(cfg.num_clients)[:cap]
            mask_np = np.arange(cap) < rng.binomial(cfg.num_clients, 0.1)
            idx = torch.as_tensor(rng.integers(0, data["cuda"].n_per_client,
                                               size=(cap, cfg.local_steps, 50)))
            outs = {}
            for dev in ("cuda", "cpu"):
                st = state if dev == "cuda" else state._replace(
                    params=state.params.cpu(),
                    server=state.server._replace(momentum=state.server.momentum.cpu(),
                                                 round=state.server.round.cpu()))
                ids_t = torch.as_tensor(ids_np, device=dev)
                batches = gather_round_batches(data[dev].client_x, data[dev].client_y, None,
                                               ids_t, cfg.local_steps, 50, idx=idx)
                outs[dev] = engs[dev].round_step(st, batches, ids_t,
                                                 torch.as_tensor(mask_np, device=dev))
            (card, m_card), (cpu, m_cpu) = outs["cuda"], outs["cpu"]
            for f in ("n_active", "n_dropped", "n_quarantined"):
                if float(getattr(m_card, f)) != float(getattr(m_cpu, f)):
                    fail(f"card vs CPU (int8 + faults) round {t}: {f} differs")
            q_card, q_cpu = recorded["cuda"], recorded["cpu"]
            dq = (q_card.q.cpu().to(torch.int32) - q_cpu.q.to(torch.int32)).abs()
            flips = int((dq != 0).sum())
            if int(dq.max()) > 1 or flips > 1e-3 * dq.numel():
                fail(f"card vs CPU (int8 + faults) round {t}: {flips} int8 elements differ, "
                     f"max by {int(dq.max())} levels")
            n_active = max(float(m_cpu.n_active), 1.0)
            quanta = (dq.float() * q_cpu.scale).sum(dim=0) / n_active  # (P,) f32
            eta_l = float(local_learning_rate(cfg, torch.tensor(t)))
            worst = 0.0
            for key, a, b, coef in (
                    ("params", card.params.cpu(), cpu.params, cfg.eta_g),
                    ("momentum", card.server.momentum.cpu(), cpu.server.momentum,
                     1.0 / (eta_l * cfg.local_steps))):
                diff = (a - b).abs()
                allowed = PARITY_ATOL + PARITY_RTOL * b.abs() + 1.001 * coef * quanta
                if bool((diff > allowed).any()):
                    fail(f"card vs CPU (int8 + faults) round {t}: {key} differ beyond the "
                         f"tolerance plus the flips' quanta (max abs diff "
                         f"{float(diff.max()):.3e})")
                worst = max(worst, float(diff.max()))
            rows.append({"round": t, "n_active": float(m_cpu.n_active),
                         "n_dropped": float(m_cpu.n_dropped),
                         "n_quarantined": float(m_cpu.n_quarantined),
                         "flips": flips, "elements": dq.numel(), "max_abs_diff": worst})
            state = card
    finally:
        engine_mod.compress_plane = original
    return rows


# ---------------------------------------------------------------------- main
def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a CUDA card")
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from a checkout")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    # ---- 1. device check
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    say(smi_line)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)} (count {torch.cuda.device_count()}); "
        f"TF32 off for matmul and cudnn")

    from repro_torch.kernels.build import build_all
    from repro_torch.kernels.fed_direction import kernel as fd_kernel
    from repro_torch.kernels.fed_direction import ref as fd_ref
    from repro_torch.kernels.server_update import kernel as su_kernel
    from repro_torch.kernels.server_update import ref as su_ref

    bindings = {"fed_direction": fd_kernel.KERNEL, "server_update": su_kernel.KERNEL,
                "dequant_update": su_kernel.DEQUANT_KERNEL}

    # ---- 2. build (one nvcc per source, started together)
    t0 = time.perf_counter()
    built = build_all(sorted({b.source for b in bindings.values()}))
    say(f"build: {time.perf_counter() - t0:.1f} s wall")
    for name, info in built.items():
        regs = [int(v) for v in re.findall(r"Used (\d+) registers", info["log"])]
        spills = sum(int(v) for v in re.findall(r"(\d+) bytes spill", info["log"]))
        say(f"  {name}: {info['seconds']:.1f} s -> {info['path'].name}; "
            f"{len(regs)} instantiations, registers/thread {min(regs, default=0)}"
            f"-{max(regs, default=0)}, spill bytes {spills}")
    for name, b in bindings.items():
        b.load()
        say(f"  bound {name}: {b.symbol} in {b.source}.cu")

    # ---- 3. kernels vs plain
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    fd_cases, su_cases, dq_cases = [], [], []
    for C, P in ((MAIN_C, MAIN_P), (BIG_C, BIG_P)):
        for dtype in (torch.float32, torch.bfloat16):
            for n_aux in range(4):
                r = check_fed_direction(torch, fd_kernel, fd_ref, C, P, n_aux, dtype, gen)
                fd_cases.append(r)
                say(f"fed_direction {json.dumps(r)}")
        for m_dtype in (torch.float32, torch.bfloat16):
            for wx in (True, False):
                for wm in (True, False):
                    r = check_server_update(torch, su_kernel, su_ref, C, P, wx, wm, m_dtype, gen)
                    su_cases.append(r)
                    say(f"server_update {json.dumps(r)}")
        torch.cuda.empty_cache()
        for q_kind in ("int8", "bf16"):
            for m_dtype in (torch.float32, torch.bfloat16):
                for wx in (True, False):
                    for wm in (True, False):
                        r = check_dequant_update(torch, su_kernel, su_ref, C, P, q_kind, wx, wm,
                                                 m_dtype, gen)
                        dq_cases.append(r)
                        say(f"dequant_update {json.dumps(r)}")
        torch.cuda.empty_cache()
    bad = [r for r in fd_cases + su_cases + dq_cases if not r["ok"]]
    if bad:
        fail(f"kernel disagrees with its plain version: {bad}")
    if not all(r["deterministic"] for r in su_cases + dq_cases):
        fail("a fold kernel is not run-to-run deterministic")
    say("kernels vs plain: all cases within tolerance, dequant_update bitwise equal to its "
        "plain version; server_update and dequant_update bitwise deterministic")

    # ---- 4. main path and the lossy-uplink paths, launch counts from each run only
    from repro_torch.configs.base import CompressionConfig, FaultConfig, FedConfig
    from repro_torch.launch.fed_train import run_federated

    base = FedConfig(participation="bernoulli", rounds=ROUNDS)
    paths = {
        "uncompressed": (base, {"fed_direction": ROUNDS * K, "server_update": ROUNDS,
                                "dequant_update": 0}),
        "int8": (replace(base, compression=CompressionConfig(kind="int8")),
                 {"fed_direction": ROUNDS * K, "server_update": 0, "dequant_update": ROUNDS}),
        "topk": (replace(base, compression=CompressionConfig(kind="topk")),
                 {"fed_direction": ROUNDS * K, "server_update": ROUNDS, "dequant_update": 0}),
        "faults": (replace(base, fault=FaultConfig(drop_rate=0.1, corrupt_rate=0.1,
                                                   corrupt_mode="nan")),
                   {"fed_direction": ROUNDS * K, "server_update": ROUNDS,
                    "dequant_update": 0}),
    }
    path_launches, path_acc = {}, {}
    for name, (cfg, expected) in paths.items():
        for b in bindings.values():
            b.launches = 0
        t0 = time.perf_counter()
        acc, log = run_federated(cfg, 0.6, eval_every=EVAL_EVERY, seed=0, echo=False,
                                 device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: b.launches for k, b in bindings.items()}
        for row in log.rows:
            say(f"{name} path: " + " ".join(f"{k}={v}" for k, v in row.items() if v is not None))
        losses = log.column("loss")
        if not all(np.isfinite(losses)):
            fail(f"{name} path: non-finite loss {losses}")
        if not losses[-1] < losses[0]:
            fail(f"{name} path: final loss {losses[-1]} not below the first {losses[0]}")
        if not acc > 0.1:
            fail(f"{name} path: test accuracy {acc} not above chance (0.1)")
        if launches != expected:
            fail(f"{name} path launch counts {launches}, expected {expected}")
        say(f"{name} path: {ROUNDS} rounds in {wall:.3f} s (set-up and eval included), "
            f"launches {launches}, final test_acc {acc:.4f}")
        path_launches[name], path_acc[name] = launches, acc
    if abs(path_acc["int8"] - path_acc["uncompressed"]) > 0.02:
        fail(f"int8 test accuracy {path_acc['int8']} not within 0.02 of the uncompressed "
             f"run's {path_acc['uncompressed']}")
    launches = {"fed_direction": path_launches["uncompressed"]["fed_direction"],
                "server_update": path_launches["uncompressed"]["server_update"],
                "dequant_update": path_launches["int8"]["dequant_update"]}

    steady = {}
    for name, (cfg, _) in paths.items():
        s_round, eng, state, data, host = steady_seconds_per_round(torch, cfg)
        steady[name] = s_round
        if not np.isfinite(host["loss"]).all() or not torch.isfinite(state.params).all():
            fail(f"{name} path: non-finite loss or params in the steady-state rounds")
        wire = eng.payload_bytes()["up_per_client"]
        if not np.array_equal(host["bytes_up"], host["n_active"] * np.float32(wire)):
            fail(f"{name} path: bytes_up is not n_active x {wire}")
        if name == "int8" and wire != MAIN_P + 4:
            fail(f"int8 path: {wire} uplink bytes per client, expected {MAIN_P + 4}")
        if name == "faults" and not (host["n_dropped"].sum() > 0
                                     and host["n_quarantined"].sum() > 0):
            fail("faults path: no client dropped or quarantined in the steady-state rounds")
        say(f"{name} path: steady state {s_round * 1e3:.3f} ms/round (mean of {ROUNDS} "
            f"rounds after 2 warm-up, synchronized); uplink {wire} B/client; dropped "
            f"{host['n_dropped'].sum():.0f}, quarantined {host['n_quarantined'].sum():.0f}")
        if name == "uncompressed":
            main_eng = (eng, state, data)
    say(f"steady ms/round: int8 {steady['int8'] * 1e3:.3f} beside uncompressed "
        f"{steady['uncompressed'] * 1e3:.3f} (topk {steady['topk'] * 1e3:.3f}, faults "
        f"{steady['faults'] * 1e3:.3f})")
    s_per_round = steady["uncompressed"]
    eng, state, data = main_eng
    dev_ms = device_ms_per_round(torch, eng, state, data)
    if dev_ms is None:
        say("main path: device time per round not measured")
    else:
        busy = dev_ms / (s_per_round * 1e3)
        say(f"main path: device time {dev_ms:.3f} ms/round (median of 11, no host "
            f"gaps) -> device busy share {busy:.4f}, idle share {1 - busy:.4f}")
    if "--profile" in sys.argv[1:]:
        profile_rounds(torch, eng, state, data)

    # ---- 5. card vs CPU
    diffs = card_vs_cpu(torch, np)
    say(f"card vs CPU over 3 injected rounds: max |diff| params {diffs['params']:.3e}, "
        f"momentum {diffs['momentum']:.3e} (rtol {PARITY_RTOL}, atol {PARITY_ATOL})")
    for row in card_vs_cpu_lossy(torch, np):
        say(f"card vs CPU, int8 + faults, hash draws: {json.dumps(row)}")
    say("card vs CPU, int8 + faults: draws bitwise equal on both devices; params and "
        "momentum within the tolerance plus one quantum per floor flip")

    # ---- 6. summary
    def main_case(cases, **sel):
        return next(r for r in cases if r["C"] == MAIN_C and r["P"] == MAIN_P
                    and all(r[k] == v for k, v in sel.items()))

    fd_main = main_case(fd_cases, n_aux=1, x="float32")
    su_main = main_case(su_cases, write_x=True, write_m=True, m="float32")
    dq_main = main_case(dq_cases, q="int8", write_x=True, write_m=True, m="float32")
    kernels = []
    for name, src, replaces, main, cases in (
        ("fed_direction", "src/repro_torch/csrc/fed_direction.cu",
         "src/repro/kernels/fed_direction/kernel.py:53", fd_main, fd_cases),
        ("server_update", "src/repro_torch/csrc/server_update.cu",
         "src/repro/kernels/server_update/kernel.py:91", su_main, su_cases),
        ("dequant_update", "src/repro_torch/csrc/server_update.cu",
         "src/repro/kernels/server_update/kernel.py:211", dq_main, dq_cases),
    ):
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in cases),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None,
        })
    say(f"steady ms/round {s_per_round * 1e3:.3f}; eager ms/call fed_direction "
        f"{fd_main['eager_ms']:.4f}, server_update {su_main['eager_ms']:.4f}, "
        f"dequant_update {dq_main['eager_ms']:.4f}")
    say(smi_line)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


def steady_seconds_per_round(torch, cfg):
    """Mean wall seconds per round of an engine on ``cfg`` at the main
    path's widths after warm-up, synchronized at both ends (host launch
    cost included).  Returns ``(s_per_round, engine, state, data,
    metrics)`` with the timed rounds' metrics on the host."""
    from repro_torch.core.engine import FederatedEngine, metrics_to_host
    from repro_torch.core.flat import FlatSpec
    from repro_torch.data import FederatedData, make_synthetic_classification
    from repro_torch.models.small import classification_loss, mlp_classifier

    x_tr, y_tr, _, _ = make_synthetic_classification(n_train=50_000, n_test=10, seed=0)
    data = FederatedData(x_tr, y_tr, cfg.num_clients, dirichlet_alpha=0.6, seed=0, device="cuda")
    model = mlp_classifier((32, 128, 128, 10))
    params = model.init(torch.Generator().manual_seed(0))
    eng = FederatedEngine(cfg, classification_loss(model.apply), FlatSpec.from_tree(params),
                          device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    state = eng.init(params, gen)
    state, _ = eng.run_rounds(state, data, 2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, ms = eng.run_rounds(state, data, ROUNDS)
    torch.cuda.synchronize()
    s_round = (time.perf_counter() - t0) / ROUNDS
    return s_round, eng, state, data, metrics_to_host(ms)


def device_ms_per_round(torch, eng, state, data, samples: int = 11) -> float:
    """Median device time of one main-path round with no host gaps: the
    card is held in ``torch.cuda._sleep`` while the host enqueues the round
    (nothing in a round waits on the device), so the events around the
    round time the kernels back to back.  Returns None (not measured) if
    the host could not finish enqueueing within the sleep: the reading
    would then include host time."""
    times = []
    for _ in range(samples):
        t0 = time.perf_counter()
        start, mid, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        start.record()
        torch.cuda._sleep(int(2e8))  # ~0.1 s at the H100's clock
        mid.record()
        state, _ = eng.run_round(state, data)
        host_s = time.perf_counter() - t0
        end.record()
        end.synchronize()
        if host_s * 1e3 >= start.elapsed_time(mid):
            say(f"device-time probe: host took {host_s * 1e3:.1f} ms to enqueue a "
                f"round, longer than the {start.elapsed_time(mid):.1f} ms sleep")
            return None
        times.append(mid.elapsed_time(end))
    return statistics.median(times)


def profile_rounds(torch, eng, state, data, n: int = 5) -> None:
    """``--profile``: device time by CUDA kernel over ``n`` main-path rounds
    (torch.profiler).  Only device-side kernel events are summed: the aten
    op rows carry their kernels' device time too and would count it twice."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        state, _ = eng.run_rounds(state, data, n)
        torch.cuda.synchronize()
    rows = sorted(((e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                  reverse=True)
    total = sum(r[0] for r in rows)
    say(f"profile: {n} rounds, kernel device time {total / n:.1f} us/round, "
        f"{sum(r[1] for r in rows) // n} kernel launches/round")
    for dev_us, count, key in rows[:12]:
        say(f"profile: {dev_us / n:9.1f} us/round {count // n:5d}/round  {key[:90]}")


if __name__ == "__main__":
    sys.exit(main())
