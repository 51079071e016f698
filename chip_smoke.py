#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and PyTorch built for CUDA; imports nothing of
JAX or of the JAX package.  Phases, each of which exits non-zero on failure:

1. device check — CUDA present, the card's name and power limit from
   ``nvidia-smi``, TF32 off for matmuls and convolutions;
2. build — the four sources of ``src/repro_torch/csrc`` compiled for
   sm_90a, one ``nvcc`` per source, in parallel; the five kernels bound
   (``server_update.cu`` holds the dense fold and the dequant fold); then
   the tensor-core instructions (``HMMA``) of every compiled kernel, counted
   in ``cuobjdump -sass``: each tensor-core kernel of ``flash_attention``
   and ``ssd_scan`` (the bf16 routes, ``*_mma_kernel``) must have some; and
   the bulk copies (``UBLKCP``, ``cp.async.bulk`` global -> shared) of each
   of the 32 ``fold_kernel`` instantiations, which must have some;
3. kernels vs plain — each kernel against its plain PyTorch version on the
   card, at the main path's plane (C, P) = (25, 22026) and at a ResNet-18
   sized plane (25, 11173962, ragged on purpose): ``fed_direction`` at
   n_aux 0–3 for f32 and bf16 x and in the aux orders of the other
   specs (``FD_LAYOUTS``: SCAFFOLD's and FedDyn's per-client aux before a
   broadcast one, FedProx's broadcast x_t), ``server_update`` at all four
   write_x/write_m combinations for f32 and bf16 momentum, and
   ``dequant_update`` for int8 and bf16 q × f32 and bf16 momentum × the
   four write combinations; then both folds at ``FOLD_EDGES`` (a
   misaligned plane view, C of 1 and 100, ragged narrow planes, C = 1000
   streaming through the ring); every fold case is launched twice and
   required bitwise equal to the first launch (determinism) and to its
   plain version.  The launch floor, a one-element ``fill_`` timed the
   same way, is printed beside the main-plane folds.  Then both folds with
   the staleness discount γ ≠ 1 on their coefficient row (``GAMMAS``: 0.9
   and 0.81) at both planes, x and m written: ``server_update`` with f32
   and bf16 momentum, ``dequant_update`` with int8 and bf16 q; each
   launched twice, bitwise against the first launch and its plain version,
   its time printed beside its γ = 1 twin.  Times are CUDA-event
   medians of 21 samples of a CUDA-graph replay, so they are device time
   without the host's launch cost; ``eager_ms`` is the time per call when
   Python launches each call, which is what the main path pays.  ``flash_attention`` at the
   serving shape (B=4, S=1024, H=32, Hkv=8, hd=64, bf16, causal; timed
   beside ``scaled_dot_product_attention(is_causal=True, enable_gqa=True)``
   as the library yardstick), at a ragged shape with a window and
   q_offset that leaves rows no key, in f32 with hd=128 without the
   causal mask, in bf16 with hd=128 at a ragged causal shape, and in bf16
   without the causal mask (GQA, Sq ≠ Skv);
   ``ssd_scan`` at the serving shape (B=4, S=1024, H=64, P=64, N=128,
   L=64, bf16 x), at a ragged S, and at S < L in f32 and in bf16 — each
   within the tolerance stated at ``LM_KERNEL_TOL``;
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
4b. the other nine algorithms — ``run_federated`` for fedprox, fedavgm,
   fedacg, fedadam, fedadagrad, fedyogi, mimelite, scaffold and feddyn at
   the CLI defaults (``ALGO_SETTINGS`` for the adaptive three) for 20
   rounds, then scaffold and mimelite under ``--uplink-compress int8``;
   each run with the launch counts set to 0 just before and read just
   after (``fed_direction`` K a round; one fold launch a round per fold
   row: ``FOLDS_PER_ROUND``), a finite loss, its final test accuracy and
   the steady seconds per round of 20 further rounds;
4c. the async ring — ``run_federated`` with ``--pipeline-depth`` /
   ``--staleness`` at γ = 0.9 (``ASYNC_RUNS``: fedcm at D=2 S=1 and D=4
   S=2, scaffold under int8 and mimelite at D=2 S=1) for 20 rounds, each
   with the launch counts set to 0 just before and read just after (K
   ``fed_direction`` a round; ``FOLDS_PER_ROUND`` fold launches a round,
   drain included), a finite loss and the final accuracy;
   then 20 further rounds of an engine (``folded`` D − 1 zeros, then ones)
   and their steady seconds per round, measured in turns with the same
   spec's sync loop before and after;
4d. the host store at fleet scale — N = ``FLEET_N`` = 1,000,000 clients,
   scaffold, zipf availability, dropout 0.1, store failures 0.05,
   ``StreamingClientData``: ``run_federated`` sync and on the ring (D=2,
   S=1) with their launch counts, then an engine's 20 rounds (touched rows
   ≤ 20 × capacity, the store's bytes, ``n_retries`` > 0) and 20 more
   (steady s/round), the device's peak memory under 1 GB throughout (a
   resident (N, P) f32 plane would be 88.1 GB); then, on device-resident
   data (N = 100), bit for bit on the card: store ≡ resident for scaffold
   and feddyn, sync and async, and for scaffold under int8 and top-k (the
   residual store ≡ the resident residual plane), and the ring at D = 1,
   S = 0 ≡ the sync loop for scaffold under int8;
5. card vs CPU — three rounds from one converted state with the same
   injected ids, masks and minibatch indices on ``cuda`` and on ``cpu``;
   then three rounds under int8 + faults, each started on both devices
   from the card's state, with the hash draws (the same bits on both) and
   the floor flips of the int8 rounding counted;
5b. card vs CPU, the other nine algorithms — three rounds of each from one
   converted state, with the same ids, masks, minibatch indices and (for
   mimelite) full batches on both devices: params, momentum, and where the
   spec has them the (N, P) client states and the second moment, within
   ``PARITY_RTOL`` / ``PARITY_ATOL``;
5c. card vs CPU under the ring — six launches at D=2, S=1, γ = 0.9 of
   fedcm, scaffold, fedadam and mimelite from one converted state
   (nonzero momentum)
   with the same injected draws on both devices, through the loop
   ``run_rounds_async`` runs (``run_rounds_async_on``): every state plane
   within ``PARITY_RTOL`` / ``PARITY_ATOL`` after the drain;
6. serving — ``repro_torch.launch.serve`` (the CLI's ``run``) at full width
   for llama3.2-1b and mamba2-1.3b, ``--full --batch 4 --prompt-len 1024
   --gen 32 --sessions 2``, with the launch counts set to 0 just before
   each and read just after: 16 ``flash_attention`` launches per prefill
   (llama) and 48 ``ssd_scan`` (mamba2), none of the federated kernels;
   prefill and decode ms and tok/s of each session; then one decode step
   of each arch at that shape: its ms, and the device operations it runs
   with their summed device time (torch.profiler);
7. card vs CPU, serving — each arch at full width cut to 2 layers, B=2,
   prompt 128, the same f32 weights on both devices: prefill logits and
   cache, then 4 teacher-forced decode steps, each within ``LM_REL_L2``;
8. summary — the ``nvidia-smi`` line, one JSON line ``{"kernels": [...]}``
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
BF16_FLOPS_PER_S = 989e12  # H100 SXM bf16 tensor cores, dense
# flash_attention and ssd_scan vs their plain versions, |Δ| ≤ rtol·|plain| +
# atol_rel·max|plain|, by output dtype.  Both sum in f32 in different orders (the kernel's online softmax /
# register or tensor-core tiles vs the plain version's full-matrix products
# and torch.cumsum), so f32 outputs differ by ~1e-7 of the largest value; a
# bf16 output may land one ulp (≤ 2^-7 relative) apart when the f32 values
# straddle a rounding boundary.  The bf16 routes' f32 operands enter the
# tensor cores as two bf16 pieces to stay within these numbers
# (tests/test_torch_kernel_precision.py, which reads this table).
LM_KERNEL_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2.0 ** -7, 1e-5)}
# Card vs CPU serving (bf16 activations): each bf16 rounding is ≤ 2^-9
# relative and a 2-layer forward chains a few dozen of them, with the card's
# GEMMs summing in another order than the CPU's: relative L2 error ≤ 2e-2
# (~10 half-ulps) for the logits and every cache leaf.
LM_REL_L2 = 2e-2
SERVE_ARGS = ["--full", "--batch", "4", "--prompt-len", "1024", "--gen", "32", "--sessions", "2"]
# the algorithms beyond FedCM and FedAvg (phases 4b and 5b)
OTHER_ALGOS = ("fedprox", "fedavgm", "fedacg", "fedadam", "fedadagrad", "fedyogi", "mimelite",
               "scaffold", "feddyn")
# the reference benchmark's per-algorithm settings (benchmarks/common.py: η_g
# 0.03 and α 0.1 for fedadam), also for fedadagrad and fedyogi, which take the
# same absolute-lr preconditioned step; a copy, so nothing of the benchmarks
# is imported
ALGO_SETTINGS = {a: {"eta_g": 0.03, "alpha": 0.1} for a in ("fedadam", "fedadagrad", "fedyogi")}
# (server_update, dequant_update) launches a fold by uplink, sync round and
# ring alike: one per fold row; under int8 every row over a plane that
# arrives compressed is a dequant launch (scaffold's state delta included:
# the fold decodes it once more for the client-state scatter)
FOLDS_PER_ROUND = {"scaffold": {None: (2, 0), "int8": (0, 2)},
                   "mimelite": {None: (2, 0), "int8": (0, 2)}}
# the async ring (phase 4c): (algo, uplink, D, S), each at γ = RING_GAMMA
ASYNC_RUNS = (("fedcm", None, 2, 1), ("fedcm", None, 4, 2), ("scaffold", "int8", 2, 1),
              ("mimelite", None, 2, 1))
RING_GAMMA = 0.9
FLEET_N = 1_000_000  # the host store's population (phase 4d)
PAIR_ROUNDS = 6  # rounds of each bitwise store pair (phase 4d)


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


# ---------------------------------------------------------------------- phase 2
def _kernel_name(mangled: str) -> str:
    """``attn_mma_kernel<64>`` from its Itanium-mangled name: walks the
    length-prefixed names of ``_ZN...`` to the one that ends in ``_kernel``,
    and adds an int template argument if one follows."""
    pos = 3 if mangled.startswith("_ZN") else 2 if mangled.startswith("_Z") else 0
    while (d := re.match(r"\d+", mangled[pos:])):
        ident = mangled[pos + d.end():pos + d.end() + int(d.group())]
        pos += d.end() + len(ident)
        if ident.endswith("_kernel"):
            arg = re.match(r"ILi(\d+)E", mangled[pos:])
            return f"{ident}<{arg.group(1)}>" if arg else ident
    return mangled


def sass_counts(lib: Path, mnemonics: dict) -> list:
    """``[(kernel, {key: instructions})]`` for every kernel compiled into
    ``lib``, one entry per compiled function (template instantiations of one
    kernel share its name), counting the SASS lines that match each regex of
    ``mnemonics`` in ``cuobjdump -sass`` (names demangled down to the
    kernel's own name and int template arguments)."""
    from repro_torch.kernels.build import nvcc_path

    tool = Path(nvcc_path()).parent / "cuobjdump"
    out = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                         timeout=300)
    if out.returncode != 0:
        fail(f"cuobjdump -sass {lib.name} failed: {out.stderr.strip()[:500]}")
    funcs = []
    for line in out.stdout.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            funcs.append((_kernel_name(m.group(1)), dict.fromkeys(mnemonics, 0)))
        elif funcs:
            for key, pattern in mnemonics.items():
                if re.search(pattern, line):
                    funcs[-1][1][key] += 1
    return funcs


# ---------------------------------------------------------------------- phase 3
# fed_direction's aux layouts: the first n_aux of (broadcast f32, per-client
# f32, broadcast bf16), and the orders the other specs produce — SCAFFOLD's
# [c_i (C, P), c (P,)] and FedDyn's [λ_i (C, P), x_t (P,)], FedProx's
# [x_t (P,)]; every case has c_x = 0.01 ≠ 0 (FedDyn, FedProx).
FD_LAYOUTS = {"scaffold/feddyn": ("client", "bcast"), "fedprox": ("bcast",)}


def check_fed_direction(torch, fd_kernel, fd_ref, C, P, n_aux, dtype, gen, layout=None):
    dev = "cuda"
    x = torch.randn((C, P), generator=gen, device=dev).to(dtype)
    g = torch.randn((C, P), generator=gen, device=dev).to(dtype)
    make = {"bcast": lambda: torch.randn((P,), generator=gen, device=dev),
            "client": lambda: torch.randn((C, P), generator=gen, device=dev),
            "bcast_bf16": lambda: torch.randn((P,), generator=gen,
                                              device=dev).to(torch.bfloat16)}
    kinds = FD_LAYOUTS[layout] if layout else ("bcast", "client", "bcast_bf16")[:n_aux]
    auxes = [make[k]() for k in kinds]
    n_aux = len(auxes)
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
    return {"C": C, "P": P, "n_aux": n_aux, "layout": layout or "pool", "aux": list(kinds),
            "x": str(dtype).split(".")[-1], "max_abs_err": err, "ok": ok, "ms": ms,
            "plain_ms": plain,
            "eager_ms": eager, "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes}


def shifted(torch, t, offset: int):
    """``t`` as a contiguous view ``offset`` elements into a larger buffer:
    the same values at a data_ptr that is no longer 16-byte aligned."""
    if offset == 0:
        return t
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    view = buf[offset:].view(t.shape)
    view.copy_(t)
    return view


def fold_inputs(torch, C, P, m_dtype, gen, offset: int = 0, gamma: float = 1.0):
    """wn (the first 2C/5 rows active, at least one), x and m of a fold
    case; with ``offset``, x and m are views 1 element into their buffers;
    ``gamma`` is the staleness discount γ, coefs[3]."""
    dev = "cuda"
    mask = torch.arange(C, device=dev) < max(1, (C * 2) // 5)
    wn = mask.float() / mask.float().sum()
    x = shifted(torch, torch.randn((P,), generator=gen, device=dev), min(offset, 1))
    m = shifted(torch, torch.randn((P,), generator=gen, device=dev).to(m_dtype), min(offset, 1))
    coefs = torch.tensor([0.0, -1.0, 1.0, gamma], dtype=torch.float32, device=dev)
    return wn, x, m, coefs


def check_server_update(torch, su_kernel, su_ref, C, P, write_x, write_m, m_dtype, gen,
                        d_dtype=None, offset: int = 0, gamma: float = 1.0):
    """``offset``: the plane (and x, m) as views ``offset`` elements into
    their buffers, so their data_ptr is misaligned."""
    dev = "cuda"
    d_dtype = d_dtype or torch.float32
    deltas = shifted(torch, (torch.randn((C, P), generator=gen, device=dev) * 1e-2).to(d_dtype),
                     offset)
    wn, x, m, coefs = fold_inputs(torch, C, P, m_dtype, gen, offset, gamma)

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
            ok = ok and torch.equal(a, b)  # bitwise: the same f32 operations
    nbytes = (deltas.numel() * deltas.element_size() + C * 4 + 16 + P * 4  # deltas, wn, coefs, mean
              + (2 * P * 4 if write_x else 0)
              + (2 * P * m.element_size() if write_m else 0))
    flops = 2 * C * P + P + (2 * P if write_x else 0) + (3 * P if write_m else 0)
    b_ms, b_by = bound(nbytes, flops)
    reps = 20 if C * P < 10_000_000 else 5
    ms = graph_ms(torch, run, reps)
    plain = graph_ms(torch, lambda: su_ref.server_update_ref(
        deltas, wn, x, m, coefs, write_x=write_x, write_m=write_m), reps)
    eager = eager_ms(torch, run, 50 if C * P < 10_000_000 else 5)
    return {"C": C, "P": P, "d": str(d_dtype).split(".")[-1], "offset": offset,
            "gamma": gamma, "write_x": write_x, "write_m": write_m,
            "m": str(m_dtype).split(".")[-1], "max_abs_err": err, "ok": ok,
            "deterministic": deterministic, "ms": ms, "plain_ms": plain,
            "eager_ms": eager, "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes}


def check_dequant_update(torch, su_kernel, su_ref, C, P, q_kind, write_x, write_m, m_dtype,
                         gen, offset: int = 0, gamma: float = 1.0):
    """``offset``: the plane as a view ``offset`` elements into its buffer
    (3 for int8, so its data_ptr is 3 bytes past an aligned one), x and m
    1 element."""
    dev = "cuda"
    if q_kind == "int8":
        q = torch.randint(-127, 128, (C, P), generator=gen, device=dev, dtype=torch.int8)
        scale = torch.rand((C, 1), generator=gen, device=dev) * 1e-3
    else:
        q = (torch.randn((C, P), generator=gen, device=dev) * 1e-2).to(torch.bfloat16)
        scale = torch.ones((C, 1), device=dev)
    q = shifted(torch, q, offset)
    wn, x, m, coefs = fold_inputs(torch, C, P, m_dtype, gen, offset, gamma)

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
    return {"C": C, "P": P, "q": q_kind, "offset": offset, "gamma": gamma,
            "write_x": write_x, "write_m": write_m,
            "m": str(m_dtype).split(".")[-1], "max_abs_err": err, "ok": ok,
            "deterministic": deterministic, "ms": ms, "plain_ms": plain_ms,
            "eager_ms": eager, "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes}


# (C, P, offset) of the fold's edge cases: a misaligned contiguous plane
# view (1 element for f32 / bf16, 3 bytes for int8; x and m 1 element), a
# cohort of 1 and of 100 at the main P, ragged narrow planes, and a cohort
# of 1000 whose rows stream through the ring in several groups.
FOLD_EDGES = ((MAIN_C, MAIN_P, 1), (1, MAIN_P, 0), (100, MAIN_P, 0), (MAIN_C, 1, 0),
              (MAIN_C, 17, 0), (MAIN_C, 4099, 0), (1000, 4099, 0))


def fold_edge_cases(torch, su_kernel, su_ref, gen):
    """Both folds at ``FOLD_EDGES``, x and m written, f32 momentum: f32 and
    bf16 deltas, int8 and bf16 q; each bitwise against its plain version and
    launched twice for determinism."""
    su, dq = [], []
    for C, P, offset in FOLD_EDGES:
        for d_dtype in (torch.float32, torch.bfloat16):
            r = check_server_update(torch, su_kernel, su_ref, C, P, True, True, torch.float32,
                                    gen, d_dtype=d_dtype, offset=offset)
            su.append(r)
            say(f"server_update edge {json.dumps(r)}")
        for q_kind in ("int8", "bf16"):
            r = check_dequant_update(torch, su_kernel, su_ref, C, P, q_kind, True, True,
                                     torch.float32, gen,
                                     offset=3 if offset and q_kind == "int8" else offset)
            dq.append(r)
            say(f"dequant_update edge {json.dumps(r)}")
    torch.cuda.empty_cache()
    return su, dq


# the staleness discounts of the γ cases: γ and γ², the async ring's fold
# weight γ^(D−1) at D = 2 and 3 for staleness_discount 0.9
GAMMAS = (0.9, 0.81)


def fold_gamma_cases(torch, su_kernel, su_ref, gen):
    """Both folds with the staleness discount γ ≠ 1 on coefs[3], at the main
    and the large plane, x and m written: ``server_update`` with f32 and
    bf16 momentum, ``dequant_update`` with int8 and bf16 q (f32 momentum);
    each launched twice, bitwise against the first launch and its plain
    version."""
    out = []
    for C, P in ((MAIN_C, MAIN_P), (BIG_C, BIG_P)):
        for gamma in GAMMAS:
            for m_dtype in (torch.float32, torch.bfloat16):
                r = check_server_update(torch, su_kernel, su_ref, C, P, True, True, m_dtype, gen,
                                        gamma=gamma)
                out.append(r)
                say(f"server_update gamma {json.dumps(r)}")
            for q_kind in ("int8", "bf16"):
                r = check_dequant_update(torch, su_kernel, su_ref, C, P, q_kind, True, True,
                                         torch.float32, gen, gamma=gamma)
                out.append(r)
                say(f"dequant_update gamma {json.dumps(r)}")
        torch.cuda.empty_cache()
    return out


def gamma_line(r, cases) -> str:
    """One γ case's time beside its γ = 1 twin (same shape and dtypes)."""
    keys = ("C", "P", "m", "d", "q")
    twin = next(c for c in cases if c.get("offset") == 0 and c["write_x"] and c["write_m"]
                and all(c.get(k) == r.get(k) for k in keys))
    name = f"server_update m {r['m']}" if "d" in r else f"dequant_update {r['q']}"
    return (f"{name} ({r['C']}, {r['P']}) gamma {r['gamma']}: {r['ms']:.6f} "
            f"(gamma 1: {twin['ms']:.6f})")


def launch_floor_ms(torch) -> float:
    """Device ms of the least launch: a one-element ``fill_``, timed as the
    fold cases are (CUDA-graph replay)."""
    one = torch.empty(1, device="cuda")
    return graph_ms(torch, lambda: one.fill_(1.0), 20)


def close_to(torch, actual, expected, rtol: float, atol_rel: float) -> bool:
    """|actual − expected| ≤ rtol·|expected| + atol_rel·max|expected|."""
    a, e = actual.float(), expected.float()
    atol = atol_rel * float(e.abs().max()) if e.numel() else 0.0
    return bool(((a - e).abs() <= rtol * e.abs() + atol).all())


def peak_flops(torch, dtype) -> float:
    """The card's peak for products of ``dtype`` inputs: the bf16 tensor
    cores for bf16, f32 outside the tensor cores for f32 (TF32 would not
    keep the plain version's f32)."""
    return BF16_FLOPS_PER_S if dtype == torch.bfloat16 else F32_FLOPS_PER_S


def check_flash_attention(torch, fa_kernel, fa_ref, B, Sq, Skv, H, Hkv, hd, dtype, causal,
                          window, q_offset, gen, library: bool):
    """The kernel against its plain version on one case; the bound counts
    the (q, k) pairs the masks keep on these shapes."""
    dev = "cuda"
    q = torch.randn((B, Sq, H, hd), generator=gen, device=dev).to(dtype)
    k = torch.randn((B, Skv, Hkv, hd), generator=gen, device=dev).to(dtype)
    v = torch.randn((B, Skv, Hkv, hd), generator=gen, device=dev).to(dtype)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    out = fa_kernel.flash_attention_bshd(q, k, v, **kw)
    ref = fa_ref.flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    name = str(dtype).split(".")[-1]
    rtol, atol_rel = LM_KERNEL_TOL[name]
    qpos = torch.arange(Sq, device=dev)[:, None] + q_offset
    kpos = torch.arange(Skv, device=dev)[None, :]
    keep = qpos >= kpos if causal else torch.ones((Sq, Skv), dtype=torch.bool, device=dev)
    if window is not None:
        keep &= qpos - kpos < window
    pairs = int(keep.sum())
    empty_rows = int((keep.sum(dim=1) == 0).sum())
    nbytes = (q.numel() + k.numel() + v.numel() + out.numel()) * q.element_size()
    b_ms, b_by = bound(nbytes, 0)
    f_ms = 4 * hd * B * H * pairs / peak_flops(torch, dtype) * 1e3
    if f_ms > b_ms:
        b_ms, b_by = f_ms, "operations"
    reps = 5 if Sq >= 1024 else 20
    res = {"B": B, "Sq": Sq, "Skv": Skv, "H": H, "Hkv": Hkv, "hd": hd, "dtype": name,
           "causal": causal, "window": window, "q_offset": q_offset, "rows_without_keys": empty_rows,
           "max_abs_err": max_err(torch, out, ref), "max_abs_plain": float(ref.float().abs().max()),
           "ok": close_to(torch, out, ref, rtol, atol_rel) and bool(torch.isfinite(out).all()),
           "ms": graph_ms(torch, lambda: fa_kernel.flash_attention_bshd(q, k, v, **kw), reps),
           "plain_ms": graph_ms(torch, lambda: fa_ref.flash_attention_ref(q, k, v, **kw), reps),
           "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
           "flops": 4 * hd * B * H * pairs, "library_ms": None}
    if library:  # the yardstick: one PyTorch call, (B, H, S, hd) layout, never on the path
        sdpa = torch.nn.functional.scaled_dot_product_attention
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        lib = sdpa(qt, kt, vt, is_causal=True, enable_gqa=True).transpose(1, 2)
        res["library_max_abs_diff"] = max_err(torch, lib, ref)
        res["library_ms"] = graph_ms(
            torch, lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True), reps)
    return res


def check_ssd_scan(torch, ssd_kernel, ssd_ref, B, S, H, P, N, L, dtype, gen):
    """The kernel against its plain version; x, B and C in ``dtype``, dt =
    softplus(normal − 4) as the model's dt_bias init gives, A = −(1..H)."""
    dev = "cuda"
    x = torch.randn((B, S, H, P), generator=gen, device=dev).to(dtype)
    dt = torch.nn.functional.softplus(torch.randn((B, S, H), generator=gen, device=dev) - 4.0)
    A = -torch.arange(1, H + 1, dtype=torch.float32, device=dev)
    Bm = torch.randn((B, S, N), generator=gen, device=dev).to(dtype)
    Cm = torch.randn((B, S, N), generator=gen, device=dev).to(dtype)
    y, st = ssd_kernel.ssd_scan(x, dt, A, Bm, Cm, chunk=L)
    y_ref, st_ref = ssd_ref.ssd_chunked_ref(x, dt, A, Bm, Cm, L)
    torch.cuda.synchronize()
    name = str(dtype).split(".")[-1]
    ok = (close_to(torch, y, y_ref, *LM_KERNEL_TOL[name])
          and close_to(torch, st, st_ref, *LM_KERNEL_TOL["float32"])
          and bool(torch.isfinite(y).all()) and bool(torch.isfinite(st).all()))
    nbytes = (x.numel() * x.element_size() + dt.numel() * 4 + A.numel() * 4
              + (Bm.numel() + Cm.numel()) * Bm.element_size() + y.numel() * y.element_size()
              + st.numel() * 4)
    # per chunk of l steps: C·Bᵀ on the causal triangle once per (b, chunk)
    # (the heads share B and C), then per (b, h, chunk) y_diag on the
    # triangle, y_off and the state update
    flops = 0
    for c0 in range(0, S, L):
        l = min(L, S - c0)
        tri = l * (l + 1) // 2
        flops += B * 2 * N * tri + B * H * (2 * P * tri + 4 * l * P * N)
    b_ms, b_by = bound(nbytes, 0)
    f_ms = flops / peak_flops(torch, dtype) * 1e3
    if f_ms > b_ms:
        b_ms, b_by = f_ms, "operations"
    reps = 5 if S >= 1024 else 20
    return {"B": B, "S": S, "H": H, "P": P, "N": N, "L": L, "dtype": name,
            "max_abs_err": max(max_err(torch, y, y_ref), max_err(torch, st, st_ref)),
            "max_abs_plain": float(y_ref.float().abs().max()), "ok": ok,
            "ms": graph_ms(torch, lambda: ssd_kernel.ssd_scan(x, dt, A, Bm, Cm, chunk=L), reps),
            "plain_ms": graph_ms(torch, lambda: ssd_ref.ssd_chunked_ref(x, dt, A, Bm, Cm, L),
                                 reps),
            "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes, "flops": flops,
            "library_ms": None}


# ---------------------------------------------------------------------- phase 6
def serve_full_width(torch, np, bindings):
    """``repro_torch.launch.serve`` at full width for both ported archs,
    each with the launch counts set to 0 just before and read just after."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import serve

    per_prefill = {"llama3.2-1b": {"flash_attention": 16}, "mamba2-1.3b": {"ssd_scan": 48}}
    out = {}
    for arch, want in per_prefill.items():
        args = serve.build_parser().parse_args(["--arch", arch, *SERVE_ARGS])
        for b in bindings.values():
            b.launches = 0
        t0 = time.perf_counter()
        res = serve.run(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: b.launches for k, b in bindings.items()}
        expected = {k: want.get(k, 0) * args.sessions for k in bindings}
        if launches != expected:
            fail(f"serving {arch}: launch counts {launches}, expected {expected}")
        vocab = get_config(arch).padded_vocab
        if res.tokens.shape != (args.batch, args.gen) or not (
                (res.tokens >= 0).all() and (res.tokens < vocab).all()):
            fail(f"serving {arch}: tokens of shape {res.tokens.shape} outside [0, {vocab})")
        rows = []
        for s, (tp, td) in enumerate(zip(res.prefill_s, res.decode_s)):
            rows.append({"session": s, "prefill_ms": tp * 1e3,
                         "prefill_tok_s": args.batch * args.prompt_len / tp,
                         "decode_ms": td * 1e3,
                         "decode_tok_s": args.batch * (args.gen - 1) / td})
            say(f"serving {arch}: {json.dumps(rows[-1])}")
        say(f"serving {arch}: launches {launches} in {args.sessions} sessions "
            f"({wall:.1f} s with init); first tokens {res.tokens[0, :8].tolist()}")
        out[arch] = {"launches": launches, "sessions": args.sessions, "rows": rows}
        del res
        torch.cuda.empty_cache()
    return out


def decode_step_breakdown(torch, arch: str):
    """One full-width decode step of ``arch`` at the serving shape (B=4,
    after a 1024-token prefill): ms per step (10 steps synchronized at both
    ends), and the device operations of one step with their summed device
    time (torch.profiler).  A step launches more operations than the
    launch queue holds, so the sleep probe of ``device_ms_per_round``
    cannot time it."""
    from repro_torch.configs.base import get_config
    from repro_torch.data.synthetic import make_synthetic_lm
    from repro_torch.launch.serve import merge
    from repro_torch.models.model import build_model
    from repro_torch.utils.trees import tree_map

    model = build_model(get_config(arch))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = model.init(gen)
    prompts = torch.as_tensor(make_synthetic_lm(512, 1024, 4, seed=0), device="cuda")
    logits, pre, _ = model.apply(params, prompts, return_cache=True)
    st = {"tok": torch.argmax(logits[:, -1].float(), dim=-1)[:, None], "pos": 1024,
          "cache": tree_map(merge, model.init_cache(params, 4, 1024 + 32), pre)}
    del logits, pre

    def step():  # greedy, as the serving loop's decode step
        lg, st["cache"] = model.decode_step(params, st["tok"], st["cache"], st["pos"])
        st["tok"] = torch.argmax(lg[:, -1].float(), dim=-1)[:, None]
        st["pos"] += 1

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        step()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / 10 * 1e3
    ops, dev_ms = device_profile(torch, step)
    del st, params
    torch.cuda.empty_cache()
    return {"arch": arch, "ms_per_step": host_ms, "device_ops_per_step": ops,
            "device_op_ms_per_step": dev_ms, "device_busy_share": dev_ms / host_ms}


# ---------------------------------------------------------------------- phase 7
def serve_card_vs_cpu(torch, np, arch: str):
    """Full width cut to 2 layers, B=2, prompt 128: prefill logits and cache,
    then 4 teacher-forced decode steps on the card and on the CPU from the
    same f32 weights (drawn on the CPU), each within ``LM_REL_L2``."""
    from dataclasses import replace as dc_replace

    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import merge
    from repro_torch.models.model import build_model
    from repro_torch.utils.trees import tree_leaves, tree_map

    cfg = dc_replace(get_config(arch), n_layers=2)
    model = build_model(cfg)
    params_cpu = model.init(torch.Generator().manual_seed(5))
    params = {"cpu": params_cpu, "cuda": tree_map(lambda t: t.cuda(), params_cpu)}
    B, S, steps = 2, 128, 4
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, size=(B, S + steps))
    outs = {}
    for dev in ("cuda", "cpu"):
        p = params[dev]
        t = torch.as_tensor(toks, device=dev)
        logits, pre, _ = model.apply(p, t[:, :S], return_cache=True)
        seq = [("prefill logits", logits)]
        seq += [(f"prefill cache {i}", x) for i, x in enumerate(tree_leaves(pre))]
        cache = tree_map(merge, model.init_cache(p, B, S + steps), pre)
        for i in range(steps):
            lg, cache = model.decode_step(p, t[:, S + i:S + i + 1], cache, S + i)
            seq.append((f"decode {i} logits", lg))
        seq += [(f"decode cache {i}", x) for i, x in enumerate(tree_leaves(cache))]
        outs[dev] = [(name, x.detach().float().cpu()) for name, x in seq]
    worst = {}
    for (name, a), (_, b) in zip(outs["cuda"], outs["cpu"]):
        rel = float((a - b).norm() / b.norm().clamp_min(1e-30))
        worst[name] = rel
        if not (rel <= LM_REL_L2 and bool(torch.isfinite(a).all())):
            fail(f"card vs CPU serving {arch}: {name} relative L2 error {rel:.3e} "
                 f"> {LM_REL_L2} (max abs diff {float((a - b).abs().max()):.3e})")
    logits_rel = max(v for k, v in worst.items() if "logits" in k)
    cache_rel = max(v for k, v in worst.items() if "cache" in k)
    return {"arch": arch, "n_layers": 2, "B": B, "prompt": S, "decode_steps": steps,
            "max_rel_l2_logits": logits_rel, "max_rel_l2_cache": cache_rel}


# ---------------------------------------------------------------------- phase 4b
def other_algorithms(torch, np, bindings):
    """``run_federated`` for each of ``OTHER_ALGOS`` at the CLI defaults,
    then scaffold and mimelite under int8, each with the launch counts set
    to 0 just before and read just after; then the steady seconds per round
    of an engine on the same config."""
    from repro_torch.configs.base import CompressionConfig, FedConfig
    from repro_torch.launch.fed_train import run_federated

    rows = []
    for algo, comp in [(a, None) for a in OTHER_ALGOS] + [("scaffold", "int8"),
                                                          ("mimelite", "int8")]:
        cfg = FedConfig(algo=algo, participation="bernoulli", rounds=ROUNDS,
                        compression=None if comp is None else CompressionConfig(kind=comp),
                        **ALGO_SETTINGS.get(algo, {}))
        su, dq = FOLDS_PER_ROUND.get(algo, {None: (1, 0)})[comp]
        expected = {"fed_direction": ROUNDS * K, "server_update": ROUNDS * su,
                    "dequant_update": ROUNDS * dq, "flash_attention": 0, "ssd_scan": 0}
        name = algo if comp is None else f"{algo} {comp}"
        for b in bindings.values():
            b.launches = 0
        t0 = time.perf_counter()
        acc, log = run_federated(cfg, 0.6, eval_every=EVAL_EVERY, seed=0, echo=False,
                                 device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: b.launches for k, b in bindings.items()}
        losses = log.column("loss")
        if not all(np.isfinite(losses)):
            fail(f"{name}: non-finite loss {losses}")
        if launches != expected:
            fail(f"{name}: launch counts {launches}, expected {expected}")
        s_round, eng, state, _, host = steady_seconds_per_round(torch, cfg)
        if not np.isfinite(host["loss"]).all() or not torch.isfinite(state.params).all():
            fail(f"{name}: non-finite loss or params in the steady-state rounds")
        wire = eng.payload_bytes()["up_per_client"]
        if not np.array_equal(host["bytes_up"], host["n_active"] * np.float32(wire)):
            fail(f"{name}: bytes_up is not n_active x {wire}")
        row = {"algo": algo, "uplink": comp or "f32", "rounds": ROUNDS, "launches": launches,
               "losses": losses, "final_test_acc": acc, "wall_s": wall,
               "steady_ms_per_round": s_round * 1e3, "uplink_bytes_per_client": wire}
        say(f"{name}: {json.dumps(row)}")
        rows.append(row)
        del eng, state
    return rows


# ---------------------------------------------------------------------- phase 4c
def async_ring(torch, np, bindings):
    """``run_federated`` on the async ring for each of ``ASYNC_RUNS`` at the
    CLI defaults, γ = 0.9, with the launch counts set to 0 just before and
    read just after (K ``fed_direction`` a round; one fold launch a round
    per fold row, drain included: ``FOLDS_PER_ROUND``); then the steady seconds
    per round of 20 further rounds of an engine, whose ``folded`` must be
    D − 1 zeros and then ones."""
    from repro_torch.configs.base import CompressionConfig, FedConfig
    from repro_torch.launch.fed_train import run_federated

    rows = []
    for algo, comp, D, S in ASYNC_RUNS:
        cfg = FedConfig(algo=algo, participation="bernoulli", rounds=ROUNDS, pipeline_depth=D,
                        staleness=S, staleness_discount=RING_GAMMA,
                        compression=None if comp is None else CompressionConfig(kind=comp))
        su, dq = FOLDS_PER_ROUND.get(algo, {None: (1, 0)})[comp]
        expected = {"fed_direction": ROUNDS * K, "server_update": ROUNDS * su,
                    "dequant_update": ROUNDS * dq, "flash_attention": 0, "ssd_scan": 0}
        name = f"{algo}{'' if comp is None else ' ' + comp} D={D} S={S}"
        for b in bindings.values():
            b.launches = 0
        t0 = time.perf_counter()
        acc, log = run_federated(cfg, 0.6, eval_every=EVAL_EVERY, seed=0, echo=False,
                                 device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: b.launches for k, b in bindings.items()}
        losses = log.column("loss")
        if not losses or not all(np.isfinite(losses)):
            fail(f"async {name}: non-finite or missing loss {losses}")
        if launches != expected:
            fail(f"async {name}: launch counts {launches}, expected {expected}")
        # the sync twin (same spec and uplink, D = 1, S = 0) before and after
        # the ring, so the two are compared in turns on one host
        sync_cfg = replace(cfg, pipeline_depth=1, staleness=0)
        sync_a = steady_seconds_per_round(torch, sync_cfg)[0]
        s_round, eng, state, _, host = steady_seconds_per_round(torch, cfg, ring=(D, S))
        sync_b = steady_seconds_per_round(torch, sync_cfg)[0]
        if not np.isfinite(host["loss"]).all() or not torch.isfinite(state.params).all():
            fail(f"async {name}: non-finite loss or params in the steady-state rounds")
        want = [0.0] * (D - 1) + [1.0] * (ROUNDS - D + 1)
        if host["folded"].tolist() != want:
            fail(f"async {name}: folded {host['folded'].tolist()}, expected {want}")
        row = {"algo": algo, "uplink": comp or "f32", "D": D, "S": S, "gamma": RING_GAMMA,
               "rounds": ROUNDS, "launches": launches, "losses": losses,
               "final_test_acc": acc, "wall_s": wall, "steady_ms_per_round": s_round * 1e3,
               "sync_twin_ms_per_round": [sync_a * 1e3, sync_b * 1e3]}
        say(f"async {name}: {json.dumps(row)}")
        rows.append(row)
        del eng, state
    return rows


# ---------------------------------------------------------------------- phase 4d
def host_store_fleet(torch, np, bindings):
    """The host store at ``FLEET_N`` clients (scaffold, zipf availability,
    dropout 0.1, store failures 0.05, ``StreamingClientData``): for the sync
    loop and the ring at D = 2, S = 1, ``run_federated`` with the launch
    counts set to 0 just before and read just after, then an engine's 20
    rounds (the touched rows, the store's bytes, n_retries) and 20 further
    rounds (steady s/round), the device's peak memory over it all."""
    from repro_torch.configs.base import FaultConfig, FedConfig
    from repro_torch.core.engine import cohort_capacity, metrics_to_host
    from repro_torch.data import StreamingClientData
    from repro_torch.launch.fed_train import run_federated

    base = FedConfig(algo="scaffold", num_clients=FLEET_N, participation="bernoulli",
                     rounds=ROUNDS, population_store="host", availability="zipf",
                     dropout_rate=0.1, fault=FaultConfig(store_failure_rate=0.05),
                     staleness_discount=RING_GAMMA)
    cap = cohort_capacity(base)
    expected = {"fed_direction": ROUNDS * K, "server_update": ROUNDS * 2, "dequant_update": 0,
                "flash_attention": 0, "ssd_scan": 0}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    rows = []
    for mode, ring in (("sync", None), ("async D=2 S=1", (2, 1))):
        cfg = base if ring is None else replace(base, pipeline_depth=ring[0], staleness=ring[1])
        for b in bindings.values():
            b.launches = 0
        acc, log = run_federated(cfg, 0.6, eval_every=EVAL_EVERY, seed=0, echo=False,
                                 device="cuda")
        torch.cuda.synchronize()
        launches = {k: b.launches for k, b in bindings.items()}
        losses = log.column("loss")
        if not losses or not all(np.isfinite(losses)):
            fail(f"host store {mode}: non-finite or missing loss {losses}")
        if launches != expected:
            fail(f"host store {mode}: launch counts {launches}, expected {expected}")
        eng, state, data = fresh_engine(torch, cfg, StreamingClientData(FLEET_N, seed=0))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, ms = run_engine(eng, state, data, ROUNDS, ring)
        torch.cuda.synchronize()
        first_s = (time.perf_counter() - t0) / ROUNDS
        first = metrics_to_host(ms)
        touched, nbytes = eng.population.touched, eng.population.nbytes
        t0 = time.perf_counter()
        state, ms = run_engine(eng, state, data, ROUNDS, ring)
        torch.cuda.synchronize()
        s_round = (time.perf_counter() - t0) / ROUNDS
        host = metrics_to_host(ms)
        if not (np.isfinite(first["loss"]).all() and np.isfinite(host["loss"]).all()
                and torch.isfinite(state.params).all()):
            fail(f"host store {mode}: non-finite loss or params")
        if state.client_states is not None or not 0 < touched <= ROUNDS * cap:
            fail(f"host store {mode}: {touched} touched rows after {ROUNDS} rounds "
                 f"(at most {ROUNDS} x {cap}), or an (N, P) device plane")
        retries = int(first["n_retries"].sum() + host["n_retries"].sum()
                      + sum(log.column("retries")))
        row = {"mode": mode, "N": FLEET_N, "capacity": cap, "launches": launches,
               "losses": losses, "final_test_acc": acc, "touched_rows": touched,
               "store_bytes": nbytes, "n_retries": retries,
               "first_ms_per_round": first_s * 1e3, "steady_ms_per_round": s_round * 1e3,
               "resident_plane_bytes": FLEET_N * eng.spec.size * 4}
        say(f"host store {mode}: {json.dumps(row)}")
        rows.append(row)
        del eng, state, data
    peak = torch.cuda.max_memory_allocated()
    say(f"host store at N={FLEET_N}: device memory allocated {before} B before, peak "
        f"{peak} B over both loops (limit 1 GB); a resident (N, P) f32 plane would take "
        f"{rows[0]['resident_plane_bytes']} B")
    if peak >= 1e9:
        fail(f"host store: peak device memory {peak} B, not under 1 GB")
    if sum(r["n_retries"] for r in rows) == 0:
        fail("host store: no store retry at failure rate 0.05")
    return rows


def bitwise_pairs_on_card(torch, np):
    """Device-resident data (N = 100) on the card, bit for bit: the host
    store against the resident plane for scaffold and feddyn, sync and
    async (D = 2, S = 1), and for scaffold under int8 and under top-k (the
    residual store against the resident residual plane); and the ring at
    D = 1, S = 0 against the sync loop for scaffold under int8."""
    from repro_torch.configs.base import CompressionConfig, FedConfig
    from repro_torch.core.engine import metrics_to_host

    def run(cfg, ring):
        eng, state, data = fresh_engine(torch, cfg)
        state, ms = run_engine(eng, state, data, PAIR_ROUNDS, ring)
        return eng, state, metrics_to_host(ms)

    def rows_of(eng, state):
        if state.client_states is not None:
            return state.client_states.cpu().numpy()
        dense = np.zeros((eng.cfg.num_clients, eng.spec.size), np.float32)
        tree = eng.population.to_pytree()
        dense[tree["ids"]] = tree["rows"]
        return dense

    def same(a, b, what):
        (ea, sa, ma), (eb, sb, mb) = a, b
        ok = torch.equal(sa.params, sb.params) and torch.equal(sa.server.momentum,
                                                               sb.server.momentum)
        ok = ok and all(np.array_equal(ma[f], mb[f]) for f in ma if f in mb)
        ok = ok and np.array_equal(rows_of(ea, sa), rows_of(eb, sb))
        if not ok:
            fail(f"{what}: not bitwise equal on the card")

    pairs = 0
    for algo in ("scaffold", "feddyn"):
        for ring in (None, (2, 1)):
            cfg = FedConfig(algo=algo, participation="bernoulli", staleness_discount=RING_GAMMA)
            same(run(cfg, ring), run(replace(cfg, population_store="host"), ring),
                 f"store vs resident {algo} {'sync' if ring is None else 'async'}")
            pairs += 1
    for kind in ("int8", "topk"):
        cfg = FedConfig(algo="scaffold", participation="bernoulli",
                        compression=CompressionConfig(kind=kind))
        res, host = run(cfg, None), run(replace(cfg, population_store="host"), None)
        same(res, host, f"store vs resident scaffold {kind}")
        if kind == "topk":
            dense = np.zeros((cfg.num_clients, host[0].spec.size), np.float32)
            tree = host[0].residual_population.to_pytree()
            dense[tree["ids"]] = tree["rows"]
            if not np.array_equal(dense, res[1].residuals.cpu().numpy()):
                fail("store vs resident scaffold topk: residual store differs")
        pairs += 1
    cfg = FedConfig(algo="scaffold", participation="bernoulli",
                    compression=CompressionConfig(kind="int8"))
    same(run(cfg, None), run(cfg, (1, 0)), "ring D=1 S=0 vs sync, scaffold int8")
    return pairs + 1


# ---------------------------------------------------------------------- phase 5
def card_vs_cpu(torch, np, algo="fedcm"):
    """Three rounds of ``algo`` from one converted state on the card and on
    the CPU, with the same ids, masks, minibatch indices and full batches;
    every state plane the spec has within the parity tolerance."""
    from repro_torch.configs.base import FedConfig
    from repro_torch.core.convert import params_to_numpy, state_from_numpy, state_to_numpy
    from repro_torch.core.engine import FederatedEngine, cohort_capacity
    from repro_torch.data import (
        FederatedData, gather_full_client_batch, gather_round_batches,
        make_synthetic_classification,
    )
    from repro_torch.models.small import classification_loss, mlp_classifier

    cfg = FedConfig(algo=algo, participation="bernoulli", **ALGO_SETTINGS.get(algo, {}))
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
            full = None
            if eng.algo.needs_full_grad:
                full = gather_full_client_batch(data.client_x, data.client_y, ids_t)
            state, _ = eng.round_step(state, batches, ids_t, torch.as_tensor(mask, device=dev),
                                      full_batches=full)
        out[dev] = state_to_numpy(state)
    res = {}
    for key in ("params", "momentum", "second_moment", "client_states"):
        a, b = out["cuda"][key], out["cpu"][key]
        if (a is None) != (b is None):
            fail(f"card vs CPU {algo}: {key} exists on one device only")
        if a is None:
            continue
        res[key] = float(np.max(np.abs(a - b)))
        if not np.allclose(a, b, rtol=PARITY_RTOL, atol=PARITY_ATOL):
            fail(f"card vs CPU {algo}: {key} differ beyond rtol {PARITY_RTOL} atol "
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


def card_vs_cpu_ring(torch, np, algo):
    """Six launches of the async ring at D = 2, S = 1, γ = 0.9 from one
    converted state (a nonzero momentum, so the stale broadcast matters)
    on the card and on the CPU, with the same injected ids, masks,
    minibatch indices and full batches; every state plane the spec has
    within the parity tolerance after the drain."""
    from repro_torch.configs.base import FedConfig
    from repro_torch.core.convert import params_to_numpy, state_from_numpy, state_to_numpy
    from repro_torch.core.engine import FederatedEngine, RoundInputs, cohort_capacity
    from repro_torch.data import (
        FederatedData, gather_full_client_batch, gather_round_batches,
        make_synthetic_classification,
    )
    from repro_torch.models.small import classification_loss, mlp_classifier

    cfg = FedConfig(algo=algo, participation="bernoulli", staleness_discount=RING_GAMMA,
                    **ALGO_SETTINGS.get(algo, {}))
    cap = cohort_capacity(cfg)
    x_tr, y_tr, _, _ = make_synthetic_classification(n_train=20_000, n_test=10, seed=3)
    model = mlp_classifier((32, 128, 128, 10))
    params = params_to_numpy(model.init(torch.Generator().manual_seed(3)))
    rng = np.random.default_rng(6)
    momentum = (0.01 * rng.normal(size=MAIN_P)).astype(np.float32)
    draws = [(rng.permutation(cfg.num_clients)[:cap],
              np.arange(cap) < rng.binomial(cfg.num_clients, 0.1)) for _ in range(6)]
    out = {}
    for dev in ("cuda", "cpu"):
        data = FederatedData(x_tr, y_tr, cfg.num_clients, dirichlet_alpha=0.6, seed=3, device=dev)
        idx_rng = np.random.default_rng(7)
        state, spec = state_from_numpy(params, cfg, momentum=momentum, device=dev)
        eng = FederatedEngine(cfg, classification_loss(model.apply), spec, device=dev)
        inputs = []
        for ids, mask in draws:
            idx = idx_rng.integers(0, data.n_per_client, size=(cap, cfg.local_steps, 50))
            ids_t = torch.as_tensor(ids, device=dev)
            full = None
            if eng.algo.needs_full_grad:
                full = gather_full_client_batch(data.client_x, data.client_y, ids_t)
            inputs.append(RoundInputs(
                gather_round_batches(data.client_x, data.client_y, None, ids_t,
                                     cfg.local_steps, 50, idx=torch.as_tensor(idx)),
                ids_t, torch.as_tensor(mask, device=dev), full_batches=full))
        it = iter(inputs)
        state, _, _ = eng.run_rounds_async_on(state, lambda _: next(it), len(draws),
                                              pipeline_depth=2, staleness=1)
        out[dev] = state_to_numpy(state)
    res = {}
    for key in ("params", "momentum", "second_moment", "client_states"):
        a, b = out["cuda"][key], out["cpu"][key]
        if (a is None) != (b is None):
            fail(f"card vs CPU ring {algo}: {key} exists on one device only")
        if a is None:
            continue
        res[key] = float(np.max(np.abs(a - b)))
        if not np.allclose(a, b, rtol=PARITY_RTOL, atol=PARITY_ATOL):
            fail(f"card vs CPU ring {algo}: {key} differ beyond rtol {PARITY_RTOL} atol "
                 f"{PARITY_ATOL} (max abs diff {res[key]:.3e})")
    return res


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
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.server_update import kernel as su_kernel
    from repro_torch.kernels.server_update import ref as su_ref
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.kernels.ssd_scan import ref as ssd_ref

    bindings = {"fed_direction": fd_kernel.KERNEL, "server_update": su_kernel.KERNEL,
                "dequant_update": su_kernel.DEQUANT_KERNEL,
                "flash_attention": fa_kernel.KERNEL, "ssd_scan": ssd_kernel.KERNEL}

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
    for name, info in built.items():
        funcs = sass_counts(info["path"], {"HMMA": r"\bHMMA\b", "UBLKCP": r"\bUBLKCP"})
        counts = {k: c["HMMA"] for k, c in funcs}
        say(f"  HMMA per kernel in {name}: {json.dumps(counts)}")
        mma = {k: v for k, v in counts.items() if "_mma_kernel" in k}
        if name in ("flash_attention", "ssd_scan") and (not mma or min(mma.values()) == 0):
            fail(f"{name}: a bf16 tensor-core kernel has no HMMA instruction: {counts}")
        if name == "server_update":  # every fold instantiation stages its plane by bulk copies
            bulk = [c["UBLKCP"] for k, c in funcs if k == "fold_kernel"]
            say(f"  UBLKCP (bulk copy global -> shared) per fold_kernel instantiation in {name}: "
                f"{len(bulk)} instantiations, {min(bulk, default=0)}-{max(bulk, default=0)} each")
            if not bulk or min(bulk) == 0:
                fail(f"{name}: a fold kernel has no bulk-copy (UBLKCP) instruction: {bulk}")

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
        for layout in FD_LAYOUTS:
            r = check_fed_direction(torch, fd_kernel, fd_ref, C, P, None, torch.float32, gen,
                                    layout=layout)
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
    su_edge, dq_edge = fold_edge_cases(torch, su_kernel, su_ref, gen)
    su_cases += su_edge
    dq_cases += dq_edge
    gamma_cases = fold_gamma_cases(torch, su_kernel, su_ref, gen)
    bad = [r for r in fd_cases + su_cases + dq_cases + gamma_cases if not r["ok"]]
    if bad:
        fail(f"kernel disagrees with its plain version: {bad}")
    if not all(r["deterministic"] for r in su_cases + dq_cases + gamma_cases):
        fail("a fold kernel is not run-to-run deterministic")
    floor_ms = launch_floor_ms(torch)
    say(f"kernels vs plain: fed_direction within tolerance; server_update and dequant_update "
        f"bitwise equal to their plain versions and bitwise deterministic in all "
        f"{len(su_cases) + len(dq_cases)} cases ({len(su_edge) + len(dq_edge)} edge cases)")
    main_xm = [r for r in su_cases + dq_cases if (r["C"], r["P"], r["offset"]) == (MAIN_C, MAIN_P, 0)
               and r["write_x"] and r["write_m"] and r["m"] == "float32"]
    say(f"launch floor {floor_ms:.6f} ms (graph replay of a one-element fill_) beside the "
        f"main-plane folds, x and m written, m f32: " + ", ".join(
            f"{'server_update ' + r['d'] if 'd' in r else 'dequant_update ' + r['q']} "
            f"{r['ms']:.6f} ms" for r in main_xm))
    say(f"fold cases at gamma 0.9 and 0.81 (x and m written) bitwise equal to their plain "
        f"versions and deterministic in all {len(gamma_cases)} cases; ms beside gamma 1: "
        + "; ".join(gamma_line(r, su_cases + dq_cases) for r in gamma_cases))

    fa_cases, ssd_cases = [], []
    # (B, Sq, Skv, H, Hkv, hd, dtype, causal, window, q_offset): the serving
    # shape, a ragged one whose window and q_offset leave rows 29-76 no key,
    # f32 with hd=128 without the causal mask, bf16 with hd=128 ragged and
    # causal, and bf16 without the causal mask (GQA, Sq ≠ Skv)
    for B, Sq, Skv, H, Hkv, hd, dtype, causal, window, q_offset in (
            (4, 1024, 1024, 32, 8, 64, torch.bfloat16, True, None, 0),
            (2, 77, 50, 8, 2, 64, torch.bfloat16, True, 20, 40),
            (2, 333, 301, 16, 4, 128, torch.float32, False, None, 0),
            (2, 333, 333, 16, 4, 128, torch.bfloat16, True, None, 0),
            (2, 200, 300, 8, 2, 64, torch.bfloat16, False, None, 0)):
        r = check_flash_attention(torch, fa_kernel, fa_ref, B, Sq, Skv, H, Hkv, hd, dtype,
                                  causal, window, q_offset, gen, library=not fa_cases)
        fa_cases.append(r)
        say(f"flash_attention {json.dumps(r)}")
    for B, S, H, P, N, L, dtype in ((4, 1024, 64, 64, 128, 64, torch.bfloat16),
                                    (2, 1000, 64, 64, 128, 64, torch.bfloat16),
                                    (2, 40, 16, 64, 128, 64, torch.float32),
                                    (2, 40, 16, 64, 128, 64, torch.bfloat16)):
        r = check_ssd_scan(torch, ssd_kernel, ssd_ref, B, S, H, P, N, L, dtype, gen)
        ssd_cases.append(r)
        say(f"ssd_scan {json.dumps(r)}")
    torch.cuda.empty_cache()
    bad = [r for r in fa_cases + ssd_cases if not r["ok"]]
    if bad:
        fail(f"kernel disagrees with its plain version: {bad}")
    if fa_cases[1]["rows_without_keys"] == 0:
        fail("the ragged flash_attention case was meant to have rows without keys")
    say(f"kernels vs plain: flash_attention and ssd_scan within {LM_KERNEL_TOL} "
        f"(rtol, atol relative to the largest plain value)")

    say(f"device memory allocated after phase 3: {torch.cuda.memory_allocated()} B")

    # ---- 4. main path and the lossy-uplink paths, launch counts from each run only
    from repro_torch.configs.base import CompressionConfig, FaultConfig, FedConfig
    from repro_torch.launch.fed_train import run_federated

    base = FedConfig(participation="bernoulli", rounds=ROUNDS)
    lm = {"flash_attention": 0, "ssd_scan": 0}  # the LM kernels stay off the federated paths
    paths = {
        "uncompressed": (base, {"fed_direction": ROUNDS * K, "server_update": ROUNDS,
                                "dequant_update": 0, **lm}),
        "int8": (replace(base, compression=CompressionConfig(kind="int8")),
                 {"fed_direction": ROUNDS * K, "server_update": 0, "dequant_update": ROUNDS,
                  **lm}),
        "topk": (replace(base, compression=CompressionConfig(kind="topk")),
                 {"fed_direction": ROUNDS * K, "server_update": ROUNDS, "dequant_update": 0,
                  **lm}),
        "faults": (replace(base, fault=FaultConfig(drop_rate=0.1, corrupt_rate=0.1,
                                                   corrupt_mode="nan")),
                   {"fed_direction": ROUNDS * K, "server_update": ROUNDS,
                    "dequant_update": 0, **lm}),
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

    # ---- 4b. the other nine algorithms, launch counts from each run only
    algo_rows = other_algorithms(torch, np, bindings)
    say("other algorithms, steady ms/round: " + ", ".join(
        f"{r['algo']}{'' if r['uplink'] == 'f32' else ' ' + r['uplink']} "
        f"{r['steady_ms_per_round']:.3f}" for r in algo_rows))

    # ---- 4c. the async ring, launch counts from each run only
    ring_rows = async_ring(torch, np, bindings)
    say("async ring, steady ms/round beside its sync twin measured before and after it: "
        + ", ".join(f"{r['algo']}{'' if r['uplink'] == 'f32' else ' ' + r['uplink']} "
                    f"D={r['D']} S={r['S']} {r['steady_ms_per_round']:.3f} (sync "
                    f"{r['sync_twin_ms_per_round'][0]:.3f} / {r['sync_twin_ms_per_round'][1]:.3f})"
                    for r in ring_rows))

    # ---- 4d. the host store at fleet scale, and store pairs on the card
    host_store_fleet(torch, np, bindings)
    say(f"bitwise pairs on the card: {bitwise_pairs_on_card(torch, np)} (4 store vs resident, "
        f"2 store vs resident under int8 / topk, 1 ring D=1 vs sync for scaffold int8)")

    # ---- 5. card vs CPU
    diffs = card_vs_cpu(torch, np)
    say(f"card vs CPU over 3 injected rounds: max |diff| params {diffs['params']:.3e}, "
        f"momentum {diffs['momentum']:.3e} (rtol {PARITY_RTOL}, atol {PARITY_ATOL})")
    for row in card_vs_cpu_lossy(torch, np):
        say(f"card vs CPU, int8 + faults, hash draws: {json.dumps(row)}")
    say("card vs CPU, int8 + faults: draws bitwise equal on both devices; params and "
        "momentum within the tolerance plus one quantum per floor flip")

    # ---- 5b. card vs CPU, the other nine algorithms
    for algo in OTHER_ALGOS:
        say(f"card vs CPU, {algo}, 3 injected rounds: max |diff| "
            f"{json.dumps(card_vs_cpu(torch, np, algo))} (rtol {PARITY_RTOL}, "
            f"atol {PARITY_ATOL})")

    # ---- 5c. card vs CPU under the async ring
    for algo in ("fedcm", "scaffold", "fedadam", "mimelite"):
        say(f"card vs CPU, ring D=2 S=1 gamma {RING_GAMMA}, {algo}, 6 injected launches: max "
            f"|diff| {json.dumps(card_vs_cpu_ring(torch, np, algo))} (rtol {PARITY_RTOL}, "
            f"atol {PARITY_ATOL})")

    # ---- 6. serving at full width, launch counts from each run only
    serving = serve_full_width(torch, np, bindings)
    for arch in ("llama3.2-1b", "mamba2-1.3b"):
        say(f"decode step: {json.dumps(decode_step_breakdown(torch, arch))}")
    launches["flash_attention"] = serving["llama3.2-1b"]["launches"]["flash_attention"]
    launches["ssd_scan"] = serving["mamba2-1.3b"]["launches"]["ssd_scan"]

    # ---- 7. card vs CPU, serving
    for arch in ("llama3.2-1b", "mamba2-1.3b"):
        say(f"card vs CPU serving: {json.dumps(serve_card_vs_cpu(torch, np, arch))} "
            f"(relative L2 ≤ {LM_REL_L2})")

    # ---- 8. summary
    def main_case(cases, **sel):
        return next(r for r in cases if r["C"] == MAIN_C and r["P"] == MAIN_P
                    and all(r[k] == v for k, v in sel.items()))

    fd_main = main_case(fd_cases, n_aux=1, x="float32", layout="pool")
    su_main = main_case(su_cases, write_x=True, write_m=True, m="float32", offset=0, d="float32")
    dq_main = main_case(dq_cases, q="int8", write_x=True, write_m=True, m="float32", offset=0)
    kernels = []
    for name, src, replaces, main, cases in (
        ("fed_direction", "src/repro_torch/csrc/fed_direction.cu",
         "src/repro/kernels/fed_direction/kernel.py:53", fd_main, fd_cases),
        ("server_update", "src/repro_torch/csrc/server_update.cu",
         "src/repro/kernels/server_update/kernel.py:91", su_main, su_cases),
        ("dequant_update", "src/repro_torch/csrc/server_update.cu",
         "src/repro/kernels/server_update/kernel.py:211", dq_main, dq_cases),
        ("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
         "src/repro/kernels/flash_attention/kernel.py:109", fa_cases[0], fa_cases),
        ("ssd_scan", "src/repro_torch/csrc/ssd_scan.cu",
         "src/repro/kernels/ssd_scan/kernel.py:92", ssd_cases[0], ssd_cases),
    ):
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in cases),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main.get("library_ms"),
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


def fresh_engine(torch, cfg, data=None):
    """An engine on ``cfg`` at the main path's widths on the card, its
    initialized state and its data (``FederatedData`` of the CLI's default
    task unless ``data`` is given)."""
    from repro_torch.core.engine import FederatedEngine
    from repro_torch.core.flat import FlatSpec
    from repro_torch.data import FederatedData, make_synthetic_classification
    from repro_torch.models.small import classification_loss, mlp_classifier

    if data is None:
        x_tr, y_tr, _, _ = make_synthetic_classification(n_train=50_000, n_test=10, seed=0)
        data = FederatedData(x_tr, y_tr, cfg.num_clients, dirichlet_alpha=0.6, seed=0,
                             device="cuda")
    model = mlp_classifier((32, 128, 128, 10))
    params = model.init(torch.Generator().manual_seed(0))
    eng = FederatedEngine(cfg, classification_loss(model.apply), FlatSpec.from_tree(params),
                          device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    return eng, eng.init(params, gen), data


def run_engine(eng, state, data, n, ring=None):
    """``n`` rounds of the sync loop, or of the async ring at ``ring = (D,
    S)`` (drained)."""
    if ring is None:
        return eng.run_rounds(state, data, n)
    return eng.run_rounds_async(state, data, n, pipeline_depth=ring[0], staleness=ring[1])


def steady_seconds_per_round(torch, cfg, ring=None, data=None):
    """Mean wall seconds per round of an engine on ``cfg`` at the main
    path's widths after warm-up, synchronized at both ends (host launch
    cost included); the async ring at ``ring = (D, S)`` counts its drain.
    Returns ``(s_per_round, engine, state, data, metrics)`` with the timed
    rounds' metrics on the host."""
    from repro_torch.core.engine import metrics_to_host

    eng, state, data = fresh_engine(torch, cfg, data)
    state, _ = run_engine(eng, state, data, 2, ring)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, ms = run_engine(eng, state, data, ROUNDS, ring)
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


def device_profile(torch, enqueue):
    """``(device operations, their summed device ms)`` of the work
    ``enqueue()`` runs, from torch.profiler's device-side rows (kernels,
    copies, fills; the gaps between them are not counted)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        enqueue()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return sum(e.count for e in rows), sum(e.self_device_time_total for e in rows) / 1e3


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
