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

    PYTHONPATH=src python -m repro_torch.launch.federated_llm --device cpu
"""
from __future__ import annotations

import argparse
import math
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch

from repro_torch.configs.base import FedConfig, get_config, reduced
from repro_torch.core.engine import FederatedEngine, metrics_to_host, resolve_device, synchronize
from repro_torch.core.flat import FlatSpec
from repro_torch.data.pipeline import LMFederatedData, federated_lm_corpora
from repro_torch.models.model import build_model, cohort_loss_fn

N_SEQS = 256  # sequences in each client's corpus
# the example's FedCM settings: momentum α, server step η_g, weight decay
ALPHA, ETA_G, WEIGHT_DECAY = 0.1, 1.0, 1e-4
METRICS = ("loss", "momentum_norm", "delta_norm", "n_active")


@dataclass
class FedLMResult:
    """One ``run``: the config's name, the flat plane's size P, each
    round's metrics on the host (``METRICS``), each round's wall ms
    (synchronized with the device at both ends), and the peak device memory
    over the run in bytes (None on the CPU)."""

    arch: str
    n_params: int
    rounds: List[Dict[str, float]]
    round_ms: List[float]
    peak_bytes: Optional[int]


def run(cfg, *, n_clients: int = 8, cohort: int = 3, local_steps: int = 4, batch: int = 4,
        seq: int = 64, rounds: int = 20, eta_l: float = 0.05, seed: int = 0,
        device="cuda") -> FedLMResult:
    """FedCM over the LM ``cfg`` for ``rounds`` rounds (a fixed cohort;
    ``ALPHA``, ``ETA_G`` and ``WEIGHT_DECAY``).
    The weights are drawn on ``device`` from ``seed``, the cohorts and
    minibatches from a generator on ``device`` seeded with ``seed + 1``."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    model = build_model(cfg)
    fed = FedConfig(algo="fedcm", num_clients=n_clients, cohort_size=cohort,
                    local_steps=local_steps, alpha=ALPHA, eta_l=eta_l, eta_g=ETA_G,
                    weight_decay=WEIGHT_DECAY, rounds=rounds, participation="fixed")
    data = LMFederatedData(federated_lm_corpora(cfg.vocab_size, n_clients, seq + 1, N_SEQS),
                           device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = model.init(gen)
    spec = FlatSpec.from_tree(params)
    eng = FederatedEngine(fed, cohort_loss_fn(model), spec, batch_size=batch, device=dev)
    rng = torch.Generator(device=dev)
    rng.manual_seed(seed + 1)
    state = eng.init(params, rng)
    del params  # the engine holds the flat plane
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
    return FedLMResult(cfg.name, spec.size, per_round, round_ms, peak)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    cfg = reduced(get_config("llama3.2-1b"))
    n_clients = 8
    res = run(cfg, n_clients=n_clients, device=args.device)
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
