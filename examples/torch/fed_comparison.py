"""All six federated algorithms head-to-head (paper Tables 1–2 in miniature).

    PYTHONPATH=src python examples/torch/fed_comparison.py [--rounds 80] [--device cpu]

The counterpart of examples/fed_comparison.py, through the port's public
API.  ``--device`` defaults to cuda, which raises without a GPU.
"""
import argparse

import torch

from repro_torch.configs.base import FedConfig
from repro_torch.core import FederatedEngine, FlatSpec, make_eval_fn
from repro_torch.core.engine import resolve_device
from repro_torch.data import FederatedData, make_synthetic_classification
from repro_torch.models.small import classification_loss, mlp_classifier

ALGOS = ["fedcm", "fedavg", "fedadam", "scaffold", "feddyn", "mimelite"]
ETA_G = {"fedadam": 0.03}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--rounds", type=int, default=80)
    ap.add_argument("--clients", type=int, default=100)
    ap.add_argument("--dirichlet", type=float, default=0.3)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    x_tr, y_tr, x_te, y_te = make_synthetic_classification(
        n_classes=20, dim=32, n_train=args.clients * 100, n_test=2000,
        separation=0.9, noise=2.0,
    )
    data = FederatedData(x_tr, y_tr, args.clients, dirichlet_alpha=args.dirichlet, device=dev)
    model = mlp_classifier((32, 128, 64, 20))
    loss_fn = classification_loss(model.apply)
    evaluate = make_eval_fn(model.apply)
    xt, yt = torch.as_tensor(x_te, device=dev), torch.as_tensor(y_te, device=dev)

    print(f"{args.clients} clients, 10% participation, Dirichlet-{args.dirichlet}, "
          f"{args.rounds} rounds\n")
    results = {}
    for algo in ALGOS:
        cfg = FedConfig(algo=algo, num_clients=args.clients, cohort_size=args.clients // 10,
                        local_steps=20, alpha=0.05, eta_l=0.05,
                        eta_g=ETA_G.get(algo, 1.0), participation="bernoulli",
                        weight_decay=1e-3, eta_l_decay=0.998, rounds=args.rounds)
        params = model.init(torch.Generator().manual_seed(0))
        eng = FederatedEngine(cfg, loss_fn, FlatSpec.from_tree(params), batch_size=20,
                              device=dev)
        state = eng.init(params, torch.Generator(device=dev).manual_seed(1))
        for r in range(cfg.rounds):
            state, m = eng.run_round(state, data)
        acc = evaluate(eng.spec.unravel(state.params), xt, yt)
        pay = eng.payload_bytes()
        results[algo] = acc
        print(f"{algo:9s} final acc={acc:.4f}   per-round per-client payload: "
              f"↓{pay['down_per_client']/2**20:.2f} MiB ↑{pay['up_per_client']/2**20:.2f} MiB")

    best = max(results, key=results.get)
    print(f"\nbest: {best} ({results[best]:.4f})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
