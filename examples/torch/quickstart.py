"""Quickstart: FedCM in ~40 lines of the port's public API.

    PYTHONPATH=src python examples/torch/quickstart.py                # on the GPU
    PYTHONPATH=src python examples/torch/quickstart.py --device cpu

The counterpart of examples/quickstart.py: trains a small MLP federated
across 50 heterogeneous clients with FedCM, prints round metrics, and
contrasts it with FedAvg — the paper's headline comparison at toy size.
``--device`` defaults to cuda, which raises without a GPU.
"""
import argparse

import torch

from repro_torch.configs.base import FedConfig
from repro_torch.core import FederatedEngine, FlatSpec, make_eval_fn
from repro_torch.core.engine import resolve_device
from repro_torch.data import FederatedData, make_synthetic_classification
from repro_torch.models.small import classification_loss, mlp_classifier


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    dev = resolve_device(ap.parse_args(argv).device)

    # 1. a non-IID federated dataset (Dirichlet label skew, paper §C.1)
    x_tr, y_tr, x_te, y_te = make_synthetic_classification(
        n_classes=10, dim=32, n_train=5000, n_test=1000, separation=0.9, noise=2.0)
    data = FederatedData(x_tr, y_tr, num_clients=50, dirichlet_alpha=0.3, device=dev)

    # 2. a model + loss
    model = mlp_classifier((32, 64, 10))
    loss_fn = classification_loss(model.apply)
    evaluate = make_eval_fn(model.apply)
    xt, yt = torch.as_tensor(x_te, device=dev), torch.as_tensor(y_te, device=dev)

    # 3. run FedCM vs FedAvg (α=1 ≡ FedAvg; α=0.05 is the paper's sweet spot)
    for algo, alpha in [("fedcm", 0.05), ("fedavg", 1.0)]:
        cfg = FedConfig(algo=algo, num_clients=50, cohort_size=5, local_steps=10,
                        alpha=alpha, eta_l=0.05, eta_g=1.0, rounds=60,
                        participation="bernoulli")
        params = model.init(torch.Generator().manual_seed(0))
        eng = FederatedEngine(cfg, loss_fn, FlatSpec.from_tree(params), batch_size=20,
                              device=dev)
        state = eng.init(params, torch.Generator(device=dev).manual_seed(1))
        for r in range(cfg.rounds):
            state, m = eng.run_round(state, data)
            if (r + 1) % 20 == 0:
                acc = evaluate(eng.spec.unravel(state.params), xt, yt)
                print(f"{algo:7s} round {r+1:3d}  loss={float(m.loss):.3f}  "
                      f"test_acc={acc:.3f}  active={int(m.n_active)}  "
                      f"downlink={float(m.bytes_down)/2**20:.2f} MiB")
        print()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
