"""The MLP classifier of the federated slice (paper §6.1 scaled).

Counterpart of ``repro.models.small.mlp_classifier`` /
``classification_loss``.  Params are a list of ``{"w": (in, out), "b":
(out,)}`` dicts — the JAX layout, so the flat plane matches the reference's
byte for byte.

Every function here also takes COHORT-BATCHED params, whose leaves carry a
leading client axis ``(C, in, out)`` / ``(C, out)``, with inputs
``(C, B, in)``: the layers then run as ``torch.baddbmm`` and the loss
returns one mean cross-entropy per client.  The engine unravels a
``(C, P)`` plane into such views, so one backward through
``loss.sum()`` yields the whole cohort's ``(C, P)`` gradient plane (each
client's loss depends only on its own row).  These products stay
PyTorch's: the reference leaves them to XLA, outside any Pallas kernel.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Sequence

import torch

from repro_torch.models.layers import dense_init


class SmallModel(NamedTuple):
    init: Callable[[torch.Generator], Any]
    apply: Callable[[Any, torch.Tensor], torch.Tensor]  # (params, x) -> logits


def _dense(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if w.dim() == 3:  # cohort-batched: h (C, B, in), w (C, in, out), b (C, out)
        return torch.baddbmm(b.unsqueeze(1), h, w)
    return torch.addmm(b, h, w)


def mlp_classifier(dims: Sequence[int], device=None) -> SmallModel:
    """dims = (in, hidden..., n_classes)."""

    def init(generator: torch.Generator):
        return [
            {
                "w": dense_init(generator, (dims[i], dims[i + 1]), device=device),
                "b": torch.zeros((dims[i + 1],), dtype=torch.float32, device=device),
            }
            for i in range(len(dims) - 1)
        ]

    def apply(params, x):
        h = x
        for i, layer in enumerate(params):
            h = _dense(h, layer["w"], layer["b"])
            if i < len(params) - 1:
                h = torch.relu(h)
        return h

    return SmallModel(init, apply)


def classification_loss(apply_fn) -> Callable[[Any, Dict[str, torch.Tensor]], torch.Tensor]:
    """Mean softmax cross-entropy; batch = {"x": (..., B, in), "y": (..., B)}.
    Returns the mean over B: a scalar, or ``(C,)`` for cohort-batched input."""

    def loss(params, batch):
        logits = apply_fn(params, batch["x"]).float()
        logz = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, batch["y"].long().unsqueeze(-1)).squeeze(-1)
        return (logz - ll).mean(dim=-1)

    return loss
