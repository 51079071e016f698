"""The small classifiers of the federated slice (paper §6.1 scaled).

Counterpart of ``repro.models.small``: ``mlp_classifier`` over feature
vectors, ``cnn_classifier`` — the paper's model class, a CNN with GroupNorm
in place of BatchNorm (running statistics break under client averaging,
GroupNorm keeps none) — over NHWC images, and ``classification_loss``.
Params keep the JAX layouts (the MLP a list of ``{"w": (in, out), "b":
(out,)}`` dicts; the CNN's convolutions HWIO), so the flat plane matches
the reference's byte for byte.

Every function here also takes COHORT-BATCHED params, whose leaves carry a
leading client axis ``(C, in, out)`` / ``(C, out)``, with inputs
``(C, B, in)``: the MLP's layers then run as ``torch.baddbmm``, the CNN's convolutions as one
grouped convolution (``groups=C``) and its GroupNorm with ``C·gn_groups``
groups, each inside one client; the loss returns one mean cross-entropy
per client.  The engine unravels a
``(C, P)`` plane into such views, so one backward through
``loss.sum()`` yields the whole cohort's ``(C, P)`` gradient plane (each
client's loss depends only on its own row).  These products stay
PyTorch's: the reference leaves them to XLA, outside any Pallas kernel.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init
from repro_torch.utils.trees import tree_map


class SmallModel(NamedTuple):
    init: Callable[[torch.Generator], Any]
    apply: Callable[[Any, torch.Tensor], torch.Tensor]  # (params, x) -> logits


def _dense(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    # ``h @ w + b`` in the promoted dtype, as JAX promotes it: bf16 leaves
    # meet f32 activations in f32
    dt = torch.promote_types(torch.promote_types(h.dtype, w.dtype), b.dtype)
    h, w, b = h.to(dt), w.to(dt), b.to(dt)
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


def same_pad(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """``(before, after)`` padding of XLA's ``"SAME"`` along one axis: the
    output is ``ceil(size / stride)`` long and the total padding goes
    ``total // 2`` before, the rest after.  At an even size and stride 2
    the one pad element is after, so ``Conv2d(padding=1)`` would shift
    every window by one."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _group_norm(h: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, groups: int,
                eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm of ``h`` (B, channels, H, W) in f32 (biased variance),
    cast back to h's dtype."""
    return F.group_norm(h.float(), groups, scale.float(), bias.float(), eps).to(h.dtype)


def cnn_classifier(channels: Sequence[int] = (32, 64), n_classes: int = 10,
                   in_channels: int = 3, gn_groups: int = 8, hw: int = 8,
                   device=None) -> SmallModel:
    """Conv(3×3, stride 2, SAME) → GroupNorm → ReLU for each of ``channels``,
    then a dense layer over the NHWC flatten.

    Params: ``conv{i}`` = {"w": (3, 3, in, out) HWIO, "gn_scale": (out,),
    "gn_bias": (out,)} and ``fc`` = {"w": (h·w·c, n_classes), "b":
    (n_classes,)}.  ``apply`` takes unbatched params with x (B, H, W, in),
    or cohort-batched params (a leading C on every leaf) with x (C, B, H,
    W, in).  The FC's input size is the last convolution's output, ceil(hw
    / 2) per layer; the reference's init sizes it by ``hw // 2**layers``,
    the same at every hw its apply runs (a power of two's multiple)."""

    def init(generator: torch.Generator):
        params: Dict[str, Any] = {}
        c_in, side = in_channels, hw
        for i, c_out in enumerate(channels):
            params[f"conv{i}"] = {
                "w": dense_init(generator, (3, 3, c_in, c_out), in_axis_size=9 * c_in,
                                device=device),
                "gn_scale": torch.ones((c_out,), dtype=torch.float32, device=device),
                "gn_bias": torch.zeros((c_out,), dtype=torch.float32, device=device),
            }
            c_in, side = c_out, -(-side // 2)
        params["fc"] = {
            "w": dense_init(generator, (side * side * c_in, n_classes), device=device),
            "b": torch.zeros((n_classes,), dtype=torch.float32, device=device),
        }
        return params

    def apply(params, x):
        if params["fc"]["w"].dim() == 2:  # unbatched: a cohort of one
            return apply(tree_map(lambda a: a.unsqueeze(0), params), x.unsqueeze(0))[0]
        C, B = x.shape[:2]
        # (C, B, H, W, in) -> (B, C·in, H, W): client c's channels are group c
        h = x.permute(1, 0, 4, 2, 3).reshape(B, C * x.shape[-1], *x.shape[2:4])
        for i in range(len(channels)):
            p = params[f"conv{i}"]
            c_in, c_out = p["w"].shape[-2:]
            # HWIO (C, 3, 3, in, out) -> (C·out, in, 3, 3)
            w = p["w"].permute(0, 4, 3, 1, 2).reshape(C * c_out, c_in, 3, 3)
            ph, pw = same_pad(h.shape[-2], 3, 2), same_pad(h.shape[-1], 3, 2)
            h = F.conv2d(F.pad(h, (*pw, *ph)), w, stride=2, groups=C)
            h = _group_norm(h, p["gn_scale"].reshape(-1), p["gn_bias"].reshape(-1),
                            C * gn_groups)
            h = torch.relu(h)
        # (B, C·out, H', W') -> (C, B, H'·W'·out): the NHWC flatten
        Hh, Ww = h.shape[-2:]
        h = h.reshape(B, C, -1, Hh, Ww).permute(1, 0, 3, 4, 2).reshape(C, B, -1)
        return _dense(h, params["fc"]["w"], params["fc"]["b"])

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
