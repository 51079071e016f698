"""Functional optimizers (counterpart of ``repro.optim.optimizers``), over
the port's param trees (nested dicts / lists / tuples of tensors).

An ``Optimizer`` is a pair of functions that leave their inputs alone:

    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    new_params = tree_map(lambda p, u: p + u, params, updates)   # updates hold −lr

The names, defaults and arithmetic are the reference's, in f32 on the
params' device: the step is a 0-d int32 tensor, the bias corrections
``1 − b ** step`` and the schedules are f32 tensor expressions, and a
Python constant meets a tensor as JAX's weakly typed scalar does (cast to
the tensor's dtype).  Moments in a narrower ``moment_dtype`` are widened to
f32 for the update, as the reference's promotion widens them.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.utils.trees import tree_leaves, tree_map

F32 = torch.float32


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., Any]  # (grads, state, params) -> (updates, state)


def _device(tree):
    leaves = tree_leaves(tree)
    return leaves[0].device if leaves else torch.device("cpu")


def _step0(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=_device(params))


def sgd(lr) -> Optimizer:
    """``lr`` a float or a schedule ``step -> lr``; the state is the step."""
    sched = _as_schedule(lr)

    def init(params):
        return _step0(params)

    def update(grads, state, params=None):
        step_lr = sched(state)
        return tree_map(lambda g: -step_lr * g, grads), state + 1

    return Optimizer(init, update)


def momentum(lr, beta: float = 0.9, nesterov: bool = False) -> Optimizer:
    sched = _as_schedule(lr)

    def init(params):
        return (_step0(params), tree_map(torch.zeros_like, params))

    def update(grads, state, params=None):
        step, mu = state
        mu = tree_map(lambda m, g: beta * m + g, mu, grads)
        eff = tree_map(lambda m, g: beta * m + g, mu, grads) if nesterov else mu
        step_lr = sched(step)
        return tree_map(lambda e: -step_lr * e, eff), (step + 1, mu)

    return Optimizer(init, update)


def adam(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, eps_root: float = 0.0,
         bias_correction: bool = True, moment_dtype=torch.float32) -> Optimizer:
    """``moment_dtype``: f32 by default; bf16 halves the moments' memory, and
    the update still runs in f32."""
    sched = _as_schedule(lr)
    mdt = moment_dtype

    def init(params):
        z = tree_map(lambda p: torch.zeros_like(p, dtype=mdt), params)
        return (_step0(params), z, tree_map(torch.clone, z))

    # Each expression below is the reference's, operation for operation; the
    # in-place ops act only on the fresh tensor the first operation made, so
    # a leaf allocates 2 temporaries a line instead of 3–7 (a new CPU tensor
    # is first-touched page by page, which at GBs a leaf costs as much as the
    # arithmetic).  Inputs are never written.
    def new_m(mi, g):  # b1·m + (1 − b1)·g
        return (mi.to(F32) * b1).add_(g.to(F32) * (1 - b1)).to(mdt)

    def new_v(vi, g):  # b2·v + (1 − b2)·g²
        return (vi.to(F32) * b2).add_(torch.square(g.to(F32)).mul_(1 - b2)).to(mdt)

    def update(grads, state, params=None):
        step, m, v = state
        m = tree_map(new_m, m, grads)
        v = tree_map(new_v, v, grads)
        step1 = step + 1
        if bias_correction:
            c1 = 1.0 - b1 ** step1.to(F32)
            c2 = 1.0 - b2 ** step1.to(F32)
        else:
            c1 = c2 = torch.ones((), dtype=F32, device=step.device)
        step_lr = sched(step)

        def upd(mi, vi):  # −lr·m̂ / (√(v̂ + eps_root) + eps)
            den = (vi.to(F32) / c2).add_(eps_root).sqrt_().add_(eps)
            return (mi.to(F32) / c1).mul_(-step_lr).div_(den)

        return tree_map(upd, m, v), (step1, m, v)

    return Optimizer(init, update)


def adamw(lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8, weight_decay: float = 0.1,
          mask: Optional[Callable[[Any], Any]] = None, moment_dtype=torch.float32) -> Optimizer:
    """AdamW with decoupled weight decay.  ``mask(params)`` → a tree of bools
    choosing the decayed leaves (default: every leaf with ndim ≥ 2)."""
    base = adam(lr, b1=b1, b2=b2, eps=eps, moment_dtype=moment_dtype)
    sched = _as_schedule(lr)
    mask_fn = mask or (lambda params: tree_map(lambda p: p.ndim >= 2, params))

    def update(grads, state, params):
        decay_lr = sched(state[0]) * weight_decay
        updates, state = base.update(grads, state, params)

        def decay(u, p, m):  # u − lr·wd·p·mask, into the fresh update
            return u.sub_((p.to(u.dtype) * decay_lr).mul_(float(m)))

        return tree_map(decay, updates, params, mask_fn(params)), state

    return Optimizer(base.init, update)


def tree_norm(tree) -> torch.Tensor:
    """Global L2 norm over every leaf, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(g.to(F32))) for g in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float, norm: Optional[torch.Tensor] = None):
    """Returns ``(clipped grads, pre-clip norm)``; ``norm`` is the global
    norm when the caller has it (over a model group, the group's:
    ``sharding.rules.group_sq_norm``), else ``tree_norm(grads)``."""
    gnorm = tree_norm(grads) if norm is None else norm
    scale = torch.clamp(max_norm / (gnorm + 1e-12), max=1.0)
    return tree_map(lambda g: g * scale, grads), gnorm


def _f32(step) -> torch.Tensor:
    return step.to(F32) if isinstance(step, torch.Tensor) else torch.tensor(step, dtype=F32)


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int, floor: float = 0.1):
    """Linear warmup, then cosine decay to ``floor · peak_lr``."""

    def sched(step):
        step = _f32(step)
        warm = peak_lr * torch.clamp((step + 1) / max(1, warmup_steps), max=1.0)
        t = torch.clamp((step - warmup_steps) / max(1, total_steps - warmup_steps), 0.0, 1.0)
        cos = floor * peak_lr + (1 - floor) * peak_lr * 0.5 * (1 + torch.cos(math.pi * t))
        return torch.where(step < warmup_steps, warm, cos)

    return sched


def exponential_decay(base_lr: float, decay: float):
    """η decayed exponentially per step (the paper's appendix C.2)."""

    def sched(step):
        return base_lr * decay ** _f32(step)

    return sched


def _as_schedule(lr):
    if callable(lr):
        return lr
    return lambda step: torch.full((), lr, dtype=F32, device=getattr(step, "device", None))
