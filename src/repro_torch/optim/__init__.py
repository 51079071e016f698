from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer,
    adam,
    adamw,
    clip_by_global_norm,
    exponential_decay,
    momentum,
    sgd,
    warmup_cosine,
)
