from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer, adam, adamw, apply_updates, chain, clip_by_global_norm,
    cosine_schedule, momentum, scale_by_schedule, sgd, warmup_cosine,
)
