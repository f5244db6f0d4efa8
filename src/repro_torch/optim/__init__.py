from repro_torch.optim.adamw import (  # noqa: F401
    AdamWState,
    Optimizer,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    cosine_schedule,
    make_optimizer,
)
