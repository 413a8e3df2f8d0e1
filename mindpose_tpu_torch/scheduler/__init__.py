from .schedulers import create_lr_scheduler, warmup_cosine_decay, warmup_multi_step_decay  # noqa: F401
