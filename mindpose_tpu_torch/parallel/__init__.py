from .train import accum_loss_and_grads, build_ema_update, build_train_step  # noqa: F401
