from .mesh import (  # noqa: F401
    gather_records,
    init_distributed,
    is_distributed,
    is_main_process,
    local_device_count,
)
from .train import accum_loss_and_grads, build_ema_update, build_train_step  # noqa: F401
