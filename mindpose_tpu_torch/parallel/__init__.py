from .fsdp import full_state, is_sharded, shard_net  # noqa: F401
from .mesh import (  # noqa: F401
    create_mesh,
    gather_records,
    init_distributed,
    is_distributed,
    is_main_process,
    local_device_count,
)
from .train import accum_loss_and_grads, build_ema_update, build_train_step  # noqa: F401
