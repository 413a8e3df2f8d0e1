from .optim_factory import create_optimizer, decay_mask  # noqa: F401
