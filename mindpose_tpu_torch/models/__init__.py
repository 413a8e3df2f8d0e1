from . import backbones, decoders, heads, loss  # noqa: F401  (registers the components)
from .model_factory import (  # noqa: F401
    create_backbone,
    create_decoder,
    create_eval_network,
    create_head,
    create_loss,
    create_network,
    create_network_with_loss,
)
from .networks import EvalNet, Net, NetWithLoss  # noqa: F401
