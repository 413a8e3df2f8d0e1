from . import backbones, decoders, heads  # noqa: F401  (registers the components)
from .model_factory import (  # noqa: F401
    create_backbone,
    create_decoder,
    create_eval_network,
    create_head,
    create_network,
)
from .networks import EvalNet, Net  # noqa: F401
