"""Engine factory: merge eval + dataset configs, dispatch via the registry.

Counterpart of ``mindpose_tpu/engine/factory.py``: the same signatures and
the same merge, which warns on keys the two configs share.
"""
import logging
from typing import Any, Dict, List, Optional, Union

from ..models.networks import EvalNet
from ..register import entrypoint
from .evaluator.evaluator import Evaluator
from .inferencer.inferencer import Inferencer

__all__ = ["create_inferencer", "create_evaluator"]


def _merged(*configs: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """Left-to-right merge (later wins) warning on colliding keys."""
    out: Dict[str, Any] = {}
    for cfg in configs:
        cfg = cfg or {}
        collisions = out.keys() & cfg.keys()
        if collisions:
            logging.warning(
                "Duplicated keys found in two configs: `%s`", set(collisions)
            )
        out.update(cfg)
    return out


def create_inferencer(
    net: EvalNet,
    name: str = "topdown_heatmap",
    config: Optional[Dict[str, Any]] = None,
    dataset_config: Optional[Dict[str, Any]] = None,
    **kwargs: Any,
) -> Inferencer:
    """Create an inference engine over the whole dataset."""
    return entrypoint("inferencer", name)(
        net=net, config=_merged(config, dataset_config), **kwargs
    )


def create_evaluator(
    annotation_file: str,
    name: str = "topdown",
    metric: Union[str, List[str]] = "AP",
    config: Optional[Dict[str, Any]] = None,
    dataset_config: Optional[Dict[str, Any]] = None,
    **kwargs: Any,
) -> Evaluator:
    """Create an evaluation engine producing metric results."""
    return entrypoint("evaluator", name)(
        annotation_file=annotation_file,
        metric=metric,
        config=_merged(config, dataset_config),
        **kwargs,
    )
