"""Transform base: dict-state protocol. A copy of ``mindpose_tpu/data/transform/transform.py``.

The loader passes record dicts end to end, so a transform is
``state -> partial-state-update``.
"""
from typing import Any, Dict, Optional


class Transform:
    def __init__(
        self, is_train: bool = True, config: Optional[Dict[str, Any]] = None
    ) -> None:
        self.is_train = is_train
        self.config = config if config else dict()
        self._transform_cfg = self.load_transform_cfg()

    def load_transform_cfg(self) -> Dict[str, Any]:
        raise NotImplementedError("Child class must implement this method.")

    def transform(self, state: Dict[str, Any]) -> Dict[str, Any]:
        raise NotImplementedError("Child class must implement this method.")

    def __call__(self, state: Dict[str, Any]) -> Dict[str, Any]:
        state.update(self.transform(state))
        return state
