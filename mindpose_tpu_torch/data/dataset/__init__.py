from .coco_topdown import COCOTopDownDataset  # noqa: F401
from .topdown import TopDownDataset  # noqa: F401
