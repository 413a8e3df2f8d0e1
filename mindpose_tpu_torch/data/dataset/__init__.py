from .bottomup import BottomUpDataset  # noqa: F401
from .coco_bottomup import COCOBottomUpDataset  # noqa: F401
from .coco_topdown import COCOTopDownDataset  # noqa: F401
from .imagefolder_bottomup import ImageFolderBottomUpDataset  # noqa: F401
from .topdown import TopDownDataset  # noqa: F401
