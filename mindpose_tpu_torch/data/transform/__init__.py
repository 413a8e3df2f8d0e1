from .bottomup_transform import (  # noqa: F401
    BottomUpGenerateTagInd,
    BottomUpGenerateTarget,
    BottomUpHorizontalRandomFlip,
    BottomUpPad,
    BottomUpRandomAffine,
    BottomUpRescale,
)
from .topdown_transform import (  # noqa: F401
    TopDownAffine,
    TopDownBoxToCenterScale,
    box_to_center_scale,
    crop_matrix,
)
