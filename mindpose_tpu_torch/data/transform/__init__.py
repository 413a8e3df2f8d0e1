from .bottomup_transform import BottomUpPad, BottomUpRescale  # noqa: F401
from .topdown_transform import (  # noqa: F401
    TopDownAffine,
    TopDownBoxToCenterScale,
    box_to_center_scale,
    crop_matrix,
)
