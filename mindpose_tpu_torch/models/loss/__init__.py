from .loss import Loss  # noqa: F401
from .mse import JointsMSELoss, JointsMSELossWithMask  # noqa: F401
