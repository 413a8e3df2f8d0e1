from .ae import AELoss  # noqa: F401
from .distill import JointsMSEDistillLoss  # noqa: F401
from .loss import Loss  # noqa: F401
from .mse import JointsMSELoss, JointsMSELossWithMask  # noqa: F401
from .multi_loss import AEMultiLoss  # noqa: F401
from .rle import RLELoss  # noqa: F401
from .simcc import KLDiscretLoss  # noqa: F401
