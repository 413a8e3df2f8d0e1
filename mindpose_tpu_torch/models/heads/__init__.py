from .head import Head  # noqa: F401
from .higher_hrnet_head import HigherHRNetHead  # noqa: F401
from .hrnet_head import HRNetHead  # noqa: F401
from .rle_head import RLERegressionHead  # noqa: F401
from .simcc_head import SimCCHead  # noqa: F401
from .simple_baseline_head import SimpleBaselineHead  # noqa: F401
