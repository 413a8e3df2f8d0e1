from .head import Head  # noqa: F401
from .hrnet_head import HRNetHead  # noqa: F401
from .simple_baseline_head import SimpleBaselineHead  # noqa: F401
