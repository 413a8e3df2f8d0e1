from .head import Head  # noqa: F401
from .hrnet_head import HRNetHead  # noqa: F401
