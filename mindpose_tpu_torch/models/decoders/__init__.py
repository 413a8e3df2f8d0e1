from .bottom_up_decoder import BottomUpHeatMapAEDecoder  # noqa: F401
from .decoder import Decoder  # noqa: F401
from .regression_decoder import RegressionDecoder  # noqa: F401
from .simcc_decoder import SimCCDecoder  # noqa: F401
from .top_down_decoder import TopDownHeatMapDecoder  # noqa: F401
