from .decoder import Decoder  # noqa: F401
from .top_down_decoder import TopDownHeatMapDecoder  # noqa: F401
