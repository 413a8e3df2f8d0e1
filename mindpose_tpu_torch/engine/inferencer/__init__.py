from .bottomup_inferencer import BottomUpHeatMapAEInferencer  # noqa: F401
from .inferencer import Inferencer  # noqa: F401
from .regression_inferencer import RegressionInferencer  # noqa: F401
from .simcc_inferencer import SimCCInferencer  # noqa: F401
from .topdown_inferencer import TopDownHeatMapInferencer  # noqa: F401
