from .factory import create_evaluator, create_inferencer  # noqa: F401
from .predictor import BottomUpPredictor, TopDownPredictor  # noqa: F401
from .server import PoseService, build_http_server  # noqa: F401
