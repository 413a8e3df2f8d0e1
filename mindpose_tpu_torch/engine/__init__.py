from .predictor import TopDownPredictor  # noqa: F401
from .server import PoseService, build_http_server  # noqa: F401
