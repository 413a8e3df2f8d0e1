from .export import export_eval_net, export_serving_fn, load_serving_fn  # noqa: F401
from .factory import create_evaluator, create_inferencer  # noqa: F401
from .predictor import BottomUpPredictor, TopDownPredictor  # noqa: F401
from .server import PoseService, build_http_server  # noqa: F401
