from .bottomup_evaluator import BottomUpEvaluator  # noqa: F401
from .evaluator import Evaluator  # noqa: F401
from .keypoint_evaluator import TopDownKeypointEvaluator  # noqa: F401
from .topdown_evaluator import TopDownEvaluator  # noqa: F401
