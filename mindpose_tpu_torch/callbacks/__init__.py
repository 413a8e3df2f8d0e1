"""Training callbacks of the port."""
from .eval_callback import EvalCallback  # noqa: F401
