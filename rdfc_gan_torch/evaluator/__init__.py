from .evaluator import Eval
from .v1_evaluator import EvalV1

__all__ = ["Eval", "EvalV1"]
