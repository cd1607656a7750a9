from .inference import evaluate, predict
from .trainer import RoundResult, make_optimizer, run_protocol, run_round

__all__ = ["predict", "evaluate", "RoundResult", "make_optimizer", "run_round",
           "run_protocol"]
