from .inference import evaluate, make_sharded_predict, predict
from .trainer import RoundResult, make_optimizer, run_protocol, run_round

__all__ = ["predict", "make_sharded_predict", "evaluate", "RoundResult", "make_optimizer",
           "run_round", "run_protocol"]
