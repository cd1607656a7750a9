from .cells import gru_scan, lstm_scan
from .init import (torch_gru_init_, torch_linear_init_, torch_lstm_init_, uniform_,
                   xavier_uniform_)
from .metrics import classification_metrics, confusion_matrix

__all__ = ["gru_scan", "lstm_scan", "torch_gru_init_", "torch_linear_init_",
           "torch_lstm_init_", "uniform_", "xavier_uniform_", "classification_metrics",
           "confusion_matrix"]
