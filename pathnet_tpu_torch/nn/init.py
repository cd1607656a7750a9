"""Torch-default initial distributions drawn from an explicit generator.

Port of ``pathnet_tpu/nn/init.py:26-68``: ``nn.Linear`` draws weight and bias
from U(-1/sqrt(fan_in), 1/sqrt(fan_in)) (the MLP encoder's ``[H, H]`` linear
too, drawn where the recurrent module is, as ``pathnet_tpu/models/pagg.py:
136-137`` draws it from the LSTM's key); ``nn.LSTM`` and ``nn.GRU`` draw every
tensor from U(-1/sqrt(hidden), 1/sqrt(hidden)); the homo PathNet redraws its ``fc0`` and
``fc2`` weights from xavier's U(-sqrt(6 / (fan_in + fan_out)), ...). Draws come from a CPU generator and are
copied to the parameter's device, so one seed gives the same weights on the
host and on the card.
"""
from __future__ import annotations

import math

import torch
from torch import nn


@torch.no_grad()
def uniform_(t: torch.Tensor, bound: float, generator: torch.Generator) -> torch.Tensor:
    """Fill ``t`` in place with U(-bound, bound) from ``generator``."""
    draw = torch.empty(t.shape, dtype=t.dtype).uniform_(-bound, bound,
                                                          generator=generator)
    return t.copy_(draw)


def torch_linear_init_(layer: nn.Linear, generator: torch.Generator) -> None:
    bound = 1.0 / math.sqrt(layer.in_features)
    uniform_(layer.weight, bound, generator)
    if layer.bias is not None:
        uniform_(layer.bias, bound, generator)


@torch.no_grad()
def xavier_uniform_(t: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Fill a weight ``t [out, in]`` in place with xavier's uniform draw
    (gain 1) from ``generator``."""
    fan_out, fan_in = t.shape
    return uniform_(t, math.sqrt(6.0 / (fan_in + fan_out)), generator)


def torch_lstm_init_(lstm: nn.LSTM, generator: torch.Generator) -> None:
    bound = 1.0 / math.sqrt(lstm.hidden_size)
    for p in lstm.parameters():
        uniform_(p, bound, generator)


def torch_gru_init_(gru: nn.GRU, generator: torch.Generator) -> None:
    """``weight_ih``, ``weight_hh``, ``bias_ih``, ``bias_hh`` in that order,
    each from U(-1/sqrt(hidden), 1/sqrt(hidden))."""
    bound = 1.0 / math.sqrt(gru.hidden_size)
    for p in gru.parameters():
        uniform_(p, bound, generator)
