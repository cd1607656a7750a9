"""The LSTM recurrence written out, with torch gate order (i, f, g, o).

Port of ``pathnet_tpu/nn/cells.py:22-46``. The input projection of every step
is hoisted into one ``[L*B, in] @ [in, 4H]`` product; the loop carries only the
recurrent product. This is K3's plain version of the recurrence; cuDNN's
LSTM is not used.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch


def lstm_scan(params: Dict[str, torch.Tensor], xs: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run an LSTM over ``xs [L, B, in]`` from a zero state.

    ``params``: ``w_ih [in, 4H]``, ``w_hh [H, 4H]``, ``b_ih [4H]``,
    ``b_hh [4H]``. Returns ``(outputs [L, B, H], h_n [B, H])``.
    """
    L, B, F = xs.shape
    H = params["w_hh"].shape[0]
    gx = (xs.reshape(L * B, F) @ params["w_ih"] + params["b_ih"]).reshape(L, B, 4 * H)
    h = xs.new_zeros((B, H))
    c = xs.new_zeros((B, H))
    ys = []
    for t in range(L):
        gates = gx[t] + h @ params["w_hh"] + params["b_hh"]
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        ys.append(h)
    return torch.stack(ys), h
