"""JAX parameter pytree (as numpy) to the port's ``state_dict``, and back.

Counterpart of ``pathnet_tpu/models/torch_compat.py``. The JAX package keeps
weights as ``[in, out]`` (for ``x @ w``) and the distance layers stacked;
the port keeps torch's ``[out, in]`` under the reference's names:

| JAX pytree | port ``state_dict`` |
|---|---|
| ``fc0.w`` / ``fc0.b`` | ``fc0.weight`` (T) / ``fc0.bias`` |
| ``dist.w[k]`` / ``dist.b[k]`` | ``nets.k.weight`` (T) / ``nets.k.bias`` |
| ``rnn.w_ih`` / ``w_hh`` / ``b_ih`` / ``b_hh`` | ``LSTM.weight_ih_l0`` (T) / ``weight_hh_l0`` (T) / ``bias_ih_l0`` / ``bias_hh_l0``; ``GRU.*`` under ``rnn="gru"`` |
| ``rnn.w`` / ``rnn.b`` (``rnn="mlp"``) | ``MLP.weight`` (T) / ``MLP.bias`` |
| ``attw.w`` / ``attw.b`` | ``attw.weight`` (T) / ``attw.bias`` |
| ``fc2.w`` / ``fc2.b`` | ``fc2.weight`` (T) / ``fc2.bias`` |

The MLP's names are the port's own: the reference has no MLP encoder, and
``pathnet_tpu/models/torch_compat.py:64`` refuses ``rnn="mlp"``, so its
parameters cross to JAX through the pytree alone.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .pagg import PaggSpec


def _rnn_name(spec: PaggSpec) -> str:
    """The recurrent module's name in the ``state_dict``, as the reference's
    and ``pathnet_tpu/models/torch_compat.py:41-61`` have it."""
    return "GRU" if spec.rnn == "gru" else "LSTM"


def params_from_jax(np_params: Mapping, spec: PaggSpec) -> Dict[str, torch.Tensor]:
    """``np_params``: the JAX pytree with every leaf as a numpy array."""
    spec.check_ported()

    def t(x, transpose=False):
        a = np.asarray(x, dtype=np.float32)
        return torch.tensor(a.T if transpose else a)

    p = np_params
    rnn = _rnn_name(spec)
    sd = {
        "fc0.weight": t(p["fc0"]["w"], True), "fc0.bias": t(p["fc0"]["b"]),
        "attw.weight": t(p["attw"]["w"], True), "attw.bias": t(p["attw"]["b"]),
        "fc2.weight": t(p["fc2"]["w"], True), "fc2.bias": t(p["fc2"]["b"]),
    }
    if spec.rnn == "mlp":
        sd.update({"MLP.weight": t(p["rnn"]["w"], True), "MLP.bias": t(p["rnn"]["b"])})
    else:
        sd.update({f"{rnn}.weight_ih_l0": t(p["rnn"]["w_ih"], True),
                   f"{rnn}.weight_hh_l0": t(p["rnn"]["w_hh"], True),
                   f"{rnn}.bias_ih_l0": t(p["rnn"]["b_ih"]),
                   f"{rnn}.bias_hh_l0": t(p["rnn"]["b_hh"])})
    for k in range(spec.walk_len):
        sd[f"nets.{k}.weight"] = t(np.asarray(p["dist"]["w"])[k], True)
        sd[f"nets.{k}.bias"] = t(np.asarray(p["dist"]["b"])[k])
    return sd


def params_to_jax(tensors: Mapping[str, torch.Tensor], spec: PaggSpec) -> Dict:
    """Inverse of :func:`params_from_jax`: a ``state_dict``, or any mapping
    with its keys (gradients, Adam moments), to the JAX pytree layout with
    numpy leaves."""
    spec.check_ported()

    def a(key, transpose=False):
        x = tensors[key].detach().cpu().numpy()
        return np.ascontiguousarray(x.T if transpose else x)

    wl = spec.walk_len
    rnn = _rnn_name(spec)
    if spec.rnn == "mlp":
        cell = {"w": a("MLP.weight", True), "b": a("MLP.bias")}
    else:
        cell = {"w_ih": a(f"{rnn}.weight_ih_l0", True), "w_hh": a(f"{rnn}.weight_hh_l0", True),
                "b_ih": a(f"{rnn}.bias_ih_l0"), "b_hh": a(f"{rnn}.bias_hh_l0")}
    return {
        "fc0": {"w": a("fc0.weight", True), "b": a("fc0.bias")},
        "dist": {"w": np.stack([a(f"nets.{k}.weight", True) for k in range(wl)]),
                 "b": np.stack([a(f"nets.{k}.bias") for k in range(wl)])},
        "rnn": cell,
        "attw": {"w": a("attw.weight", True), "b": a("attw.bias")},
        "fc2": {"w": a("fc2.weight", True), "b": a("fc2.bias")},
    }
