"""The JAX zoo's parameter pytree (as numpy) to a :class:`~.zoo.Baseline`
``state_dict``, and back.

A linear ``{"w": [in, out], "b": [out]}`` at JAX path ``a/0/b`` is
``a.0.b.weight`` (transposed) and ``a.0.b.bias``; every other leaf keeps its
path (``bns.0.scale``, ``att.0.a_src``, ``eps``, ``gamma``, ``w_nodes``). The
batch norms' running statistics, JAX's ``bn_state`` list of ``{"mean",
"var"}``, are the buffers ``bns.<i>.running_mean`` and ``running_var``.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from .zoo import BaselineSpec, skeleton


def _t(x) -> torch.Tensor:
    return torch.tensor(np.asarray(x, dtype=np.float32))


def baseline_params_from_jax(np_params: Mapping, spec: BaselineSpec,
                             bn_state: Optional[Sequence[Mapping]] = None
                             ) -> Dict[str, torch.Tensor]:
    """A full ``state_dict`` from JAX's params (and ``bn_state``; None:
    torch's initial running statistics, mean 0 and variance 1)."""
    spec.check_ported()
    sd: Dict[str, torch.Tensor] = {}

    def walk(prefix, node):
        if isinstance(node, Mapping) and set(node) == {"w", "b"}:
            sd[prefix + "weight"] = _t(node["w"]).T.contiguous()
            sd[prefix + "bias"] = _t(node["b"])
        elif isinstance(node, Mapping):
            for k, v in node.items():
                walk(f"{prefix}{k}.", v)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(f"{prefix}{i}.", v)
        else:
            sd[prefix[:-1]] = _t(node)

    walk("", np_params)
    for i, b in enumerate(np_params.get("bns", [])):
        st = bn_state[i] if bn_state is not None else None
        dim = np.asarray(b["scale"]).shape
        sd[f"bns.{i}.running_mean"] = _t(st["mean"]) if st else torch.zeros(dim)
        sd[f"bns.{i}.running_var"] = _t(st["var"]) if st else torch.ones(dim)
    return sd


def _lists(node):
    """Nested dicts whose keys are all indices become lists."""
    if not isinstance(node, dict):
        return node
    if node and all(k.isdigit() for k in node):
        return [_lists(node[str(i)]) for i in range(len(node))]
    return {k: _lists(v) for k, v in node.items()}


def baseline_params_to_jax(tensors: Mapping[str, torch.Tensor], spec: BaselineSpec) -> Dict:
    """Inverse of :func:`baseline_params_from_jax` for the parameters: a
    ``state_dict``, or any mapping with its parameter names (gradients, Adam
    moments), to JAX's pytree with numpy leaves."""
    spec.check_ported()
    skel = skeleton(spec)
    linears = {n for n, m in skel.named_modules() if isinstance(m, nn.Linear)}
    tree: dict = {}
    for name, _ in skel.named_parameters():
        x = tensors[name].detach().cpu().numpy()
        prefix, _, leaf = name.rpartition(".")
        if prefix in linears:
            path = prefix.split(".") + ["w" if leaf == "weight" else "b"]
            x = x.T if leaf == "weight" else x
        else:
            path = name.split(".")
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(x)
    return _lists(tree)


def bn_state_to_jax(tensors: Mapping[str, torch.Tensor]) -> List[Dict]:
    """The running statistics of a ``state_dict`` as JAX's ``bn_state``."""
    n = sum(k.endswith(".running_mean") for k in tensors)
    return [{"mean": tensors[f"bns.{i}.running_mean"].detach().cpu().numpy(),
             "var": tensors[f"bns.{i}.running_var"].detach().cpu().numpy()} for i in range(n)]
