"""The PAGG model (port of ``pathnet_tpu/models/pagg.py:56-114,142-147,191-313``).

Forward of the hetero PathNet with an LSTM encoder and attention readout:
``h = X @ W0 + b0`` (one plain large product, as the JAX package also leaves
it), then kernel K3 (``kernels/pagg_encode.py``) for the encode and the path
attention, the ego rows ``h[ego_idx]`` through kernel K5
(``kernels/row_gather.py``), then ``[h[target], h_agg] @ fc2``.

Training (``train=True``) runs the same forward with both of JAX's dropouts,
taken as explicit keep masks: the first on the LSTM input (``pagg.py:274``,
inside K3), the second on ``[h[target], h_agg]`` before ``fc2`` (``:312``).
Gradients flow through two autograd functions: ``PaggEncode``
(forward K3, backward K4, ``kernels/pagg_encode_bwd.py``) and ``RowGather``
(forward and backward K5). K4 sums the row gradients into ``dh [n, H]``
(its segment sum, in an order fixed by the paths) and autograd takes ``dW0 = X^T dh`` through ``h = X @ W0 + b0``: JAX's "h"
gather mode. Its "x" mode computes the same gradient, so
``PaggSpec.gather_mode`` does not change the port's math; nor do
``dist_mode`` (one formulation of the distance select) and ``remat`` (K4
recomputes the forward).

Parameters keep the reference's ``state_dict`` names (``fc0``, ``nets.k``,
``LSTM.*_l0``, ``attw``, ``fc2``), so ``data/reference_checkpoints/cornell.pth``
loads with ``strict=True``. The ``nn.LSTM`` only holds the weights: its cuDNN
forward is never called.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..kernels.pagg_encode import pagg_encode_fwd
from ..kernels.pagg_encode_bwd import pagg_encode_bwd
from ..kernels.row_gather import row_gather, row_gather_bwd
from ..nn.init import torch_linear_init_, torch_lstm_init_

Masks = Tuple[torch.Tensor, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class PaggSpec:
    """Static model hyperparameters, named as in the JAX package."""

    feat_dim: int
    hidden: int
    out_dim: int
    walk_len: int
    variant: str = "hetero"
    rnn: str = "lstm"
    agg: str = "attention"
    dropout: float = 0.7
    quirk_compat: bool = False
    # Accepted so JAX specs carry over; K4 always recomputes the forward.
    remat: bool = False
    compute_dtype: str = "float32"
    # Which table JAX's per-walk gather reads ("h", "x" or "auto"). Both give
    # the same gradient; the port always gathers h and scatters into dh.
    gather_mode: str = "auto"
    # JAX's two formulations of the distance select ("onehot", "mask"): the
    # same math, summed in different orders; the port has one.
    dist_mode: str = "onehot"

    def check_ported(self) -> None:
        """Raise ``NotImplementedError`` for a choice the port does not run yet."""
        todo = {"variant": (self.variant, "hetero"), "rnn": (self.rnn, "lstm"),
                "agg": (self.agg, "attention"),
                "quirk_compat": (self.quirk_compat, False),
                "compute_dtype": (self.compute_dtype, "float32")}
        for name, (value, ported) in todo.items():
            if value != ported:
                raise NotImplementedError(
                    f"PaggSpec.{name}={value!r} is not ported yet; the port "
                    f"runs {name}={ported!r} (ROADMAP §1 item 3)")
        if self.gather_mode not in ("auto", "h", "x"):
            raise ValueError(f"gather_mode={self.gather_mode!r}")
        if self.dist_mode not in ("onehot", "mask"):
            raise ValueError(f"dist_mode={self.dist_mode!r}")
        if not 0.0 <= self.dropout < 1.0:
            raise ValueError(f"dropout={self.dropout} must lie in [0, 1)")


class PaggEncode(torch.autograd.Function):
    """K3 forward, K4 backward: ``h_agg [T, H]`` from ``h`` and the encode
    weights in K3's layout, with an optional dropout keep mask."""

    @staticmethod
    def forward(ctx, h, paths, dists, keep_mask, keep, wd, bd, w_ih, w_hh,
                b_ih, b_hh, attw, attb):
        ctx.keep = keep
        ctx.save_for_backward(h, paths, dists, keep_mask, wd, bd, w_ih, w_hh,
                              b_ih, b_hh, attw, attb)
        return pagg_encode_fwd(h, paths, dists, wd, bd, w_ih, w_hh, b_ih,
                               b_hh, attw, attb, keep_mask, keep)

    @staticmethod
    def backward(ctx, g):
        h, paths, dists, keep_mask, *weights = ctx.saved_tensors
        dh, *dweights = pagg_encode_bwd(g.contiguous(), h, paths, dists,
                                        *weights, keep_mask, ctx.keep)
        return (dh, None, None, None, None, *dweights)


class RowGather(torch.autograd.Function):
    """K5 forward and backward: ``tbl[idx]`` for int32 ``idx``."""

    @staticmethod
    def forward(ctx, tbl, idx):
        ctx.n = tbl.shape[0]
        ctx.save_for_backward(idx)
        return row_gather(tbl, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return row_gather_bwd(g.contiguous(), idx, ctx.n, check=False), None


def draw_dropout_masks(spec: PaggSpec, T: int, nw: int,
                       generator: torch.Generator,
                       device: Union[str, torch.device]) -> Optional[Masks]:
    """The training forward's two keep masks from ``generator``: uint8
    ``[wl, T * nw, H]`` (LSTM input) and ``[T, 2H]`` (before ``fc2``), each
    entry 1 with probability ``1 - dropout``. None when dropout is 0 (JAX
    skips both dropouts then)."""
    if spec.dropout <= 0.0:
        return None
    keep = 1.0 - spec.dropout
    H, wl = spec.hidden, spec.walk_len
    m1 = torch.rand((wl, T * nw, H), generator=generator, device=device) < keep
    m2 = torch.rand((T, 2 * H), generator=generator, device=device) < keep
    return m1.to(torch.uint8), m2.to(torch.uint8)


class PathNet(nn.Module):
    """Hetero PathNet. Weights are torch-default draws from ``generator`` (a
    CPU generator; seed 0 when omitted)."""

    def __init__(self, spec: PaggSpec,
                 device: Optional[Union[str, torch.device]] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        spec.check_ported()
        self.spec = spec
        dev = resolve_device(device)
        H, wl = spec.hidden, spec.walk_len
        with torch.device("meta"):   # no draws from the global generator
            self.fc0 = nn.Linear(spec.feat_dim, H)
            self.nets = nn.ModuleList(nn.Linear(H, H) for _ in range(wl))
            self.LSTM = nn.LSTM(H, H)
            self.attw = nn.Linear(2 * H, 1)
            self.fc2 = nn.Linear(2 * H, spec.out_dim)
        self.to_empty(device=dev)
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        for layer in (self.fc0, *self.nets, self.attw, self.fc2):
            torch_linear_init_(layer, g)
        torch_lstm_init_(self.LSTM, g)

    def _encode_inputs(self, X: torch.Tensor):
        h = F.linear(X, self.fc0.weight, self.fc0.bias)
        lstm = self.LSTM
        weights = tuple(w.contiguous() for w in (
            torch.stack([l.weight.t() for l in self.nets]),
            torch.stack([l.bias for l in self.nets]),
            lstm.weight_ih_l0.t(), lstm.weight_hh_l0.t(),
            lstm.bias_ih_l0, lstm.bias_hh_l0,
            self.attw.weight.reshape(-1), self.attw.bias))
        return h, weights

    @torch.no_grad()
    def encode_inputs(self, X: torch.Tensor):
        """``h = X @ W0 + b0`` and the weights in K3's layout, in K3's order
        after ``(h, paths, dists)``, detached from the parameters."""
        h, weights = self._encode_inputs(X)
        return h, tuple(w.detach() for w in weights)

    def forward(self, X: torch.Tensor, paths: torch.Tensor, dists: torch.Tensor,
                ego_idx: torch.Tensor, train: bool = False,
                masks: Optional[Masks] = None) -> torch.Tensor:
        """Logits ``[T, out_dim]`` of targets ``ego_idx [T]`` from their walks
        ``paths`` and hop distances ``dists`` (``int32 [T, nw, wl]``); ``X`` is
        the full feature matrix ``[n, F]``.

        ``train=False`` serves (no gradient, no dropout). ``train=True`` builds
        the autograd graph; ``masks`` (from :func:`draw_dropout_masks`) apply
        both dropouts, and None trains without dropout.
        """
        ego_idx = ego_idx.to(torch.int32).contiguous()
        if not train:
            with torch.no_grad():
                h, weights = self._encode_inputs(X)
                h_agg = pagg_encode_fwd(h, paths, dists, *weights)
                out = torch.cat([row_gather(h, ego_idx), h_agg], dim=-1)
                return F.linear(out, self.fc2.weight, self.fc2.bias)
        keep = 1.0 - self.spec.dropout
        m1, m2 = masks if masks is not None else (None, None)
        h, weights = self._encode_inputs(X)
        h_agg = PaggEncode.apply(h, paths, dists, m1, keep, *weights)
        out = torch.cat([RowGather.apply(h, ego_idx), h_agg], dim=-1)
        if m2 is not None:
            out = torch.where(m2.bool(), out / keep, 0.0)
        return F.linear(out, self.fc2.weight, self.fc2.bias)
