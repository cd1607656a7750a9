"""The PAGG model (port of ``pathnet_tpu/models/pagg.py:56-114,142-147,191-313``).

Forward of PathNet with an LSTM or GRU encoder (``PaggSpec.rnn``) and the
attention, mean or sum readout (``PaggSpec.agg``), in both of JAX's
variants (``PaggSpec.variant``): ``h = X @ W0 + b0`` (one plain large
product, as the JAX package also leaves it; the homo variant takes its
ReLU), then kernel K3 (``kernels/pagg_encode.py``) for the encode and the
readout, the ego rows ``h[ego_idx]`` through kernel K5
(``kernels/row_gather.py``), then ``[h[target], h_agg] @ fc2``. The homo
variant (``pagg.py:9-20``) also runs each walk in sampled order, takes a
ReLU after the distance select, scores each walk against its selected
step-0 row and reads out ``mean((1 + score) h_n)`` (all inside K3 and K4,
``homo=True``), and redraws the ``fc0`` and ``fc2`` weights from xavier's
uniform. The mean and sum readouts (either variant) read out ``mean(h_n)`` or
``sum(h_n)``: ``attw`` stays in the model and gets a zero gradient (which
Adam's additive L2 still decays, as in JAX). The GRU's weights reach K3 and
K4 packed into the LSTM's layout (:func:`~pathnet_tpu_torch.kernels.pagg_encode.pack_gru`,
autograd ops, so the packed gradients flow back unpacked). The MLP encoder
(``rnn="mlp"``, ``pagg.py:180-188``) is ``h_n = mean_t(s_t) @ W + b``, an
``nn.Linear`` named ``MLP`` that K3 and K4 take as ``(W, b)`` with empty
recurrent weights (:func:`~pathnet_tpu_torch.kernels.pagg_encode.cell_shapes`).
``quirk_compat=True`` (hetero; JAX's ``_hetero_quirk_forward``,
``pagg.py:316-338``) runs K3 and K4 under their "quirk" readout, in f32
whatever ``compute_dtype`` and ``agg`` say, as JAX's quirk path ignores them;
the homo variant ignores the flag, as JAX's does (``pagg.py:229``).

Training (``train=True``) runs the same forward with both of JAX's dropouts,
taken as explicit keep masks: the first on the LSTM input (``pagg.py:274``,
inside K3), the second on ``[h[target], h_agg]`` before ``fc2`` (``:312``).
Gradients flow through two autograd functions: ``PaggEncode``
(forward K3, backward K4, ``kernels/pagg_encode_bwd.py``) and ``RowGather``
(forward and backward K5). K4 sums the row gradients into ``dh [n, H]``
(its segment sum, in an order fixed by the paths) and autograd takes ``dW0 = X^T dh`` through ``h = X @ W0 + b0``: JAX's "h"
gather mode. In f32 its "x" mode computes the same values and gradient, so
``PaggSpec.gather_mode`` does not change the port's f32 math; nor do
``dist_mode`` (one formulation of the distance select) and ``remat`` (K4
recomputes the forward).

bf16 compute (``compute_dtype="bfloat16"``, JAX's ``pagg.py:233-279``): K3
and K4 read a bf16 table ``hb [n, H]`` and bf16 copies of ``wd, bd, w_ih,
w_hh, b_ih, b_hh``; the attention, ``fc2``, the ego rows through K5 (from
the f32 ``h``) and every reduction stay f32. Here the gather mode does
change the result, so the port follows JAX's choice
(:meth:`PaggSpec.resolved_gather_mode`): "x" (``F <= 128`` under "auto")
projects the bf16 rows, ``hb = round(round(X_bf16 @ W0_bf16) + b0_bf16)``
(homo: its ReLU), and "h" rounds the f32 projection, ``hb = round(h)``.
Each cast is an autograd op, so each cast parameter gets the gradient of
the bf16 path, as JAX's does through ``astype``.

With ``X`` row-sharded over ranks (``parallel/``), ``forward`` takes this
rank's block of ``X`` and a ``FeatureExchange`` (JAX's ``gather_fn``): ``h``
and K3's table are projected on the block, and the rows K3 and K5 read come
through the exchange (the whole table all-gathered, or the walks' and ego
rows gathered, which K3 then reads as a table of its own with the ids
``arange``).

Parameters keep the reference's ``state_dict`` names (``fc0``, ``nets.k``,
``LSTM.*_l0`` or ``GRU.*_l0``, ``attw``, ``fc2``; the MLP, which the
reference lacks, ``MLP.weight`` and ``MLP.bias``), so
``data/reference_checkpoints/cornell.pth`` loads with ``strict=True``. The
``nn.LSTM`` or ``nn.GRU`` only holds the weights: its cuDNN forward is never
called.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..kernels.pagg_encode import pack_gru, pagg_encode_fwd
from ..kernels.pagg_encode_bwd import pagg_encode_bwd
from ..kernels.row_gather import row_gather, row_gather_bwd
from ..nn.init import torch_gru_init_, torch_linear_init_, torch_lstm_init_, xavier_uniform_

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
    # "float32", or "bfloat16": K3 and K4 on a bf16 table and bf16 weights
    compute_dtype: str = "float32"
    # Which table JAX's per-walk gather reads ("h", "x" or "auto"). In f32
    # both give the same values and gradient; in bf16 they round differently
    # and the port builds its bf16 table as the resolved mode says.
    gather_mode: str = "auto"
    # JAX's two formulations of the distance select ("onehot", "mask"): the
    # same math, summed in different orders; the port has one.
    dist_mode: str = "onehot"

    def resolved_gather_mode(self) -> str:
        """JAX's ``PaggSpec.resolved_gather_mode`` (``pagg.py:106-114``):
        "auto" is "x" for feature rows of at most 128 entries, else "h"."""
        if self.gather_mode != "auto":
            return self.gather_mode
        return "x" if self.feat_dim <= 128 else "h"

    def check_ported(self) -> None:
        """Raise ``ValueError`` for a choice the JAX package does not know."""
        if self.variant not in ("hetero", "homo"):
            raise ValueError(f"variant={self.variant!r}")
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype={self.compute_dtype!r}")
        if self.rnn not in ("lstm", "gru", "mlp"):
            raise ValueError(f"rnn={self.rnn!r}")
        if self.agg not in ("attention", "mean", "sum"):
            raise ValueError(f"agg={self.agg!r}")
        if self.gather_mode not in ("auto", "h", "x"):
            raise ValueError(f"gather_mode={self.gather_mode!r}")
        if self.dist_mode not in ("onehot", "mask"):
            raise ValueError(f"dist_mode={self.dist_mode!r}")
        if not 0.0 <= self.dropout < 1.0:
            raise ValueError(f"dropout={self.dropout} must lie in [0, 1)")

    def quirk(self) -> bool:
        """Whether the quirk path runs: ``quirk_compat`` on the hetero variant
        (``pagg.py:229``)."""
        return self.quirk_compat and self.variant == "hetero"


class PaggEncode(torch.autograd.Function):
    """K3 forward, K4 backward: ``h_agg [T, H]`` from the table ``h`` and the
    encode weights in K3's layout (f32, or bf16 table and weights), with an
    optional dropout keep mask."""

    @staticmethod
    def forward(ctx, h, paths, dists, keep_mask, keep, homo, agg, cell, wd, bd, w_ih,
                w_hh, b_ih, b_hh, attw, attb):
        ctx.keep, ctx.homo, ctx.agg, ctx.cell = keep, homo, agg, cell
        ctx.save_for_backward(h, paths, dists, keep_mask, wd, bd, w_ih, w_hh,
                              b_ih, b_hh, attw, attb)
        return pagg_encode_fwd(h, paths, dists, wd, bd, w_ih, w_hh, b_ih,
                               b_hh, attw, attb, keep_mask, keep, homo, agg, cell)

    @staticmethod
    def backward(ctx, g):
        h, paths, dists, keep_mask, *weights = ctx.saved_tensors
        dh, *dweights = pagg_encode_bwd(g.contiguous(), h, paths, dists,
                                        *weights, keep_mask, ctx.keep, ctx.homo,
                                        ctx.agg, ctx.cell)
        return (dh, None, None, None, None, None, None, None, *dweights)


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
    """PathNet, hetero or homo (``spec.variant``), with an ``nn.LSTM`` named
    ``LSTM``, (``spec.rnn == "gru"``) an ``nn.GRU`` named ``GRU`` or (``"mlp"``)
    an ``nn.Linear(H, H)`` named ``MLP``, drawn in the recurrent module's place. Weights
    are torch-default draws from ``generator`` (a CPU generator; seed 0 when
    omitted); the homo variant then redraws the ``fc0`` and ``fc2`` weights
    from xavier's uniform, as the reference does
    (``pathnet_tpu/models/pagg.py:124-127``)."""

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
            if spec.rnn == "gru":
                self.GRU = nn.GRU(H, H)
            elif spec.rnn == "mlp":
                self.MLP = nn.Linear(H, H)
            else:
                self.LSTM = nn.LSTM(H, H)
            self.attw = nn.Linear(2 * H, 1)
            self.fc2 = nn.Linear(2 * H, spec.out_dim)
        self.to_empty(device=dev)
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        for layer in (self.fc0, *self.nets, self.attw, self.fc2):
            torch_linear_init_(layer, g)
        if spec.rnn == "gru":
            torch_gru_init_(self.GRU, g)
        elif spec.rnn == "mlp":
            torch_linear_init_(self.MLP, g)
        else:
            torch_lstm_init_(self.LSTM, g)
        self.homo = spec.variant == "homo"
        # the quirk path runs f32 under its own readout (pagg.py:229-231)
        self.agg = "quirk" if spec.quirk() else spec.agg
        self.bf16 = spec.compute_dtype == "bfloat16" and not spec.quirk()
        if self.homo:
            xavier_uniform_(self.fc0.weight, g)
            xavier_uniform_(self.fc2.weight, g)

    def _encode_inputs(self, X: torch.Tensor):
        """``(h, weights)``: ``h = X @ W0 + b0`` (homo: its ReLU) in f32,
        from which K5 gathers the ego rows, and the f32 weights in K3's
        layout (the GRU's packed; the MLP's ``(W, b)`` with empty recurrent
        weights)."""
        h = F.linear(X, self.fc0.weight, self.fc0.bias)
        if self.homo:
            h = torch.relu(h)
        if self.spec.rnn == "gru":
            rnn = self.GRU
            cell = pack_gru(rnn.weight_ih_l0.t(), rnn.weight_hh_l0.t(), rnn.bias_ih_l0,
                            rnn.bias_hh_l0)
        elif self.spec.rnn == "mlp":
            w = self.MLP.weight
            cell = (w.t(), w.new_zeros((w.shape[0], 0)), self.MLP.bias, w.new_zeros(0))
        else:
            rnn = self.LSTM
            cell = (rnn.weight_ih_l0.t(), rnn.weight_hh_l0.t(), rnn.bias_ih_l0,
                    rnn.bias_hh_l0)
        weights = tuple(w.contiguous() for w in (
            torch.stack([l.weight.t() for l in self.nets]),
            torch.stack([l.bias for l in self.nets]),
            *cell, self.attw.weight.reshape(-1), self.attw.bias))
        return h, weights

    def _k3_inputs(self, X: torch.Tensor, h: torch.Tensor, weights):
        """K3's table and weights: ``h`` and ``weights`` in f32; under bf16
        compute the bf16 table ``hb`` of the resolved gather mode and the
        first six weights cast to bf16."""
        if not self.bf16:
            return h, weights
        bf = torch.bfloat16
        if self.spec.resolved_gather_mode() == "x":
            # JAX's project() on bf16 rows: the product rounded, then the bias
            z = (X.to(bf).float() @ self.fc0.weight.to(bf).float().t()).to(bf)
            hb = z + self.fc0.bias.to(bf)
            if self.homo:
                hb = torch.relu(hb)
        else:
            hb = h.to(bf)
        return hb, tuple(w.to(bf) for w in weights[:6]) + weights[6:]

    @torch.no_grad()
    def encode_inputs(self, X: torch.Tensor):
        """K3's table and weights, in K3's order after ``(h, paths, dists)``,
        detached from the parameters: ``h = X @ W0 + b0`` (homo: its ReLU)
        and the f32 weights, or under bf16 compute the bf16 table and the
        six cast weights (``attw``, ``attb`` f32)."""
        table, weights = self._k3_inputs(X, *self._encode_inputs(X))
        return table, tuple(w.detach() for w in weights)

    def forward(self, X: torch.Tensor, paths: torch.Tensor, dists: torch.Tensor,
                ego_idx: torch.Tensor, train: bool = False,
                masks: Optional[Masks] = None, exchange=None) -> torch.Tensor:
        """Logits ``[T, out_dim]`` of targets ``ego_idx [T]`` from their walks
        ``paths`` and hop distances ``dists`` (``int32 [T, nw, wl]``); ``X`` is
        the full feature matrix ``[n, F]``.

        ``train=False`` serves (no gradient, no dropout). ``train=True`` builds
        the autograd graph; ``masks`` (from :func:`draw_dropout_masks`) apply
        both dropouts, and None trains without dropout.

        ``exchange`` (a :class:`~pathnet_tpu_torch.parallel.mesh.FeatureExchange`,
        JAX's ``gather_fn``) takes ``X`` as this rank's row block: the table
        and ``h`` are projected on the block and the rows K3 and K5 read come
        through the exchange.
        """
        ego_idx = ego_idx.to(torch.int32).contiguous()
        if not train:
            with torch.no_grad():
                h, table, weights, paths, ego_idx = self._tables(X, paths, ego_idx, exchange)
                h_agg = pagg_encode_fwd(table, paths, dists, *weights, homo=self.homo,
                                        agg=self.agg, cell=self.spec.rnn)
                out = torch.cat([row_gather(h, ego_idx), h_agg], dim=-1)
                return F.linear(out, self.fc2.weight, self.fc2.bias)
        keep = 1.0 - self.spec.dropout
        m1, m2 = masks if masks is not None else (None, None)
        h, table, weights, paths, ego_idx = self._tables(X, paths, ego_idx, exchange)
        h_agg = PaggEncode.apply(table, paths, dists, m1, keep, self.homo, self.agg,
                                 self.spec.rnn, *weights)
        out = torch.cat([RowGather.apply(h, ego_idx), h_agg], dim=-1)
        if m2 is not None:
            out = torch.where(m2.bool(), out / keep, 0.0)
        return F.linear(out, self.fc2.weight, self.fc2.bias)

    def _tables(self, X, paths, ego_idx, exchange):
        """``(h, table, weights, paths, ego_idx)`` for K5 and K3, through
        ``exchange`` when ``X`` is a row block."""
        h, weights = self._encode_inputs(X)
        table, weights = self._k3_inputs(X, h, weights)
        if exchange is not None:
            table, h, paths, ego_idx = exchange.tables(table, h, paths, ego_idx)
        return h, table, weights, paths, ego_idx
