"""The baseline zoo (port of ``pathnet_tpu/models/baselines/zoo.py``).

The reference's comparison models: MLP, GCN, GAT, GraphSAGE (two forms),
GIN, SGC, FAGCN, H2GCN, MixHop, GPRGNN, APPNP, LINK, GCN-JK, GAT-JK, Cheb
and label propagation, plus ``sgcmem``. Each is one :class:`Baseline`
module whose parameters mirror JAX's pytree (``lins.0.weight`` for
``params["lins"][0]["w"]``, torch's ``[out, in]`` layout; ``bns.0.scale``;
``att.0.a_src``), drawn from an explicit generator with JAX's shapes and
bounds (torch-default ``U(+-1/sqrt(fan_in))`` linears, ``U(+-1/sqrt(hdim))``
attention vectors, GPRGNN's fixed ``gamma``). The message passing runs on
kernels S1-S4 through :mod:`.ops`; the linears, batch norms, activations and
concatenations are plain torch, as JAX leaves them to XLA outside any
kernel.

``compute_dtype="bfloat16"`` is JAX's bf16 forward (``zoo.py:270-287``): each
call casts ``X`` and every parameter to bf16 (the master parameters and the
running statistics stay f32, and the gradients come back f32), and every op
then follows JAX's promotion, op by op: the graphs' weights stay f32, so a
``spmm`` of bf16 rows gives f32 and what follows it computes in f32 on the
bf16-rounded weights; a bf16 product is rounded, then its bias add
(:func:`_linear`); a Python scalar beside a bf16 tensor is rounded to bf16
(:func:`~.ops.weak`); the logits come back f32. The port matches XLA's
arithmetic op by op, as JAX runs ``baseline_forward`` eagerly; under
``jit`` XLA may skip the rounding of a bf16 result that only feeds an f32
op (its excess precision), which the port does not follow.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Union

import numpy as np
import scipy.sparse as sp
import torch
import torch.nn.functional as F
from torch import nn

from ...data.graph import Graph
from ...device import resolve_device
from ...nn.init import torch_linear_init_, uniform_
from .ops import BatchNorm, EdgeGraph, gather_edges, segment_softmax, spmm, weak


@dataclasses.dataclass(frozen=True)
class BaselineSpec:
    name: str
    feat_dim: int
    hidden: int
    out_dim: int
    num_layers: int = 2
    heads: int = 8            # GAT
    dropout: float = 0.5
    k_hops: int = 2           # SGC / MixHop / GPR
    alpha: float = 0.1        # APPNP / GPR teleport
    eps: float = 0.3          # FAGCN residual
    n_nodes: int = 0          # LINK (adjacency-row regression)
    compute_dtype: str = "float32"

    def check_ported(self) -> None:
        """Raise ``ValueError`` for a name or choice the JAX package does not
        know."""
        if self.name not in BASELINES + EXTRA_MODELS:
            raise ValueError(f"unknown baseline {self.name}")
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype={self.compute_dtype!r}")
        if not 0.0 <= self.dropout < 1.0:
            raise ValueError(f"dropout={self.dropout} must lie in [0, 1)")


BASELINES = ("mlp", "gcn", "gat", "sage", "sage1", "gin", "sgc", "fagcn",
             "h2gcn", "mixhop", "gprgnn", "appnp", "link", "gcnjk", "gatjk",
             "cheb", "lp")
EXTRA_MODELS = ("sgcmem",)


def build_baseline_graphs(g: Graph, name: str,
                          device: Optional[Union[str, torch.device]] = None
                          ) -> Dict[str, EdgeGraph]:
    """Per-model adjacency variants (``zoo.py:76-113``), host-built once per
    graph, on ``device``."""
    def edge_graph(gg, norm, loops):
        return EdgeGraph.from_graph(gg, norm=norm, add_self_loops=loops, device=device)

    graphs: Dict[str, EdgeGraph] = {}
    if name in ("gcn", "sgc", "sgcmem", "mixhop", "gprgnn", "appnp", "gcnjk", "lp"):
        graphs["sym"] = edge_graph(g, "sym", True)
    if name == "link":
        graphs["raw"] = edge_graph(g, "none", False)
    if name in ("gat", "gin", "fagcn", "gatjk"):
        graphs["raw"] = edge_graph(g, "none", name in ("gat", "gatjk"))
    if name == "sage":
        graphs["mean"] = edge_graph(g, "rw", False)
    if name == "sage1":
        # my_SAGEConv removes then re-adds self-loops before the mean
        graphs["mean_sl"] = edge_graph(g, "rw", True)
    if name in ("fagcn", "cheb", "lp"):
        graphs["symnl"] = edge_graph(g, "sym", False)
    if name == "h2gcn":
        a = g.to_adjacency(binary=True)
        a = a.maximum(a.T)
        a.setdiag(0)
        a.eliminate_zeros()
        a2 = (a @ a).tocsr()
        a2.setdiag(0)
        a2.data = np.ones_like(a2.data)
        a2 = a2 - a2.multiply(a)          # strict 2-hop
        a2.eliminate_zeros()
        graphs["h1"] = edge_graph(Graph.from_scipy(a), "sym", False)
        graphs["h2"] = edge_graph(Graph.from_scipy(a2), "sym", False)
    return graphs


def _attention(nheads: int, hdim: int) -> nn.ParameterDict:
    return nn.ParameterDict({"a_src": nn.Parameter(torch.empty(nheads, hdim)),
                             "a_dst": nn.Parameter(torch.empty(nheads, hdim))})


def _build(m: nn.Module, spec: BaselineSpec) -> None:
    """Register ``spec``'s parameters on ``m`` with JAX's names and shapes
    (``zoo.py:124-235``), undrawn."""
    F_, H, C, L = spec.feat_dim, spec.hidden, spec.out_dim, spec.num_layers
    nm, hd = spec.name, spec.heads
    Lin, ML = nn.Linear, nn.ModuleList
    if nm in ("mlp", "gcn"):
        dims = [F_] + [H] * (L - 1) + [C]
        m.lins = ML(Lin(dims[i], dims[i + 1]) for i in range(L))
        m.bns = ML(BatchNorm(H) for _ in range(L - 1))
    elif nm == "gat":
        lins, att = [Lin(F_, H * hd)], [_attention(hd, H)]
        for i in range(1, L):
            nheads = 1 if i == L - 1 else hd
            hdim = C if i == L - 1 else H
            lins.append(Lin(H * hd, hdim * nheads))
            att.append(_attention(nheads, hdim))
        m.lins, m.att = ML(lins), ML(att)
        m.bns = ML(BatchNorm(H * hd) for _ in range(L - 1))
    elif nm in ("sage", "sage1"):
        dims = [F_] + [H] * (L - 1) + [C]
        m.lin_l = ML(Lin(dims[i], dims[i + 1]) for i in range(L))
        m.lin_r = ML(Lin(dims[i], dims[i + 1]) for i in range(L))
        m.bns = ML(BatchNorm(H) for _ in range(L - 1))
    elif nm == "gin":
        dims = [F_] + [H] * L
        m.mlps = ML(nn.ModuleDict({"l1": Lin(dims[i], H), "l2": Lin(H, H)}) for i in range(L))
        m.eps = nn.Parameter(torch.empty(L))
        m.out = Lin(H, C)
        m.bns = ML(BatchNorm(H) for _ in range(L))
    elif nm in ("sgc", "sgcmem"):
        m.lin = Lin(F_, C)
    elif nm == "fagcn":
        m.add_module("in", Lin(F_, H))
        m.att = ML(Lin(2 * H, 1) for _ in range(L))
        m.out = Lin(H, C)
    elif nm == "h2gcn":
        m.embed = Lin(F_, H)
        # after R rounds the concat is H * (2^{R+1} - 1) wide
        m.out = Lin(H * (2 ** (L + 1) - 1), C)
    elif nm == "mixhop":
        hops = spec.k_hops + 1
        dims_in = [F_] + [H * hops] * (L - 1)
        m.hop_lins = ML(ML(Lin(dims_in[i], H) for _ in range(hops)) for i in range(L))
        m.bns = ML(BatchNorm(H * hops) for _ in range(L))
        m.out = Lin(H * hops, C)
    elif nm == "link":
        m.w_nodes = nn.Parameter(torch.empty(spec.n_nodes, C))
        m.b = nn.Parameter(torch.empty(C))
    elif nm == "gcnjk":
        dims = [F_] + [H] * L
        m.lins = ML(Lin(dims[i], H) for i in range(L))
        m.bns = ML(BatchNorm(H) for _ in range(L))
        m.out = Lin(H * L, C)
    elif nm == "gatjk":
        m.lins = ML(Lin(F_ if i == 0 else H * hd, H * hd) for i in range(L))
        m.att = ML(_attention(hd, H) for _ in range(L))
        m.bns = ML(BatchNorm(H * hd) for _ in range(L - 1))
        m.out = Lin(H * hd, C)
    elif nm == "cheb":
        # ChebConv(K=2) x 2: out = W0 x + W1 (L~ x), L~ = -Â_sym for λmax = 2
        m.c1 = ML([Lin(F_, H), Lin(F_, H)])
        m.c2 = ML([Lin(H, C), Lin(H, C)])
    elif nm == "lp":
        m.dummy = nn.Parameter(torch.empty(1))   # parameterless label propagation
    else:   # gprgnn, appnp
        m.l1 = Lin(F_, H)
        m.l2 = Lin(H, C)
        if nm == "gprgnn":
            m.gamma = nn.Parameter(torch.empty(spec.k_hops * 5 + 1))


def skeleton(spec: BaselineSpec) -> nn.Module:
    """A module with ``spec``'s parameter names and shapes on the meta
    device (no storage, no draws)."""
    m = nn.Module()
    with torch.device("meta"):
        _build(m, spec)
    return m


MaskSource = Callable[[int, tuple, torch.device], torch.Tensor]


class _Dropout:
    """JAX's ``_drop`` (``zoo.py:242-246``) in call order: call ``i`` takes
    keep mask ``masks(i, shape, device)``; without masks, or outside
    training, nothing drops."""

    def __init__(self, rate: float, train: bool, masks: Optional[MaskSource]):
        self.keep = 1.0 - rate
        self.on = train and rate > 0 and masks is not None
        self.masks, self.i = masks, 0

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        i = self.i
        self.i += 1
        if not self.on:
            return x
        m = self.masks(i, tuple(x.shape), x.device)
        if tuple(m.shape) != tuple(x.shape):
            raise ValueError(f"dropout call {i}: mask {tuple(m.shape)}, input {tuple(x.shape)}")
        # JAX's x / keep: keep rounded to bf16 beside a bf16 x, the quotient
        # rounded once
        q = (x / self.keep if x.dtype == torch.float32
             else (x.float() / weak(self.keep, x)).to(x.dtype))
        return torch.where(m.to(x.device, torch.bool), q, 0.0)


class Baseline(nn.Module):
    """One model of the zoo (``spec.name``), its parameters drawn from
    ``generator`` (a CPU generator; seed 0 when omitted) and copied to
    ``device`` (None: the CUDA card)."""

    def __init__(self, spec: BaselineSpec,
                 device: Optional[Union[str, torch.device]] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        spec.check_ported()
        self.spec = spec
        dev = resolve_device(device)
        with torch.device("meta"):
            _build(self, spec)
        self.to_empty(device=dev)
        self._draw(generator if generator is not None else torch.Generator().manual_seed(0))

    @torch.no_grad()
    def _draw(self, g: torch.Generator) -> None:
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                torch_linear_init_(mod, g)
            elif isinstance(mod, nn.ParameterDict):     # attention vectors [heads, hdim]
                for p in mod.values():
                    uniform_(p, 1.0 / math.sqrt(p.shape[1]), g)
            elif isinstance(mod, BatchNorm):
                mod.scale.fill_(1.0)
                for t in (mod.bias, mod.running_mean):
                    t.zero_()
                mod.running_var.fill_(1.0)
        spec = self.spec
        if spec.name == "link":
            uniform_(self.w_nodes, 1.0 / math.sqrt(max(spec.n_nodes, 1)), g)
            self.b.zero_()
        for name in ("eps", "dummy"):
            if name in self._parameters:
                self._parameters[name].zero_()
        if spec.name == "gprgnn":
            a, K = spec.alpha, spec.k_hops * 5
            gamma = a * (1 - a) ** np.arange(K + 1)
            gamma[-1] = (1 - a) ** K
            self.gamma.copy_(torch.from_numpy(gamma.astype(np.float32)))

    def forward(self, X: torch.Tensor, graphs: Dict[str, EdgeGraph], train: bool = False,
                masks: Optional[MaskSource] = None) -> torch.Tensor:
        """Logits ``[n, out_dim]``, float32 (``zoo.py:270-507``).

        ``train`` applies the dropouts (keep masks from ``masks`` in JAX's
        ``_drop`` call order; without them, none), normalizes with the batch
        statistics and advances the batch norms' running statistics; eval
        mode normalizes with them. ``train=True`` without masks gives JAX's
        stateless ``baseline_forward``: batch statistics, no dropout (and
        under bf16 its batch norm in bf16, :class:`~.ops.BatchNorm`).
        """
        spec, nm = self.spec, self.spec.name
        bf16 = spec.compute_dtype == "bfloat16"
        cast = (lambda t: t.to(torch.bfloat16)) if bf16 else (lambda t: t)
        drop = _Dropout(spec.dropout, train, masks)
        stateless = train and masks is None

        def lin(m, x):
            return _linear(cast(m.weight), cast(m.bias), x)

        def bn(i, h):
            return self.bns[i](h, train, cast, stateless)

        h = cast(X)
        if nm in ("mlp", "gcn"):
            eg = graphs.get("sym")
            for i, m in enumerate(self.lins[:-1]):
                h = lin(m, h) if nm == "mlp" else spmm(eg, lin(m, h))
                h = drop(torch.relu(bn(i, h)))
            h = lin(self.lins[-1], h)
            out = h if nm == "mlp" else spmm(eg, h)

        elif nm in ("gat", "gatjk"):
            eg = graphs["raw"]
            L = len(self.lins)
            xs = []
            for i in range(L):
                att = self.att[i]
                nheads, hdim = att["a_src"].shape
                z = lin(self.lins[i], h).reshape(-1, nheads, hdim)
                # JAX's einsum: a dot product in f32, rounded once
                s_src = (z.float() * cast(att["a_src"]).float()).sum(-1).to(z.dtype)
                s_dst = (z.float() * cast(att["a_dst"]).float()).sum(-1).to(z.dtype)
                x = gather_edges(eg, s_src, "src") + gather_edges(eg, s_dst, "dst")
                # JAX's leaky_relu: where(x >= 0, x, slope * x)
                alpha = segment_softmax(eg, torch.where(x >= 0, x, x * weak(0.2, x)))
                if nm == "gat":
                    alpha = drop(alpha)
                h = spmm(eg, z, alpha).reshape(eg.n, nheads * hdim)
                if i < L - 1:
                    h = F.elu(bn(i, h))
                    xs.append(h)
                    h = drop(h)
                elif nm == "gat":
                    h = h.reshape(eg.n, nheads, hdim).mean(1)
                else:
                    xs.append(h)
            # max jumping knowledge (Mixhop models.py:422 jk_type='max');
            # amax splits a tie's gradient as JAX's max does
            out = h if nm == "gat" else lin(self.out, torch.amax(torch.stack(xs), dim=0))

        elif nm in ("sage", "sage1"):
            eg = graphs["mean" if nm == "sage" else "mean_sl"]
            L = len(self.lin_l)
            for i in range(L):
                agg = spmm(eg, h)                     # mean over neighbors(+self)
                h = lin(self.lin_l[i], agg) + lin(self.lin_r[i], h)
                if i < L - 1:
                    h = drop(torch.relu(bn(i, h)))
            out = h

        elif nm == "gin":
            eg = graphs["raw"]
            eps = cast(self.eps)
            for i, mlp in enumerate(self.mlps):
                agg = spmm(eg, h) + (1.0 + eps[i]) * h
                h = lin(mlp["l2"], torch.relu(lin(mlp["l1"], agg)))
                h = torch.relu(bn(i, h))
            out = lin(self.out, drop(h))

        elif nm == "sgc":
            for _ in range(spec.k_hops):
                h = spmm(graphs["sym"], h)
            out = lin(self.lin, h)

        elif nm == "sgcmem":
            # SGCMem: the linear first (F -> C), then the propagations
            h = lin(self.lin, h)
            for _ in range(spec.k_hops):
                h = spmm(graphs["sym"], h)
            out = h

        elif nm == "fagcn":
            egs = graphs["symnl"]
            h = drop(torch.relu(lin(getattr(self, "in"), drop(h))))
            h0 = h
            for att in self.att:
                cat = torch.cat([gather_edges(egs, h, "src"), gather_edges(egs, h, "dst")], -1)
                alpha = torch.tanh(lin(att, cat))[:, 0]
                h = h0 * weak(spec.eps, h0) + spmm(egs, h, alpha * egs.w)
            out = lin(self.out, h)

        elif nm == "h2gcn":
            h1, h2 = graphs["h1"], graphs["h2"]
            h = torch.relu(lin(self.embed, h))
            feats = [h]
            cur = h
            for _ in range(spec.num_layers):
                cur = torch.cat([spmm(h1, cur), spmm(h2, cur)], -1)
                feats.append(cur)
            out = lin(self.out, drop(torch.cat(feats, -1)))

        elif nm == "mixhop":
            eg = graphs["sym"]
            for i, hop_lins in enumerate(self.hop_lins):
                outs = []
                z = h
                for j, m in enumerate(hop_lins):
                    outs.append(lin(m, z))
                    if j < len(hop_lins) - 1:
                        z = spmm(eg, z)
                h = drop(torch.relu(bn(i, torch.cat(outs, -1))))
            out = lin(self.out, h)

        elif nm == "link":
            out = spmm(graphs["raw"], cast(self.w_nodes)) + cast(self.b)

        elif nm == "gcnjk":
            eg = graphs["sym"]
            outs = []
            for i, m in enumerate(self.lins):
                h = drop(torch.relu(bn(i, spmm(eg, lin(m, h)))))
                outs.append(h)
            out = lin(self.out, torch.cat(outs, -1))

        elif nm == "cheb":
            # ChebConv K=2, λmax=2: T0 = x, T1 = L~x = -Â_sym x
            eg = graphs["symnl"]
            h = lin(self.c1[0], h) + lin(self.c1[1], -spmm(eg, h))
            h = drop(torch.relu(h))
            out = lin(self.c2[0], h) + lin(self.c2[1], -spmm(eg, h))

        elif nm == "lp":
            # MultiLP: X is the one-hot train labels (zeros elsewhere); 50
            # α-iterations of k_hops propagations
            eg = graphs["symnl"]
            y0 = res = h
            for _ in range(50):
                for _ in range(spec.k_hops):
                    res = spmm(eg, res)
                res = spec.alpha * res + y0 * weak(1 - spec.alpha, y0)
            out = res + 0.0 * cast(self.dummy)[0]

        else:   # gprgnn, appnp
            eg = graphs["sym"]
            h = drop(torch.relu(lin(self.l1, drop(h))))
            h = lin(self.l2, h)
            if nm == "appnp":
                z = h
                for _ in range(10):
                    z = (1 - spec.alpha) * spmm(eg, z) + h * weak(spec.alpha, h)
            else:
                gamma = cast(self.gamma)
                z = gamma[0] * h
                cur = h
                for k in range(1, gamma.shape[0]):
                    cur = spmm(eg, cur)
                    z = z + gamma[k] * cur
            out = z
        return out.float()


def _linear(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """JAX's ``x @ w + b`` (``zoo.py:249-250``) for torch's ``w [out, in]``,
    under JAX's promotion: in f32 when either of ``x`` and ``w`` is f32 (the
    other widened); both bf16, the product rounded to bf16, then the bias
    add."""
    if x.dtype == w.dtype == torch.bfloat16:
        return x @ w.t() + b
    return F.linear(x.float(), w.float(), b.float())
