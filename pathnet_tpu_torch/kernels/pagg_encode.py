"""K3 ``pagg_encode_fwd``: the PAGG encode forward and its readout, in f32 or
with bf16 compute.

Replaces ``pathnet_tpu/models/pagg.py:235-307`` (the encode block and the
readout of ``pagg_forward``, both variants), with ``_dist_select``
(``:150-177``) and ``nn/cells.py:22-68`` (``lstm_scan``, ``gru_scan``). Per
target: gather its ``nw * wl`` rows of ``h`` and apply ``W[d] x + b[d]`` with
``d`` clipped to ``[0, wl - 1]``, then run the ``wl``-step recurrence
(``cell``: "lstm", the default, or "gru"), then read the walks out (``agg``):

- **attention** (the default), **hetero**: each walk flipped (far to near);
  each walk scored by ``leaky_relu(attw . [h_n, h[walk start]] + attb)``,
  softmax over the walks; the result is the weighted **sum** of the ``h_n``.
- **attention**, **homo** (``homo=True``, ``pagg.py:257-303``): the walk in
  sampled order, a ReLU on each selected row, whose step-0 row (before
  dropout) is the walk's ego row; each walk scored by ``attw . [h_n, ego] +
  attb``; the result is the **mean** over the walks of ``(1 + score) * h_n``.
- **mean** and **sum** (``pagg.py:304-307``), either variant: the mean or
  the sum of the ``h_n`` over the walks; no score, no ego row, and
  ``attw``, ``attb`` are not read.

Either way the result is ``[T, H]``.

**The GRU** (``cell="gru"``, ``nn/cells.py:49-68``, gates r, z, n): K3 takes
its weights in the LSTM's ``[H, 4H]`` layout, packed by :func:`pack_gru` as
``w_ih = [W_ir, W_iz, W_in, 0]``, ``w_hh = [W_hr, W_hz, 0, W_hn]``, ``b_ih =
[b_ir, b_iz, b_in, 0]`` and ``b_hh = [b_hr, b_hz, 0, b_hn]``, so the gate
product ``[s_t | h_{t-1}] @ [w_ih; w_hh] + b_ih + b_hh`` is the LSTM's and its
four column groups are ``r`` and ``z`` before their sigmoids, ``x W_in +
b_in`` and ``h W_hn + b_hn`` apart, as ``n = tanh(x W_in + b_in + r (h W_hn +
b_hn))`` needs them (``b_hn`` inside the product with ``r``, as
``torch.nn.GRU`` and JAX have it). The zero blocks must stay zero: the
kernel multiplies by them, the plain version (:func:`unpack_gru`, then
``gru_scan``) drops them. The product then does 16 H^2 flops a step where
the GRU needs 12 H^2.

**The MLP** (``cell="mlp"``, ``pagg.py:180-188``): ``h_n = mean_t(s_t) @ W +
b``, no recurrence. K3 takes ``W [H, H]`` as ``w_ih`` and ``b [H]`` as
``b_ih``; ``w_hh`` and ``b_hh`` are empty (``[H, 0]`` and ``[0]``,
:func:`cell_shapes`). The encode sums each walk's selected rows (after
dropout) over the steps in registers and ends with one ``[M, H] x [H, H]``
product of their mean: no gate product.

**quirk_compat** (``agg="quirk"``, hetero only; JAX's
``_hetero_quirk_forward``, ``pagg.py:316-338``): the reference's two index
quirks. :func:`quirk_layout` builds, in plain torch from ``paths`` and
``dists`` once a call, walks that the hetero encode reads in the quirk's
order: step ``l`` of quirk walk ``b' = g * T + j`` takes node ``pf[i % B, wl -
1 - i // B]`` (``i = b' * wl + l``, ``pf = paths.reshape(B, wl)``, ``B = T *
nw``), class ``clip(dists.reshape(B, wl)[b', l])`` unflipped, and the keep
mask's column ``b'``; the quirk walks are grouped by ``j`` so that each run
of ``nw`` walks is one readout group, and each walk's ego row is
``h[pf[b', 0]]``, its start node before the misalignment. The readout is the
hetero softmax over the group followed by a **mean** over it. The quirk
runs in f32, whatever ``compute_dtype`` or ``agg`` says, as JAX's does.

**bf16 compute** (the JAX package's ``compute_dtype="bfloat16"``,
``pagg.py:233-279``): the table ``h`` and the six cast weights ``wd, bd, w_ih,
w_hh, b_ih, b_hh`` are given as bf16, all of them or none (a mixed set
raises); ``attw`` and ``attb`` stay f32, and so does the result. Every
product sums in f32 the products of bf16 values (exact), on the card on the
bf16 tensor cores, and the LSTM cell runs in f32; the values are rounded to
bf16 (:func:`round_bf16`) where JAX's encode holds them in bf16:

- the distance select ``s = round(round(x @ W[d]) + b[d])`` (homo: its
  ReLU, exact in bf16);
- the dropout ``round(s / keep_b)``, ``keep_b`` being ``keep`` rounded to
  bf16 (:func:`dropout_divisor`: JAX divides the bf16 row by the Python
  float ``keep``, a weak type that takes the row's type);
- the LSTM: one f32 product ``[s_t | h_{t-1}] @ [w_ih; w_hh] + b_ih + b_hh``
  and the cell in f32, then ``c_t = round(f c + i g)`` and ``h_t =
  round(o tanh(c_t))`` at the end of each step (the scan's bf16 carry);
- the GRU: the same packed f32 product, its two n-group columns ``x W_in +
  b_in`` and ``h W_hn + b_hn``, which the packed product keeps apart and JAX
  holds in bf16 (its ``gx`` and ``gh``), rounded, the cell in f32, then
  ``h_t = round((1 - z) n + z h_{t-1})`` (the scan's bf16 carry). JAX also
  rounds the r and z columns' ``x`` and ``h`` parts apart, which one packed
  product cannot, and each gate;
- the MLP: the mean ``m = round(sum_t s_t / wl)`` (JAX's bf16 ``mean``
  sums in f32 and rounds once) and ``h_n = round(round(m @ W) + b)``;
- the readout in f32, on the hetero walk-start rows of the bf16 table (JAX's
  ``nei[:, :, 0]``) or the homo rounded step-0 rows.

JAX rounds its input product ``gx`` on its own and runs its cell in bf16;
those differences stay inside a few bf16 ulps of ``h_n``
(``tests/test_torch_bf16.py``, ``tests/test_torch_bf16_cells.py``). The bf16
instances of the kernel are the template parameter ``BF16``, compiled at H =
64 and 32 and at the run-time
width; their products are ``mma.sync`` on the tensor cores (bf16 operands,
f32 accumulators), which sum in another order than the plain version's f32
product, so a rounding to bf16 can fall an ulp apart (the card tests hold
them within four bf16 ulps of the plain version's largest entry).

Training mode: with ``keep_mask`` (uint8 ``[wl, T * nw, H]``, the layout of
the LSTM input ``seq`` at ``pagg.py:274``) the selected input of step ``t`` of
walk ``b`` becomes ``keep_mask[t, b] ? s / keep : 0``, JAX's
``where(mask, x / keep, 0)``. The mask is an input, drawn by the caller, so
the kernel and its plain version see the same draws. Without a mask the
kernel is the serving kernel unchanged (a separate template instance); the
variant is a template parameter too (``HOMO``), so the hetero instances are
what they were before the homo variant came; so are the cell (``CELL``,
the encode: LSTM, GRU or MLP) and the readout (``AGG``, the second launch),
so the LSTM and attention instances are what they were before them.

Source: ``pathnet_tpu_torch/csrc/pagg_encode.cu``, two launches behind the
one wrapper (one count a call). The first runs the encode over the flat walk
axis ``b = target * nw + walk`` in tiles of ``M`` walks (``M`` from ``H``: 64
at H = 64, 32 at H = 256; :func:`encode_tile`), each step a register-tiled f32
GEMM ``[M, 2H] x [2H, 4H]`` with ``[s_t | h_{t-1}]`` in shared memory and
``[w_ih; w_hh]`` staged through shared memory in double-buffered 16-byte
``cp.async`` chunks. A thread holds 8 walks x 2 hidden units x 4 gates of
accumulators, so the cell update is the GEMM's epilogue in registers and
``c`` never leaves them. The distance select is one such GEMM per distance
class present in the tile. It writes ``h_n`` ``[T * nw, H]`` to a scratch
(and, homo, the ego rows to a second one); the second launch, one block per
target, scores the walks, reduces the softmax once (hetero) and forms the
weighted sum; under mean or sum it only adds each target's ``h_n`` rows
(its threads split the walks, then add the parts in a fixed order).
:func:`encode_walks` and
:func:`readout` launch each stage alone (for timing and tests; they count no
launch), with plain versions :func:`encode_walks_plain` and
:func:`readout_plain`, whose composition is :func:`pagg_encode_fwd_plain`.

Bound on the H100: f32 FMA work, about 18 H^2 flops per walk step: at one
8192-target request (nw = 40, wl = 4, H = 64) about 97 GFLOP, 1.4 ms at the
67 TFLOP/s f32 rate, against about 29 MB of unique bytes (9 us). The f32
instances compute on the CUDA cores, so the f32 rate is their bound; the
bf16 instances run the same 97 GFLOP on the tensor cores, about 0.10 ms at
bf16's dense rate (989 TFLOP/s), and are held above it by the tile's shared
memory traffic and its f32 epilogue (``csrc/pagg_tile.cuh``). The homo variant
adds per-element work only (two ReLUs, the ego store): the same bound. The
GRU needs 14 H^2 flops a walk step (2 for the select, 12 for its gates): 75
GFLOP, 1.12 ms at the bgp request, though the packed product runs the
LSTM's 18 H^2. The MLP needs 2.5 H^2 a walk step at wl = 4 (the select's 2
and its one product's 2 a walk): 13.4 GFLOP, 0.20 ms at the bgp request. The
mean and sum readouts read ``h_n`` once (84 MB at the bgp request, 0.025 ms
at 3.35 TB/s). The quirk's layout is ~10 plain torch ops a call on
``[T, nw, wl]`` integers.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from ..nn.cells import gru_scan, lstm_scan
from . import build

# the readouts and cells K3 and K4 run; their index is the C entries' code
AGGS = ("attention", "mean", "sum", "quirk")
CELLS = ("lstm", "gru", "mlp")


class _RoundBf16(torch.autograd.Function):
    """Round to the nearest bf16, kept as f32; the gradient passes as it is."""

    @staticmethod
    def forward(ctx, t):
        return t.to(torch.bfloat16).float()

    @staticmethod
    def backward(ctx, g):
        return g


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to the nearest bf16 (ties to even), as an f32 tensor:
    the rounding of every bf16 plain version. Its derivative is the
    identity, as the kernels take it (JAX's convert VJP only changes the
    cotangent's type)."""
    return _RoundBf16.apply(t)


def is_bf16(h: torch.Tensor, bf16: bool = False) -> bool:
    """Whether a plain version computes in bf16: asked for, or given a bf16
    table."""
    return bf16 or h.dtype == torch.bfloat16


def gather_rows(h: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``h[idx]`` for an integer ``idx`` of any shape, through ``index_select``:
    its backward adds with ``index_add_``, in the same order on every run,
    where autograd through ``h[idx]`` adds with ``index_put_``, which a
    multi-threaded CPU adds in thread order."""
    return h.index_select(0, idx.reshape(-1).long()).view(*idx.shape, h.shape[1])


def select_plain(x, d, wd, bd, homo=False, bf16=False):
    """The distance select of rows ``x [R, H]`` with clipped classes ``d [R,
    1]``: ``x @ wd[d] + bd[d]`` (bf16: ``round(round(x @ wd[d]) + bd[d])``),
    then the homo ReLU."""
    sel = torch.zeros_like(x)
    for k in range(wd.shape[0]):
        z = round_bf16(round_bf16(x @ wd[k]) + bd[k]) if bf16 else x @ wd[k] + bd[k]
        sel = torch.where(d == k, z, sel)
    return torch.relu(sel) if homo else sel


def dropout_divisor(keep: float, bf16: bool = False) -> float:
    """What JAX's ``where(mask, x / keep, 0)`` divides by: ``keep``, or for a
    bf16 ``x`` ``keep`` rounded to bf16 (0.3 becomes 0.30078125)."""
    return float(torch.tensor(keep, dtype=torch.bfloat16)) if bf16 else keep


def dropout_plain(seq, keep_mask, keep, bf16=False):
    """JAX's ``where(mask, x / keep, 0)``; bf16: the divisor and the quotient
    rounded to bf16."""
    if keep_mask is None:
        return seq
    q = seq / dropout_divisor(keep, bf16)
    return torch.where(keep_mask.bool(), round_bf16(q) if bf16 else q, 0.0)


def lstm_bf16_steps(xs, w_ih, w_hh, b_ih, b_hh):
    """The bf16 LSTM over ``xs [wl, B, H]`` from a zero state, step by step:
    yields ``(h_{t-1}, gate activations [B, 4H], c_t, h_t)``, with one f32
    product ``[x_t | h_{t-1}] @ [w_ih; w_hh] + b_ih + b_hh`` and ``c_t``,
    ``h_t`` rounded to bf16."""
    w = torch.cat([w_ih, w_hh], 0)
    b = b_ih + b_hh
    h = xs.new_zeros(xs.shape[1:])
    c = torch.zeros_like(h)
    for x in xs:
        i, f, g, o = (torch.cat([x, h], 1) @ w + b).chunk(4, dim=1)
        si, sf, tg, so = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)
        c = round_bf16(sf * c + si * tg)
        hp, h = h, round_bf16(so * torch.tanh(c))
        yield hp, torch.cat([si, sf, tg, so], dim=1), c, h


def pack_gru(w_ih, w_hh, b_ih, b_hh):
    """A GRU's weights ``w_ih, w_hh [H, 3H]`` and biases ``[3H]`` (gates r,
    z, n; ``x @ w``) in K3's ``[H, 4H]`` / ``[4H]`` layout: ``[W_ir, W_iz,
    W_in, 0]``, ``[W_hr, W_hz, 0, W_hn]``, ``[b_ir, b_iz, b_in, 0]``, ``[b_hr,
    b_hz, 0, b_hn]`` (autograd ops: a packed gradient flows back unpacked)."""
    H = w_hh.shape[0]
    zw, zb = w_hh.new_zeros((H, H)), b_hh.new_zeros(H)
    return (torch.cat([w_ih, zw], 1), torch.cat([w_hh[:, :2 * H], zw, w_hh[:, 2 * H:]], 1),
            torch.cat([b_ih, zb]), torch.cat([b_hh[:2 * H], zb, b_hh[2 * H:]]))


def gru_bf16_steps(xs, w_ih, w_hh, b_ih, b_hh):
    """The bf16 GRU over ``xs [wl, B, H]`` on packed weights from a zero
    state, step by step: yields ``(h_{t-1}, (r, z, n, h W_hn + b_hn) [B, 4H],
    None, h_t)``, with one f32 product ``[x_t | h_{t-1}] @ [w_ih; w_hh] + b_ih
    + b_hh``, its n-group columns and ``h_t`` rounded to bf16."""
    w = torch.cat([w_ih, w_hh], 0)
    b = b_ih + b_hh
    h = xs.new_zeros(xs.shape[1:])
    for x in xs:
        ar, az, an, a3 = (torch.cat([x, h], 1) @ w + b).chunk(4, dim=1)
        an, a3 = round_bf16(an), round_bf16(a3)
        r, z = torch.sigmoid(ar), torch.sigmoid(az)
        n = torch.tanh(an + r * a3)
        hp, h = h, round_bf16((1.0 - z) * n + z * h)
        yield hp, torch.cat([r, z, n, a3], dim=1), None, h


def mlp_plain(seq, w, b, bf16=False):
    """The MLP encoder on ``seq [wl, B, H]``: ``(m, h_n)``, ``m`` the mean
    over the steps and ``h_n = m @ w + b`` (bf16: ``m`` rounded, ``h_n =
    round(round(m @ w) + b)``)."""
    m = seq.mean(dim=0)
    if not bf16:
        return m, m @ w + b
    m = round_bf16(m)
    return m, round_bf16(round_bf16(m @ w) + b)


def cell_plain(seq, w_ih, w_hh, b_ih, b_hh, cell="lstm", bf16=False):
    """``h_n [B, H]`` of the encoder ``cell`` over ``seq [wl, B, H]`` (the
    GRU's weights packed; bf16 as in the module docstring)."""
    if cell == "mlp":
        return mlp_plain(seq, w_ih, b_ih, bf16)[1]
    if bf16:
        steps = gru_bf16_steps if cell == "gru" else lstm_bf16_steps
        return list(steps(seq, w_ih, w_hh, b_ih, b_hh))[-1][-1]
    if cell == "gru":
        return gru_scan(unpack_gru(w_ih, w_hh, b_ih, b_hh), seq)[1]
    return lstm_scan({"w_ih": w_ih, "w_hh": w_hh, "b_ih": b_ih, "b_hh": b_hh}, seq)[1]


def cell_shapes(cell: str, H: int) -> tuple:
    """The shapes of ``w_ih, w_hh, b_ih, b_hh`` for ``cell``: ``[H, 4H]``
    and ``[4H]`` (the LSTM, the packed GRU), or the MLP's ``W [H, H]`` and
    ``b [H]`` with an empty ``w_hh [H, 0]`` and ``b_hh [0]``."""
    if cell == "mlp":
        return (H, H), (H, 0), (H,), (0,)
    return (H, 4 * H), (H, 4 * H), (4 * H,), (4 * H,)


def quirk_layout(paths: torch.Tensor, dists: torch.Tensor):
    """JAX's quirk layout (module docstring) as hetero walks: ``(qpaths,
    qdists, ego, perm)``, int32 ``[T, nw, wl]`` walks whose hetero steps
    (position ``wl - 1 - t`` at step ``t``) read the quirk's steps in order,
    the ego nodes as one-step walks ``[T, nw, 1]`` (the readout's ``paths``),
    and the int64 quirk walk ``b'`` of each of these walks (the keep mask's
    columns: ``keep_mask[:, perm]``)."""
    T, nw, wl = paths.shape
    B = T * nw
    dev = paths.device
    pf, df = paths.reshape(B, wl).long(), dists.reshape(B, wl)
    # walk j * nw + g here is quirk walk g * T + j: each run of nw one group
    perm = (torch.arange(nw, device=dev)[None, :] * T
            + torch.arange(T, device=dev)[:, None]).reshape(-1)
    i = perm[:, None] * wl + torch.arange(wl, device=dev)[None, :]     # [B, wl]
    node = pf[i % B, wl - 1 - torch.div(i, B, rounding_mode="floor")]
    qpaths = node.flip(1).to(torch.int32).reshape(T, nw, wl).contiguous()
    qdists = df[perm].flip(1).contiguous().reshape(T, nw, wl)
    ego = pf[perm, 0].to(torch.int32).reshape(T, nw, 1)
    return qpaths, qdists, ego, perm


def quirk_encode_plain(h, paths, dists, wd, bd, w_ih, w_hh, b_ih, b_hh, keep_mask=None,
                       keep=1.0, cell="lstm"):
    """JAX's ``_hetero_quirk_forward`` (``pagg.py:319-328``) written out as it
    is, independent of :func:`quirk_layout`: ``(h_n, first)``, ``[nw, T, H]``
    each, the quirk walks' ``h_n`` and ego rows in its walk-major groups."""
    T, nw, wl = paths.shape
    B, H = T * nw, h.shape[1]
    seq = gather_rows(h, paths).reshape(B, wl, H).transpose(0, 1)       # [wl, B, H]
    flat = seq.flip(0).reshape(wl * B, H)                                # l-major
    d = dists.reshape(B * wl, 1).clamp(0, wl - 1)                        # b-major
    sel = select_plain(flat, d, wd, bd).reshape(B, wl, H).transpose(0, 1)
    sel = dropout_plain(sel, keep_mask, keep)
    hn = cell_plain(sel, w_ih, w_hh, b_ih, b_hh, cell)
    return hn.reshape(nw, T, H), seq[0].reshape(nw, T, H)


def unpack_gru(w_ih, w_hh, b_ih, b_hh) -> dict:
    """Inverse of :func:`pack_gru`: ``gru_scan``'s parameters, the zero
    blocks dropped."""
    H = w_hh.shape[0]
    return {"w_ih": w_ih[:, :3 * H], "w_hh": torch.cat([w_hh[:, :2 * H], w_hh[:, 3 * H:]], 1),
            "b_ih": b_ih[:3 * H], "b_hh": torch.cat([b_hh[:2 * H], b_hh[3 * H:]])}


def encode_walks_plain(h, paths, dists, wd, bd, w_ih, w_hh, b_ih, b_hh,
                       keep_mask=None, keep=1.0, homo=False, bf16=False, cell="lstm"):
    """Plain PyTorch version of K3's first launch: ``h_n`` ``[T * nw, H]``;
    with ``homo``, ``(h_n, ego)``, ``ego [T * nw, H]`` the walks' ego rows.
    ``bf16`` (or a bf16 ``h``): the bf16 rules of the module docstring, on
    inputs that hold bf16 values, bf16 or f32. ``cell="gru"``: ``gru_scan``
    on the unpacked weights (:func:`unpack_gru`; bf16, :func:`gru_bf16_steps`
    on the packed ones); ``cell="mlp"``: :func:`mlp_plain`."""
    bf16 = is_bf16(h, bf16)
    check_choices(cell=cell)
    if bf16:
        h, wd, bd, w_ih, w_hh, b_ih, b_hh = (t.float() for t in
                                             (h, wd, bd, w_ih, w_hh, b_ih, b_hh))
    T, nw, wl = paths.shape
    H = h.shape[1]
    x, d = gather_rows(h, paths), dists
    if not homo:
        x, d = x.flip(2), d.flip(2)
    x = x.reshape(-1, H)
    d = d.clamp(0, wl - 1).reshape(-1, 1)
    sel = select_plain(x, d, wd, bd, homo, bf16)
    seq = sel.reshape(T * nw, wl, H).transpose(0, 1)       # [wl, B, H]
    ego = seq[0].contiguous() if homo else None
    seq = dropout_plain(seq, keep_mask, keep, bf16)
    hn = cell_plain(seq, w_ih, w_hh, b_ih, b_hh, cell, bf16)
    return (hn, ego) if homo else hn


def readout_plain(h, paths, hn, attw, attb, ego=None, agg="attention") -> torch.Tensor:
    """Plain PyTorch version of K3's second launch: the readout ``[T, H]``;
    ``agg`` "mean" or "sum" of ``h_n`` over the walks, or the attention
    readout, homo where ``ego`` (the first launch's) is given; ``h`` f32 or
    the bf16 table. "quirk": the hetero attention readout's mean over the
    walks in place of its sum, the ego rows at ``paths[:, :, 0]`` (the ego
    nodes of :func:`quirk_layout`)."""
    T, nw, _ = paths.shape
    H = hn.shape[1]
    h_n = hn.reshape(T, nw, H)
    if agg == "mean":
        return h_n.mean(dim=1)
    if agg == "sum":
        return h_n.sum(dim=1)
    e = gather_rows(h, paths[:, :, 0]).float() if ego is None else ego.reshape(T, nw, H)
    score = torch.cat([h_n, e], dim=-1) @ attw + attb           # [T, nw]
    if ego is not None:
        return ((1.0 + score)[:, :, None] * h_n).mean(dim=1)
    att = torch.softmax(F.leaky_relu(score, 0.01), dim=1)
    out = att[:, :, None] * h_n
    return out.mean(dim=1) if agg == "quirk" else out.sum(dim=1)


def pagg_encode_fwd_plain(h, paths, dists, wd, bd, w_ih, w_hh, b_ih, b_hh,
                          attw, attb, keep_mask=None, keep=1.0,
                          homo=False, bf16=False, agg="attention",
                          cell="lstm") -> torch.Tensor:
    """Plain PyTorch version; same arguments and result as
    :func:`pagg_encode_fwd` (``bf16`` as in :func:`encode_walks_plain`). The
    quirk (``agg="quirk"``) is JAX's formulation as written
    (:func:`quirk_encode_plain`), not :func:`quirk_layout`'s."""
    if agg == "quirk":
        check_quirk(homo, h)
        hn, first = quirk_encode_plain(h, paths, dists, wd, bd, w_ih, w_hh, b_ih, b_hh,
                                       keep_mask, keep, cell)
        score = torch.cat([hn, first], dim=-1) @ attw + attb          # [nw, T]
        att = torch.softmax(F.leaky_relu(score, 0.01), dim=0)
        return (att[:, :, None] * hn).mean(dim=0)
    out = encode_walks_plain(h, paths, dists, wd, bd, w_ih, w_hh, b_ih, b_hh,
                             keep_mask, keep, homo, bf16, cell)
    hn, ego = out if homo else (out, None)
    return readout_plain(h, paths, hn, attw, attb, ego, agg)


def compute_dtype(*tensors: torch.Tensor) -> torch.dtype:
    """The encode's compute type, f32 or bf16, which the table ``h`` and the
    six cast weights share; raises ``TypeError`` for another type or a mixed
    set."""
    kinds = {t.dtype for t in tensors}
    if len(kinds) != 1 or not kinds <= {torch.float32, torch.bfloat16}:
        raise TypeError("the table h and the weights wd, bd, w_ih, w_hh, b_ih, b_hh must be "
                        "all float32 or all bfloat16; got "
                        + ", ".join(str(t.dtype) for t in tensors))
    return kinds.pop()


def check_choices(agg: str = "attention", cell: str = "lstm") -> None:
    """Raise ``ValueError`` for a readout or cell K3 and K4 do not know."""
    if agg not in AGGS:
        raise ValueError(f"agg={agg!r}: expected one of {AGGS}")
    if cell not in CELLS:
        raise ValueError(f"cell={cell!r}: expected one of {CELLS}")


def check_quirk(homo: bool, h: torch.Tensor) -> None:
    """Raise ``ValueError`` unless the quirk runs on the hetero variant in
    f32 (JAX's homo variant ignores ``quirk_compat``, and its quirk path
    returns before ``compute_dtype`` is read)."""
    if homo or h.dtype != torch.float32:
        raise ValueError("agg='quirk' runs the hetero variant in float32 only")


def _check(h, paths, dists, wd, bd, w_ih, w_hh, b_ih, b_hh, keep_mask, keep,
           cell="lstm"):
    """Raise unless the encode's inputs fit together and the device is the
    CPU or a CUDA card that takes their width."""
    dev = h.device
    dt = compute_dtype(h, wd, bd, w_ih, w_hh, b_ih, b_hh)
    check_choices(cell=cell)
    build.require(h, "h", dt, (None, None), dev)
    H = h.shape[1]
    build.require(paths, "paths", torch.int32, (None, None, None), dev)
    T, nw, wl = paths.shape
    build.require(dists, "dists", torch.int32, (T, nw, wl), dev)
    build.require(wd, "wd", dt, (wl, H, H), dev)
    build.require(bd, "bd", dt, (wl, H), dev)
    for t, name, shape in zip((w_ih, w_hh, b_ih, b_hh), ("w_ih", "w_hh", "b_ih", "b_hh"),
                              cell_shapes(cell, H)):
        build.require(t, name, dt, shape, dev)
    check_keep_mask(keep_mask, keep, wl, T * nw, H, dev)
    if nw < 1 or wl < 1:
        raise ValueError(f"pagg_encode_fwd needs nw, wl >= 1, got {nw}, {wl}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"pagg_encode_fwd: unsupported device {dev}")
    if dev.type == "cuda" and H > 1024:
        raise ValueError(f"pagg_encode_fwd: hidden {H} > 1024 is not supported")


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    """A tensor's device address for a C entry point; None for no tensor."""
    return None if t is None else t.data_ptr()


def _launch_walks(h, paths, dists, wd, bd, w_ih, w_hh, b_ih, b_hh, keep_mask, keep,
                  homo, cell="lstm"):
    """Launch 1: ``h_n``, and with ``homo`` ``(h_n, ego)``."""
    T, nw, wl = paths.shape
    H = h.shape[1]
    bf16 = h.dtype == torch.bfloat16
    hn = torch.empty((T * nw, H), dtype=torch.float32, device=h.device)
    ego = torch.empty_like(hn) if homo else None
    with torch.cuda.device(h.device):
        rc = build.library().pathnet_pagg_encode_walks(
            h.data_ptr(), paths.data_ptr(), dists.data_ptr(), wd.data_ptr(),
            bd.data_ptr(), w_ih.data_ptr(), w_hh.data_ptr(), b_ih.data_ptr(),
            b_hh.data_ptr(), ptr(keep_mask), dropout_divisor(keep, bf16), hn.data_ptr(),
            ptr(ego), T, nw, wl, H, int(bf16), CELLS.index(cell), build.stream_ptr(h))
    build.check(rc, "pagg_encode_fwd (encode)")
    return (hn, ego) if homo else hn


def _launch_readout(h, paths, hn, attw, attb, ego=None, agg="attention"):
    T, nw, wl = paths.shape
    H = h.shape[1]
    out = torch.empty((T, H), dtype=torch.float32, device=h.device)
    with torch.cuda.device(h.device):
        rc = build.library().pathnet_pagg_readout(
            h.data_ptr(), paths.data_ptr(), hn.data_ptr(), ptr(ego), attw.data_ptr(),
            attb.data_ptr(), out.data_ptr(), T, nw, wl, H, int(h.dtype == torch.bfloat16),
            AGGS.index(agg), build.stream_ptr(h))
    build.check(rc, "pagg_encode_fwd (readout)")
    return out


def pagg_encode_fwd(h: torch.Tensor, paths: torch.Tensor, dists: torch.Tensor,
                    wd: torch.Tensor, bd: torch.Tensor, w_ih: torch.Tensor,
                    w_hh: torch.Tensor, b_ih: torch.Tensor, b_hh: torch.Tensor,
                    attw: torch.Tensor, attb: torch.Tensor,
                    keep_mask: Optional[torch.Tensor] = None,
                    keep: float = 1.0, homo: bool = False, agg: str = "attention",
                    cell: str = "lstm") -> torch.Tensor:
    """Path-aggregated features ``float32 [T, H]`` of the ``T`` targets.

    ``h`` float32 ``[n, H]`` (projected node features; bf16 with the six
    weights ``wd`` .. ``b_hh`` bf16 for bf16 compute), ``paths`` and
    ``dists`` int32 ``[T, nw, wl]`` (node ids in ``[0, n)``), ``wd``
    ``[wl, H, H]`` and ``bd`` ``[wl, H]`` (the distance transforms, ``x @
    wd[d]``), ``w_ih``/``w_hh`` ``[H, 4H]`` and ``b_ih``/``b_hh`` ``[4H]``
    (LSTM, gates i, f, g, o; ``cell="gru"``: the GRU packed by
    :func:`pack_gru`), ``attw`` ``[2H]`` and ``attb`` ``[1]`` (read by the
    attention readout only); ``keep_mask`` uint8 ``[wl, T * nw, H]`` and
    ``keep`` in ``(0, 1]`` for the training forward's dropout; ``homo``
    picks the homo variant and ``agg`` the readout ("quirk": JAX's
    ``quirk_compat``, hetero and f32; see the module docstring).
    """
    enc = (h, paths, dists, wd, bd, w_ih, w_hh, b_ih, b_hh, keep_mask, keep)
    _check(*enc, cell)
    check_choices(agg)
    build.require(attw, "attw", torch.float32, (2 * h.shape[1],), h.device)
    build.require(attb, "attb", torch.float32, (1,), h.device)
    if agg == "quirk":
        check_quirk(homo, h)
    if h.device.type == "cpu":
        return pagg_encode_fwd_plain(*enc[:9], attw, attb, keep_mask, keep, homo,
                                     agg=agg, cell=cell)
    if agg == "quirk":
        paths, dists, ego_paths, perm = quirk_layout(paths, dists)
        keep_mask = None if keep_mask is None else keep_mask[:, perm].contiguous()
        hn = _launch_walks(h, paths, dists, *enc[3:9], keep_mask, keep, False, cell)
        out = _launch_readout(h, ego_paths, hn, attw, attb, None, agg)
    else:
        walks = _launch_walks(*enc, homo, cell)
        hn, ego = walks if homo else (walks, None)
        out = _launch_readout(h, paths, hn, attw, attb, ego, agg)
    pagg_encode_fwd.launches += 1
    return out


def encode_walks(h, paths, dists, wd, bd, w_ih, w_hh, b_ih, b_hh,
                 keep_mask=None, keep=1.0, homo=False, cell="lstm"):
    """K3's first launch alone: ``h_n`` ``[T * nw, H]`` of every walk; with
    ``homo``, ``(h_n, ego)`` as :func:`encode_walks_plain` returns them.

    For timing and tests; it counts no launch (the model calls
    :func:`pagg_encode_fwd`)."""
    enc = (h, paths, dists, wd, bd, w_ih, w_hh, b_ih, b_hh, keep_mask, keep)
    _check(*enc, cell)
    if h.device.type == "cpu":
        return encode_walks_plain(*enc, homo, cell=cell)
    return _launch_walks(*enc, homo, cell)


def readout(h, paths, hn, attw, attb, ego=None, agg="attention") -> torch.Tensor:
    """K3's second launch alone: the readout ``[T, H]`` (``agg``) from ``hn``
    ``[T * nw, H]``, homo where the ego rows ``ego [T * nw, H]`` are given.
    For timing and tests; it counts no launch."""
    check_choices(agg)
    dev = h.device
    build.require(h, "h", compute_dtype(h), (None, None), dev)
    H = h.shape[1]
    build.require(paths, "paths", torch.int32, (None, None, None), dev)
    T, nw, _ = paths.shape
    build.require(hn, "hn", torch.float32, (T * nw, H), dev)
    if ego is not None:
        build.require(ego, "ego", torch.float32, (T * nw, H), dev)
    build.require(attw, "attw", torch.float32, (2 * H,), dev)
    build.require(attb, "attb", torch.float32, (1,), dev)
    if dev.type == "cpu":
        return readout_plain(h, paths, hn, attw, attb, ego, agg)
    if dev.type != "cuda":
        raise ValueError(f"readout: unsupported device {dev}")
    return _launch_readout(h, paths, hn, attw, attb, ego, agg)


def encode_tile(H: int, bf16: bool = False) -> dict:
    """K3's tile at width ``H`` (``bf16``: with bf16 weight chunks) as its
    launcher derives it (needs the built library): walks a block ``M``,
    ``threads``, ``shared_bytes``, and ``kc``, the weight rows a chunk."""
    out = (ctypes.c_int * 4)()
    build.check(build.library().pathnet_pagg_encode_tile(H, int(bf16), out), "encode_tile")
    return {"M": out[0], "threads": out[1], "shared_bytes": out[2], "kc": out[3]}


pagg_encode_fwd.launches = 0


def check_keep_mask(keep_mask: Optional[torch.Tensor], keep: float, wl: int,
                    B: int, H: int, device: torch.device) -> None:
    """Raise unless ``keep_mask`` is None or uint8 ``[wl, B, H]`` on
    ``device`` with ``0 < keep <= 1``."""
    if keep_mask is None:
        return
    build.require(keep_mask, "keep_mask", torch.uint8, (wl, B, H), device)
    if not 0.0 < keep <= 1.0:
        raise ValueError(f"keep must lie in (0, 1], got {keep}")
