"""K4's weight contractions, ``pagg_contract`` (``kernels/pagg_encode_bwd.py``,
``csrc/pagg_contract.cu``).

On the host the wrapper takes its plain version, ``contractions_plain``. It
is held against ``jax.vjp`` of the JAX package's encode block (``_dist_select``
and ``_encode`` with the readout of ``pagg_forward``) in the weights, for
every cell, both variants and walk lengths 4, 5 and 7, and against an
independent float64 sum per distance class. On a card (tests marked
``gpu``) the kernel is held against the plain version and two calls must be
bit-equal; those tests import no JAX, so they run where JAX is absent:
``python -m pytest tests/test_torch_contract.py -m gpu --noconftest``.
"""
import numpy as np
import pytest
import torch

from pathnet_tpu_torch import kernels as K
from pathnet_tpu_torch.kernels.pagg_encode import unpack_gru

NW, F, C, KEEP = 6, 24, 5, 0.7
NAMES = ("dwd", "dbd", "dw_ih", "dw_hh", "db")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def streams(T, nw, wl, H, cell, seed=0, device="cpu", empty_class=None):
    """Random f32 streams in K4's layout and distances (some outside ``[0, wl
    - 1]``, which the class clips), made with numpy from ``seed``; no row of
    class ``empty_class``."""
    rng = np.random.default_rng(seed)
    B = T * nw
    r = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(device)
    xr, xin, dsel = r(wl, B, H), r(wl, B, H), r(wl, B, H)
    hp = r(B, H) if cell == "mlp" else r(wl, B, H)
    dg = r(B, H) if cell == "mlp" else r(wl, B, 4 * H)
    d = rng.integers(-1, wl + 1, size=(T, nw, wl))
    if empty_class is not None:
        d[np.clip(d, 0, wl - 1) == empty_class] = 0 if empty_class else wl - 1
    return xr, xin, hp, dsel, dg, torch.from_numpy(d.astype(np.int32)).to(device)


def classes64(dists, homo):
    """float64 ``[wl, B]``: the clipped class of step ``t`` of each walk,
    written out: step ``t`` holds position ``wl - 1 - t`` (homo ``t``)."""
    T, nw, wl = dists.shape
    d = np.clip(dists.cpu().numpy().reshape(T * nw, wl), 0, wl - 1)
    return d.T if homo else d[:, ::-1].T


@pytest.mark.parametrize("cell", ["lstm", "mlp"])
@pytest.mark.parametrize("homo", [False, True])
def test_plain_contractions_equal_float64_sums_per_class(cell, homo):
    """``dwd[k]``, ``dbd[k]`` against float64 masked sums over the rows of
    class ``k`` (class 2 has no row: exact zeros), the rest against float64
    products; R = 4 x 77 rows is no multiple of any tile."""
    xr, xin, hp, dsel, dg, dists = streams(7, 11, 4, 12, cell, seed=3, empty_class=2)
    got = K.pagg_contract(xr, xin, hp, dsel, dg, dists, homo, cell)
    cls = classes64(dists, homo)
    x, s = xr.double().numpy(), dsel.double().numpy()
    for k in range(4):
        on = (cls == k)[:, :, None]
        want_w = np.einsum("tbi,tbj->ij", x * on, s)
        want_b = (s * on).sum((0, 1))
        if k == 2:
            assert not on.any() and not got[0][k].any() and not got[1][k].any()
        np.testing.assert_allclose(got[0][k].double().numpy(), want_w, rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(want_w).max()))
        np.testing.assert_allclose(got[1][k].double().numpy(), want_b, rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(want_b).max()))
    a = (hp if cell == "mlp" else xin).double().reshape(-1, 12).numpy()
    g = dg.double().reshape(a.shape[0], -1).numpy()
    wants = [a.T @ g, g.sum(0)]
    gots = [got[2], got[4]]
    if cell != "mlp":
        wants.append(hp.double().reshape(-1, 12).numpy().T @ g)
        gots.append(got[3])
    else:
        assert got[3].shape == (12, 0)
    for a_, b_ in zip(gots, wants):
        np.testing.assert_allclose(a_.double().numpy(), b_, rtol=0,
                                   atol=1e-5 * np.abs(b_).max())


def test_the_wrapper_checks_its_inputs():
    args = streams(3, 5, 4, 8, "lstm")
    xr, xin, hp, dsel, dg, dists = args
    with pytest.raises(ValueError, match="unsupported device"):
        K.pagg_contract(*(t.to("meta") for t in args))
    with pytest.raises(TypeError):
        K.pagg_contract(xr.double(), xin, hp, dsel, dg, dists)
    with pytest.raises(TypeError):
        K.pagg_contract(xr, xin, hp, dsel, dg, dists.long())
    with pytest.raises(ValueError):
        K.pagg_contract(xr, xin, hp, dsel[:, :-1], dg, dists)
    with pytest.raises(ValueError):
        K.pagg_contract(xr, xin, hp, dsel, dg[..., :-1], dists)
    with pytest.raises(ValueError):
        K.pagg_contract(xr, xin, hp, dsel, dg, dists[:-1])
    with pytest.raises(ValueError, match="contiguous"):
        K.pagg_contract(xr, xin.transpose(0, 1).contiguous().transpose(0, 1), hp, dsel, dg,
                        dists)
    with pytest.raises(ValueError):
        K.pagg_contract(xr, xin, hp, dsel, dg, dists, cell="rnn")
    with pytest.raises(ValueError):   # the MLP's mean input and d h_n are [B, H]
        K.pagg_contract(xr, xin, hp, dsel, dg, dists, cell="mlp")
    K.reset_launch_counts()
    K.pagg_contract(*args)
    assert K.launch_counts()["pagg_contract"] == 0   # the host counts no launch
    assert K.contractions is K.pagg_contract


def jax_encode(params, h, paths, dists, mask, keep, homo, cell):
    """The JAX encode block and readout (``pagg_forward``'s ``encode_block``
    with the attention readout, on the table ``h``) as a function of the
    params; returns ``h_agg [T, H]``."""
    import jax
    import jax.numpy as jnp
    from pathnet_tpu.models.pagg import _dist_select, _encode

    T, nw, wl = paths.shape
    H = h.shape[1]
    nei = h[paths]
    seq_in, d_in = (nei, dists) if homo else (jnp.flip(nei, 2), jnp.flip(dists, 2))
    sel = _dist_select(params, seq_in.reshape(-1, H), d_in.reshape(-1), wl,
                       mode="onehot").reshape(T, nw, wl, H)
    if homo:
        sel = jax.nn.relu(sel)
    ego = sel[:, :, 0, :] if homo else nei[:, :, 0, :]
    seq = jnp.where(mask, sel.reshape(T * nw, wl, H).transpose(1, 0, 2) / keep, 0.0)
    h_n = _encode(params, seq, cell).reshape(T, nw, H)
    score = jnp.concatenate([h_n, ego], axis=-1) @ params["attw"]["w"] + params["attw"]["b"]
    if homo:
        return jnp.mean((1.0 + score) * h_n, axis=1)
    return jnp.sum(jax.nn.softmax(jax.nn.leaky_relu(score), axis=1) * h_n, axis=1)


@pytest.mark.parametrize("wl", [4, 5, 7])
@pytest.mark.parametrize("homo", [False, True])
@pytest.mark.parametrize("cell", ["lstm", "gru", "mlp"])
def test_plain_contractions_match_jax_param_vjp(cell, homo, wl):
    """The plain stages' streams (recompute, attention backward, BPTT) into
    ``pagg_contract`` on the host: ``dwd``, ``dbd`` and the cell's weight and
    bias gradients within 1e-5 of the largest entry of ``jax.vjp`` of the
    JAX encode block in its params (the GRU's packed gradients unpacked)."""
    import jax
    import jax.numpy as jnp
    from pathnet_tpu.models import PaggSpec as JPaggSpec
    from pathnet_tpu.models import init_pagg_params
    from pathnet_tpu_torch.models import PaggSpec, PathNet, params_from_jax

    n, T, H = 60, 23, 16
    rng = np.random.default_rng(wl * 10 + 2 * int(homo) + len(cell))
    variant = "homo" if homo else "hetero"
    jspec = JPaggSpec(feat_dim=F, hidden=H, out_dim=C, walk_len=wl, rnn=cell, variant=variant)
    params = init_pagg_params(jax.random.PRNGKey(wl + int(homo)), jspec)
    spec = PaggSpec(feat_dim=F, hidden=H, out_dim=C, walk_len=wl, rnn=cell, variant=variant)
    model = PathNet(spec, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params), spec),
                          strict=True)
    h, w = model.encode_inputs(torch.from_numpy(rng.normal(size=(n, F)).astype(np.float32)))
    paths = rng.integers(0, n, size=(T, NW, wl)).astype(np.int32)
    dists = rng.integers(-1, wl + 1, size=(T, NW, wl)).astype(np.int32)
    mask = (rng.random((wl, T * NW, H)) < KEEP).astype(np.uint8)
    g = rng.normal(size=(T, H)).astype(np.float32)
    tp, td, tm, tg = (torch.from_numpy(a) for a in (paths, dists, mask, g))

    hn, xr, xin, hp, cs, gt, *ego = K.encode_walks_streams(h, tp, td, *w[:6], tm, KEEP, homo,
                                                           cell)
    ego = ego[0] if homo else None
    dhn, dego = K.attention_bwd(tg, h, tp, hn, *w[6:], ego)[:2]
    state = {"gru": hp, "mlp": None}.get(cell, cs)
    _, dgates, dsel = K.bptt(dhn, tp, td, w[0], w[2], w[3], state, gt, tm, KEEP,
                             (xin, ego, dego) if homo else None, cell)
    got = K.pagg_contract(xr, xin, hp, dsel, dhn if cell == "mlp" else dgates, td, homo,
                          cell)
    assert K.contractions_plain(xr, xin, hp, dsel, dhn if cell == "mlp" else dgates, td,
                                homo, cell)[0].equal(got[0])

    _, vjp = jax.vjp(lambda p: jax_encode(p, jnp.asarray(h.numpy()), jnp.asarray(paths),
                                          jnp.asarray(dists), jnp.asarray(mask.astype(bool)),
                                          KEEP, homo, cell), params)
    gp = vjp(jnp.asarray(g))[0]
    dwd, dbd, dw_ih, dw_hh, db = got
    if cell == "mlp":
        pairs = {"w": (dw_ih, gp["rnn"]["w"]), "b": (db, gp["rnn"]["b"])}
        assert dw_hh.shape == (H, 0)
    elif cell == "gru":
        un = unpack_gru(dw_ih, dw_hh, db, db)
        pairs = {k: (un[k], gp["rnn"][k]) for k in ("w_ih", "w_hh", "b_ih", "b_hh")}
    else:
        pairs = {k: (t, gp["rnn"][k]) for k, t in
                 (("w_ih", dw_ih), ("w_hh", dw_hh), ("b_ih", db), ("b_hh", db))}
    pairs.update(dwd=(dwd, gp["dist"]["w"]), dbd=(dbd, gp["dist"]["b"]))
    for name, (a, b) in pairs.items():
        b = np.asarray(b)
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-5 * np.abs(b).max(),
                                   err_msg=name)


def offset_views(args, floats=1):
    """``args``' float streams as contiguous views that start ``floats``
    floats into a buffer of their own (4 bytes past a 16-byte boundary for
    ``floats = 1``), with equal values."""
    out = []
    for t in args:
        if t.is_floating_point():
            buf = t.new_zeros(t.numel() + floats)
            buf[floats:] = t.reshape(-1)
            t = buf[floats:].view(t.shape)
        out.append(t)
    return out


@pytest.mark.parametrize("H, floats, route", [(64, 0, "tma"), (24, 0, "tma"), (18, 0, "cp.async"),
                                              (64, 1, "cp.async"), (64, 2, "cp.async"),
                                              (64, 4, "tma")])
def test_contract_route_follows_row_bytes_and_alignment(H, floats, route):
    """The kernel's staging is chosen from the shapes and the pointers: TMA
    where every stream starts at a 16-byte boundary and a row is a multiple
    of 16 bytes (H % 4 == 0), 4-byte cp.async otherwise; any stream decides."""
    args = streams(3, 5, 4, H, "lstm")
    xr, xin, hp, dsel, dg, _ = args
    base = [t for t in (xr, dsel, xin, hp, dg) if t.data_ptr() % 16 == 0]
    assert len(base) == 5   # torch's allocations are aligned
    moved = offset_views([xr, dsel, xin, hp, dg], floats) if floats else [xr, dsel, xin, hp, dg]
    assert all(a.equal(b) and a.is_contiguous() for a, b in zip(moved, base))
    assert K.contract_route(H, *moved) == route
    assert K.contract_route(H, moved[0], *base[1:]) == route   # one stream decides
    assert K.contract_route(H) == ("tma" if H % 4 == 0 else "cp.async")


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(8192, 40, 4, 64), (183, 40, 5, 64), (193, 40, 4, 256),
                                   (37, 7, 5, 24), (50, 3, 4, 18), (8192, 40, 4, 32),
                                   (37, 7, 6, 64), (37, 7, 7, 24), (40, 10, 11, 32)])
@pytest.mark.parametrize("homo", [False, True])
@pytest.mark.parametrize("cell", ["lstm", "mlp"])
def test_kernel_matches_plain_and_is_bit_equal_on_the_card(cuda, cell, homo, shape):
    """The kernel against the plain version run in float64 on the same
    streams (the GRU's contraction is the LSTM's): each gradient within
    1e-5 of its largest plain entry, class 2 of the small shapes empty
    (exact zeros), two calls bit-equal; H = 18 takes the 4-byte copies and
    ragged tiles, H = 32 (the Electronics band's width) runs at the bgp
    microbatch's rows; wl = 6, 7 and 11 take the classes in chunks of at
    most five (two and three chunks)."""
    T, nw, wl, H = shape
    args = streams(T, nw, wl, H, cell, seed=H, device=cuda,
                   empty_class=2 if T < 100 else None)
    K.reset_launch_counts()
    got = K.pagg_contract(*args, homo, cell)
    again = K.pagg_contract(*args, homo, cell)
    torch.cuda.synchronize()
    assert K.launch_counts()["pagg_contract"] == 2
    want = K.contractions_plain(*(t.double() if t.is_floating_point() else t for t in args),
                                homo, cell)
    for name, a, b, c in zip(NAMES, got, want, again):
        assert a.shape == b.shape, name
        assert torch.equal(a, c), name
        if b.numel():
            assert float((a.double() - b).abs().max()) <= 1e-5 * float(b.abs().max()), name
    if T < 100:
        assert not got[0][2].any() and not got[1][2].any()


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["lstm", "mlp"])
def test_kernel_on_unaligned_streams_takes_the_4_byte_copies(cuda, cell):
    """Streams that start 4 bytes past a 16-byte boundary (views into a
    buffer), which no tensor map describes: the wrapper routes them to the
    4-byte ``cp.async`` staging, held to the same 1e-5 of the float64 plain
    version and bit-equal on two calls and to the aligned streams' result."""
    args = streams(257, 40, 4, 64, cell, seed=7, device=cuda)
    moved = offset_views(args)
    present = moved[:4] + [moved[4]] if cell != "mlp" else [moved[0], moved[2], moved[3], moved[4]]
    assert K.contract_route(64, *present) == "cp.async"
    got = K.pagg_contract(*moved, False, cell)
    again = K.pagg_contract(*moved, False, cell)
    aligned = K.pagg_contract(*args, False, cell)
    want = K.contractions_plain(*(t.double() if t.is_floating_point() else t for t in args),
                                False, cell)
    torch.cuda.synchronize()
    for name, a, b, c, d in zip(NAMES, got, want, again, aligned):
        assert torch.equal(a, c), name
        if b.numel():
            assert float((a.double() - b).abs().max()) <= 1e-5 * float(b.abs().max()), name
            # the two stagings land the same values in the same layout
            assert torch.equal(a, d), name
