"""K3's two stages (the encode to ``h_n`` and the attention readout) against
the whole encode and against the JAX package's encode block.

On the host each stage wrapper takes its plain version; their composition is
what ``pagg_encode_fwd`` launches on a card. The JAX reference is built from
the JAX package's own ``_dist_select`` (its default "onehot" form) and
``_encode``, with the hetero attention readout of ``pagg_forward``
(``pathnet_tpu/models/pagg.py:235-303``) and the same keep mask.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathnet_tpu.data import Graph as JGraph
from pathnet_tpu.models import PaggSpec as JPaggSpec
from pathnet_tpu.models import init_pagg_params
from pathnet_tpu.models.pagg import _dist_select, _encode
from pathnet_tpu.sample import PathSampler as JPathSampler

from pathnet_tpu_torch import kernels as K
from pathnet_tpu_torch.models import PaggSpec, PathNet, params_from_jax

ROOT = os.path.join(os.path.dirname(__file__), "..")
CORNELL = os.path.join(ROOT, "data", "edge_input", "cornell.in")
F, C, NW, WL, KEEP = 24, 5, 6, 4, 0.3


@pytest.fixture(scope="module")
def cornell():
    return JGraph.from_edge_input(CORNELL)


def jax_encode(params, h, paths, dists, mask, keep):
    """h_agg [T, H] of the hetero / LSTM / attention encode, in JAX."""
    T, nw, wl = paths.shape
    H = h.shape[1]
    nei = h[paths]
    sel = _dist_select(params, jnp.flip(nei, 2).reshape(-1, H),
                       jnp.flip(dists, 2).reshape(-1), wl, mode="onehot")
    seq = sel.reshape(T * nw, wl, H).transpose(1, 0, 2)
    if mask is not None:
        seq = jnp.where(mask, seq / keep, 0.0)
    h_n = _encode(params, seq, "lstm").reshape(T, nw, H)
    score = (jnp.concatenate([h_n, nei[:, :, 0, :]], axis=-1) @ params["attw"]["w"]
             + params["attw"]["b"])
    att = jax.nn.softmax(jax.nn.leaky_relu(score), axis=1)
    return jnp.sum(att * h_n, axis=1)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("H", [16, 64])
def test_stages_compose_to_the_encode_and_to_jax(cornell, H, masked):
    rng = np.random.default_rng(H)
    X = rng.normal(size=(cornell.n, F)).astype(np.float32)
    paths, dists = JPathSampler.build(cornell, NW, WL).sample(jax.random.PRNGKey(H))
    paths, dists = np.array(paths), np.array(dists)
    T = paths.shape[0]
    mask = (rng.random((WL, T * NW, H)) < KEEP).astype(np.uint8) if masked else None
    keep = KEEP if masked else 1.0
    jspec = JPaggSpec(feat_dim=F, hidden=H, out_dim=C, walk_len=WL)
    params = init_pagg_params(jax.random.PRNGKey(H + 1), jspec)
    spec = PaggSpec(feat_dim=F, hidden=H, out_dim=C, walk_len=WL)
    model = PathNet(spec, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                         spec), strict=True)
    h, w = model.encode_inputs(torch.from_numpy(X))
    tp, td = torch.from_numpy(paths), torch.from_numpy(dists)
    tm = None if mask is None else torch.from_numpy(mask)

    K.reset_launch_counts()
    hn = K.encode_walks(h, tp, td, *w[:6], tm, keep)
    assert hn.shape == (T * NW, H)
    got = K.readout(h, tp, hn, *w[6:])
    assert all(c == 0 for c in K.launch_counts().values())
    assert torch.equal(got, K.pagg_encode_fwd_plain(h, tp, td, *w, tm, keep))

    jh = jnp.asarray(X) @ params["fc0"]["w"] + params["fc0"]["b"]
    want = jax_encode(params, jh, jnp.asarray(paths), jnp.asarray(dists),
                      None if mask is None else jnp.asarray(mask.astype(bool)), keep)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_stage_wrappers_reject_bad_inputs():
    gen = torch.Generator().manual_seed(0)
    T, nw, wl, H, n = 3, 2, 3, 8, 10
    h = torch.randn((n, H), generator=gen)
    paths = torch.randint(0, n, (T, nw, wl), generator=gen, dtype=torch.int32)
    dists = torch.zeros_like(paths)
    w = (torch.zeros(wl, H, H), torch.zeros(wl, H), torch.zeros(H, 4 * H),
         torch.zeros(H, 4 * H), torch.zeros(4 * H), torch.zeros(4 * H))
    hn = K.encode_walks(h, paths, dists, *w)
    with pytest.raises(ValueError):
        K.encode_walks(h, paths, dists[:, :, :-1].contiguous(), *w)
    with pytest.raises(ValueError):
        K.readout(h, paths, hn[:-1], torch.zeros(2 * H), torch.zeros(1))
    with pytest.raises(TypeError):
        K.readout(h, paths, hn.double(), torch.zeros(2 * H), torch.zeros(1))
    with pytest.raises(ValueError):
        K.encode_walks(h.to("meta"), paths.to("meta"), dists.to("meta"),
                       *(t.to("meta") for t in w))
