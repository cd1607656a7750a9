"""``segment_sum``, the scatter-add of the gather VJP that K4 hands its row
gradients to, against JAX's: ``jax.vjp`` of the row gather ``h[idx]`` (the
gather of ``pathnet_tpu/models/pagg.py``, whose VJP XLA makes a scatter-add,
``:83-93``), on inputs made with numpy from a seed.

On the host ``segment_sum`` is its plain version: the port's grouping
(``segments``) written in torch, then ``index_add_`` in that order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathnet_tpu_torch import kernels as K
from pathnet_tpu_torch.kernels.segment_sum import segments, unit_rows

N, H = 300, 16


def gather_ids(kind, rng):
    """int32 node ids: uniform, or K4's layout of a microbatch (runs of nw
    position-0 and ego rows a target, the last targets padding at node 0)."""
    if kind == "uniform ids":
        return rng.integers(0, N, size=3000).astype(np.int32)
    T, nw, wl, pad = 24, 6, 4, 5
    paths = rng.integers(0, N, size=(T, nw, wl)).astype(np.int32)
    paths[:, :, 0] = rng.permutation(np.arange(1, N))[:T, None]
    paths[T - pad:, :, 0] = 0
    return K.row_nodes(torch.from_numpy(paths)).numpy()


@pytest.mark.parametrize("kind", ["uniform ids", "K4's layout with padding"])
def test_segment_sum_equals_jax_gather_vjp(kind):
    rng = np.random.default_rng(len(kind))
    idx = gather_ids(kind, rng)
    h = rng.standard_normal((N, H)).astype(np.float32)
    g = rng.standard_normal((idx.shape[0], H)).astype(np.float32)
    _, vjp = jax.vjp(lambda t: t[jnp.asarray(idx)], jnp.asarray(h))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    index = torch.from_numpy(idx)
    got = K.segment_sum(torch.from_numpy(g), index, N)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    # the grouping visits every row once, each node's rows in row order
    order = unit_rows(*segments(index, N))
    assert torch.equal(order, torch.sort(index, stable=True).indices)
