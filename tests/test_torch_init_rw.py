"""The port's ``init_rw`` CLI against the JAX package's steps as
``pathnet_tpu/init_rw.py:49-55`` runs them (``load_structure``, ``merw_graph``
with unit record weights, ``write_edge_input``), each into its own directory:
the header and the (u, v) records equal, the probabilities within 5e-5 (two
f32 power iterations from different start vectors). cora is disconnected and
both packages take one global eigenvector, as the reference does: where psi
underflows to 0 on a minor component a probability is NaN, in either package
on its own iteration's nodes, so the probabilities are compared where both
are finite and every NaN must lie outside the largest component."""
import os

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.csgraph as csgraph
import torch

from pathnet_tpu.data.formats import write_edge_input as j_write_edge_input
from pathnet_tpu.data.registry import load_structure as j_load_structure
from pathnet_tpu.merw import merw_graph as j_merw_graph

from pathnet_tpu_torch import init_rw
from pathnet_tpu_torch.data import read_edge_input

ROOT = os.path.join(os.path.dirname(__file__), "..")
DATA = os.path.join(ROOT, "data")
PROB_TOL = 5e-5


def outside_largest_component(n, src, dst):
    a = sp.csr_matrix((np.ones(len(src)), (src, dst)), shape=(n, n))
    _, lab = csgraph.connected_components(a, directed=False)
    return lab != np.bincount(lab).argmax()


@pytest.mark.parametrize("name", ["cornell", "cora"])
def test_init_rw_cli_equals_jax(tmp_path, name):
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    paths = init_rw.main(["-data", name, "--data-root", DATA, "--out", str(port_dir),
                          "--device", "cpu"])
    assert paths == [str(port_dir / f"{name}_nsl.in")]
    g = j_load_structure(name, DATA)
    gm = j_merw_graph(g, weights=np.ones(len(g.src)))
    os.makedirs(jax_dir)
    j_write_edge_input(str(jax_dir / f"{name}_nsl.in"), gm.n, gm.src, gm.dst, gm.prob)
    got_text = (port_dir / f"{name}_nsl.in").read_text().splitlines()
    want_text = (jax_dir / f"{name}_nsl.in").read_text().splitlines()
    assert got_text[0] == want_text[0] and len(got_text) == len(want_text)
    n, src, dst, p = read_edge_input(str(port_dir / f"{name}_nsl.in"))
    jn, jsrc, jdst, jp = read_edge_input(str(jax_dir / f"{name}_nsl.in"))
    assert n == jn and np.array_equal(src, jsrc) and np.array_equal(dst, jdst)
    both = np.isfinite(p) & np.isfinite(jp)
    assert float(np.abs(p[both] - jp[both]).max()) <= PROB_TOL
    minor = outside_largest_component(n, src, dst)
    for probs in (p, jp):
        assert not np.isinf(probs).any()
        assert minor[src[np.isnan(probs)]].all()
    if name == "cornell":
        assert both.all()
        rows = np.bincount(src, weights=p, minlength=n)
        assert np.abs(rows[rows > 0] - np.round(rows[rows > 0])).max() < 1e-4


def test_init_rw_writes_beside_the_tracked_edge_files_by_default(tmp_path):
    root = tmp_path / "data"
    paths = init_rw.main(["-data", "cornell", "-data", "texas", "--data-root", str(root),
                          "--device", "cpu"])
    assert paths == [str(root / "edge_input_torch" / f"{n}_nsl.in") for n in ("cornell", "texas")]
    assert all(os.path.isfile(p) for p in paths)
    assert not (root / "edge_input").exists()


def test_init_rw_defaults_to_the_card_and_raises_without_one(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_rw.main(["-data", "cornell", "--data-root", DATA, "--out", str(tmp_path)])
