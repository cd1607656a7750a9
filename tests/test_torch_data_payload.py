"""Payload generation: the port's ``load_dataset`` against the JAX package's,
each making its payload from nothing in its own ``data_root``. Everything
here is exact: the generation is the same numpy in the same order, so every
array, dtype, mask and cache file must be equal."""
import os
import pickle

import numpy as np
import pytest
import scipy.sparse as sp

from pathnet_tpu.data import formats as jformats
from pathnet_tpu.data import registry as jreg
from pathnet_tpu.data import synthetic as jsyn

import chip_smoke
from pathnet_tpu_torch.data import Graph, formats, registry, synthetic

FIELDS = ("src", "dst", "prob", "features", "labels")
GENERATED = ("cornell", "Nba", "texas", "wisconsin", "chameleon")


@pytest.fixture(autouse=True)
def _clear_payload_caches():
    yield
    registry.clear_payload_cache()
    jreg.clear_payload_cache()


@pytest.fixture(scope="module")
def made(tmp_path_factory):
    """``{name: (port root, JAX root, port result, JAX result)}``, round 0,
    each payload made from nothing."""
    out = {}
    for name in GENERATED:
        mine = tmp_path_factory.mktemp(f"port_{name}")
        theirs = tmp_path_factory.mktemp(f"jax_{name}")
        out[name] = (mine, theirs, registry.load_dataset(name, str(mine), 0),
                     jreg.load_dataset(name, str(theirs), 0))
    registry.clear_payload_cache()
    jreg.clear_payload_cache()
    return out


def assert_same_graph(a, b):
    assert a.n == b.n
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y), f


@pytest.mark.parametrize("name", GENERATED)
def test_generated_payload_equals_jax(made, name):
    _, _, got, want = made[name]
    assert_same_graph(got[0], want[0])
    for a, b in zip(got[1:4], want[1:4]):
        assert np.array_equal(a, b)
    for f in FIELDS:
        assert not getattr(got[0], f).flags.writeable, f


@pytest.mark.parametrize("name", GENERATED)
def test_cache_files_have_the_same_name_and_arrays(made, name):
    mine, theirs, _, _ = made[name]
    fp = registry.payload_fingerprint(registry.DATASETS[name])
    fname = f"{name}.{fp}.npz"
    assert os.listdir(mine / "payload_cache") == [fname]
    assert os.listdir(theirs / "payload_cache") == [fname]
    a, b = np.load(mine / "payload_cache" / fname), np.load(theirs / "payload_cache" / fname)
    assert sorted(a.files) == sorted(b.files) == ["dst", "n", "prob", "src", "x", "y"]
    for k in a.files:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("name", GENERATED)
def test_each_package_reads_the_others_cache(made, name):
    mine, theirs, got, want = made[name]
    registry.clear_payload_cache()
    jreg.clear_payload_cache()
    assert_same_graph(registry.load_dataset(name, str(theirs), 0)[0], want[0])
    assert_same_graph(jreg.load_dataset(name, str(mine), 0)[0], got[0])


@pytest.mark.parametrize("round_i", [1, 2])
@pytest.mark.parametrize("name", ["cornell", "Nba", "chameleon"])
def test_later_rounds_masks_equal_jax(made, name, round_i):
    mine, theirs, _, _ = made[name]
    got = registry.load_dataset(name, str(mine), round_i)
    want = jreg.load_dataset(name, str(theirs), round_i)
    for a, b in zip(got[1:4], want[1:4]):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("name", ["cornell", "Nba"])
def test_pinned_digests_are_the_jax_payloads(made, name):
    """The digests ``chip_smoke.py`` holds the card's payloads to."""
    g = made[name][3][0]
    assert {f: chip_smoke.array_sha256(getattr(g, f)) for f in FIELDS} == \
        chip_smoke.PAYLOAD_SHA256[name]


def test_array_digest_sees_dtype_shape_and_bytes():
    a = np.arange(6, dtype=np.int32)
    d = chip_smoke.array_sha256(a)
    assert d == chip_smoke.array_sha256(a.copy())
    assert d != chip_smoke.array_sha256(a.astype(np.int64))
    assert d != chip_smoke.array_sha256(a.reshape(2, 3))
    b = a.copy()
    b[5] = 7
    assert d != chip_smoke.array_sha256(b)


@pytest.mark.parametrize("name", ["texas", "chameleon", "bgp"])
def test_sbm_structure_equals_jax(name):
    if name == "bgp":   # n = 63,977: compare the generator at a tenth of the scale
        spec = registry.DATASETS[name]
        kw = dict(signal=spec.signal, structure=spec.structure, seed=registry._stable_seed(name),
                  offdiag=spec.offdiag, label_noise=spec.label_noise,
                  pattern_frac=spec.pattern_frac, bit_smooth=spec.bit_smooth)
        args = (6397, spec.avg_deg, spec.num_classes, spec.homophily, spec.feat_dim)
        got, want = synthetic.synthetic_graph(*args, **kw), jsyn.synthetic_graph(*args, **kw)
    else:
        got, want = registry.load_structure(name, "."), jreg.load_structure(name, ".")
    assert_same_graph(got, want)


@pytest.mark.parametrize("name", ["Nba", "cora", "citeseer", "cornell"])
def test_structure_of_edge_files_equals_jax(name):
    """Nba, cora and citeseer carry broken columns and take the MERW repair;
    cornell's column is valid and read as it is."""
    got, want = registry.load_structure(name), jreg.load_structure(name)
    assert got.n == want.n
    for f in ("src", "dst", "prob"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert (got.prob > 0).all()
    raw = Graph.from_edge_input(os.path.join(os.path.dirname(__file__), "..", "data",
                                             "edge_input", registry.DATASETS[name].edge_file))
    assert np.array_equal(got.prob, raw.prob) == (name == "cornell")


@pytest.mark.parametrize("kind", ["xor", "raw"])
@pytest.mark.parametrize("with_prob", [False, True])
def test_pattern_channel_equals_jax(kind, with_prob):
    g = Graph.from_edge_input(os.path.join(os.path.dirname(__file__), "..", "data",
                                           "edge_input", "cornell.in"))
    rng = np.random.default_rng(3)
    y = rng.integers(0, 5, size=g.n)
    x = rng.normal(size=(g.n, 12)).astype(np.float32)
    prob = g.prob if with_prob else None
    args = (g.src, g.dst, g.n, y, x, 5, 0.3, 2, 11, kind)
    got = synthetic.apply_pattern_channel(*args, prob=prob, pattern_balance="class")
    want = jsyn.apply_pattern_channel(*args, prob=prob, pattern_balance="class")
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("C,offdiag", [(2, "shift"), (5, "matching"), (6, "matching"),
                                       (7, "shift")])
def test_compat_matrix_and_field_homophily_equal_jax(C, offdiag):
    assert np.array_equal(synthetic.compat_matrix(C, 0.3, 0.8, offdiag),
                          jsyn.compat_matrix(C, 0.3, 0.8, offdiag))
    assert synthetic.field_homophily_for(0.3, 0.4, C) == jsyn.field_homophily_for(0.3, 0.4, C)


def write_planetoid(root, name, n_train=3, n_test=4, f=5, c=3, gap=True):
    """A tiny Kipf-style pickle set: ``n_train`` labelled, a few unlabelled
    and ``n_test`` test nodes (one missing from the test index when ``gap``,
    as citeseer's isolated nodes are)."""
    rng = np.random.default_rng(0)
    n_all = n_train + 2
    test_ids = np.arange(n_all, n_all + n_test + (1 if gap else 0))
    if gap:
        test_ids = np.delete(test_ids, 1)
    n = int(test_ids.max()) + 1
    onehot = lambda k: np.eye(c)[rng.integers(0, c, size=k)]
    objs = {
        "x": sp.csr_matrix(rng.random((n_train, f))), "y": onehot(n_train),
        "tx": sp.csr_matrix(rng.random((len(test_ids), f))), "ty": onehot(len(test_ids)),
        "allx": sp.csr_matrix(rng.random((n_all, f))), "ally": onehot(n_all),
        "graph": {u: [int(v) for v in rng.choice(n, size=2, replace=False)] for u in range(n)},
    }
    for k, v in objs.items():
        with open(root / f"ind.{name}.{k}", "wb") as fh:
            pickle.dump(v, fh)
    with open(root / f"ind.{name}.test.index", "w") as fh:
        fh.write("\n".join(str(int(i)) for i in rng.permutation(test_ids)) + "\n")
    return n


@pytest.mark.parametrize("gap", [False, True])
@pytest.mark.parametrize("val_size", [None, 1])
def test_planetoid_reader_equals_jax(tmp_path, gap, val_size):
    write_planetoid(tmp_path, "tiny", gap=gap)
    got = formats.load_planetoid("ind.tiny", str(tmp_path), val_size)
    want = jformats.load_planetoid("ind.tiny", str(tmp_path), val_size)
    assert set(got) == set(want)
    for k in got:
        a, b = got[k], want[k]
        if sp.issparse(a):
            assert (a != b).nnz == 0 and a.shape == b.shape, k
        else:
            assert a.dtype == b.dtype and np.array_equal(a, b), k


def test_npy_reader_equals_jax(tmp_path):
    d = tmp_path / "Nba"
    d.mkdir()
    rng = np.random.default_rng(0)
    np.save(d / "x.npy", rng.normal(size=(6, 3)))
    np.save(d / "y.npy", rng.integers(0, 2, size=6).astype(np.int32))
    np.save(d / "edge_index.npy", np.array([[0, 1, 2], [1, 2, 3]]))
    got = formats.load_npy_dataset(str(tmp_path), "Nba")
    want = jformats.load_npy_dataset(str(tmp_path), "Nba")
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    os.remove(d / "edge_index.npy")
    assert formats.load_npy_dataset(str(tmp_path), "Nba")[2] is None
    g = Graph.from_edge_index(4, got[2])
    assert g.src.dtype == np.int32 and np.array_equal(g.prob, np.ones(3))


def write_edge_file(root, fname, n, edges):
    """An edge-input file whose probability column is a uniform walk (valid
    rows, so no MERW repair)."""
    (root / "edge_input").mkdir(exist_ok=True)
    deg = np.bincount([u for u, _ in edges], minlength=n)
    with open(root / "edge_input" / fname, "w") as fh:
        fh.write(f"{n} {len(edges)}\n")
        for u, v in edges:
            fh.write(f"{u} {v} {1.0 / deg[u]}\n")


def ring(n):
    return [(u, (u + d) % n) for u in range(n) for d in (1, n - 1)]


def test_load_dataset_reads_planetoid_payloads_with_their_fixed_masks(tmp_path):
    (tmp_path / "planetoid").mkdir()
    n = write_planetoid(tmp_path / "planetoid", "cora", gap=False)
    write_edge_file(tmp_path, "cora_nsl.in", n, ring(n))
    got = registry.load_dataset("cora", str(tmp_path), 3)
    want = jreg.load_dataset("cora", str(tmp_path), 3)
    assert_same_graph(got[0], want[0])
    for a, b in zip(got[1:4], want[1:4]):
        assert np.array_equal(a, b)
    pl = formats.load_planetoid("ind.cora", str(tmp_path / "planetoid"), 1019)
    assert np.array_equal(got[1], pl["train_mask"]) and np.array_equal(got[3], pl["test_mask"])
    assert not (tmp_path / "payload_cache").exists()


def test_load_dataset_reads_npy_payloads(tmp_path):
    n = 40
    write_edge_file(tmp_path, "Nba.in", n, ring(n))
    d = tmp_path / "other_data" / "Nba"
    d.mkdir(parents=True)
    rng = np.random.default_rng(1)
    np.save(d / "x.npy", rng.normal(size=(n, 4)).astype(np.float32))
    np.save(d / "y.npy", rng.integers(0, 2, size=n))
    got = registry.load_dataset("Nba", str(tmp_path), 1)
    want = jreg.load_dataset("Nba", str(tmp_path), 1)
    assert_same_graph(got[0], want[0])
    for a, b in zip(got[1:4], want[1:4]):
        assert np.array_equal(a, b)


def test_load_dataset_reads_geomgcn_files(tmp_path):
    d = tmp_path / "geomgcn" / "texas"
    d.mkdir(parents=True)
    rng = np.random.default_rng(2)
    n = 12
    with open(d / "out1_node_feature_label.txt", "w") as fh:
        fh.write("node_id\tfeature\tlabel\n")
        for i in range(n):
            feat = ",".join(str(int(v)) for v in rng.integers(0, 2, size=6))
            fh.write(f"{i}\t{feat}\t{int(rng.integers(0, 5))}\n")
    with open(d / "out1_graph_edges.txt", "w") as fh:
        fh.write("node_id\tnode_id\n")
        for u, v in ring(n)[::2]:
            fh.write(f"{u}\t{v}\n")
    got = registry.load_dataset("texas", str(tmp_path), 0)
    want = jreg.load_dataset("texas", str(tmp_path), 0)
    assert_same_graph(got[0], want[0])
    for a, b in zip(got[1:4], want[1:4]):
        assert np.array_equal(a, b)
    adj, x, y = formats.load_geomgcn(str(d / "out1_graph_edges.txt"),
                                     str(d / "out1_node_feature_label.txt"))
    assert (adj != adj.T).nnz == 0 and x.shape == (n, 6) and np.array_equal(got[0].labels, y)
