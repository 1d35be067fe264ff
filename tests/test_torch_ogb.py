"""The port's OGB loader (``graphnets_tpu_torch/data/ogb.py``) against the
JAX package's: datasets written by either package's
``save_ogb_node_dataset`` load bit-equal through both loaders, gzipped and
plain, directed and made undirected; a missing dataset raises; the loaded
graph feeds the port's sampler, batch for batch as JAX's feeds its own.
The datasets are synthetic, written into a temporary directory."""

import numpy as np
import pytest

import graphnets_tpu_torch as pt
from graphnets_tpu.data import large_graph as j_lg
from graphnets_tpu.data import ogb as j_ogb
from graphnets_tpu_torch.data import ogb


def _data(n=70, e=400, d=6, n_classes=4, seed=0):
    rng = np.random.default_rng(seed)
    senders = rng.integers(0, n, e)
    receivers = rng.integers(0, n, e)
    feat = rng.normal(size=(n, d)).astype(np.float32)
    labels = rng.integers(0, n_classes, n)
    ids = rng.permutation(n)
    splits = {"train": ids[: n // 2], "valid": ids[n // 2: 3 * n // 4],
              "test": ids[3 * n // 4:]}
    return senders, receivers, feat, labels, splits


def _same(a, b):
    assert a.name == b.name and a.num_classes == b.num_classes
    np.testing.assert_array_equal(a.graph.indptr, b.graph.indptr)
    np.testing.assert_array_equal(a.graph.src, b.graph.src)
    np.testing.assert_array_equal(a.graph.node_feat, b.graph.node_feat)
    np.testing.assert_array_equal(a.graph.labels, b.graph.labels)
    assert sorted(a.splits) == sorted(b.splits)
    for k in a.splits:
        np.testing.assert_array_equal(a.splits[k], b.splits[k])


@pytest.mark.parametrize("undirected", [False, True])
@pytest.mark.parametrize("compress", [True, False])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_roundtrip_both_ways(tmp_path, writer, compress, undirected):
    senders, receivers, feat, labels, splits = _data()
    save = (ogb if writer == "port" else j_ogb).save_ogb_node_dataset
    d = save(str(tmp_path), "ogbn-tiny", senders, receivers, feat, labels,
             splits, compress=compress)
    assert d.endswith("ogbn_tiny")
    mine = ogb.load_ogb_node_dataset(str(tmp_path), "ogbn-tiny",
                                     make_undirected=undirected)
    theirs = j_ogb.load_ogb_node_dataset(str(tmp_path), "ogbn-tiny",
                                         make_undirected=undirected)
    _same(mine, theirs)
    assert isinstance(mine.graph, pt.LargeGraph)
    assert mine.num_nodes == len(feat)
    np.testing.assert_allclose(mine.graph.node_feat, feat, rtol=1e-6)
    if not undirected:
        assert mine.num_edges == len(senders)
        recon = sorted((int(s), v) for v in range(mine.num_nodes)
                       for s in mine.graph.src[mine.graph.indptr[v]:
                                               mine.graph.indptr[v + 1]])
        assert recon == sorted(zip(senders.tolist(), receivers.tolist()))
    else:
        both = np.stack([np.concatenate([senders, receivers]),
                         np.concatenate([receivers, senders])], axis=1)
        assert mine.num_edges == len(np.unique(both, axis=0))


def test_label_sentinels_and_split_schemes(tmp_path):
    """Unlabelled nodes (-1) stay -1 and do not count as a class; a second
    split scheme must be named."""
    senders, receivers, feat, labels, splits = _data(seed=1)
    labels[::5] = -1
    ogb.save_ogb_node_dataset(str(tmp_path), "ogbn-tiny", senders,
                              receivers, feat, labels, splits,
                              split_scheme="a")
    ogb.save_ogb_node_dataset(str(tmp_path), "ogbn-tiny", senders,
                              receivers, feat, labels, {"train": splits[
                                  "train"][:5]}, split_scheme="b")
    with pytest.raises(ValueError, match="split_scheme"):
        ogb.load_ogb_node_dataset(str(tmp_path), "ogbn-tiny")
    mine = ogb.load_ogb_node_dataset(str(tmp_path), "ogbn-tiny",
                                     split_scheme="b")
    theirs = j_ogb.load_ogb_node_dataset(str(tmp_path), "ogbn-tiny",
                                         split_scheme="b")
    _same(mine, theirs)
    assert (mine.graph.labels[::5] == -1).all()
    assert mine.num_classes == labels.max() + 1
    assert list(mine.splits) == ["train"] and len(mine.splits["train"]) == 5


def test_missing_dataset_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="ogbn-absent"):
        ogb.load_ogb_node_dataset(str(tmp_path), "ogbn-absent")


def test_out_of_range_edge_raises(tmp_path):
    senders, receivers, feat, labels, splits = _data(seed=2)
    senders[3] = len(feat) + 4
    ogb.save_ogb_node_dataset(str(tmp_path), "ogbn-tiny", senders,
                              receivers, feat, labels, splits)
    with pytest.raises(ValueError, match="out of range"):
        ogb.load_ogb_node_dataset(str(tmp_path), "ogbn-tiny")


@pytest.mark.parametrize("emit_node_ids", [False, True])
def test_feeds_the_sampler_as_jax(tmp_path, emit_node_ids):
    """A loaded dataset feeds the port's sampler; its batches are those of
    JAX's sampler on JAX's load of the same files."""
    senders, receivers, feat, labels, splits = _data(n=120, e=900, seed=3)
    ogb.save_ogb_node_dataset(str(tmp_path), "ogbn-tiny", senders,
                              receivers, feat, labels, splits)
    mine = ogb.load_ogb_node_dataset(str(tmp_path), "ogbn-tiny")
    theirs = j_ogb.load_ogb_node_dataset(str(tmp_path), "ogbn-tiny")
    kw = dict(fanouts=(4, 3), batch_size=16, seed=1,
              emit_node_ids=emit_node_ids)
    seeds = mine.splits["train"][:16]
    bp = pt.NeighborSampler(mine.graph, device="cpu", **kw).sample(seeds)
    bj = j_lg.NeighborSampler(theirs.graph, **kw).sample(seeds)
    assert int(bp.label_mask.sum()) == 16
    np.testing.assert_array_equal(bp.labels.numpy(), np.asarray(bj.labels))
    np.testing.assert_array_equal(bp.graph.senders.numpy(),
                                  np.asarray(bj.graph.senders))
    if emit_node_ids:
        np.testing.assert_array_equal(bp.node_ids.numpy(),
                                      np.asarray(bj.node_ids))
    else:
        np.testing.assert_array_equal(bp.graph.nf.numpy(),
                                      np.asarray(bj.graph.nf))
