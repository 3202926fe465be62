"""The port's on-disk dataset readers and multilabel path against the JAX
package's, on the CPU.

No dataset is in the repo, so every reader reads a fixture this module
writes in the libraries' on-disk layout (as tests/test_dataset_loaders.py
does): DGL's Reddit npz files with the graph in scipy's csr, csc and coo
save_npz layouts; GraphSAINT's Yelp files; OGB's csv variant and its
binary (papers100M) variant with NaN labels. Each port reader, and the
port's load_data over it (canonical form; Yelp's features standard-scaled
on the train rows), must give the JAX package's graph array for array.

The multilabel path: bce_sum against the JAX package's (1e-6), the port's
multilabel synthetic graph against the JAX generator's, the multilabel
artifacts' labels ([P, pad_inner, C] f32), a multilabel P=1 run through
the entry point on the Yelp fixture (the micro-F1 lines), and its eval on
the ranks' forward printing the host eval's micro-F1. The P=4
multilabel loss curve against the JAX package's is in test_torch_dist.py's
module fixture.
"""

import gzip
import json

import numpy as np
import pytest
import torch

from bnsgcn_tpu.config import Config as JConfig
from bnsgcn_tpu.data import disk_readers as j_readers
from bnsgcn_tpu.data.datasets import load_data as j_load_data
from bnsgcn_tpu_torch import main as t_main
from bnsgcn_tpu_torch.config import Config
from bnsgcn_tpu_torch.data import disk_readers
from bnsgcn_tpu_torch.data.datasets import load_data

FIELDS = ("n_nodes", "src", "dst", "feat", "label", "train_mask", "val_mask",
          "test_mask", "multilabel")


def _same_graph(got, want):
    for k in FIELDS:
        a, b = getattr(got, k), getattr(want, k)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def _write_sparse(path, n, src, dst, fmt):
    """scipy.sparse.save_npz's layout of the [n, n] adjacency (src row, dst
    column) in `fmt`, written without scipy."""
    src, dst = np.asarray(src, np.int64), np.asarray(dst, np.int64)
    if fmt == "coo":
        np.savez(path, format=np.bytes_("coo"), shape=np.array([n, n]),
                 data=np.ones(len(src)), row=src.astype(np.int32),
                 col=dst.astype(np.int32))
        return
    major, minor = (src, dst) if fmt == "csr" else (dst, src)
    order = np.argsort(major, kind="stable")
    indptr = np.concatenate([[0], np.cumsum(np.bincount(major,
                                                        minlength=n))])
    np.savez(path, format=np.bytes_(fmt), shape=np.array([n, n]),
             data=np.ones(len(src)), indices=minor[order].astype(np.int32),
             indptr=indptr.astype(np.int32))


def _reddit(tmp, fmt, seed=3):
    rng = np.random.default_rng(seed)
    n, e = 40, 160
    d = tmp / "reddit"
    d.mkdir()
    types = rng.integers(1, 4, n)
    np.savez(d / "reddit_data.npz",
             feature=rng.normal(size=(n, 6)).astype(np.float64),
             label=rng.integers(0, 5, n).astype(np.int32), node_types=types)
    _write_sparse(d / "reddit_graph.npz", n, rng.integers(0, n, e),
                  rng.integers(0, n, e), fmt)


def _yelp(tmp, seed=4, n=30, e=90, c=4, f=5):
    rng = np.random.default_rng(seed)
    d = tmp / "yelp"
    d.mkdir()
    _write_sparse(d / "adj_full.npz", n, rng.integers(0, n, e),
                  rng.integers(0, n, e), "csr")
    np.save(d / "feats.npy", (rng.normal(size=(n, f)) * 2 + 1))
    cmap = {str(i): (rng.random(c) < 0.4).astype(int).tolist()
            for i in rng.permutation(n)}
    (d / "class_map.json").write_text(json.dumps(cmap))
    ids = rng.permutation(n)
    k1, k2 = int(0.6 * n), int(0.8 * n)
    (d / "role.json").write_text(json.dumps(
        {"tr": ids[:k1].tolist(), "va": ids[k1:k2].tolist(),
         "te": ids[k2:].tolist()}))


def _ogb_csv(tmp, seed=5):
    rng = np.random.default_rng(seed)
    n, e = 25, 70
    d = tmp / "ogbn_products"
    (d / "raw").mkdir(parents=True)
    sd = d / "split" / "sales_ranking"
    sd.mkdir(parents=True)

    def wgz(path, arr, fmt):
        with gzip.open(path, "wt") as f:
            np.savetxt(f, arr, delimiter=",", fmt=fmt)

    wgz(d / "raw" / "edge.csv.gz",
        np.stack([rng.integers(0, n, e), rng.integers(0, n, e)], 1), "%d")
    wgz(d / "raw" / "node-feat.csv.gz",
        rng.normal(size=(n, 4)).astype(np.float32), "%.6f")
    wgz(d / "raw" / "node-label.csv.gz", rng.integers(0, 3, size=(n, 1)),
        "%d")
    ids = rng.permutation(n)
    wgz(sd / "train.csv.gz", ids[:15].reshape(-1, 1), "%d")
    wgz(sd / "valid.csv.gz", ids[15:20].reshape(-1, 1), "%d")
    wgz(sd / "test.csv.gz", ids[20:].reshape(-1, 1), "%d")


def _ogb_binary(tmp, seed=6):
    rng = np.random.default_rng(seed)
    n, e = 20, 50
    d = tmp / "ogbn_papers100M"
    (d / "raw").mkdir(parents=True)
    sd = d / "split" / "time"
    sd.mkdir(parents=True)
    np.savez(d / "raw" / "data.npz",
             edge_index=np.stack([rng.integers(0, n, e),
                                  rng.integers(0, n, e)]),
             node_feat=rng.normal(size=(n, 4)).astype(np.float32),
             num_nodes_list=np.array([n]))
    lab = rng.integers(0, 3, n).astype(np.float64)
    lab[10:] = np.nan
    np.savez(d / "raw" / "node-label.npz", node_label=lab)
    np.savez(sd / "train.npz", ids=np.arange(0, 6))
    np.savez(sd / "valid.npz", ids=np.arange(6, 8))
    np.savez(sd / "test.npz", ids=np.arange(8, 10))


@pytest.mark.parametrize("fmt", ["csr", "csc", "coo"])
def test_reddit_reader_matches_jax(tmp_path, fmt):
    """DGL's Reddit layout, the graph in each save_npz format: the reader
    and load_data (canonical form) array-equal to the JAX package's."""
    _reddit(tmp_path, fmt)
    got = disk_readers.load_reddit_npz(str(tmp_path))
    _same_graph(got, j_readers.load_reddit_npz(str(tmp_path)))
    assert got.feat.dtype == np.float32 and got.label.dtype == np.int64
    g, n_feat, n_class = load_data(Config(dataset="reddit",
                                          data_path=str(tmp_path)))
    g_j, n_feat_j, n_class_j = j_load_data(JConfig(dataset="reddit",
                                                   data_path=str(tmp_path)))
    _same_graph(g, g_j)
    assert (n_feat, n_class) == (n_feat_j, n_class_j) == (6, 5)
    assert np.sum(g.src == g.dst) == g.n_nodes


def test_sparse_npz_formats_agree(tmp_path):
    """The csr, csc and coo files of one adjacency give the same edge set,
    in the order each layout stores it."""
    rng = np.random.default_rng(0)
    n, src, dst = 12, rng.integers(0, 12, 30), rng.integers(0, 12, 30)
    edges = {}
    for fmt in ("csr", "csc", "coo"):
        path = tmp_path / f"{fmt}.npz"
        _write_sparse(path, n, src, dst, fmt)
        s, d, m = disk_readers._sparse_npz_edges(str(path))
        js, jd, jm = j_readers._sparse_npz_edges(str(path))
        np.testing.assert_array_equal(s, js)
        np.testing.assert_array_equal(d, jd)
        assert m == jm == n and s.dtype == np.int64
        edges[fmt] = sorted(zip(s.tolist(), d.tolist()))
    assert edges["csr"] == edges["csc"] == edges["coo"] == sorted(
        zip(src.tolist(), dst.tolist()))


def test_yelp_reader_matches_jax(tmp_path):
    """GraphSAINT's Yelp layout: multi-hot [N, C] f32 labels, role.json
    masks; load_data standard-scales the features on the train rows, as
    the JAX package does."""
    _yelp(tmp_path)
    got = disk_readers.load_yelp_saint(str(tmp_path))
    _same_graph(got, j_readers.load_yelp_saint(str(tmp_path)))
    assert got.multilabel and got.label.dtype == np.float32
    g, n_feat, n_class = load_data(Config(dataset="yelp",
                                          data_path=str(tmp_path)))
    g_j, _, _ = j_load_data(JConfig(dataset="yelp", data_path=str(tmp_path)))
    _same_graph(g, g_j)
    assert n_class == 4 and g.n_class == 4
    assert np.abs(g.feat[g.train_mask].mean(0)).max() < 1e-5


def test_ogb_csv_reader_matches_jax(tmp_path):
    _ogb_csv(tmp_path)
    got = disk_readers.load_ogb_disk("ogbn-products", str(tmp_path))
    _same_graph(got, j_readers.load_ogb_disk("ogbn-products", str(tmp_path)))
    g, _, _ = load_data(Config(dataset="ogbn-products",
                               data_path=str(tmp_path)))
    g_j, _, _ = j_load_data(JConfig(dataset="ogbn-products",
                                    data_path=str(tmp_path)))
    _same_graph(g, g_j)
    assert g.train_mask.sum() == 15


def test_ogb_binary_reader_nan_labels_match_jax(tmp_path):
    """papers100M's binary layout: NaN labels become -1, as the JAX
    package pins them."""
    _ogb_binary(tmp_path)
    got = disk_readers.load_ogb_disk("ogbn-papers100M", str(tmp_path))
    _same_graph(got, j_readers.load_ogb_disk("ogbn-papers100M",
                                             str(tmp_path)))
    g, _, _ = load_data(Config(dataset="ogbn-papers100m",
                               data_path=str(tmp_path)))
    g_j, _, _ = j_load_data(JConfig(dataset="ogbn-papers100m",
                                    data_path=str(tmp_path)))
    _same_graph(g, g_j)
    assert g.label.min() == -1 and g.label[g.train_mask].min() >= 0


def test_missing_split_fails_by_name(tmp_path):
    _ogb_binary(tmp_path)
    for f in (tmp_path / "ogbn_papers100M" / "split" / "time").iterdir():
        if f.name.startswith("valid"):
            f.unlink()
    with pytest.raises(FileNotFoundError, match="no valid split file"):
        disk_readers.load_ogb_disk("ogbn-papers100M", str(tmp_path))


@pytest.mark.parametrize("seed", range(3))
def test_bce_sum_matches_jax(seed):
    """BCE with logits summed over the masked rows and every class, f32,
    against bnsgcn_tpu/trainer.py bce_sum (1e-6 relative), bf16 logits
    included; its gradient is sigmoid(x) - z on the masked rows."""
    import jax.numpy as jnp
    from bnsgcn_tpu.trainer import bce_sum as j_bce_sum
    from bnsgcn_tpu_torch.trainer import bce_sum
    rng = np.random.default_rng(seed)
    n, c = 30, 7
    x = (rng.normal(size=(n, c)) * 4).astype(np.float32)
    x[0, :3] = [60.0, -60.0, 0.0]               # saturated and zero logits
    z = (rng.random((n, c)) < 0.3).astype(np.float32)
    m = rng.random(n) < 0.6
    want = float(j_bce_sum(jnp.asarray(x), jnp.asarray(z), jnp.asarray(m)))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = bce_sum(xt, torch.from_numpy(z), torch.from_numpy(m))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got.detach()), want, rtol=1e-6)
    got.backward()
    sig = 1 / (1 + np.exp(-x.astype(np.float64)))
    np.testing.assert_allclose(xt.grad.numpy(),
                               np.where(m[:, None], sig - z, 0), atol=1e-6)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    want_b = float(j_bce_sum(jnp.asarray(x).astype(jnp.bfloat16),
                             jnp.asarray(z), jnp.asarray(m)))
    np.testing.assert_allclose(float(bce_sum(xb, torch.from_numpy(z),
                                             torch.from_numpy(m))),
                               want_b, rtol=1e-6)


def test_multilabel_synthetic_graph_matches_jax():
    """synthetic_graph(multilabel=True) draws the JAX generator's streams:
    the same graph, multi-hot labels [N, C] f32."""
    from bnsgcn_tpu.data.graph import synthetic_graph as j_synthetic
    from bnsgcn_tpu_torch.data.graph import synthetic_graph
    kw = dict(n_nodes=80, avg_degree=5, n_feat=6, n_class=5, seed=2,
              multilabel=True)
    g = synthetic_graph(**kw)
    _same_graph(g, j_synthetic(**kw))
    assert g.label.shape == (80, 5) and g.multilabel
    _same_graph(synthetic_graph(**kw, power_law=True),
                j_synthetic(**kw, power_law=True))


def test_multilabel_artifacts_and_blocks_match_jax():
    """Multilabel artifacts hold [P, pad_inner, C] f32 labels (zero on
    padded rows) and build_block_arrays passes them on, array-equal to the
    JAX package's."""
    from bnsgcn_tpu.data.artifacts import build_artifacts as j_build
    from bnsgcn_tpu.data.graph import synthetic_graph as j_synthetic
    from bnsgcn_tpu.trainer import build_block_arrays as j_blocks
    from bnsgcn_tpu_torch.data.artifacts import build_artifacts
    from bnsgcn_tpu_torch.data.graph import synthetic_graph
    from bnsgcn_tpu_torch.data.partitioner import partition_graph
    from bnsgcn_tpu_torch.trainer import build_block_arrays
    kw = dict(n_nodes=60, avg_degree=5, n_feat=4, n_class=6, seed=8,
              multilabel=True)
    g, g_j = synthetic_graph(**kw), j_synthetic(**kw)
    pid = partition_graph(g, 3, method="random", seed=0)
    art, art_j = build_artifacts(g, pid), j_build(g_j, pid)
    assert art.multilabel and art.label.dtype == np.float32
    assert art.label.shape == (3, art.pad_inner, 6)
    np.testing.assert_array_equal(art.label, art_j.label)
    assert not art.label[~art.inner_mask].any()
    for model in ("graphsage", "gcn"):
        b, bj = build_block_arrays(art, model), j_blocks(art_j, model)
        for k in b:
            np.testing.assert_array_equal(b[k], bj[k], err_msg=k)


def test_yelp_trains_through_the_entry_point(tmp_path, capsys):
    """--dataset yelp --data-path on the GraphSAINT fixture at P=1 through
    main: the multilabel graph, the BCE loss, the micro-F1 eval lines
    (printed as 'Accuracy', as the JAX package prints them), inductive as
    scripts/yelp_torch.sh trains."""
    _yelp(tmp_path, n=120, e=600, c=6, f=8)
    rc = t_main.main(["--dataset", "yelp", "--data-path", str(tmp_path),
                      "--n-partitions", "1", "--model", "graphsage",
                      "--n-layers", "3", "--n-linear", "1", "--n-hidden",
                      "16", "--use-pp", "--inductive", "--n-epochs", "4",
                      "--log-every", "2", "--device", "cpu", "--fix-seed",
                      "--ckpt-path", str(tmp_path / "ck"), "--results-path",
                      str(tmp_path / "res")])
    out = capsys.readouterr().out
    assert rc == 0
    assert "F=8, 6 classes" in out
    f1 = [ln for ln in out.splitlines() if ln.startswith("Epoch ")]
    assert len(f1) == 2 and all(" | Accuracy " in ln for ln in f1)
    losses = [float(x) for x in
              out.split("LOSSES from_epoch=0 ")[1].split()[0].split(",")]
    assert len(losses) == 4 and all(np.isfinite(losses))


def test_multilabel_mesh_eval_equals_the_host_eval(tmp_path, capsys):
    """The multilabel eval on the ranks' forward (_metric_stats' multi-hot
    branch: true/false positives and false negatives, summed) prints the
    micro-F1 the host eval (calc_acc on the whole graph) prints, for the
    same run on the Yelp fixture, transductive."""
    _yelp(tmp_path, n=120, e=600, c=6, f=8)
    outs = []
    for dev in ("mesh", "host"):
        rc = t_main.main(["--dataset", "yelp", "--data-path", str(tmp_path),
                          "--n-partitions", "1", "--n-layers", "2",
                          "--n-hidden", "16", "--use-pp", "--spmm",
                          "hybrid", "--block-tile", "16", "--n-epochs", "6",
                          "--log-every", "2", "--lr", "0.05", "--dropout",
                          "0", "--device", "cpu", "--fix-seed",
                          "--eval-device", dev, "--ckpt-path",
                          str(tmp_path / dev), "--results-path",
                          str(tmp_path / f"res_{dev}")])
        assert rc == 0
        outs.append([ln for ln in capsys.readouterr().out.splitlines()
                     if ln.startswith(("Epoch ", "Test Result", "RESULT"))])
    assert outs[0] == outs[1] and len(outs[0]) >= 4
    assert any(float(ln.split("Validation Accuracy ")[1].split("%")[0]) > 0
               for ln in outs[0] if "Validation Accuracy" in ln)
