"""The streaming artifact builder, bf16 feature storage and the unlabeled
nodes of papers100M, the port against the JAX package on the CPU.

  * the port's build_artifacts_streaming writes, on the same graph and
    part_id, the JAX package's directory: every array of every part file
    bitwise (bf16 features as the bits ml_dtypes rounds to), shared.npz
    and meta.json (the ELL geometry included) equal, on uniform,
    power-law and multilabel graphs, with f32 and bf16 storage;
  * a directory written by either package loads in the other;
  * training from streamed artifacts matches training from in-memory ones
    within 1e-5 at P=2 (tests/test_streaming_artifacts.py's law);
  * --streaming-artifacts auto streams above run.STREAMING_MIN_EDGES (here
    lowered) and not below it;
  * ce_sum on labels holding -1 on masked-out rows: value and gradient as
    the JAX ce_sum's, finite;
  * an OGB binary fixture at papers100M's layout (NaN labels outside the
    splits), trained at P=1 through both packages from the same
    parameters, in memory and through the streaming builder with bf16
    storage: losses within 1e-4.
"""

import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from bnsgcn_tpu.config import Config as JConfig
from bnsgcn_tpu.data import artifacts as j_art
from bnsgcn_tpu.data import graph as j_graph
from bnsgcn_tpu.data import partitioner as j_part
from bnsgcn_tpu.models.gnn import init_params as j_init_params
from bnsgcn_tpu.models.gnn import spec_from_config as j_spec_from_config
from bnsgcn_tpu.run import run_training as j_run_training
from bnsgcn_tpu.trainer import ce_sum as j_ce_sum
from bnsgcn_tpu_torch import run as t_run
from bnsgcn_tpu_torch.config import Config
from bnsgcn_tpu_torch.data import artifacts as t_art
from bnsgcn_tpu_torch.data import graph as t_graph
from bnsgcn_tpu_torch.models.gnn import spec_from_config
from bnsgcn_tpu_torch.trainer import (build_block_arrays, ce_sum,
                                      params_from_jax)

GRAPHS = {
    "uniform": dict(n_nodes=150, avg_degree=7, n_feat=6, n_class=5, seed=51),
    "power_law": dict(n_nodes=150, avg_degree=7, n_feat=6, n_class=5,
                      seed=52, power_law=True),
    "multilabel": dict(n_nodes=90, avg_degree=5, n_feat=6, n_class=4,
                       seed=54, multilabel=True),
}
CURVE_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both_dirs(tmp, kind, feat_dtype, parts=4):
    """(port's directory, JAX's directory) of one graph and part_id."""
    g = t_graph.synthetic_graph(**GRAPHS[kind])
    g_j = j_graph.synthetic_graph(**GRAPHS[kind])
    pid = j_part.partition_graph(g_j, parts, method="random", seed=6)
    t_dir, j_dir = str(tmp / "port"), str(tmp / "jax")
    t_art.build_artifacts_streaming(g, pid, t_dir, feat_dtype=feat_dtype)
    j_art.build_artifacts_streaming(g_j, pid, j_dir, feat_dtype=feat_dtype)
    return t_dir, j_dir, g, pid


@pytest.mark.parametrize("feat_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", sorted(GRAPHS))
def test_streaming_writes_the_jax_directory(tmp_path, kind, feat_dtype):
    t_dir, j_dir, g, _ = _both_dirs(tmp_path, kind, feat_dtype)
    assert sorted(os.listdir(t_dir)) == sorted(os.listdir(j_dir))
    for fn in sorted(os.listdir(j_dir)):
        if fn.endswith(".json"):
            with open(os.path.join(t_dir, fn)) as a, \
                    open(os.path.join(j_dir, fn)) as b:
                assert json.load(a) == json.load(b)
            continue
        with np.load(os.path.join(t_dir, fn)) as a, \
                np.load(os.path.join(j_dir, fn)) as b:
            assert sorted(a.files) == sorted(b.files), fn
            for k in b.files:
                assert a[k].dtype == b[k].dtype, (fn, k)
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{fn} {k}")
    with open(os.path.join(t_dir, "meta.json")) as f:
        meta = json.load(f)
    assert meta["feat_dtype"] == feat_dtype
    assert set(meta["ell_geometry"]) == {"fwd", "bwd", "gat_fwd"}
    if feat_dtype == "bfloat16":
        # the bits are ml_dtypes' round to nearest even of the f32 values
        with np.load(os.path.join(t_dir, "part0.npz")) as p0:
            ids = p0["global_nid"][p0["inner_mask"]]
            want = g.feat[ids].astype(ml_dtypes.bfloat16).view(np.uint16)
            np.testing.assert_array_equal(p0["feat"][:len(ids)], want)


def test_bf16_bits_round_to_nearest_even_as_ml_dtypes():
    """Ties, subnormals, infinities and values near the largest bf16, the
    conversion the builder stores, against ml_dtypes; and back exactly."""
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.normal(size=4096).astype(np.float32) * 1e3,
        np.array([1 + 2 ** -8, 1 + 3 * 2 ** -8, -(1 + 2 ** -8), 1e-40,
                  -1e-41, np.inf, -np.inf, 3.389e38, 0.0, -0.0],
                 dtype=np.float32),
        (rng.integers(0, 2 ** 31, 4096, dtype=np.uint32) & 0x7F7FFFFF)
        .view(np.float32)])
    bits = t_art.bf16_bits(x)
    assert bits.dtype == np.uint16
    np.testing.assert_array_equal(bits, x.astype(ml_dtypes.bfloat16)
                                  .view(np.uint16))
    np.testing.assert_array_equal(
        t_art.bf16_to_f32(bits),
        bits.view(ml_dtypes.bfloat16).astype(np.float32))


@pytest.mark.parametrize("feat_dtype", ["float32", "bfloat16"])
def test_directories_load_in_both_packages(tmp_path, feat_dtype):
    """The JAX package loads the port's directory as its own, and the port
    loads the JAX package's: every field equal, the bf16 features as the
    same bits (the port keeps them as uint16, which feat_dtype reads),
    upcast exactly by the block arrays; a rank's partial load too."""
    t_dir, j_dir, _, _ = _both_dirs(tmp_path, "power_law", feat_dtype)
    for path in (t_dir, j_dir):
        got, want = t_art.load_artifacts(path), j_art.load_artifacts(path)
        assert t_art.feat_dtype(got) == feat_dtype
        for f in ("n_parts", "pad_inner", "pad_boundary", "pad_edges",
                  "n_feat", "n_class", "n_train", "multilabel",
                  "ell_geometry"):
            assert getattr(got, f) == getattr(want, f), f
        for f in ("n_inner", "n_b") + tuple(t_art._PER_PART):
            a, b = getattr(got, f), getattr(want, f)
            if f == "feat" and feat_dtype == "bfloat16":
                assert a.dtype == np.uint16
                b = b.view(np.uint16)
            np.testing.assert_array_equal(a, b, err_msg=f)
        feat = build_block_arrays(got, "gcn")["feat"]
        assert feat.dtype == np.float32
        np.testing.assert_array_equal(feat, want.feat.astype(np.float32))
        part = t_art.load_artifacts(path, parts=[2])
        np.testing.assert_array_equal(part.feat[0], got.feat[2])
        meta = t_art.read_meta(path)
        assert (meta.pad_inner, meta.feat_dtype) == (got.pad_inner,
                                                     feat_dtype)
        np.testing.assert_array_equal(meta.n_b, want.n_b)


def _train_cfg(tmp, mode, **kw):
    return Config(dataset="sbm", model="graphsage", n_partitions=2,
                  n_layers=2, n_hidden=8, sampling_rate=1.0, dropout=0.0,
                  use_pp=True, eval=False, n_epochs=5, log_every=10, seed=3,
                  device="cpu", dist_backend="gloo",
                  streaming_artifacts=mode,
                  part_path=str(tmp / f"parts_{mode}"),
                  ckpt_path=str(tmp / f"ckpt_{mode}"),
                  results_path=str(tmp / "res"), **kw)


def test_streamed_artifacts_train_like_in_memory(tmp_path):
    """P=2 on the same graph from streamed and from in-memory artifacts
    (rate 1.0: the losses differ only by the within-part edge order's
    float sums)."""
    g = t_graph.sbm_graph(n_nodes=200, n_class=3, n_feat=8, p_in=0.12,
                          p_out=0.01, seed=53)
    losses = {mode: t_run.run_training(_train_cfg(tmp_path, mode), g=g,
                                       log=lambda m: None).losses
              for mode in ("never", "always")}
    np.testing.assert_allclose(losses["always"], losses["never"],
                               rtol=1e-5, atol=1e-6)
    with open(tmp_path / "parts_always" / "sbm-2-metis-vol-trans"
              / "meta.json") as f:
        assert json.load(f)["feat_dtype"] == "float32"


@pytest.mark.parametrize("n_edges_over", [True, False])
def test_auto_streams_above_the_threshold(tmp_path, monkeypatch,
                                          n_edges_over):
    """--streaming-artifacts auto takes the streaming builder (and its
    --feat-storage) above STREAMING_MIN_EDGES edges, the in-memory one at
    or below it."""
    g = t_graph.synthetic_graph(**GRAPHS["power_law"])
    monkeypatch.setattr(t_run, "STREAMING_MIN_EDGES",
                        g.n_edges - 1 if n_edges_over else g.n_edges)
    cfg = Config(dataset="synthetic", n_partitions=4,
                 partition_method="random", streaming_artifacts="auto",
                 feat_storage="bfloat16", part_path=str(tmp_path),
                 graph_name="auto")
    t_run.prepare_partition(cfg, g, load=False)
    with open(tmp_path / "auto" / "meta.json") as f:
        meta = json.load(f)
    assert meta.get("feat_dtype") == ("bfloat16" if n_edges_over else None)
    pid = t_run.partition_graph(g, 4, method="random", seed=cfg.seed)
    ref = str(tmp_path / "ref")
    if n_edges_over:
        t_art.build_artifacts_streaming(g, pid, ref, feat_dtype="bfloat16")
    else:
        t_art.save_artifacts(t_art.build_artifacts(g, pid), ref)
    got, want = (t_art.load_artifacts(str(tmp_path / "auto")),
                 t_art.load_artifacts(ref))
    for f in t_art._PER_PART:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


@pytest.mark.parametrize("seed", range(3))
def test_ce_sum_on_unlabeled_rows_matches_jax(seed):
    """Labels -1 on rows outside the mask (papers100M's unlabeled nodes):
    the loss and its gradient equal the JAX ce_sum's, finite, and the
    masked-out rows get no gradient."""
    rng = np.random.default_rng(seed)
    n, c = 40, 6
    x = (rng.normal(size=(n, c)) * 3).astype(np.float32)
    m = rng.random(n) < 0.5
    y = rng.integers(0, c, n).astype(np.int32)
    y[~m] = -1
    want, want_g = jax.value_and_grad(
        lambda v: j_ce_sum(v, jnp.asarray(y), jnp.asarray(m)))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = ce_sum(xt, torch.from_numpy(y), torch.from_numpy(m))
    got.backward()
    assert np.isfinite(float(got.detach()))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_g),
                               rtol=1e-6, atol=1e-7)
    assert not xt.grad.numpy()[~m].any()


def _papers_fixture(root, seed=7, n=300, e=2400, f=8, c=5):
    """An OGB binary directory at papers100M's layout: data.npz, labels as
    floats with NaN on every node outside the splits, split/time/."""
    rng = np.random.default_rng(seed)
    d = root / "ogbn_papers100M"
    (d / "raw").mkdir(parents=True)
    sd = d / "split" / "time"
    sd.mkdir(parents=True)
    lab = rng.integers(0, c, n)
    centers = rng.normal(size=(c, f))
    feat = (centers[lab] + rng.normal(size=(n, f))).astype(np.float32)
    # edges mostly within a class, so the labels can be learned
    src = rng.integers(0, n, e)
    same = np.flatnonzero(rng.random(e) < 0.8)
    pool = [np.flatnonzero(lab == k) for k in range(c)]
    dst = rng.integers(0, n, e)
    dst[same] = [rng.choice(pool[lab[s]]) for s in src[same]]
    np.savez(d / "raw" / "data.npz", edge_index=np.stack([src, dst]),
             node_feat=feat, num_nodes_list=np.array([n]))
    ids = rng.permutation(n)
    tr, va, te = ids[:120], ids[120:150], ids[150:180]
    label = np.full(n, np.nan)
    for s in (tr, va, te):
        label[s] = lab[s]
    np.savez(d / "raw" / "node-label.npz", node_label=label[:, None])
    for name, s in (("train", tr), ("valid", va), ("test", te)):
        np.savez(sd / f"{name}.npz", ids=s)


@pytest.mark.parametrize("streaming,storage", [("never", "float32"),
                                               ("always", "bfloat16")])
def test_papers_layout_trains_like_jax(tmp_path, streaming, storage):
    """The unlabeled nodes' -1 labels reach the loss at P=1 in both
    packages, which train GCN from the same parameters to losses within
    1e-4: in memory, and from the streaming builder's bf16 features."""
    _papers_fixture(tmp_path)
    common = dict(dataset="ogbn-papers100m", data_path=str(tmp_path),
                  model="gcn", n_layers=3, n_hidden=16, dropout=0.0,
                  use_pp=True, lr=0.01, spmm="ell", n_partitions=1,
                  n_epochs=6, log_every=3, seed=0, eval=True,
                  streaming_artifacts=streaming, feat_storage=storage)

    def paths(who):
        return dict(part_path=str(tmp_path / f"parts_{who}"),
                    ckpt_path=str(tmp_path / f"ck_{who}"),
                    results_path=str(tmp_path / f"res_{who}"))

    cfg_j = JConfig(**common, **paths("jax"))
    res_j = j_run_training(cfg_j, verbose=False)
    from bnsgcn_tpu.data.datasets import load_data as j_load_data
    g_j, n_feat, n_class = j_load_data(cfg_j)
    assert g_j.label.min() == -1
    params, _ = j_init_params(jax.random.key(0), j_spec_from_config(
        cfg_j.replace(n_feat=n_feat, n_class=n_class, n_train=g_j.n_train)))
    cfg = Config(**common, **paths("port"), device="cpu")
    spec = spec_from_config(cfg.replace(n_feat=n_feat, n_class=n_class,
                                        n_train=g_j.n_train))
    res = t_run.run_training(cfg, log=lambda m: None, model_init=(
        params_from_jax(jax.tree.map(np.asarray, params), spec)))
    assert all(np.isfinite(res.losses))
    np.testing.assert_allclose(res.losses, res_j.losses, **CURVE_TOL)
    assert abs(res.best_val_acc - res_j.best_val_acc) < 1e-6
    if streaming == "always":
        with open(tmp_path / "parts_port" / cfg.derive_graph_name()
                  / "meta.json") as f:
            assert json.load(f)["feat_dtype"] == "bfloat16"


def test_partition_cli_streams_the_eval_artifacts_too(tmp_path, capsys):
    """partition_cli --inductive --eval-device mesh with the script's
    partition flags: the train subgraph's directory and the eval graphs'
    ('-val', '-test') all come from the streaming builder with bf16
    features, and a --skip-partition run trains from them."""
    from bnsgcn_tpu_torch import main as t_main
    from bnsgcn_tpu_torch import partition_cli
    flags = ["--dataset", "sbm", "--n-partitions", "2", "--device", "cpu",
             "--dist-backend", "gloo", "--inductive", "--eval-device",
             "mesh", "--model", "gcn", "--n-layers", "2", "--n-hidden", "8",
             "--use-pp", "--dtype", "bfloat16", "--fix-seed",
             "--streaming-artifacts", "always", "--feat-storage", "bfloat16",
             "--part-path", str(tmp_path / "p"), "--graph-name", "g"]
    assert partition_cli.main(flags) == 0
    for name in ("g", "g-val", "g-test"):
        with open(tmp_path / "p" / name / "meta.json") as f:
            assert json.load(f)["feat_dtype"] == "bfloat16", name
    capsys.readouterr()
    assert t_main.main(flags + ["--skip-partition", "--n-epochs", "2",
                                "--log-every", "2", "--ckpt-path",
                                str(tmp_path / "ck"), "--results-path",
                                str(tmp_path / "r")]) == 0
    out = capsys.readouterr().out
    assert "(bfloat16 features)" in out and "Test Result | Accuracy" in out
