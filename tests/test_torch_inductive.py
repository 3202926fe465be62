"""The port's inductive path against the JAX package, on the CPU.

  * Graph.subgraph and inductive_split: array-equal to the JAX package's
    (ids relabelled in increasing order; train / train+val / full nesting);
  * the inductive artifacts prepare_partition writes at P=4: the directory
    the JAX package's prepare_partition writes for the same flags, file for
    file and array for array, partitioning the train subgraph;
  * evaluate_induc: the JAX package's accuracies for the same carried-over
    parameters on the train+val subgraph (mode 'val') and the full graph
    (mode 'test'), each from logits on that graph alone;
  * the P=1 loop under --inductive trains on the train subgraph
    (n_train its node count), evaluates on the train+val subgraph and
    scores the best parameters on the full graph, and appends each eval
    line to the results file.

The 4-rank inductive training parity is in test_torch_dist.py's module
fixture, beside the other 4-rank cases.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from bnsgcn_tpu.config import Config as JConfig
from bnsgcn_tpu.data import graph as j_graph
from bnsgcn_tpu.evaluate import evaluate_induc as j_evaluate_induc
from bnsgcn_tpu.models.gnn import ModelSpec as JModelSpec
from bnsgcn_tpu.models.gnn import init_params as j_init_params
from bnsgcn_tpu.run import prepare_partition as j_prepare_partition
from bnsgcn_tpu_torch.config import Config
from bnsgcn_tpu_torch.data import graph as t_graph
from bnsgcn_tpu_torch.evaluate import evaluate_induc
from bnsgcn_tpu_torch.models.gnn import GNN, spec_from_config
from bnsgcn_tpu_torch.run import (artifacts_dir, prepare_partition,
                                  prepare_run, results_file, train_loop)
from bnsgcn_tpu_torch.trainer import params_from_jax

GRAPH = dict(n_nodes=300, n_class=4, n_feat=6, p_in=0.08, p_out=0.005,
             seed=13)
FIELDS = ("src", "dst", "feat", "label", "train_mask", "val_mask",
          "test_mask")


def _quiet(*a, **k):
    pass


def _assert_graph_equal(a, b):
    assert a.n_nodes == b.n_nodes and a.multilabel == b.multilabel
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


def test_subgraph_equals_jax():
    tg = t_graph.sbm_graph(**GRAPH).canonicalize()
    jg = j_graph.sbm_graph(**GRAPH).canonicalize()
    mask = np.random.default_rng(0).random(tg.n_nodes) < 0.4
    _assert_graph_equal(tg.subgraph(mask), jg.subgraph(mask))
    sub = tg.subgraph(mask)
    assert sub.n_nodes == mask.sum()
    # every kept node keeps its self-loop: the subgraph stays canonical
    assert (sub.in_degrees() >= 1).all() and (sub.out_degrees() >= 1).all()


def test_inductive_split_equals_jax():
    tg = t_graph.sbm_graph(**GRAPH).canonicalize()
    jg = j_graph.sbm_graph(**GRAPH).canonicalize()
    t_split, j_split = t_graph.inductive_split(tg), j_graph.inductive_split(jg)
    for a, b in zip(t_split, j_split):
        _assert_graph_equal(a, b)
    train_g, val_g, test_g = t_split
    assert train_g.train_mask.all() and not train_g.val_mask.any()
    assert val_g.n_nodes == (tg.train_mask | tg.val_mask).sum()
    assert not val_g.test_mask.any() and test_g is tg


def _npz_dir(path):
    out = {}
    for fn in sorted(os.listdir(path)):
        if fn.endswith(".npz"):
            with np.load(os.path.join(path, fn)) as z:
                out[fn] = {k: z[k] for k in z.files}
    with open(os.path.join(path, "meta.json")) as f:
        return json.load(f), out


def test_inductive_artifacts_equal_jax_at_p4(tmp_path):
    """The same flags through both packages' prepare_partition: the port's
    directory is the JAX package's, meta.json and every array of every part
    file, with the parts cut from the train subgraph."""
    common = dict(dataset="synthetic", n_partitions=4, inductive=True,
                  seed=5)
    t_cfg = Config(part_path=str(tmp_path / "t"), **common)
    j_cfg = JConfig(part_path=str(tmp_path / "j"), **common)
    art = prepare_partition(t_cfg)
    j_prepare_partition(j_cfg)
    t_path = artifacts_dir(t_cfg)
    assert os.path.basename(t_path) == "synthetic-4-metis-vol-induc"
    t_meta, t_npz = _npz_dir(t_path)
    j_meta, j_npz = _npz_dir(str(tmp_path / "j" / os.path.basename(t_path)))
    assert t_meta == j_meta
    assert sorted(t_npz) == sorted(j_npz) == [
        "part0.npz", "part1.npz", "part2.npz", "part3.npz", "shared.npz"]
    for fn in t_npz:
        assert sorted(t_npz[fn]) == sorted(j_npz[fn]), fn
        for k, x in t_npz[fn].items():
            y = j_npz[fn][k]
            assert x.dtype == y.dtype and x.shape == y.shape, (fn, k)
            np.testing.assert_array_equal(x, y, err_msg=f"{fn}:{k}")
    # the train subgraph: every inner node is a train node
    assert art.n_train == int(art.n_inner.sum()) == t_meta["n_train"]


@pytest.mark.parametrize("model,use_pp", [("graphsage", True),
                                          ("graphsage", False),
                                          ("gcn", False)])
def test_evaluate_induc_equals_jax(model, use_pp):
    """The same parameters score the same accuracy in both packages, on the
    train+val subgraph's val mask and on the full graph's test mask, with
    norms from each graph's own degrees; the line format is the JAX one."""
    tg = t_graph.sbm_graph(**GRAPH).canonicalize()
    jg = j_graph.sbm_graph(**GRAPH).canonicalize()
    spec_j = JModelSpec(model, (tg.n_feat, 16, 16, tg.n_class),
                        norm="layer", dropout=0.5, use_pp=use_pp)
    params, state = j_init_params(jax.random.key(3), spec_j)
    params_np = jax.tree.map(np.asarray, params)
    cfg = Config(model=model, n_layers=3, n_hidden=16, use_pp=use_pp,
                 n_feat=tg.n_feat, n_class=tg.n_class)
    net = GNN(spec_from_config(cfg))
    net.load_state_dict(params_from_jax(params_np, net.spec))
    lines = []
    accs = []
    for (t_g, j_g), mode in zip(
            [(t_graph.inductive_split(tg)[1], j_graph.inductive_split(jg)[1]),
             (tg, jg)], ("val", "test")):
        got = evaluate_induc("Epoch 00009", net, t_g, "cpu", mode,
                             log=lines.append)
        want = j_evaluate_induc("Epoch 00009", params_np, state, spec_j, j_g,
                                mode)
        assert got == want
        accs.append(got)
    assert lines == ["Epoch 00009 | Accuracy {:.2%}".format(a) for a in accs]
    assert net.training                 # the eval does not leave it in eval


def test_inductive_loop_at_p1(tmp_path):
    """P=1 under --inductive: the artifacts hold the train subgraph only,
    the periodic evals score the train+val subgraph's val mask into the
    results file, and the last line scores the best parameters on the full
    graph's test mask."""
    g = t_graph.sbm_graph(**GRAPH).canonicalize()
    cfg = Config(dataset="sbm", n_partitions=1, model="graphsage",
                 n_layers=2, n_hidden=16, use_pp=True, dropout=0.5,
                 n_epochs=4, log_every=2, inductive=True, device="cpu",
                 seed=0, ckpt_path=str(tmp_path / "ck"),
                 results_path=str(tmp_path / "res"))
    pr = prepare_run(cfg, g=g, log=_quiet)
    assert pr.cfg.n_train == g.n_train
    assert pr.val_g.n_nodes == (g.train_mask | g.val_mask).sum()
    assert pr.test_g is g
    lines = []
    res, _ = train_loop(pr, log=lines.append)
    evals = [ln for ln in lines if ln.startswith("Epoch ")]
    assert [ln.split(" |")[0] for ln in evals] == ["Epoch 00001",
                                                   "Epoch 00003"]
    assert all(" | Accuracy " in ln for ln in evals)
    with open(results_file(cfg)) as f:
        assert f.read().splitlines() == evals
    assert lines[-1].startswith("Test Result | Accuracy ")
    assert "model saved" in lines
    best = max(float(ln.rsplit(" ", 1)[1].rstrip("%")) / 100 for ln in evals)
    assert res.val_acc == res.best_val_acc
    assert abs(res.best_val_acc - best) <= 5e-5     # printed to 0.01%
    assert torch.isfinite(torch.tensor(res.losses)).all()
