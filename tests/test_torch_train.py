"""The port's model, loss, gradients, optimizer and training loop against
the JAX package at P=1, on the CPU, plus the port's entry point.

Both packages start from the same parameters (the JAX tree carried over by
trainer.params_from_jax) on the same seeded graph, with dropout 0.5: both
draw jax's masks from the step's key (seed 0's key(1) folded with the
epoch and the rank, trainer.dropout_key). Tolerances: 1e-5 (rtol and atol) per op, since
XLA:CPU and PyTorch sum in different orders; 1e-4 on the 10-epoch loss
curve, where those differences pass through ten Adam steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bnsgcn_tpu.config import Config as JConfig
from bnsgcn_tpu.data.artifacts import build_artifacts as j_build_artifacts
from bnsgcn_tpu.data.graph import sbm_graph as j_sbm_graph
from bnsgcn_tpu.evaluate import full_graph_logits as j_full_graph_logits
from bnsgcn_tpu.models.gnn import ModelSpec as JModelSpec
from bnsgcn_tpu.models.gnn import init_params as j_init_params
from bnsgcn_tpu.parallel.mesh import make_parts_mesh
from bnsgcn_tpu.trainer import (build_block_arrays as j_build_block_arrays,
                                build_step_fns as j_build_step_fns,
                                init_training, place_blocks,
                                place_replicated)
from bnsgcn_tpu_torch import main as t_main
from bnsgcn_tpu_torch.config import Config as TConfig
from bnsgcn_tpu_torch.data.graph import sbm_graph as t_sbm_graph
from bnsgcn_tpu_torch.evaluate import full_graph_logits
from bnsgcn_tpu_torch.models.gnn import GNN
from bnsgcn_tpu_torch.run import prepare_run, run_training
from bnsgcn_tpu_torch.trainer import (ce_sum, dropout_key, make_tx,
                                      params_from_jax)

OP_TOL = dict(rtol=1e-5, atol=1e-5)      # one op, f32, other sum order
CURVE_TOL = dict(rtol=1e-4, atol=1e-4)   # ten Adam steps of the above

GRAPH = dict(n_nodes=240, n_class=4, n_feat=8, p_in=0.1, p_out=0.005,
             seed=66)
EPOCHS = 10


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs in parallel workers; torch would otherwise spread each
    # tiny op over every core and crowd the timing-sensitive tests beside it
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _quiet(*a, **k):
    pass


@pytest.fixture(scope="module", params=["hybrid", "ell"])
def pair(request):
    """The same P=1 run set up in both packages; the JAX side runs 10
    epochs and keeps every intermediate the tests compare."""
    spmm = request.param
    g_j = j_sbm_graph(**GRAPH)
    common = dict(model="graphsage", n_layers=3, n_hidden=16, dropout=0.5,
                  use_pp=True, norm="layer", lr=0.01, weight_decay=5e-4,
                  spmm=spmm, block_tile=64, block_occupancy=4,
                  n_partitions=1, n_epochs=EPOCHS)
    cfg_j = JConfig(n_train=g_j.n_train, **common)
    spec_j = JModelSpec("graphsage", (8, 16, 16, 4), norm="layer",
                        dropout=0.5, use_pp=True, train_size=g_j.n_train)
    params0, state0 = j_init_params(jax.random.key(6), spec_j)
    params_np = jax.tree.map(np.asarray, params0)
    mesh = make_parts_mesh(1)
    art = j_build_artifacts(g_j, np.zeros(g_j.n_nodes, np.int32))
    fns, _, tables, tables_full = j_build_step_fns(cfg_j, spec_j, art, mesh)
    blk_np = j_build_block_arrays(art, "graphsage")
    blk_np.update(fns.extra_blk)
    for k in fns.drop_blk_keys:
        blk_np.pop(k, None)
    blk = place_blocks(blk_np, mesh)
    tb = place_replicated(tables, mesh)
    blk["feat"] = fns.precompute(blk, place_replicated(tables_full, mesh))
    keys = (jax.random.key(0), jax.random.key(1))

    def placed(tree):
        return place_replicated(tree, mesh)

    out = {"feat_pre": np.asarray(blk["feat"])[0]}
    out["logits"] = np.asarray(fns.forward(
        placed(params_np), placed(state0), jnp.uint32(0), blk, tb, *keys))[0]
    loss, grads = fns.loss_and_grad(placed(params_np), placed(state0),
                                    jnp.uint32(0), blk, tb, *keys)
    out["loss"], out["grads"] = float(loss), jax.tree.map(np.asarray, grads)
    out["eval_logits"] = j_full_graph_logits(params_np, state0, spec_j, g_j)
    p, s = placed(params_np), placed(state0)
    _, _, opt = init_training(cfg_j, spec_j, mesh)
    losses = []
    for e in range(EPOCHS):
        p, s, opt, loss = fns.train_step(p, s, opt, jnp.uint32(e), blk, tb,
                                         *keys)
        losses.append(float(loss))
        if e == 0:
            out["params_1"] = jax.tree.map(np.asarray, jax.device_get(p))
    out["losses"] = losses
    cfg_t = TConfig(device="cpu", eval=False, log_every=1000, **common)
    return dict(out, params_np=params_np, cfg_t=cfg_t)


def _port(pair):
    g = t_sbm_graph(**GRAPH)
    pr = prepare_run(pair["cfg_t"], g=g, log=_quiet)
    model = GNN(pr.spec)
    model.load_state_dict(params_from_jax(pair["params_np"], pr.spec))
    blk = dict(pr.blk)
    blk["feat"] = pr.fns.precompute(blk)
    return g, pr, model, blk


def _close_state(got: dict, want: dict, **tol):
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_allclose(got[k].detach().numpy(), want[k].numpy(),
                                   err_msg=k, **tol)


def test_precompute_and_train_logits_match(pair):
    _, pr, model, blk = _port(pair)
    np.testing.assert_allclose(blk["feat"].numpy(), pair["feat_pre"], **OP_TOL)
    np.testing.assert_allclose(
        pr.fns.forward(model, blk, 0, dropout_key(0, 0, 0)).detach().numpy(),
        pair["logits"], **OP_TOL)


def test_eval_logits_match(pair):
    g, _, model, _ = _port(pair)
    model.eval()
    np.testing.assert_allclose(full_graph_logits(model, g, "cpu"),
                               pair["eval_logits"], **OP_TOL)


def test_loss_grads_and_adam_step_match(pair):
    _, pr, model, blk = _port(pair)
    logits = pr.fns.forward(model, blk, 0, dropout_key(0, 0, 0))
    loss = ce_sum(logits, blk["label"], blk["train_mask"]) / pr.cfg.n_train
    assert abs(float(loss.detach()) - pair["loss"]) <= 1e-5
    loss.backward()
    _close_state({k: p.grad for k, p in model.named_parameters()},
                 params_from_jax(pair["grads"], pr.spec), **OP_TOL)
    opt = make_tx(pr.cfg, model.parameters())
    opt.step()          # Adam with weight decay 5e-4, vs optax's chain
    _close_state(dict(model.named_parameters()),
                 params_from_jax(pair["params_1"], pr.spec), **OP_TOL)


def test_loss_curve_matches(pair):
    """10 epochs of the slice's training loop == the JAX trainer at P=1."""
    g, pr, _, _ = _port(pair)
    res = run_training(pair["cfg_t"], log=_quiet, prepared=pr,
                       model_init=params_from_jax(pair["params_np"], pr.spec))
    np.testing.assert_allclose(res.losses, pair["losses"], **CURVE_TOL)
    assert res.losses[-1] < res.losses[0]


# ---------------------------------------------------------------------------
# (h) the entry point
# ---------------------------------------------------------------------------

def test_entry_point_refuses_cpu_fallback(monkeypatch, capsys):
    """Without --device cpu and without a GPU, the CLI exits with an error
    instead of training on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = t_main.main(["--dataset", "sbm", "--n-epochs", "1"])
    assert rc == 2
    assert "[config] no CUDA device" in capsys.readouterr().err


@pytest.mark.parametrize("flags", [
    ["--n-partitions", "4", "--dist-backend", "gloo", "--cycles", "2"],
    ["--warm-start", "w"], ["--continual-source", "server"],
    ["--continual-cut-growth", "2.0"], ["--cycle-epochs", "3"],
    ["--tune-prior", "model"], ["--continual-imbalance", "3.0"],
    ["--cycles", "3"],
    ["--n-partitions", "1", "--continual-acc-drop", "0.1"],
    ["--cycle-nonce", "2"],
    ["--continual-source", "log"],
    ["--n-partitions", "4", "--dist-backend", "gloo",
     "--warm-start", "w2"],
])
def test_unported_flag_exits_2(flags, capsys):
    rc = t_main.main(["--dataset", "sbm", "--device", "cpu"] + flags)
    assert rc == 2
    assert "not ported yet" in capsys.readouterr().err


@pytest.mark.parametrize("flags", [
    ["--dtype", "bfloat16"], ["--spmm-dense", "int8", "--spmm", "hybrid"],
    ["--spmm-gather", "fp8"], ["--spmm-gather", "int8"], ["--spmm", "auto"],
    ["--halo-wire", "bf16"],
])
def test_reduced_precision_flags_train_on_cpu(flags, capsys, tmp_path):
    """The values slice 5 ports, once refused: each trains at P=1 through
    the entry point (the Graph line names the dtypes), 2 epochs."""
    rc = t_main.main(["--dataset", "sbm", "--device", "cpu",
                      "--n-partitions", "1", "--n-layers", "2",
                      "--n-hidden", "16", "--block-tile", "64",
                      "--n-epochs", "2", "--log-every", "2",
                      "--ckpt-path", str(tmp_path / "ck"),
                      "--results-path", str(tmp_path / "res")] + flags)
    out = capsys.readouterr().out
    assert rc == 0
    assert "RESULT final_loss=" in out
    assert f"{'bfloat16' if '--dtype' in flags else 'float32'} spmm=" in out


@pytest.mark.parametrize("rate", ["-0.000001", "1.5", "-0.1", "nan"])
def test_sampling_rate_outside_0_1_exits_2(rate, capsys):
    rc = t_main.main(["--dataset", "sbm", "--device", "cpu", "--n-partitions",
                      "4", "--dist-backend", "gloo", "--sampling-rate", rate])
    assert rc == 2
    assert "--sampling-rate must be in [0, 1]" in capsys.readouterr().err


def test_entry_point_trains_on_cpu_when_asked(capsys, tmp_path):
    rc = t_main.main(["--dataset", "sbm", "--n-partitions", "1", "--model",
                      "graphsage", "--n-layers", "2", "--n-hidden", "16",
                      "--use-pp", "--spmm", "hybrid", "--use-pallas",
                      "--block-tile", "64", "--n-epochs", "2", "--log-every",
                      "1", "--device", "cpu", "--ckpt-path",
                      str(tmp_path / "ck"), "--results-path",
                      str(tmp_path / "res")])
    out = capsys.readouterr().out
    assert rc == 0
    assert "Process 000 | Epoch 00001 | Time(s)" in out
    assert "Test Result | Accuracy" in out


@pytest.mark.parametrize("parts", [
    ["--n-partitions", "1", "--spmm-gather", "int8"],
    ["--n-partitions", "4", "--dist-backend", "gloo", "--partition-method",
     "random", "--sampling-rate", "0.5", "--eval-device", "mesh"]])
def test_gat_trains_through_main_on_cpu(parts, capsys, tmp_path):
    """--model gat --heads 2, once refused, trains through the entry point
    at P=1 (where --spmm-gather says it has no effect) and at P=4 over gloo
    with BNS and the evaluation on the ranks: the Graph or Part line names
    the model and its heads, the loss falls, the run ends on its Test
    Result."""
    rc = t_main.main(["--dataset", "sbm", "--device", "cpu", "--model",
                      "gat", "--heads", "2", "--n-layers", "2",
                      "--n-hidden", "16", "--dropout", "0", "--n-epochs", "4",
                      "--log-every", "2", "--fix-seed",
                      "--part-path", str(tmp_path / "p"),
                      "--ckpt-path", str(tmp_path / "ck"),
                      "--results-path", str(tmp_path / "res")] + parts)
    out = capsys.readouterr().out
    assert rc == 0
    assert "| float32 model=gat heads=2 spmm=ell" in out
    assert ("has no effect for spmm='ell' / model='gat'" in out) == (
        "--spmm-gather" in parts)
    losses = [float(x) for x in out.split("LOSSES from_epoch=0 ")[1]
              .split()[0].split(",")]
    assert len(losses) == 4 and losses[-1] < losses[0]
    assert "Test Result | Accuracy" in out


@pytest.mark.parametrize("flags,want", [([], 424242),
                                        (["--fix-seed"], 7)])
def test_seed_is_drawn_unless_fix_seed(flags, want, monkeypatch, capsys):
    """As the JAX CLI does, main draws the seed unless --fix-seed: once, in
    the launching process, so the one Config every rank is spawned with
    carries it (every rank then keys the same boundary sample)."""
    import bnsgcn_tpu_torch.run as t_run
    seen, draws = [], []

    def draw(n):
        draws.append(n)
        return 424242

    monkeypatch.setattr(t_main.random, "randrange", draw)
    monkeypatch.setattr(t_run, "run_training",
                        lambda cfg: seen.append(cfg) or t_run.RunResult())
    rc = t_main.main(["--dataset", "sbm", "--device", "cpu", "--seed", "7",
                      "--n-partitions", "4", "--dist-backend", "gloo",
                      "--sampling-rate", "0.1"] + flags)
    assert rc == 0
    assert [c.seed for c in seen] == [want]
    assert draws == ([] if flags else [1 << 31])
    assert ("seed 424242 (drawn" in capsys.readouterr().out) == (not flags)


def test_final_eval_takes_the_best_parameters_on_a_copy(monkeypatch,
                                                         tmp_path):
    """The last evaluation scores the best-validation parameters on a copy:
    the trained model keeps its final parameters, which at P > 1 every rank
    must hold alike for the replication check (rank 0 used to load the best
    ones into it, which failed any run whose best epoch was not its last).
    The periodic evals (evaluate_trans, in the eval thread, on a copy of
    the parameters taken at their log point) see each log point's
    parameters; the final one (evaluate_induc on the full graph's test
    mask, as the JAX package scores it) the best ones."""
    import bnsgcn_tpu_torch.run as t_run
    accs = iter([0.9, 0.5, 0.7])        # the best validation comes first
    seen = []

    def fake_eval(tag, model, g, device, log=print, result_file=None):
        seen.append((tag, {k: v.clone() for k, v in
                           model.state_dict().items()}))
        acc = next(accs)
        return acc, acc

    def fake_final(tag, model, g, device, mode, log=print,
                   result_file=None):
        assert mode == "test"
        return fake_eval(tag, model, g, device)[0]

    monkeypatch.setattr(t_run, "evaluate_trans", fake_eval)
    monkeypatch.setattr(t_run, "evaluate_induc", fake_final)
    cfg = TConfig(dataset="sbm", n_partitions=1, n_layers=2, n_hidden=8,
                  dropout=0.0, n_epochs=4, log_every=2, device="cpu", seed=0,
                  ckpt_path=str(tmp_path / "ck"),
                  results_path=str(tmp_path / "res"))
    pr = prepare_run(cfg, g=t_sbm_graph(**GRAPH), log=_quiet)
    res, model = t_run.train_loop(pr, log=_quiet)
    assert [t for t, _ in seen] == ["Epoch 00001", "Epoch 00003",
                                    "Test Result"]
    best, last, final = (sd for _, sd in seen)
    for k, v in model.state_dict().items():
        assert torch.equal(final[k], best[k]) and torch.equal(v, last[k])
    assert any(not torch.equal(best[k], last[k]) for k in best)
    assert (res.best_val_acc, res.val_acc, res.test_acc) == (0.9, 0.9, 0.7)
