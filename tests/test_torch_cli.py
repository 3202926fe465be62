"""The port's command line against the JAX CLI's, on the CPU.

  * every long flag of bnsgcn_tpu/config.py's parser parses in the port's
    parser with the same default, type and choices, and a non-default value
    is either honoured (it lands in Config, or _NOT_PORTED lists it as what
    the port does) or refused by a `--<flag> ... is not ported yet` error
    naming the flag; never an argparse usage error;
  * --n-partitions defaults to 2, as in the JAX CLI; the JAX CLI's
    subcommands the port lacks exit 2 by name, and `serve` without a
    checkpoint exits 2 with the JAX package's words;
  * Time(s) drops the first 5 epochs: run.warm_mean equals what the JAX
    package's EpochTimer(warmup=5) gives for the same times, resumed runs
    included;
  * partition_cli writes the artifacts (--graph-name names the directory);
    a --skip-partition run trains from them exactly as a run that
    partitioned itself; --skip-partition without them, and partition_cli's
    --eval-device mesh, exit 2 by name;
  * scripts/reddit_torch.sh, the flagship's flags, trains at P=1 with small
    overrides: epoch and accuracy lines, checkpoints, the results file.
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from bnsgcn_tpu.config import create_parser as j_create_parser
from bnsgcn_tpu.utils.timers import EpochTimer
from bnsgcn_tpu_torch import main as t_main
from bnsgcn_tpu_torch import partition_cli
from bnsgcn_tpu_torch.config import (SUBCOMMANDS, Config, ConfigError,
                                     accepted_values, config_from_args,
                                     create_parser, parse_config)
from bnsgcn_tpu_torch.run import WARMUP_EPOCHS, warm_mean

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = ["--dataset", "sbm", "--device", "cpu", "--dist-backend", "gloo"]


def _jax_flags():
    """(first long option, action) of every option of the JAX parser."""
    out = []
    for a in j_create_parser()._actions:
        longs = [o for o in a.option_strings if o.startswith("--")]
        if longs and a.dest != "help":
            out.append((longs[0], a))
    return out


def _non_default(a: argparse.Action):
    """(argv, parsed value) selecting a value other than a's default where
    there is one (--eval is its own default)."""
    flag = a.option_strings[0]
    if a.nargs == 0:
        return [flag], a.const
    if a.choices:
        v = next(c for c in a.choices if c != a.default)
        return [flag, v], v
    if a.type is int:
        return [flag, str(a.default + 1)], a.default + 1
    if a.type is float:
        v = a.default / 2 if a.default else 0.5
        return [flag, repr(v)], v
    v = (a.default or "") + "x"
    return [flag, v], v


@pytest.mark.parametrize("flag,action", _jax_flags(),
                         ids=[f for f, _ in _jax_flags()])
def test_every_jax_flag_is_parsed_and_honoured_or_refused(flag, action):
    ours = {o: a for a in create_parser()._actions for o in a.option_strings}
    mine = ours[flag]
    assert (mine.dest, mine.default, mine.type, mine.choices, mine.nargs,
            mine.const) == (action.dest, action.default, action.type,
                            action.choices, action.nargs, action.const)
    assert set(action.option_strings) <= set(mine.option_strings)
    argv, value = _non_default(action)
    args = create_parser().parse_args(BASE + argv)      # no usage error
    assert getattr(args, action.dest) == value
    try:
        cfg = config_from_args(args)
    except ConfigError as e:
        msg = str(e)
        assert msg.startswith(mine.option_strings[0]), msg
        assert "is not ported yet" in msg
        return
    fields = {f.name for f in dataclasses.fields(Config)}
    if action.dest in fields:
        want = None if (action.dest == "norm" and value == "none") else value
        assert getattr(cfg, action.dest) == want
    else:
        assert value in accepted_values(action.dest, create_parser()), \
            f"{flag} {value} accepted but neither carried nor listed"


def test_every_jax_flag_is_carried_or_listed():
    """Each flag of the JAX CLI either reaches Config or has its accepted
    values in _NOT_PORTED: none is parsed and then dropped silently."""
    fields = {f.name for f in dataclasses.fields(Config)}
    p = create_parser()
    silent = [f for f, a in _jax_flags() if a.dest not in fields
              and accepted_values(a.dest, p) is None]
    assert not silent, silent


def test_n_partitions_defaults_to_2_as_in_jax():
    assert parse_config([]).n_partitions == 2 == Config().n_partitions
    assert j_create_parser().get_default("n_partitions") == 2


@pytest.mark.parametrize("name", SUBCOMMANDS)
def test_subcommands_exit_2_by_name(name, capsys, tmp_path):
    """Continual training's subcommand is refused by name; `serve` is
    ported, and without a checkpoint exits 2 with the JAX package's words;
    the serving fleet's are ported, and without partition artifacts exit 2
    with the JAX package's words."""
    if name == "serve":
        assert t_main.main([name, "--dataset", "sbm", "--device", "cpu",
                            "--ckpt-path", str(tmp_path)]) == 2
        assert ("[config] no loadable checkpoint for graph "
                "'sbm-2-metis-vol-trans' rate 1.00 under "
                f"{tmp_path} — train first, or point --ckpt-path at a "
                "finished run") in capsys.readouterr().err
        return
    if name in ("serve-router", "serve-backend"):
        assert t_main.main([name, "--dataset", "sbm", "--part-path",
                            str(tmp_path), "--serve-part", "0"]) == 2
        part_dir = os.path.join(str(tmp_path), "sbm-2-metis-vol-trans")
        assert (f"[config] no partition artifacts at {part_dir} — build "
                "them first") in capsys.readouterr().err
        return
    assert t_main.main([name, "--dataset", "sbm"]) == 2
    assert f"[config] {name} is not ported yet" in capsys.readouterr().err


@pytest.mark.parametrize("argv,flag", [
    (["--cycle-epochs", "3"], "--cycle-epochs 3"),
    (["--tune-prior", "model"], "--tune-prior model"),
    (["--no-comm-trace", "--warm-start", "w"], "--warm-start w"),
    (["--continual-source", "server"], "--continual-source server"),
    (["--cycles", "2"], "--cycles 2"),
])
def test_unported_flags_exit_2_naming_the_flag(argv, flag, capsys):
    assert t_main.main(BASE + argv) == 2
    assert f"[config] {flag} is not ported yet" in capsys.readouterr().err


@pytest.mark.parametrize("start,n", [(0, 12), (3, 9), (7, 5), (0, 4)])
def test_warm_mean_equals_the_jax_epoch_timer(start, n):
    """Epochs start..start+n-1 with random times (and comm, reduce): the
    port's mean is EpochTimer(warmup=5)'s, 0.0 when no epoch is past the
    warm-up."""
    assert WARMUP_EPOCHS == 5
    rng = np.random.default_rng(start + n)
    t, c, r = (list(rng.random(n)) for _ in range(3))
    timer = EpochTimer(warmup=5)
    for i in range(n):
        timer.record(start + i, t[i], c[i], r[i])
    assert timer.means() == (warm_mean(t, start), warm_mean(c, start),
                             warm_mean(r, start))
    assert (warm_mean(t, start) == 0.0) == (start + n <= 5)


def _losses(out: str) -> tuple[int, list]:
    line = [ln for ln in out.splitlines() if ln.startswith("LOSSES ")][-1]
    _, start, values = line.split(" ")
    return int(start.split("=")[1]), values.split(",")


def test_partition_cli_then_skip_partition_trains_the_same(tmp_path, capsys):
    """partition_cli writes the inductive artifacts at P=4 (named by
    --graph-name); a --skip-partition run trains from them and gives the
    losses, bitwise, of a run that partitioned itself."""
    flags = BASE + ["--n-partitions", "4", "--inductive", "--fix-seed",
                    "--model", "graphsage", "--n-layers", "2", "--n-hidden",
                    "8", "--use-pp", "--sampling-rate", "0.5",
                    "--n-epochs", "3", "--log-every", "3",
                    "--graph-name", "sbm-offline",
                    "--results-path", str(tmp_path / "res")]
    assert partition_cli.main(flags + ["--part-path",
                                       str(tmp_path / "a")]) == 0
    assert "partition artifacts written to" in capsys.readouterr().out
    assert (tmp_path / "a" / "sbm-offline" / "part3.npz").exists()
    assert t_main.main(flags + ["--part-path", str(tmp_path / "a"),
                                "--skip-partition", "--ckpt-path",
                                str(tmp_path / "ck_a")]) == 0
    out_a = capsys.readouterr().out
    assert t_main.main(flags + ["--part-path", str(tmp_path / "b"),
                                "--ckpt-path", str(tmp_path / "ck_b")]) == 0
    out_b = capsys.readouterr().out
    assert _losses(out_a) == _losses(out_b)
    assert len(_losses(out_a)[1]) == 3
    for fn in os.listdir(tmp_path / "a" / "sbm-offline"):
        a = tmp_path / "a" / "sbm-offline" / fn
        b = tmp_path / "b" / "sbm-offline" / fn
        if fn.endswith(".npz"):
            with np.load(a) as x, np.load(b) as y:
                assert sorted(x.files) == sorted(y.files)
                for k in x.files:
                    np.testing.assert_array_equal(x[k], y[k])
        else:
            assert a.read_text() == b.read_text()
    assert "Test Result | Accuracy" in out_a


def test_skip_partition_without_artifacts_fails_by_name(tmp_path, capsys):
    rc = t_main.main(BASE + ["--n-partitions", "4", "--skip-partition",
                             "--part-path", str(tmp_path), "--no-eval"])
    assert rc == 2
    err = capsys.readouterr().err
    assert "[config] --skip-partition: no partition artifacts at" in err
    assert not any(tmp_path.iterdir())


def test_partition_cli_writes_eval_artifacts_like_jax(tmp_path, capsys):
    """partition_cli --inductive --eval-device mesh writes, beside the
    train subgraph's artifacts, the eval graphs' ({name}-val: the train+val
    subgraph; {name}-test: the full graph), file for file and array for
    array the JAX partition_cli's for the same flags; without
    --eval-device mesh it writes the train subgraph's alone."""
    from bnsgcn_tpu import partition_cli as j_partition_cli
    flags = BASE + ["--n-partitions", "4", "--inductive", "--eval-device",
                    "mesh", "--fix-seed", "--graph-name", "sbm-ev"]
    assert partition_cli.main(flags + ["--part-path",
                                       str(tmp_path / "port")]) == 0
    out = capsys.readouterr().out
    assert out.count("eval partition artifacts written to") == 2
    # the same flags without the port's own --device and --dist-backend
    j_partition_cli.main(BASE[:2] + flags[len(BASE):]
                         + ["--part-path", str(tmp_path / "jax")])
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax")) == [
        "sbm-ev", "sbm-ev-test", "sbm-ev-val"]
    for name in names:
        a_dir, b_dir = tmp_path / "port" / name, tmp_path / "jax" / name
        assert sorted(os.listdir(a_dir)) == sorted(os.listdir(b_dir))
        for fn in os.listdir(a_dir):
            if fn.endswith(".npz"):
                with np.load(a_dir / fn) as x, np.load(b_dir / fn) as y:
                    assert sorted(x.files) == sorted(y.files)
                    for k in x.files:
                        np.testing.assert_array_equal(x[k], y[k],
                                                      err_msg=f"{name}/{k}")
            else:
                assert json.loads((a_dir / fn).read_text()) == json.loads(
                    (b_dir / fn).read_text())
    assert partition_cli.main(BASE + ["--n-partitions", "4", "--inductive",
                                      "--part-path", str(tmp_path / "host"),
                                      "--graph-name", "sbm-ev"]) == 0
    assert os.listdir(tmp_path / "host") == ["sbm-ev"]


def test_flagship_script_trains_at_p1(tmp_path):
    """scripts/reddit_torch.sh: GraphSAGE 4x256, use_pp, --inductive, rate
    0.1, dropout 0.5, with P=1, 2 epochs and a small synthetic Reddit
    appended."""
    env = dict(os.environ, PYTHON=sys.executable, PYTHONPATH=ROOT)
    r = subprocess.run(
        ["bash", os.path.join(ROOT, "scripts", "reddit_torch.sh"),
         "--dataset", "synth-reddit:0.005", "--n-partitions", "1",
         "--device", "cpu", "--n-epochs", "2", "--log-every", "1",
         "--fix-seed", "--part-path", str(tmp_path / "parts"),
         "--ckpt-path", str(tmp_path / "ck"), "--results-path",
         str(tmp_path / "res")],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    out = r.stdout
    assert "Process 000 | Epoch 00001 | Time(s)" in out
    assert "Epoch 00001 | Accuracy" in out and "Test Result | Accuracy" in out
    name = "synth-reddit:0.005-1-metis-vol-induc_p0.10"
    assert sorted(os.listdir(tmp_path / "ck")) == sorted(
        [f"{name}_0.ckpt", f"{name}_1.ckpt", f"{name}_final.ckpt"])
    with open(tmp_path / "res" / "synth-reddit:0.005_n1_p0.10.txt") as f:
        assert len(f.read().splitlines()) == 2
    assert _losses(out)[0] == 0 and len(_losses(out)[1]) == 2
