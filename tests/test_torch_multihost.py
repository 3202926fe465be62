"""The multi-host launch and the launcher's reads, on the CPU.

Two launchers of 2 gloo ranks each on localhost (--n-nodes 2
--parts-per-node 2 --node-rank 0|1) against one launcher of 4 (the law
tests/test_multihost.py pins for the JAX package's two processes):

  * without --fix-seed node 1 adopts the seed node 0 drew, and one launch
    of 4 with that seed trains the same losses, bitwise, and ends on the
    same parameters (the periodic checkpoints' bytes of parameters);
  * --resume across the two launchers (node 0 picks the checkpoint and
    hands its choice and seed over; rank 0 broadcasts the state) continues
    as the uninterrupted run, with a warm --cache-dir;
  * every named config error exits 2, and a node that cannot reach node 0
    exits 1 with a [launch] line;
  * a launcher reads only meta.json and shared.npz of the artifacts, never
    a part file: the ranks load their own parts;
  * `--inject sigterm@E3:r2` (a rank of node 1) makes both launchers exit
    75: the ranks agree on the preemption over the world, rank 0 (node 0)
    writes the epoch-3 checkpoint.
"""

import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from bnsgcn_tpu_torch import checkpoint as ckpt
from bnsgcn_tpu_torch import main as t_main
from bnsgcn_tpu_torch import partition_cli
from bnsgcn_tpu_torch.parallel import mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGS = ["--dataset", "sbm", "--n-partitions", "4", "--dist-backend", "gloo",
         "--device", "cpu", "--model", "gcn", "--n-layers", "2",
         "--n-hidden", "16", "--sampling-rate", "0.5", "--use-pp",
         "--log-every", "2"]
TIMEOUT_S = 240


def _ports() -> int:
    """A free port p whose p + 1 is free too (the store and the ranks'
    rendezvous)."""
    for _ in range(50):
        with socket.socket() as a:
            a.bind(("127.0.0.1", 0))
            p = a.getsockname()[1]
            with socket.socket() as b:
                try:
                    b.bind(("127.0.0.1", p + 1))
                except OSError:
                    continue
        return p
    raise RuntimeError("no two adjacent free ports")


def _cmd(tmp, *extra):
    return ([sys.executable, "-m", "bnsgcn_tpu_torch.main"] + FLAGS
            + ["--part-path", str(tmp / "parts"), "--results-path",
               str(tmp / "res")] + list(extra))


def _env():
    return dict(os.environ, PYTHONPATH=ROOT)


def _one(tmp, *extra):
    r = subprocess.run(_cmd(tmp, *extra), capture_output=True, text=True,
                       env=_env(), timeout=TIMEOUT_S, cwd=tmp)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    return r.stdout


def _two(tmp, *extra, rc=0):
    """Two concurrent launchers, node 0 and node 1, each exiting `rc`;
    their stdouts."""
    port = _ports()
    node = ["--n-nodes", "2", "--parts-per-node", "2", "--master-addr",
            "127.0.0.1", "--port", str(port)]
    procs = [subprocess.Popen(_cmd(tmp, *extra, *node, "--node-rank", str(k)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=_env(), cwd=tmp)
             for k in (0, 1)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT_S)
            assert p.returncode == rc, out[-3000:] + err[-3000:]
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    return outs


def _line(out, prefix):
    return [ln for ln in out.splitlines() if ln.startswith(prefix)][-1]


def _params(ck, epoch):
    """The periodic checkpoint's parameters of epoch `epoch`, as bytes."""
    path = os.path.join(ck, f"sbm-4-metis-vol-trans_p0.50_{epoch}.ckpt")
    tree = ckpt.read_blob(path)["params"]
    out = {}

    def walk(prefix, x):
        if isinstance(x, dict):
            for k in sorted(x):
                walk(f"{prefix}/{k}", x[k])
        else:
            out[prefix] = np.asarray(x).tobytes()
    walk("", tree)
    return out


def test_two_nodes_train_as_one_launch_and_resume(tmp_path):
    a = _two(tmp_path, "--n-epochs", "4", "--ckpt-path",
             str(tmp_path / "ck_a"))
    seed = int(re.search(r"seed (\d+) \(drawn", a[0]).group(1))
    assert f"seed {seed} (node 0's)" in a[1]
    assert "node 0 of 2: ranks 0..1" in a[0]
    assert "node 1 of 2: ranks 2..3" in a[1]
    # both launchers report rank 0's losses (all-reduced: the same)
    assert _line(a[0], "LOSSES") == _line(a[1], "LOSSES")
    r0, r1 = _line(a[0], "RESULT"), _line(a[1], "RESULT")
    assert r0.split()[1] == r1.split()[1]
    # host eval: rank 0 alone evaluates, so node 1 reports 0 (as a JAX
    # process other than 0)
    assert r1.endswith("best_val=0.000000 test=0.000000")
    assert "Test Result" in a[0] and "Test Result" not in a[1]

    b = _one(tmp_path, "--n-epochs", "6", "--fix-seed", "--seed", str(seed),
             "--skip-partition", "--cache-dir", str(tmp_path / "cache"),
             "--ckpt-path", str(tmp_path / "ck_b"))
    losses_b = _line(b, "LOSSES").split()[2].split(",")
    assert _line(a[0], "LOSSES").split()[2].split(",") == losses_b[:4]
    assert _params(tmp_path / "ck_a", 3) == _params(tmp_path / "ck_b", 3)
    assert "layout cache: wrote" in b
    assert sum(1 for f in os.listdir(tmp_path / "cache")
               if f.endswith(".pkl")) == 4         # one per rank

    c = _two(tmp_path, "--n-epochs", "6", "--resume", "--skip-partition",
             "--cache-dir", str(tmp_path / "cache"), "--ckpt-path",
             str(tmp_path / "ck_a"))
    assert "Resumed from" in c[0] and "at epoch 4" in c[0]
    assert f"seed {seed} (node 0's); resuming from" in c[1]
    assert re.search(r"loaded layouts_\S+_ell\.pkl", c[0])
    assert "layout cache: wrote" not in c[0]
    assert _line(c[0], "LOSSES") == "LOSSES from_epoch=4 " + ",".join(
        losses_b[4:])
    assert _params(tmp_path / "ck_a", 5) == _params(tmp_path / "ck_b", 5)


@pytest.mark.parametrize("flags,msg", [
    (["--n-nodes", "2", "--parts-per-node", "1"],
     "--n-nodes 2 x --parts-per-node 1 = 2 ranks cannot host --n-partitions "
     "4"),
    (["--n-nodes", "3", "--parts-per-node", "2", "--node-rank", "2"],
     "process 2 hosts no partition"),
    (["--n-nodes", "2", "--node-rank", "2"],
     "--node-rank 2 is not a node of --n-nodes 2"),
    (["--backend", "nccl"], "--backend nccl is not ported yet"),
])
def test_node_config_errors_exit_2(tmp_path, capsys, flags, msg):
    rc = t_main.main(FLAGS + ["--part-path", str(tmp_path)] + flags)
    assert rc == 2
    assert f"[config] {msg}" in capsys.readouterr().err
    assert not any(tmp_path.iterdir())


def test_nccl_with_more_ranks_on_a_node_than_cards_exits_2(
        tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    flags = [a for a in FLAGS if a not in ("--device", "cpu")]
    flags[flags.index("gloo")] = "nccl"
    rc = t_main.main(flags + ["--part-path", str(tmp_path), "--n-nodes", "2",
                              "--parts-per-node", "2"])
    assert rc == 2
    err = capsys.readouterr().err
    assert ("[config] mesh does not fit: 2 ranks on this node with "
            "--dist-backend nccl needs 2 CUDA devices") in err


def test_unreachable_node_0_fails_by_name(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(mesh, "NODE_CONNECT_TIMEOUT_S", 2.0)
    rc = t_main.main(FLAGS + ["--part-path", str(tmp_path), "--n-nodes",
                              "2", "--parts-per-node", "2", "--node-rank",
                              "1", "--port", str(_ports())])
    assert rc == 1
    err = capsys.readouterr().err
    assert "[launch] node 1: the launchers' store at 127.0.0.1:" in err
    assert "unreachable within 2 s" in err


def test_launcher_reads_only_the_meta(tmp_path, monkeypatch, capsys):
    """A --skip-partition launch of 2 ranks: the launcher opens meta.json
    and shared.npz, never a part file (np.load in this process, the ranks
    being spawned processes of their own); the ranks train."""
    flags = FLAGS[:FLAGS.index("--n-partitions") + 1] + ["2"] + FLAGS[
        FLAGS.index("--n-partitions") + 2:] + [
        "--part-path", str(tmp_path / "p"), "--fix-seed", "--n-epochs", "2",
        "--no-eval", "--ckpt-path", str(tmp_path / "ck")]
    assert partition_cli.main(flags) == 0
    opened = []
    real = np.load

    def load(path, *a, **k):
        opened.append(os.path.basename(str(path)))
        return real(path, *a, **k)

    monkeypatch.setattr(np, "load", load)
    assert t_main.main(flags + ["--skip-partition"]) == 0
    assert opened == ["shared.npz"]
    assert "LOSSES from_epoch=0" in capsys.readouterr().out


def test_sigterm_on_a_rank_of_node_1_makes_both_launchers_exit_75(tmp_path):
    outs = _two(tmp_path, "--n-epochs", "8", "--fix-seed", "--ckpt-path",
                str(tmp_path / "ck"), "--inject", "sigterm@E3:r2", rc=75)
    path = os.path.join(tmp_path, "ck",
                        "sbm-4-metis-vol-trans_p0.50_3.ckpt")
    for out in outs:
        assert f"resumable checkpoint at {path}" in out
    assert ckpt.read_blob(path)["epoch"] == 3
