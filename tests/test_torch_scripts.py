"""The port's twins of the reference scripts (scripts/*_torch.sh) against
the JAX package's scripts, on the CPU, without training: each script runs
under bash with `python` and `$PYTHON` standing for a recorder, so every
command line a script would start is recorded in order (a sweep's nine
runs, the multi-node flow's partition step and launch). Each recorded
command line of a twin parses through the port's create_parser and
config_from_args to the same fields as the JAX script's through
bnsgcn_tpu.config, field for field where both Configs have the field; a
twin only adds the port's own flags (--device, --dist-backend) where the
JAX script runs on a virtual CPU mesh. The OGB dataset is not in the repo,
so no twin trains here on products.
"""

import dataclasses
import os
import subprocess

import pytest

from bnsgcn_tpu import config as j_config
from bnsgcn_tpu_torch import config as t_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (JAX script, its twin, environment, the flags the twin adds)
TWINS = [
    ("ogbn-products.sh", "ogbn-products_torch.sh", {}, {}),
    ("sbm_demo.sh", "sbm_demo_torch.sh", {},
     {"device": "cpu", "dist_backend": "gloo"}),
    ("reddit_multi_node.sh", "reddit_multi_node_torch.sh",
     {"NODE_RANK": "0"}, {}),
    ("reddit_multi_node.sh", "reddit_multi_node_torch.sh",
     {"NODE_RANK": "2", "MASTER": "10.0.0.1"}, {}),
    ("reddit_full.sh", "reddit_full_torch.sh", {}, {}),
    ("ogbn-products_full.sh", "ogbn-products_full_torch.sh", {}, {}),
    ("yelp_full.sh", "yelp_full_torch.sh", {}, {}),
]
RECORDER = """#!/bin/sh
for a in "$@"; do printf '%s\\t' "$a"; done >> "$ARGV_LOG"
printf '\\n' >> "$ARGV_LOG"
"""


def _record(script, tmp, env, args=()):
    """The command lines `bash scripts/<script> args` starts, each a list
    of arguments after `python`."""
    work = tmp / script
    (work / "bin").mkdir(parents=True)
    for name in ("python", "python3"):
        exe = work / "bin" / name
        exe.write_text(RECORDER)
        exe.chmod(0o755)
    os.symlink(os.path.join(ROOT, "scripts"), work / "scripts")
    log = work / "argv.log"
    run_env = dict(os.environ, ARGV_LOG=str(log),
                   PATH=f"{work / 'bin'}:{os.environ['PATH']}",
                   PYTHON=str(work / "bin" / "python3"), **env)
    r = subprocess.run(["bash", os.path.join("scripts", script), *args],
                       cwd=work, env=run_env, capture_output=True, text=True,
                       timeout=60)
    assert r.returncode == 0, r.stderr
    return [ln.split("\t")[:-1] for ln in log.read_text().splitlines()]


def _fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("jax_script,twin,env,adds", TWINS,
                         ids=[f"{t}-{'-'.join(e.values()) or 'default'}"
                              for _, t, e, _ in TWINS])
def test_twin_parses_to_the_jax_scripts_config(tmp_path, jax_script, twin,
                                               env, adds):
    args = ("--n-epochs", "7", "--seed", "3")
    want = _record(jax_script, tmp_path / "jax", env,
                   () if "full" in jax_script else args)
    got = _record(twin, tmp_path / "port", env,
                  () if "full" in twin else args)
    assert want and len(got) == len(want)
    for j_argv, t_argv in zip(want, got):
        assert j_argv[:2] == ["-m", j_argv[1]] and t_argv[0] == "-m"
        assert t_argv[1] == j_argv[1].replace("bnsgcn_tpu.",
                                              "bnsgcn_tpu_torch.")
        j_cfg = _fields(j_config.parse_config(j_argv[2:]))
        t_cfg = _fields(t_config.parse_config(t_argv[2:]))
        for k, v in adds.items():
            assert t_cfg[k] == v
        common = sorted(set(j_cfg) & set(t_cfg))
        assert len(common) > 40
        diff = {k: (j_cfg[k], t_cfg[k]) for k in common
                if k not in adds and j_cfg[k] != t_cfg[k]}
        assert not diff, (j_argv, diff)
