"""The PyTorch port stands alone: no module of bnsgcn_tpu_torch/ and not
chip_smoke.py imports jax or anything of the JAX package (bnsgcn_tpu,
tools/), nor flax, msgpack or ml_dtypes (the card's machine has none of
them: checkpoints, bf16 leaves included, go through the port's own codec),
by static scan and by importing every module in a fresh process."""

import ast
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "optax", "flax", "msgpack", "ml_dtypes",
             "bnsgcn_tpu", "tools"}


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "bnsgcn_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _port_modules():
    mods = []
    for f in _port_files():
        rel = os.path.relpath(f, ROOT)[:-3].replace(os.sep, ".")
        if rel.startswith("bnsgcn_tpu_torch"):
            mods.append(rel[:-len(".__init__")] if rel.endswith("__init__")
                        else rel)
    return mods


def test_no_jax_import_in_port_sources():
    bad = []
    for f in _port_files():
        with open(f) as fh:
            tree = ast.parse(fh.read(), f)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            elif (isinstance(node, ast.Call)
                  and getattr(node.func, "attr", getattr(node.func, "id", ""))
                  in ("import_module", "__import__") and node.args
                  and isinstance(node.args[0], ast.Constant)):
                names = [str(node.args[0].value)]
            bad += [f"{os.path.relpath(f, ROOT)}:{node.lineno} imports {n}"
                    for n in names if n.split(".")[0] in FORBIDDEN]
    assert not bad, bad
    assert len(_port_modules()) > 10
    assert {"bnsgcn_tpu_torch.parallel.halo", "bnsgcn_tpu_torch.parallel.mesh",
            "bnsgcn_tpu_torch.parallel.reducer",
            "bnsgcn_tpu_torch.parallel.sampling",
            "bnsgcn_tpu_torch.utils.prng", "bnsgcn_tpu_torch.utils.quant",
            "bnsgcn_tpu_torch.anchor", "bnsgcn_tpu_torch.evaluate",
            "bnsgcn_tpu_torch.utils.metrics",
            "bnsgcn_tpu_torch.data.disk_readers",
            "bnsgcn_tpu_torch.data.datasets",
            "bnsgcn_tpu_torch.ops.ell_attention"} <= set(_port_modules())


def test_importing_the_port_loads_no_jax():
    # modules an interpreter start-up hook may have loaded do not count
    code = ("import sys\nbefore = set(sys.modules)\n"
            + "".join(f"import {m}\n" for m in _port_modules())
            + "import chip_smoke\n"
            + f"bad = sorted(m for m in set(sys.modules) - before if "
              f"m.split('.')[0] in "
              f"{sorted(FORBIDDEN)!r})\n"
            + "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
