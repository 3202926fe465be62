"""--cache-dir, the layout cache, on the CPU at P=1 through the entry point.

  * a first run builds and writes this part's layouts, a second loads them
    and trains bitwise as a run without the cache (the ELL tables, the
    hybrid's tiles and residual, the GAT layouts);
  * another --spmm (another layout key) misses and builds its own;
  * a torn `*.tmp` of a dead writer is swept, a stale version or a corrupt
    file is ignored and rebuilt over, and the run trains as before;
  * the cache's file names carry the graph, the part's digest and the key,
    the JAX package's layout key of the same knobs.
"""

import os
import pickle
import re
import time

import pytest
import torch

from bnsgcn_tpu import trainer as j_trainer
from bnsgcn_tpu.config import Config as JConfig
from bnsgcn_tpu_torch import main as t_main
from bnsgcn_tpu_torch import trainer
from bnsgcn_tpu_torch.config import Config
from bnsgcn_tpu_torch.utils import diskcache

BASE = ["--dataset", "sbm", "--n-partitions", "1", "--device", "cpu",
        "--n-layers", "2", "--n-hidden", "8", "--n-epochs", "3",
        "--log-every", "10", "--fix-seed", "--use-pp", "--block-tile", "64"]
MODELS = {"ell": ["--model", "graphsage", "--spmm", "ell"],
          "hybrid": ["--model", "graphsage", "--spmm", "hybrid"],
          "gat": ["--model", "gat", "--heads", "2"]}
KEYS = {"ell": "ell", "hybrid": "hybrid-16-2048-t64", "gat": "gat"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(capsys, tmp, flags, cache=True):
    argv = BASE + flags + ["--ckpt-path", str(tmp / "ck"), "--results-path",
                           str(tmp / "res")]
    if cache:
        argv += ["--cache-dir", str(tmp / "cache")]
    assert t_main.main(argv) == 0
    out = capsys.readouterr().out
    losses = [ln for ln in out.splitlines() if ln.startswith("LOSSES")][-1]
    return out, losses


def _pickles(tmp):
    return sorted(f for f in os.listdir(tmp / "cache") if f.endswith(".pkl"))


@pytest.mark.parametrize("model", sorted(MODELS))
def test_warm_run_loads_and_trains_as_uncached(tmp_path, capsys, model):
    cold, l_cold = _run(capsys, tmp_path, MODELS[model])
    assert "layout cache: wrote" in cold
    names = _pickles(tmp_path)
    assert len(names) == 1
    assert re.fullmatch(rf"layouts_sbm-1-metis-vol-trans_[0-9a-f]{{12}}_"
                        rf"{KEYS[model]}\.pkl", names[0]), names
    warm, l_warm = _run(capsys, tmp_path, MODELS[model])
    assert f"loaded {names[0]}" in warm and "layout cache: wrote" not in warm
    _, l_none = _run(capsys, tmp_path, MODELS[model], cache=False)
    assert l_cold == l_warm == l_none


def test_another_spmm_misses(tmp_path, capsys):
    _run(capsys, tmp_path, MODELS["ell"])
    out, _ = _run(capsys, tmp_path, MODELS["hybrid"])
    assert "loaded layouts_" not in out
    assert "layout cache: wrote" in out
    assert [n.rsplit("_", 1)[1] for n in _pickles(tmp_path)] == [
        "ell.pkl", "hybrid-16-2048-t64.pkl"]


def test_torn_stale_and_corrupt_files(tmp_path, capsys):
    _, want = _run(capsys, tmp_path, MODELS["ell"])
    (name,) = _pickles(tmp_path)
    path = tmp_path / "cache" / name
    # a torn dump of a writer that is gone, untouched for two hours
    torn = tmp_path / "cache" / f"{name}.999999999.tmp"
    torn.write_bytes(b"\x80\x04garbage")
    old = time.time() - 7200
    os.utime(torn, (old, old))
    # a stale version
    with open(path, "wb") as f:
        pickle.dump((diskcache.CACHE_VER + 1, {"not": "a layout"}), f)
    out, got = _run(capsys, tmp_path, MODELS["ell"])
    assert not torn.exists()
    assert "cache sweep: removed 1 stale .tmp file(s)" in out
    assert f"stale cache version {diskcache.CACHE_VER + 1}" in out
    assert "layout cache: wrote" in out and got == want
    # a corrupt file
    path.write_bytes(b"not a pickle")
    out, got = _run(capsys, tmp_path, MODELS["ell"])
    assert f"cache read failed at {path}" in out
    assert "layout cache: wrote" in out and got == want
    # and the rewritten file loads again
    out, got = _run(capsys, tmp_path, MODELS["ell"])
    assert f"loaded {name}" in out and got == want


@pytest.mark.parametrize("knobs", [
    {}, {"block_tile": 64}, {"block_occupancy": 40},
    {"block_tile": 256, "block_tile_budget_mb": 512}, {"model": "gat"}])
def test_layout_keys_are_the_jax_keys(knobs):
    got, want = Config(**knobs), JConfig(**knobs)
    for name in ("ell_layout_key", "hybrid_layout_key", "gat_layout_key"):
        assert getattr(trainer, name)(got) == getattr(j_trainer, name)(want)
