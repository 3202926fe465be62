"""The port's multi-part partitioning and on-disk artifacts against the JAX
package, on the CPU.

Partitioners and artifacts are host numpy in both packages and the port
keeps its own copy, so they must agree exactly: every part id and every
array bitwise. Artifact directories written by either package load in the
other, array for array.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

from bnsgcn_tpu.data import artifacts as j_art
from bnsgcn_tpu.data import graph as j_graph
from bnsgcn_tpu.data import partitioner as j_part
from bnsgcn_tpu.native import native_available
from bnsgcn_tpu_torch.config import Config, ConfigError
from bnsgcn_tpu_torch.data import artifacts as t_art
from bnsgcn_tpu_torch.data import graph as t_graph
from bnsgcn_tpu_torch.data import partitioner as t_part
from bnsgcn_tpu_torch.run import artifacts_dir, prepare_partition

GRAPH = dict(n_nodes=260, n_class=4, n_feat=6, p_in=0.12, p_out=0.004,
             seed=11)


def _graphs():
    return t_graph.sbm_graph(**GRAPH), j_graph.sbm_graph(**GRAPH)


def _assert_artifacts_equal(a, b, geometry_keys=None):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name == "ell_geometry":
            keys = geometry_keys or sorted(set(x) | set(y))
            assert {k: x[k] for k in keys} == {k: y[k] for k in keys}
        elif isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name


@pytest.mark.parametrize("method", ["random", "bfs", "metis"])
@pytest.mark.parametrize("seed", [0, 3])
def test_partitioners_equal_jax_at_p4(method, seed):
    tg, jg = _graphs()
    if method == "bfs":
        tp, jp = (t_part.bfs_partition(tg, 4, seed),
                  j_part.bfs_partition(jg, 4, seed))
    else:
        if method == "metis":
            assert native_available()   # else the JAX side falls back to BFS
        tp = t_part.partition_graph(tg, 4, method=method, seed=seed)
        jp = j_part.partition_graph(jg, 4, method=method, seed=seed)
    assert tp.dtype == jp.dtype == np.int32
    np.testing.assert_array_equal(tp, jp)
    assert sorted(np.unique(tp).tolist()) == [0, 1, 2, 3]


def test_metis_objectives_equal_jax():
    tg, jg = _graphs()
    for obj in ("vol", "cut"):
        np.testing.assert_array_equal(
            t_part.partition_graph(tg, 4, method="metis", obj=obj, seed=1),
            j_part.partition_graph(jg, 4, method="metis", obj=obj, seed=1))


def _p4_artifacts():
    tg, jg = _graphs()
    pid = t_part.partition_graph(tg, 4, method="random", seed=3)
    return t_art.build_artifacts(tg, pid), j_art.build_artifacts(jg, pid)


def test_port_save_loads_in_jax(tmp_path):
    ta, ja = _p4_artifacts()
    t_art.save_artifacts(ta, str(tmp_path))
    got = j_art.load_artifacts(str(tmp_path))
    # the port's geometry has no GAT entry yet
    _assert_artifacts_equal(got, ja, geometry_keys=["fwd", "bwd"])


def test_jax_save_loads_in_port(tmp_path):
    ta, ja = _p4_artifacts()
    j_art.save_artifacts(ja, str(tmp_path))
    got = t_art.load_artifacts(str(tmp_path))
    _assert_artifacts_equal(got, j_art.load_artifacts(str(tmp_path)))
    _assert_artifacts_equal(got, ta, geometry_keys=["fwd", "bwd"])


@pytest.mark.parametrize("parts", [[2], [3, 1]])
def test_partial_load_equals_jax(tmp_path, parts):
    """A rank loads only its part: the stacked axis holds the listed parts in
    order, the pads and n_parts stay global."""
    ta, _ = _p4_artifacts()
    t_art.save_artifacts(ta, str(tmp_path))
    got = t_art.load_artifacts(str(tmp_path), parts=parts)
    want = j_art.load_artifacts(str(tmp_path), parts=parts)
    _assert_artifacts_equal(got, want, geometry_keys=["fwd", "bwd"])
    assert got.n_parts == 4 and got.feat.shape[0] == len(parts)
    np.testing.assert_array_equal(got.src, ta.src[parts])


def test_validate_artifact_dir_names_missing_and_stale_parts(tmp_path):
    ta, _ = _p4_artifacts()
    t_art.save_artifacts(ta, str(tmp_path))
    os.remove(tmp_path / "part3.npz")
    with pytest.raises(ConfigError, match=r"part files \[3\] are missing"):
        t_art.load_artifacts(str(tmp_path))
    t_art.load_artifacts(str(tmp_path), parts=[0])       # a partial load is fine
    with open(tmp_path / "meta.json") as f:
        meta = json.load(f)
    meta["n_parts"] = 2
    with open(tmp_path / "meta.json", "w") as f:
        json.dump(meta, f)
    with pytest.raises(ConfigError, match="extra part files"):
        t_art.load_artifacts(str(tmp_path))


def test_prepare_partition_writes_once_and_reuses(tmp_path):
    """The JAX package's prepare_partition contract: the directory is named
    after the configuration and reused when it exists."""
    cfg = Config(dataset="sbm", n_partitions=4, partition_method="random",
                 part_path=str(tmp_path), seed=2)
    path = artifacts_dir(cfg)
    assert os.path.basename(path) == "sbm-4-random-vol-trans"
    art = prepare_partition(cfg)
    assert os.path.exists(os.path.join(path, "part3.npz"))
    stamp = os.path.getmtime(os.path.join(path, "part0.npz"))
    again = prepare_partition(cfg)
    assert os.path.getmtime(os.path.join(path, "part0.npz")) == stamp
    _assert_artifacts_equal(again, art)
    _assert_artifacts_equal(j_art.load_artifacts(path), art,
                            geometry_keys=["fwd", "bwd"])
