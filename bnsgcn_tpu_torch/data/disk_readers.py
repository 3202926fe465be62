"""Dependency-free on-disk dataset readers (counterpart of
bnsgcn_tpu/data/disk_readers.py, copied so the port imports nothing of the
JAX package).

The port has no dgl or ogb branch (reference requirements.txt:1-5): these
readers parse the libraries' documented on-disk layouts directly with
numpy + stdlib, so a dataset dropped under --data-path runs
`scripts/reddit_torch.sh` unchanged:

  * Reddit  — DGL layout `{data_path}/reddit/`: `reddit_data.npz`
    (feature/label/node_types, node_types 1=train 2=val 3=test) +
    `reddit_graph.npz` (scipy.sparse save_npz matrix, csr/csc/coo)
    (reference loader helper/utils.py:40-41 via dgl.data.RedditDataset).
  * Yelp    — GraphSAINT layout `{data_path}/yelp/`: `adj_full.npz`
    (scipy CSR), `feats.npy`, `class_map.json`, `role.json` ('tr'/'va'/'te')
    (reference helper/utils.py:48-57 via dgl.data.YelpDataset).
  * ogbn-*  — OGB NodePropPredDataset layout `{data_path}/{name_}/`:
    csv variant (`raw/edge.csv.gz`, `raw/node-feat.csv.gz`,
    `raw/node-label.csv.gz`) or binary variant (`raw/data.npz` +
    `raw/node-label.npz`, the papers100M format), plus
    `split/{split_name}/{train,valid,test}.csv.gz` index files
    (reference helper/utils.py:43-47 via ogb.nodeproppred).

All return a `Graph` with the fields the JAX package's dgl/ogb adapters
produce; `datasets.load_data` canonicalizes it (self-loops) afterwards.
"""

from __future__ import annotations

import glob
import gzip
import json
import os

import numpy as np

from bnsgcn_tpu_torch.data.graph import Graph


def _sparse_npz_edges(path: str) -> tuple[np.ndarray, np.ndarray, int]:
    """(src, dst, n) from a scipy.sparse.save_npz file without scipy."""
    z = np.load(path, allow_pickle=True)
    fmt = z["format"]
    fmt = fmt.item() if hasattr(fmt, "item") else fmt
    fmt = fmt.decode() if isinstance(fmt, bytes) else str(fmt)
    shape = tuple(int(x) for x in z["shape"])
    n = shape[0]
    if fmt == "coo":
        return z["row"].astype(np.int64), z["col"].astype(np.int64), n
    indptr = z["indptr"].astype(np.int64)
    indices = z["indices"].astype(np.int64)
    major = np.repeat(np.arange(len(indptr) - 1, dtype=np.int64),
                      np.diff(indptr))
    if fmt == "csr":
        return major, indices, n
    if fmt == "csc":
        return indices, major, n
    raise ValueError(f"unsupported sparse format {fmt!r} in {path}")


def load_reddit_npz(data_path: str) -> Graph:
    d = os.path.join(data_path, "reddit")
    z = np.load(os.path.join(d, "reddit_data.npz"))
    src, dst, n = _sparse_npz_edges(os.path.join(d, "reddit_graph.npz"))
    types = z["node_types"]
    return Graph(
        n_nodes=n, src=src, dst=dst,
        feat=z["feature"].astype(np.float32),
        label=z["label"].astype(np.int64),
        train_mask=types == 1, val_mask=types == 2, test_mask=types == 3,
    )


def load_yelp_saint(data_path: str) -> Graph:
    d = os.path.join(data_path, "yelp")
    src, dst, n = _sparse_npz_edges(os.path.join(d, "adj_full.npz"))
    feats = np.load(os.path.join(d, "feats.npy")).astype(np.float32)
    with open(os.path.join(d, "class_map.json")) as f:
        cmap = json.load(f)
    n_class = len(next(iter(cmap.values())))
    label = np.zeros((n, n_class), dtype=np.float32)
    for k, v in cmap.items():
        label[int(k)] = np.asarray(v, dtype=np.float32)
    with open(os.path.join(d, "role.json")) as f:
        role = json.load(f)
    masks = {}
    for key, mname in [("tr", "train_mask"), ("va", "val_mask"), ("te", "test_mask")]:
        m = np.zeros(n, dtype=bool)
        m[np.asarray(role[key], dtype=np.int64)] = True
        masks[mname] = m
    return Graph(n_nodes=n, src=src, dst=dst, feat=feats, label=label,
                 multilabel=True, **masks)


def _read_csv_gz(path: str, dtype) -> np.ndarray:
    with gzip.open(path, "rt") as f:
        return np.loadtxt(f, delimiter=",", dtype=dtype, ndmin=2)


def _read_split_ids(split_dir: str, part: str) -> np.ndarray:
    for cand, loader in [
        (os.path.join(split_dir, f"{part}.csv.gz"),
         lambda p: _read_csv_gz(p, np.int64).reshape(-1)),
        (os.path.join(split_dir, f"{part}.npz"),
         lambda p: next(iter(np.load(p).values())).reshape(-1).astype(np.int64)),
    ]:
        if os.path.exists(cand):
            return loader(cand)
    raise FileNotFoundError(f"no {part} split file under {split_dir}")


def load_ogb_disk(name: str, data_path: str) -> Graph:
    d = os.path.join(data_path, name.replace("-", "_"))
    raw = os.path.join(d, "raw")
    binary = os.path.join(raw, "data.npz")
    if os.path.exists(binary):
        z = np.load(binary)
        edge_index = z["edge_index"]
        src = edge_index[0].astype(np.int64)
        dst = edge_index[1].astype(np.int64)
        feat = z["node_feat"].astype(np.float32)
        n = int(z["num_nodes_list"][0]) if "num_nodes_list" in z else feat.shape[0]
        lz = np.load(os.path.join(raw, "node-label.npz"))
        label = next(iter(lz.values())).reshape(-1)
    else:
        edges = _read_csv_gz(os.path.join(raw, "edge.csv.gz"), np.int64)
        src, dst = edges[:, 0], edges[:, 1]
        feat = _read_csv_gz(os.path.join(raw, "node-feat.csv.gz"),
                            np.float32)
        label = _read_csv_gz(os.path.join(raw, "node-label.csv.gz"),
                             np.float64).reshape(-1)
        n = feat.shape[0]
    # unlabeled nodes are NaN in papers100M: the -1 sentinel, as the JAX
    # package's ogb adapter pins them (bnsgcn_tpu/data/datasets.py)
    if np.issubdtype(np.asarray(label).dtype, np.floating):
        label = np.nan_to_num(label, nan=-1.0)
    label = label.astype(np.int64)
    split_dirs = sorted(glob.glob(os.path.join(d, "split", "*")))
    if not split_dirs:
        raise FileNotFoundError(f"no split directory under {d}/split")
    sd = split_dirs[0]
    masks = {}
    for part, mname in [("train", "train_mask"), ("valid", "val_mask"),
                        ("test", "test_mask")]:
        m = np.zeros(n, dtype=bool)
        m[_read_split_ids(sd, part)] = True
        masks[mname] = m
    return Graph(n_nodes=n, src=src, dst=dst, feat=feat, label=label, **masks)
