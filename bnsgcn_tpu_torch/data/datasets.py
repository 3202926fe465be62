"""Dataset loaders (counterpart of bnsgcn_tpu/data/datasets.py).

The reference's datasets, read from --data-path in the libraries' on-disk
layouts (data/disk_readers.py; the port has no dgl or ogb branch):

  * 'reddit'             {data_path}/reddit/ (DGL's npz files)
  * 'yelp'               {data_path}/yelp/ (GraphSAINT's files), multilabel;
                         features standard-scaled on the train rows
  * 'ogbn-products'      {data_path}/ogbn_products/ (OGB's csv or binary)
  * 'ogbn-papers100m'    {data_path}/ogbn_papers100M/ (the same)

and the offline synthetic families, generated from `cfg.seed`:

  * 'synthetic'          small random graph (tests/demos)
  * 'sbm'                stochastic block model (learnable communities)
  * 'synth-reddit[:s]'   Reddit-shaped degree-corrected SBM: 602 features,
                         41 classes, 232,965 * s nodes (s defaults to 0.1)
"""

from __future__ import annotations

from bnsgcn_tpu_torch.config import Config
from bnsgcn_tpu_torch.data import disk_readers
from bnsgcn_tpu_torch.data.graph import (Graph, reddit_like_graph, sbm_graph,
                                         synthetic_graph)
from bnsgcn_tpu_torch.utils.metrics import standard_scale


def synth_reddit(scale: float = 1.0, seed: int = 0) -> Graph:
    """Reddit-shaped synthetic stand-in; node count and mean degree scale
    together so the edge density class stays Reddit-like."""
    n = max(int(232_965 * scale), 1000)
    avg_deg = max(int(492 * min(scale * 2, 1.0)), 25)
    return reddit_like_graph(n_nodes=n, avg_degree=avg_deg, n_feat=602,
                             n_class=41, seed=seed)


def load_data(cfg: Config) -> tuple[Graph, int, int]:
    """Returns (graph, n_feat, n_class), canonicalized."""
    name = cfg.dataset
    if name == "reddit":
        g = disk_readers.load_reddit_npz(cfg.data_path)
    elif name == "yelp":
        g = disk_readers.load_yelp_saint(cfg.data_path)
        g.feat = standard_scale(g.feat, g.train_mask)
    elif name == "ogbn-products":
        g = disk_readers.load_ogb_disk("ogbn-products", cfg.data_path)
    elif name == "ogbn-papers100m":
        g = disk_readers.load_ogb_disk("ogbn-papers100M", cfg.data_path)
    elif name == "synthetic":
        g = synthetic_graph(n_nodes=2000, avg_degree=10, n_feat=32, n_class=8,
                            seed=cfg.seed)
    elif name == "sbm":
        g = sbm_graph(n_nodes=2000, n_class=8, n_feat=32, seed=cfg.seed)
    elif name.startswith("synth-reddit"):
        scale = float(name.split(":", 1)[1]) if ":" in name else 0.1
        g = synth_reddit(scale=scale, seed=cfg.seed)
    else:
        raise ValueError(f"Unknown dataset: {name}")
    g = g.canonicalize()
    return g, g.n_feat, g.n_class
