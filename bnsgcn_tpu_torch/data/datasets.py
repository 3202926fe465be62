"""Dataset loaders for the slice (counterpart of bnsgcn_tpu/data/datasets.py).

The offline synthetic families, generated from `cfg.seed`:

  * 'synthetic'          small random graph (tests/demos)
  * 'sbm'                stochastic block model (learnable communities)
  * 'synth-reddit[:s]'   Reddit-shaped degree-corrected SBM: 602 features,
                         41 classes, 232,965 * s nodes (s defaults to 0.1)

The real Reddit/Yelp/OGB readers are not ported yet.
"""

from __future__ import annotations

from bnsgcn_tpu_torch.config import Config
from bnsgcn_tpu_torch.data.graph import (Graph, reddit_like_graph, sbm_graph,
                                         synthetic_graph)


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
    if name == "synthetic":
        g = synthetic_graph(n_nodes=2000, avg_degree=10, n_feat=32, n_class=8,
                            seed=cfg.seed)
    elif name == "sbm":
        g = sbm_graph(n_nodes=2000, n_class=8, n_feat=32, seed=cfg.seed)
    elif name.startswith("synth-reddit"):
        scale = float(name.split(":", 1)[1]) if ":" in name else 0.1
        g = synth_reddit(scale=scale, seed=cfg.seed)
    elif name in ("reddit", "yelp", "ogbn-products", "ogbn-papers100m"):
        from bnsgcn_tpu_torch.config import ConfigError
        raise ConfigError(f"dataset {name!r} (on-disk reader) is not ported "
                          f"yet; use synthetic, sbm or synth-reddit[:scale]")
    else:
        raise ValueError(f"Unknown dataset: {name}")
    g = g.canonicalize()
    return g, g.n_feat, g.n_class
