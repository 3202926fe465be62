"""Host-side graph container and synthetic graph generators (counterpart of
bnsgcn_tpu/data/graph.py, copied so the port imports nothing of the JAX
package).

The generators draw the same numpy streams in the same order as the JAX
package's, so the same seed gives a bit-identical graph
(tests/test_torch_data.py pins it). Canonical form: self-loops removed then
re-added, so every node has in_deg >= 1 and out_deg >= 1.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass
class Graph:
    """Directed graph in COO form with node features/labels/masks.

    Edges are (src, dst): a message flows src -> dst, aggregation happens at
    dst (the reference's DGL `update_all(copy_u, sum)` over ('_U','_E','_V')).
    """

    n_nodes: int
    src: np.ndarray                    # [E] int64
    dst: np.ndarray                    # [E] int64
    feat: np.ndarray                   # [N, F] float32
    label: np.ndarray                  # [N] int64 (single-label) or [N, C] float32 (multi-label)
    train_mask: np.ndarray             # [N] bool
    val_mask: np.ndarray               # [N] bool
    test_mask: np.ndarray              # [N] bool
    multilabel: bool = False
    # cached degrees (with self-loops, i.e. canonical form)
    _in_deg: Optional[np.ndarray] = field(default=None, repr=False)
    _out_deg: Optional[np.ndarray] = field(default=None, repr=False)

    @property
    def n_edges(self) -> int:
        return int(self.src.shape[0])

    @property
    def n_feat(self) -> int:
        return int(self.feat.shape[1])

    @property
    def n_class(self) -> int:
        # reference helper/utils.py:61-65 (multi-label aware)
        if self.label.ndim == 1:
            return int(self.label.max()) + 1
        return int(self.label.shape[1])

    @property
    def n_train(self) -> int:
        return int(self.train_mask.sum())

    def in_degrees(self) -> np.ndarray:
        if self._in_deg is None:
            self._in_deg = np.bincount(self.dst, minlength=self.n_nodes).astype(np.int64)
        return self._in_deg

    def out_degrees(self) -> np.ndarray:
        if self._out_deg is None:
            self._out_deg = np.bincount(self.src, minlength=self.n_nodes).astype(np.int64)
        return self._out_deg

    def canonicalize(self) -> "Graph":
        """Remove then add self-loops (reference helper/utils.py:67-69).

        Dtype-preserving: int32 edge arrays (any n_nodes < 2^31 — even
        papers100M's 111M) stay int32, halving the billion-edge working
        set; promoting to int64 here was one of the 1.6B-edge rehearsal's
        memory hogs."""
        dt = self.src.dtype
        keep = self.src != self.dst
        src = np.concatenate([self.src[keep], np.arange(self.n_nodes, dtype=dt)])
        dst = np.concatenate([self.dst[keep], np.arange(self.n_nodes, dtype=dt)])
        return Graph(self.n_nodes, src, dst, self.feat, self.label,
                     self.train_mask, self.val_mask, self.test_mask, self.multilabel)

    def subgraph(self, node_mask: np.ndarray) -> "Graph":
        """Node-induced subgraph, ids relabelled in increasing order of the
        kept nodes (bnsgcn_tpu/data/graph.py:84, the reference's
        dgl.node_subgraph). A canonical graph's subgraph keeps every kept
        node's self-loop, so it is canonical too."""
        node_mask = np.asarray(node_mask, dtype=bool)
        new_id = np.full(self.n_nodes, -1, dtype=np.int64)
        kept = np.nonzero(node_mask)[0]
        new_id[kept] = np.arange(kept.shape[0])
        ekeep = node_mask[self.src] & node_mask[self.dst]
        return Graph(
            n_nodes=int(kept.shape[0]),
            src=new_id[self.src[ekeep]], dst=new_id[self.dst[ekeep]],
            feat=self.feat[kept], label=self.label[kept],
            train_mask=self.train_mask[kept], val_mask=self.val_mask[kept],
            test_mask=self.test_mask[kept], multilabel=self.multilabel)


def inductive_split(g: Graph) -> tuple[Graph, Graph, Graph]:
    """(train, train+val, full) nested subgraphs (bnsgcn_tpu/data/graph.py
    :111, the reference's helper/utils.py:226-230): training sees only the
    train nodes, validation the train and val nodes, the test the graph."""
    return (g.subgraph(g.train_mask), g.subgraph(g.train_mask | g.val_mask),
            g)


def _random_masks(rng: np.random.Generator, n: int,
                  train_frac=0.6, val_frac=0.2) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    perm = rng.permutation(n)
    n_train = int(train_frac * n)
    n_val = int(val_frac * n)
    train = np.zeros(n, dtype=bool)
    val = np.zeros(n, dtype=bool)
    test = np.zeros(n, dtype=bool)
    train[perm[:n_train]] = True
    val[perm[n_train:n_train + n_val]] = True
    test[perm[n_train + n_val:]] = True
    return train, val, test


def synthetic_graph(n_nodes=200, avg_degree=8, n_feat=16, n_class=5,
                    seed=0, multilabel=False, power_law=False) -> Graph:
    """Random directed graph with features correlated to labels.

    Used by tests and demos in place of downloadable datasets.
    `multilabel=True` gives multi-hot [N, n_class] f32 labels (each node's
    class plus each other class with probability 0.2), Yelp's label kind.
    `power_law=True` yields a skewed degree distribution closer to
    Reddit's.
    """
    rng = np.random.default_rng(seed)
    n_edges = n_nodes * avg_degree
    if power_law:
        # preferential-attachment-flavored endpoints: skewed degree distribution
        w = 1.0 / (np.arange(n_nodes) + 1.0) ** 0.5
        w /= w.sum()
        src = rng.choice(n_nodes, size=n_edges, p=w).astype(np.int64)
        dst = rng.choice(n_nodes, size=n_edges, p=w).astype(np.int64)
    else:
        src = rng.integers(0, n_nodes, size=n_edges).astype(np.int64)
        dst = rng.integers(0, n_nodes, size=n_edges).astype(np.int64)
    label = rng.integers(0, n_class, size=n_nodes).astype(np.int64)
    centers = rng.normal(size=(n_class, n_feat)).astype(np.float32)
    feat = (centers[label] + rng.normal(scale=1.0, size=(n_nodes, n_feat))).astype(np.float32)
    if multilabel:
        lab = np.zeros((n_nodes, n_class), dtype=np.float32)
        lab[np.arange(n_nodes), label] = 1.0
        extra = rng.random((n_nodes, n_class)) < 0.2
        label = np.maximum(lab, extra.astype(np.float32))
    train, val, test = _random_masks(rng, n_nodes)
    g = Graph(n_nodes, src, dst, feat, label, train, val, test,
              multilabel=multilabel)
    return g.canonicalize()


def reddit_like_graph(n_nodes=232_965, avg_degree=492, n_class=41,
                      n_feat=602, homophily=0.78, seed=0,
                      feat_snr=1.0, label_noise=0.0) -> Graph:
    """Degree-corrected SBM calibrated to Reddit's shape statistics.

    `feat_snr` scales the class centers relative to unit per-feature noise:
    below ~0.2 a node's OWN features are weakly informative and accuracy
    depends on neighborhood aggregation — which is what makes a broken
    BNS rescale or biased sampler VISIBLE as an accuracy drop.
    `label_noise` flips that fraction of labels (train and eval alike) to
    arbitrary other classes, capping attainable accuracy at ~1-label_noise
    the way real Reddit's ceiling is 97.2%, not 100% (reference
    README.md:100-101). Defaults preserve the saturating round-2 behavior
    (bench caches stay valid); the calibrated accuracy anchor
    (tests/test_accuracy_anchor.py) uses both knobs.

    Real Reddit (the reference's flagship dataset, helper/utils.py:40-41) is
    232,965 posts in 41 subreddit communities, ~114.6M directed edges (mean
    degree ~492), and STRONGLY clustered — a GraphSAGE reaching 97.2% test
    accuracy (reference README.md:101) requires high label homophily; the
    commonly reported edge homophily for Reddit is ~0.78, which is the
    default here. A uniform random graph (synthetic_graph) has none of this
    structure and is an adversarial worst case no real dataset in the
    reference's suite resembles.

    Model: community sizes ~ Zipf; per-node popularity w ~ (local rank)^-0.5
    (power-law degrees); each edge picks its source from the global
    popularity law; with prob `homophily` the destination comes from the
    SOURCE's community popularity law, else from the global law. Labels are
    the communities; features are label-correlated Gaussians. All sampling
    is inverse-transform (u^2 trick), O(E) vectorized.
    """
    rng = np.random.default_rng(seed)
    # Zipf-ish community sizes, largest first, each >= 32 nodes; small graphs
    # get fewer communities instead of a negative balancing remainder
    n_class = max(min(n_class, n_nodes // 64), 1)
    raw = 1.0 / np.arange(1, n_class + 1) ** 0.9
    sizes = np.maximum((raw / raw.sum() * n_nodes).astype(np.int64), 32)
    while sizes.sum() > n_nodes:          # trim the floor-induced excess from
        sizes[0] -= min(sizes[0] - 32, sizes.sum() - n_nodes)  # the largest
        if sizes[0] <= 32 and sizes.sum() > n_nodes:
            sizes = sizes[:-1]
    sizes[0] += n_nodes - sizes.sum()
    off = np.concatenate([[0], np.cumsum(sizes)])
    label = np.repeat(np.arange(n_class, dtype=np.int64), sizes)

    n_edges = n_nodes * avg_degree
    # popularity mass of community c: sum_j (j+1)^-0.5 ~ 2*sqrt(n_c)
    mass = 2.0 * np.sqrt(sizes.astype(np.float64))
    cdf = np.cumsum(mass / mass.sum())

    def global_draw(k):
        c = np.searchsorted(cdf, rng.random(k))
        return off[c] + (sizes[c] * rng.random(k) ** 2).astype(np.int64)

    src = global_draw(n_edges)
    intra = rng.random(n_edges) < homophily
    c_src = label[src]
    dst = np.empty(n_edges, dtype=np.int64)
    n_in = int(intra.sum())
    dst[intra] = off[c_src[intra]] + (
        sizes[c_src[intra]] * rng.random(n_in) ** 2).astype(np.int64)
    dst[~intra] = global_draw(n_edges - n_in)

    centers = rng.normal(size=(n_class, n_feat)).astype(np.float32)
    feat = (centers[label] * np.float32(feat_snr) + rng.normal(
        scale=1.0, size=(n_nodes, n_feat)).astype(np.float32))
    if label_noise > 0.0:
        # flip OBSERVED labels only, after features (and edges) were drawn
        # from the true communities: the flipped nodes carry no recoverable
        # signal, so ~label_noise is a genuine accuracy ceiling
        flip = rng.random(n_nodes) < label_noise
        shift = rng.integers(1, max(n_class, 2), size=n_nodes)
        label = np.where(flip, (label + shift) % n_class, label)
    train, val, test = _random_masks(rng, n_nodes)
    g = Graph(n_nodes, src, dst, feat, label, train, val, test)
    return g.canonicalize()


def sbm_graph(n_nodes=400, n_class=4, n_feat=16, p_in=0.05, p_out=0.002,
              seed=0) -> Graph:
    """Stochastic-block-model graph: communities align with labels, so a GNN
    can actually learn — the accuracy-improves e2e test uses this."""
    rng = np.random.default_rng(seed)
    label = rng.integers(0, n_class, size=n_nodes).astype(np.int64)
    same = label[:, None] == label[None, :]
    prob = np.where(same, p_in, p_out)
    mask = rng.random((n_nodes, n_nodes)) < prob
    src, dst = np.nonzero(mask)
    # symmetric edges
    src, dst = np.concatenate([src, dst]).astype(np.int64), np.concatenate([dst, src]).astype(np.int64)
    centers = rng.normal(size=(n_class, n_feat)).astype(np.float32)
    feat = (centers[label] * 0.8 + rng.normal(scale=1.0, size=(n_nodes, n_feat))).astype(np.float32)
    train, val, test = _random_masks(rng, n_nodes)
    g = Graph(n_nodes, src, dst, feat, label, train, val, test)
    return g.canonicalize()
