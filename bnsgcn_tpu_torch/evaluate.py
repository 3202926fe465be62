"""Full-graph evaluation (counterpart of bnsgcn_tpu/evaluate.py).

The eval forward is apply_model in eval mode over the whole undistributed
graph: COO sum-aggregation (ops/spmm.agg_sum), norms from the eval graph's
own degrees, identity exchange, no dropout.
"""

from __future__ import annotations

import numpy as np
import torch

from bnsgcn_tpu_torch.data.graph import Graph
from bnsgcn_tpu_torch.models.gnn import GNN, GraphEnv, apply_model
from bnsgcn_tpu_torch.ops.spmm import agg_sum
from bnsgcn_tpu_torch.utils.metrics import calc_acc


def build_eval_env(g: Graph, model: str, device) -> GraphEnv:
    in_deg = g.in_degrees().astype(np.float32)
    out_deg = g.out_degrees().astype(np.float32)
    if model == "gcn":
        in_deg, out_deg = np.sqrt(in_deg), np.sqrt(out_deg)
    src = torch.from_numpy(np.asarray(g.src, np.int64)).to(device)
    dst = torch.from_numpy(np.asarray(g.dst, np.int64)).to(device)
    return GraphEnv(
        n_dst=g.n_nodes, in_norm=torch.from_numpy(in_deg).to(device),
        out_norm=torch.from_numpy(out_deg).to(device),
        exchange=lambda i, h: h,
        aggregate=lambda h_ext: agg_sum(h_ext, src, dst, g.n_nodes),
        training=False)


@torch.no_grad()
def full_graph_logits(model: GNN, g: Graph, device) -> np.ndarray:
    env = build_eval_env(g, model.spec.model, device)
    feat = torch.from_numpy(np.asarray(g.feat, np.float32)).to(device)
    return apply_model(model, feat, env).cpu().numpy()


def evaluate_trans(name: str, model: GNN, g: Graph, device,
                   log=print) -> tuple[float, float]:
    """Transductive: val + test accuracy in one pass."""
    was_training = model.training
    model.eval()
    try:
        logits = full_graph_logits(model, g, device)
    finally:
        model.train(was_training)
    label = np.asarray(g.label)
    val_acc = calc_acc(logits[g.val_mask], label[g.val_mask])
    test_acc = calc_acc(logits[g.test_mask], label[g.test_mask])
    log("{:s} | Validation Accuracy {:.2%} | Test Accuracy {:.2%}".format(
        name, val_acc, test_acc))
    return val_acc, test_acc
