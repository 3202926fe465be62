"""Evaluation (counterpart of bnsgcn_tpu/evaluate.py).

--eval-device host (the default): the eval forward is apply_model in eval
mode over the whole undistributed graph on rank 0's device: COO
sum-aggregation in a fixed order per row (ops/spmm.FixedOrderSum, each
row's terms in the order of its in-edges, as index_add_ adds them on the
CPU: the same bits on every call on a card too; GAT: the segment softmax
over the same edges, ops/spmm.segment_softmax), norms from the eval
graph's own degrees, identity exchange, no dropout. Transductive runs
score the val and test masks of the full graph in one pass; inductive runs
score a subgraph's val or test mask (run.py hands in the train+val
subgraph or the full graph). run.py runs these in a thread, overlapped
with training.

--eval-device mesh: `evaluate_mesh` runs the ranks' full-rate eval forward
(trainer.StepFns.eval_forward, through K1 and K2) over the eval graph's
partition artifacts; each rank reduces its inner rows to summable metric
statistics (`_metric_stats`), one all-reduce sums them, and rank 0 prints
the line: the JAX package's multi-process branch, since the port's ranks
are processes.

The serving forward (`full_graph_embeddings`, serve.py's tier B) is this
forward, returning the final layer's input too.

Accuracy is argmax accuracy on single-label rows and micro-F1 of
(logits > 0) on multilabel ones. Each line may also be appended to a
results file.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from bnsgcn_tpu_torch.data.graph import Graph
from bnsgcn_tpu_torch.models.gnn import GNN, GraphEnv, apply_model
from bnsgcn_tpu_torch.ops.spmm import FixedOrderSum
from bnsgcn_tpu_torch.utils.metrics import calc_acc


def coo_env(src, dst, n_dst: int, in_norm, out_norm,
            row_tile: int = 0) -> GraphEnv:
    """The eval forward's env over COO edges src -> dst (tensors on the
    device; dst == n_dst: a padded edge) with the given norms and the
    identity exchange: a FixedOrderSum's sums (GAT's too), and `row_tile`
    (models/gnn.by_rows)."""
    fixed = FixedOrderSum(src, dst, n_dst)
    return GraphEnv(
        n_dst=n_dst, in_norm=in_norm, out_norm=out_norm,
        exchange=lambda i, h: h, aggregate=fixed.gather_sum,
        training=False, src=src, dst=dst, row_tile=row_tile,
        fixed_sum=fixed)


def build_eval_env(g: Graph, model: str, device) -> GraphEnv:
    in_deg = g.in_degrees().astype(np.float32)
    out_deg = g.out_degrees().astype(np.float32)
    if model == "gcn":
        in_deg, out_deg = np.sqrt(in_deg), np.sqrt(out_deg)
    src = torch.from_numpy(np.asarray(g.src, np.int64)).to(device)
    dst = torch.from_numpy(np.asarray(g.dst, np.int64)).to(device)
    return coo_env(src, dst, g.n_nodes, torch.from_numpy(in_deg).to(device),
                   torch.from_numpy(out_deg).to(device))


class EvalGraph:
    """An eval graph's tensors on a device, copied once for repeated
    evaluations (run.HostEval's): the eval env (its COO edges too) and the
    raw features. The
    evaluate_* functions take it wherever they take a Graph."""

    def __init__(self, g: Graph, model: str, device):
        self.g, self.model, self.device = g, model, torch.device(device)
        self.env = build_eval_env(g, model, device)
        self.feat = torch.from_numpy(np.asarray(g.feat, np.float32)).to(device)


def _to_host(x: torch.Tensor) -> np.ndarray:
    """x as host numpy. From a card through a pinned buffer, waiting on an
    event: a copy into pageable memory waits inside the driver for the
    stream's queued work, and the process's other pageable copies (the
    training thread's, beside an eval thread) wait behind it."""
    if x.device.type != "cuda":
        return x.numpy()
    out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    out.copy_(x, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    done.synchronize()
    return out.numpy()


@torch.no_grad()
def full_graph_logits(model: GNN, g, device) -> np.ndarray:
    """The eval forward's logits on the whole of g (a Graph, or an
    EvalGraph already on `device`), as host numpy."""
    if not isinstance(g, EvalGraph):
        g = EvalGraph(g, model.spec.model, device)
    return _to_host(apply_model(model, g.feat, g.env))


@torch.no_grad()
def full_graph_embeddings(model: GNN, g, device
                          ) -> tuple[np.ndarray, np.ndarray]:
    """(hidden [N, H], logits [N, C]) on the whole of g (a Graph, or an
    EvalGraph already on `device`; bnsgcn_tpu/evaluate.py:59): the
    all-node embedding table serve.py and --dump-embeddings precompute, the
    final layer's input and its output through full_graph_logits' forward
    (the same logits, bitwise)."""
    if not isinstance(g, EvalGraph):
        g = EvalGraph(g, model.spec.model, device)
    logits, hidden = apply_model(model, g.feat, g.env, return_hidden=True)
    return _to_host(hidden), _to_host(logits)


def _graph(g) -> Graph:
    return g.g if isinstance(g, EvalGraph) else g


def _logits(model: GNN, g, device) -> np.ndarray:
    was_training = model.training
    model.eval()
    try:
        return full_graph_logits(model, g, device)
    finally:
        model.train(was_training)


def _emit(buf: str, log, result_file: Optional[str]):
    """Log the line and, with a results file, append it there."""
    log(buf)
    if result_file is not None:
        with open(result_file, "a+") as f:
            f.write(buf + "\n")


def evaluate_trans(name: str, model: GNN, g, device, log=print,
                   result_file: Optional[str] = None) -> tuple[float, float]:
    """Transductive: val + test accuracy in one pass (g a Graph or an
    EvalGraph)."""
    logits = _logits(model, g, device)
    g = _graph(g)
    label = np.asarray(g.label)
    val_acc = calc_acc(logits[g.val_mask], label[g.val_mask])
    test_acc = calc_acc(logits[g.test_mask], label[g.test_mask])
    _emit("{:s} | Validation Accuracy {:.2%} | Test Accuracy {:.2%}".format(
        name, val_acc, test_acc), log, result_file)
    return val_acc, test_acc


def evaluate_induc(name: str, model: GNN, g, device, mode: str,
                   log=print, result_file: Optional[str] = None) -> float:
    """Inductive (bnsgcn_tpu/evaluate.py:86): the accuracy on subgraph g's
    `mode` ('val' | 'test') mask, from logits computed on g alone with
    norms from g's own degrees (g a Graph or an EvalGraph)."""
    logits = _logits(model, g, device)
    g = _graph(g)
    mask = g.val_mask if mode == "val" else g.test_mask
    acc = calc_acc(logits[mask], np.asarray(g.label)[mask])
    _emit("{:s} | Accuracy {:.2%}".format(name, acc), log, result_file)
    return acc


def gather_parts(art, stacked) -> np.ndarray:
    """[P, pad_inner, ...] stacked per-part rows -> [N, ...] in global node
    order (drops padding via inner_mask, places via global_nid)."""
    stacked = np.asarray(stacked)
    out = np.zeros((int(art.n_inner.sum()),) + stacked.shape[2:],
                   stacked.dtype)
    for p in range(art.n_parts):
        ids = art.global_nid[p][art.inner_mask[p]]
        out[ids] = stacked[p][art.inner_mask[p]]
    return out


def _metric_stats(logits, labels, mask, multilabel) -> np.ndarray:
    """Sufficient statistics for accuracy / micro-F1 as a summable int64
    [3]: (correct, rows, 0), or (true, false positives, false
    negatives)."""
    lg, lb = logits[mask], labels[mask]
    if multilabel:
        pred = lg > 0
        pos = lb.astype(bool)
        return np.array([np.sum(pos & pred), np.sum(~pos & pred),
                         np.sum(pos & ~pred)], dtype=np.int64)
    correct = np.sum(np.argmax(lg, 1) == lb) if lg.size else 0
    return np.array([correct, lb.shape[0], 0], dtype=np.int64)


def _stats_to_acc(s, multilabel) -> float:
    if multilabel:
        denom = 2 * s[0] + s[1] + s[2]
        return float(2 * s[0] / denom) if denom else 0.0
    return float(s[0] / s[1]) if s[1] else 0.0


def evaluate_mesh(name: str, eval_forward, model: GNN, blk_eval: dict,
                  art_eval, modes: tuple, result_file: Optional[str] = None,
                  comm=None, log=print) -> dict:
    """Evaluation on the ranks (bnsgcn_tpu/evaluate.py:140, its
    multi-process branch): every rank runs `eval_forward` (a collective at
    P > 1) on its part of the eval graph (`blk_eval` on its device, the
    raw features in 'feat'; `art_eval` its artifacts, holding this rank's
    part alone or every part), reduces its inner rows' logits to
    _metric_stats per mode ('val', 'test'), and one all-reduce sums the
    int64 vectors. Every rank returns {mode: accuracy}; rank 0 emits the
    line (val and test: the transductive line; one mode: `name | Accuracy
    x%`)."""
    rank = comm.rank if comm is not None else 0
    row = rank if art_eval.feat.shape[0] == art_eval.n_parts else 0
    logits = _to_host(eval_forward(model, blk_eval).float())
    masks = {"val": art_eval.val_mask, "test": art_eval.test_mask}
    stats = np.stack([_metric_stats(
        logits, art_eval.label[row], masks[m][row] & art_eval.inner_mask[row],
        art_eval.multilabel) for m in modes])
    if comm is not None:
        total = torch.from_numpy(stats).to(comm.device)
        stats = comm.all_reduce_(total).cpu().numpy()
    accs = {m: _stats_to_acc(s, art_eval.multilabel)
            for m, s in zip(modes, stats)}
    if "test" in accs and "val" in accs:
        buf = ("{:s} | Validation Accuracy {:.2%} | Test Accuracy "
               "{:.2%}".format(name, accs["val"], accs["test"]))
    else:
        buf = "{:s} | Accuracy {:.2%}".format(name, list(accs.values())[0])
    if rank == 0:
        _emit(buf, log, result_file)
    return accs
