"""Typed run configuration for the PyTorch port (counterpart of
bnsgcn_tpu/config.py).

Only the fields this slice reads are here, under the JAX CLI's flag names.
Flags of the JAX CLI that select a feature the port does not have yet are
parsed too, so that a command line written for the JAX package fails with a
named `[config] ... not ported yet` error (exit 2) instead of an argparse
usage error or, worse, a silently different run.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass
from typing import Optional


class ConfigError(ValueError):
    """A named configuration error: main.py prints it and exits 2."""


@dataclass(frozen=True)
class Config:
    # --- data ---
    dataset: str = "reddit"
    inductive: bool = False
    n_partitions: int = 1
    part_path: str = "./partition/"     # where P > 1 writes its artifacts
    partition_method: str = "metis"     # 'metis' | 'random'
    partition_obj: str = "vol"          # 'vol' | 'cut' (metis objective)

    # --- model ---
    model: str = "graphsage"            # 'gcn' | 'graphsage'
    n_layers: int = 2
    n_hidden: int = 16
    n_linear: int = 0
    norm: Optional[str] = "layer"       # 'layer' | None
    dropout: float = 0.5
    use_pp: bool = False

    # --- optimization ---
    lr: float = 1e-2
    weight_decay: float = 0.0
    n_epochs: int = 200
    sampling_rate: float = 1.0

    # --- bookkeeping ---
    log_every: int = 10
    eval: bool = True
    seed: int = 0

    # --- aggregation ---
    dtype: str = "float32"
    spmm: str = "ell"                   # 'ell' | 'hybrid'
    use_pallas: bool = False            # accepted for command-line parity: on
                                        # the card the hand-written kernels
                                        # always run
    block_occupancy: int = 0            # hybrid: min edges for a dense tile
                                        # (0 = tile*tile/512)
    block_tile_budget_mb: int = 2048    # hybrid: int8 tile budget per direction
    block_tile: int = 512               # hybrid: square tile edge

    # --- where it runs ---
    device: str = "cuda"                # 'cuda' | 'cpu'
    dist_backend: str = "nccl"          # P > 1: 'nccl' (one card per rank)
                                        # | 'gloo' (ranks may share a card
                                        # or run on the CPU)

    # filled from the partition artifacts
    n_feat: int = 0
    n_class: int = 0
    n_train: int = 0

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def derive_graph_name(self) -> str:
        """The artifact directory's name (bnsgcn_tpu/config.py:424)."""
        mode = "induc" if self.inductive else "trans"
        return (f"{self.dataset}-{self.n_partitions}-{self.partition_method}-"
                f"{self.partition_obj}-{mode}")

    def layer_sizes(self) -> list[int]:
        """[n_feat, hidden, ..., hidden, n_class] (bnsgcn_tpu/config.py:419)."""
        if self.n_layers < 1:
            raise ConfigError(f"--n-layers must be >= 1, got {self.n_layers}")
        return ([self.n_feat] + [self.n_hidden] * (self.n_layers - 1)
                + [self.n_class])


# flags of the JAX CLI whose non-default values select features that later
# slices port: (flag, default, why it is refused)
_NOT_PORTED = (
    ("halo_exchange", "padded", "--halo-exchange other than padded"),
    ("halo_wire", "native", "--halo-wire other than native"),
    ("dtype", "float32", "--dtype bfloat16"),
    ("spmm_dense", "native", "--spmm-dense int8"),
    ("spmm_gather", "native", "--spmm-gather fp8/int8"),
    ("inductive", False, "--inductive"),
    ("replicas", 1, "--replicas > 1"),
    ("feat", 1, "--feat > 1"),
    ("halo_refresh", 1, "--halo-refresh > 1"),
    ("overlap", "off", "--overlap split"),
    ("reorder", "off", "--reorder"),
    ("resume", False, "--resume (checkpoints)"),
    ("heads", 1, "--heads (GAT)"),
)


def create_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="bnsgcn_tpu_torch: the PyTorch/CUDA port of bnsgcn_tpu "
                    "(GraphSAGE/GCN training on P ranks with boundary-node "
                    "sampling)")

    def both(name, **kw):
        p.add_argument(f"--{name}", f"--{name.replace('-', '_')}", **kw)

    p.add_argument("--dataset", type=str, default="reddit")
    both("part-path", type=str, default="./partition/")
    p.add_argument("--model", type=str, default="graphsage",
                   choices=["gcn", "graphsage", "gat"])
    p.add_argument("--dropout", type=float, default=0.5)
    p.add_argument("--lr", type=float, default=1e-2)
    both("sampling-rate", type=float, default=1.0)
    p.add_argument("--heads", type=int, default=1)
    both("n-epochs", type=int, default=200)
    both("n-partitions", type=int, default=1)
    both("n-hidden", type=int, default=16)
    both("n-layers", type=int, default=2)
    both("log-every", type=int, default=10)
    both("weight-decay", type=float, default=0.0)
    p.add_argument("--norm", choices=["layer", "batch", "none"],
                   default="layer")
    both("partition-obj", choices=["vol", "cut"], default="vol")
    both("partition-method", choices=["metis", "random"], default="metis")
    both("n-linear", type=int, default=0)
    both("use-pp", action="store_true", default=False)
    p.add_argument("--inductive", action="store_true")
    both("fix-seed", action="store_true", default=False)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--eval", action="store_true", dest="eval")
    p.add_argument("--no-eval", action="store_false", dest="eval")
    p.set_defaults(eval=True)
    p.add_argument("--replicas", type=int, default=1)
    p.add_argument("--feat", type=int, default=1)
    p.add_argument("--dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--spmm", type=str, default="ell",
                   choices=["ell", "hybrid", "auto", "segment"])
    both("halo-exchange", type=str, default="padded",
         choices=["padded", "shift", "ragged", "auto"])
    both("halo-wire", type=str, default="native",
         choices=["native", "bf16", "fp8", "int8"])
    both("halo-refresh", type=int, default=1)
    p.add_argument("--overlap", type=str, default="off",
                   choices=["off", "split"])
    p.add_argument("--reorder", type=str, default="off",
                   choices=["auto", "cluster", "off"])
    p.add_argument("--resume", action="store_true")
    both("use-pallas", action="store_true", default=False)
    both("spmm-gather", type=str, default="native",
         choices=["native", "fp8", "int8"])
    both("spmm-dense", type=str, default="native", choices=["native", "int8"])
    both("block-occupancy", type=int, default=0)
    both("block-tile-budget-mb", type=int, default=2048)
    both("block-tile", type=int, default=512)
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"],
                   help="run on the GPU (default) or, when asked, the CPU")
    both("dist-backend", type=str, default="nccl", choices=["nccl", "gloo"],
         help="P > 1: nccl runs one rank per card; gloo lets ranks share a "
              "card (collectives staged through host memory) or run on the "
              "CPU")
    return p


def config_from_args(args: argparse.Namespace) -> Config:
    """Namespace -> Config, refusing every selected feature the port lacks."""
    d = vars(args).copy()
    for name, default, what in _NOT_PORTED:
        if name in d and d[name] != default:
            raise ConfigError(f"{what} is not ported yet")
    if d.get("model") == "gat":
        raise ConfigError("--model gat is not ported yet")
    if d.get("norm") == "batch":
        raise ConfigError("--norm batch (SyncBatchNorm) is not ported yet")
    if d.get("spmm") in ("auto", "segment"):
        raise ConfigError(f"--spmm {d['spmm']} is not ported yet")
    rate = d.get("sampling_rate", 1.0)
    if not 0.0 < rate <= 1.0:
        raise ConfigError(f"--sampling-rate must be in (0, 1], got {rate}")
    if d.get("norm") == "none":
        d["norm"] = None
    if (d.get("n_partitions", 1) > 1 and d.get("device") == "cpu"
            and d.get("dist_backend") != "gloo"):
        raise ConfigError("--device cpu with --n-partitions > 1 needs "
                          "--dist-backend gloo: NCCL runs on CUDA devices "
                          "only")
    valid = {f.name for f in dataclasses.fields(Config)}
    return Config(**{k: v for k, v in d.items() if k in valid})


def parse_config(argv=None) -> Config:
    return config_from_args(create_parser().parse_args(argv))
