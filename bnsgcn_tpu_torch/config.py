"""Typed run configuration for the PyTorch port (counterpart of
bnsgcn_tpu/config.py).

The parser takes every long option of the JAX CLI (python -m
bnsgcn_tpu.main), with the same default, type and choices, plus the port's
own --device and --dist-backend. Config carries the fields the port reads.
A flag that selects a feature the port does not have yet is refused by
name: `config_from_args` raises `[config] --<flag> ... is not ported yet`
(exit 2) for any value outside the ones `_NOT_PORTED` accepts, instead of
training a silently different run.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from dataclasses import dataclass
from typing import Optional


class ConfigError(ValueError):
    """A named configuration error: main.py prints it and exits 2."""


@dataclass(frozen=True)
class Config:
    # --- data / partitioning ---
    dataset: str = "reddit"
    data_path: str = "./dataset/"       # root of the on-disk datasets
                                        # (data/disk_readers.py layouts)
    part_path: str = "./partition/"     # where the artifacts are written
    graph_name: str = ""                # artifact directory ('' = derived)
    n_partitions: int = 2
    partition_method: str = "metis"     # 'metis' | 'random'
    partition_obj: str = "vol"          # 'vol' | 'cut' (metis objective)
    inductive: bool = False             # train on the train subgraph
    skip_partition: bool = False        # load the artifacts, never build
    streaming_artifacts: str = "auto"   # 'always' | 'never' | 'auto' (the
                                        # streaming builder above
                                        # run.STREAMING_MIN_EDGES edges)
    feat_storage: str = "float32"       # the streaming builder's feature
                                        # storage: 'float32' | 'bfloat16'

    # --- model ---
    model: str = "graphsage"            # 'gcn' | 'graphsage' | 'gat'
    heads: int = 1                      # GAT's attention heads
    n_layers: int = 2
    n_hidden: int = 16
    n_linear: int = 0
    norm: Optional[str] = "layer"       # 'layer' | 'batch' | None
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
    eval_device: str = "host"           # 'host': rank 0's overlapped eval on
                                        # the full graph; 'mesh': on the
                                        # ranks, through K1 and K2
    seed: int = 0
    fix_seed: bool = False
    ckpt_path: str = "./checkpoint/"
    results_path: str = "./results/"
    resume: bool = False
    keep_ckpt: int = 5
    cache_dir: str = ""                 # host-side layouts cached across
                                        # runs ('' = off)

    # --- aggregation ---
    dtype: str = "float32"              # 'float32' | 'bfloat16': parameters,
                                        # Adam moments and activations
    spmm: str = "ell"                   # 'ell' | 'hybrid' | 'auto' (hybrid
                                        # when enough edges densify) |
                                        # 'segment' (COO index_add_)
    use_pallas: bool = False            # accepted for command-line parity: on
                                        # the card the hand-written kernels
                                        # always run
    spmm_gather: str = "native"         # 'native' | 'int8' | 'fp8': the ELL
                                        # gathers' rows, one scale per call
    spmm_dense: str = "native"          # 'native' | 'int8': the dense
                                        # tiles' slabs
    halo_wire: str = "native"           # 'native' | 'bf16' | 'int8' | 'fp8':
                                        # the training exchange's payload
    halo_exchange: str = "padded"       # 'padded' | 'shift' | 'ragged' |
                                        # 'auto' (the collective)
    halo_refresh: int = 1               # K: exchange 1/K of each boundary
                                        # list per epoch, the rest cached
    halo_mode: str = "exchange"         # 'exchange' | 'grad-only' (no
                                        # activation exchange)
    overlap: str = "off"                # 'off' | 'split' (interior rows
                                        # aggregate while the exchange flies)
    edge_chunk: int = 0                 # --spmm segment: edges per chunk
                                        # (0: a memory budget's)
    block_occupancy: int = 0            # hybrid: min edges for a dense tile
                                        # (0 = tile*tile/512)
    block_tile_budget_mb: int = 2048    # hybrid: int8 tile budget per direction
    block_tile: int = 512               # hybrid: square tile edge
    reorder: str = "off"                # 'auto' | 'cluster' | 'off': each
                                        # part's rows in tile-packed
                                        # cluster order (data/reorder.py)
    remat: bool = False                 # recompute each layer's
                                        # activations in the backward

    # --- where it runs ---
    n_nodes: int = 1                    # launchers (one per node)
    node_rank: int = 0                  # this launcher's node
    master_addr: str = "127.0.0.1"      # node 0: the launchers' store at
    port: int = 18118                   # --port, the ranks' rendezvous at
                                        # --port + 1
    parts_per_node: int = 10            # ranks per node (n_nodes > 1)
    device: str = "cuda"                # 'cuda' | 'cpu'
    dist_backend: str = "nccl"          # P > 1: 'nccl' (one card per rank)
                                        # | 'gloo' (ranks may share a card
                                        # or run on the CPU)
    replicas: int = 1                   # R: full replicas of the
                                        # partitioned graph, each with its
                                        # own boundary sample; the gradient
                                        # is their mean
    feat: int = 1                       # T: hidden widths sharded T ways
                                        # (R x P x T ranks;
                                        # parallel/replicas.py, feat.py)

    # --- fault tolerance (resilience.py) ---
    resilience: str = "on"              # 'on': divergence rollback,
                                        # preemption exit 75, the hung-step
                                        # watchdog | 'off': the plain loop
    inject: str = ""                    # fault injection, e.g.
                                        # 'nan@E5,sigterm@E9:r1' (the env
                                        # $BNSGCN_FAULT is the default)
    resil_retries: int = 3              # rollbacks before exit 76
    # --- coordination and telemetry (parallel/coord.py, obs.py) ---
    coord: str = "auto"                 # 'tcp' | 'file' | 'off' | 'auto'
                                        # (tcp when more than one launch
                                        # coordinates: --n-nodes or
                                        # --coord-world > 1)
    coord_addr: str = ""                # rank 0's server (default
                                        # master_addr), --coord tcp
    coord_port: int = 18119             # rank 0's server port, --coord tcp
    coord_dir: str = ""                 # --coord file's shared directory
                                        # (default {ckpt_path}/.coord)
    coord_rank: int = -1                # harness mode: this launch's
    coord_world: int = 0                # coordination rank of coord_world
                                        # independent launches
    elastic: str = "off"                # 'on': a launch lost mid-run is a
                                        # resize of the world, not exit 77
    elastic_min_world: int = 1          # the smallest world a resize leaves
    obs: str = "on"                     # 'on': the telemetry bus (a log with
                                        # --obs-log) | 'off': nothing built
    obs_log: str = ""                   # the JSONL event log ($BNSGCN_OBS_LOG;
                                        # coordination rank r > 0 writes
                                        # PATH.r<r>)
    obs_dir: str = ""                   # post-mortem files (default
                                        # {ckpt_path}/postmortem)
    # --- the comm auto-tuner, strict execution, the profiler window
    # (tune.py, strict.py, utils/traceparse.py) ---
    tune: str = "off"                   # 'off' | 'schedule' | 'auto'
    tune_schedule: str = ""             # 'K=4@0,K=2@30,...' (--tune schedule)
    tune_prior: str = "ladder"          # 'ladder' ('model' is refused)
    strict_exec: bool = False           # guard every step (strict.py)
    profile_dir: str = ""               # the trace window's directory
    comm_trace: bool = True             # trace a window for the [traced]
                                        # Comm column (one launch only)
    # --- online serving (serve.py) and the embedding table ---
    serve_port: int = 18120             # the server's TCP port (0: any)
    serve_addr: str = ""                # its bind address ('' = all)
    serve_dir: str = ""                 # delta log and snapshot (default
                                        # {ckpt_path}/serve)
    serve_max_batch: int = 64           # tier-B targets per bucket step
    serve_refresh_s: float = 0.2        # background refresh period (0: off)
    embeddings: str = ""                # serve: cold-start table
    dump_embeddings: str = ""           # training: write the table here
    serve_compact_deltas: int = 0       # fold the delta log into a
                                        # snapshot every N deltas (0: off)

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


# Flags of the JAX CLI whose feature the port lacks, for some or all of
# their values: (dests, the values the port accepts (None: the flag's
# default only), what a refused value would select). An accepted value other
# than the default is one the port honours as it stands: --backend names
# the JAX package's collectives, a no-op here (--dist-backend picks the
# port's). --tune-prior model needs the JAX package's roofline model of
# the partition (its analysis tier), which the port does not have.
_NOT_PORTED = (
    (("tune_prior",), None, "the comm auto-tuner's model prior"),
    (("backend",), ("xla", "gloo", "mpi"),
     "collectives other than --dist-backend's"),
    (("parts", "part_replicas", "serve_part", "serve_replica",
      "serve_backend_port", "serve_router", "serve_degraded",
      "serve_probe_s", "serve_hedge", "serve_wal_cap"),
     None, "the partition-sharded serving fleet"),
    (("cycle_epochs", "cycles", "continual_source", "continual_cut_growth",
      "continual_imbalance", "continual_acc_drop", "warm_start",
      "cycle_nonce"), None, "continual training"),
)

# the JAX CLI's subcommands (bnsgcn_tpu/main.py:31-54); `serve` is
# ported (serve.py), the serving fleet's and continual training's are not
SUBCOMMANDS = ("serve", "serve-router", "serve-backend", "continual")
UNPORTED_SUBCOMMANDS = ("serve-router", "serve-backend", "continual")


def create_parser() -> argparse.ArgumentParser:
    """Every long option of bnsgcn_tpu/config.py create_parser, same
    defaults, types and choices, plus --device and --dist-backend."""
    p = argparse.ArgumentParser(
        description="bnsgcn_tpu_torch: the PyTorch/CUDA port of bnsgcn_tpu "
                    "(GraphSAGE/GCN/GAT training on P ranks with "
                    "boundary-node sampling)")

    def both(name, **kw):
        p.add_argument(f"--{name}", f"--{name.replace('-', '_')}", **kw)

    p.add_argument("--dataset", type=str, default="reddit")
    both("data-path", type=str, default="./dataset/")
    both("part-path", type=str, default="./partition/")
    both("graph-name", type=str, default="")
    p.add_argument("--model", type=str, default="graphsage",
                   choices=["gcn", "graphsage", "gat"])
    p.add_argument("--dropout", type=float, default=0.5)
    p.add_argument("--lr", type=float, default=1e-2)
    both("sampling-rate", type=float, default=1.0)
    p.add_argument("--heads", type=int, default=1)
    both("n-epochs", type=int, default=200)
    both("n-partitions", type=int, default=2)
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
    p.add_argument("--backend", type=str, default="xla")
    p.add_argument("--port", type=int, default=18118)
    both("master-addr", type=str, default="127.0.0.1")
    both("node-rank", type=int, default=0)
    both("parts-per-node", type=int, default=10)
    p.add_argument("--skip-partition", action="store_true")
    p.add_argument("--eval", action="store_true", dest="eval")
    p.add_argument("--no-eval", action="store_false", dest="eval")
    p.set_defaults(eval=True)
    p.add_argument("--replicas", type=int, default=1)
    p.add_argument("--feat", type=int, default=1)
    p.add_argument("--dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--spmm", type=str, default="ell",
                   choices=["ell", "hybrid", "auto", "segment"])
    both("profile-dir", type=str, default="")
    p.add_argument("--no-comm-trace", action="store_false", dest="comm_trace")
    p.set_defaults(comm_trace=True)
    p.add_argument("--remat", action="store_true")
    both("eval-device", type=str, default="host", choices=["host", "mesh"])
    both("halo-exchange", type=str, default="padded",
         choices=["padded", "shift", "ragged", "auto"])
    both("halo-wire", type=str, default="native",
         choices=["native", "bf16", "fp8", "int8"])
    both("halo-refresh", type=int, default=1)
    both("halo-mode", type=str, default="exchange",
         choices=["exchange", "grad-only"])
    p.add_argument("--tune", type=str, default="off",
                   choices=["off", "schedule", "auto"])
    both("tune-schedule", type=str, default="")
    both("tune-prior", type=str, default="ladder", choices=["ladder", "model"])
    p.add_argument("--overlap", type=str, default="off",
                   choices=["off", "split"])
    both("streaming-artifacts", type=str, default="auto",
         choices=["auto", "always", "never"])
    both("feat-storage", type=str, default="float32",
         choices=["float32", "bfloat16"])
    p.add_argument("--resilience", type=str, default="on",
                   choices=["on", "off"])
    p.add_argument("--inject", type=str,
                   default=os.environ.get("BNSGCN_FAULT", ""))
    both("resil-retries", type=int, default=3)
    p.add_argument("--elastic", type=str, default="off", choices=["off", "on"])
    both("elastic-min-world", type=int, default=1)
    p.add_argument("--coord", type=str, default="auto",
                   choices=["auto", "tcp", "file", "off"])
    both("coord-addr", type=str, default="")
    both("coord-port", type=int, default=18119)
    both("coord-dir", type=str, default="")
    both("coord-rank", type=int, default=-1)
    both("coord-world", type=int, default=0)
    both("serve-port", type=int, default=18120)
    both("serve-addr", type=str, default="")
    both("serve-dir", type=str, default="")
    both("serve-max-batch", type=int, default=64)
    both("serve-refresh-s", type=float, default=0.2)
    p.add_argument("--embeddings", type=str, default="")
    both("dump-embeddings", type=str, default="")
    both("serve-compact-deltas", type=int, default=0)
    p.add_argument("--parts", type=int, default=0)
    both("part-replicas", type=int, default=1)
    both("serve-part", type=int, default=-1)
    both("serve-replica", type=int, default=0)
    both("serve-backend-port", type=int, default=0)
    both("serve-router", type=str, default="")
    both("serve-degraded", type=str, default="off",
         choices=["off", "partial", "stale-ok"])
    both("serve-probe-s", type=float, default=0.0)
    both("serve-hedge", type=str, default="off", choices=["off", "on"])
    both("serve-wal-cap", type=int, default=256)
    both("cycle-epochs", type=int, default=5)
    p.add_argument("--cycles", type=int, default=1)
    both("continual-source", type=str, default="auto",
         choices=["auto", "server", "log"])
    both("continual-cut-growth", type=float, default=1.5)
    both("continual-imbalance", type=float, default=2.0)
    both("continual-acc-drop", type=float, default=0.02)
    both("warm-start", type=str, default="")
    both("cycle-nonce", type=int, default=0)
    p.add_argument("--obs", type=str, default="on", choices=["on", "off"])
    both("obs-log", type=str, default=os.environ.get("BNSGCN_OBS_LOG", ""))
    both("obs-dir", type=str, default="")
    both("strict-exec", action="store_true", default=False)
    both("cache-dir", type=str, default=os.environ.get("BNSGCN_CACHE_DIR", ""))
    both("edge-chunk", type=int, default=0)
    both("use-pallas", action="store_true", default=False)
    both("spmm-gather", type=str, default="native",
         choices=["native", "fp8", "int8"])
    both("spmm-dense", type=str, default="native", choices=["native", "int8"])
    both("block-occupancy", type=int, default=0)
    both("block-tile-budget-mb", type=int, default=2048)
    both("block-tile", type=int, default=512)
    p.add_argument("--reorder", type=str, default="off",
                   choices=["auto", "cluster", "off"])
    both("ckpt-path", type=str, default="./checkpoint/")
    both("results-path", type=str, default="./results/")
    p.add_argument("--resume", action="store_true")
    both("keep-ckpt", type=int, default=5)
    both("n-nodes", type=int, default=1)
    # the port's own
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"],
                   help="run on the GPU (default) or, when asked, the CPU")
    both("dist-backend", type=str, default="nccl", choices=["nccl", "gloo"],
         help="P > 1: nccl runs one rank per card; gloo lets ranks share a "
              "card (collectives staged through host memory) or run on the "
              "CPU")
    return p


def accepted_values(dest: str, parser: argparse.ArgumentParser):
    """The values of `dest` the port accepts: its _NOT_PORTED entry's (None:
    the parser's default only), or None when the port takes every value."""
    for dests, ok, _ in _NOT_PORTED:
        if dest in dests:
            return ok if ok is not None else (parser.get_default(dest),)
    return None


def node_ranks(cfg: Config) -> range:
    """The global ranks this node's launcher starts: all R x P x T with one
    node; with --n-nodes > 1, node k hosts [k * ppn, min((k + 1) * ppn,
    P)) for ppn = --parts-per-node (the reference's processes per node).
    Raises a named ConfigError for a node outside --n-nodes, too few slots
    for P, a node that hosts no rank, and --replicas or --feat above 1
    across nodes (the JAX package's refusal, bnsgcn_tpu/run.py:259-263)."""
    P, n, k, ppn = (cfg.n_partitions, cfg.n_nodes, cfg.node_rank,
                    cfg.parts_per_node)
    if n < 1:
        raise ConfigError(f"--n-nodes must be >= 1, got {n}")
    if not 0 <= k < n:
        raise ConfigError(f"--node-rank {k} is not a node of --n-nodes {n}")
    if n == 1:
        return range(cfg.replicas * P * cfg.feat)
    if cfg.replicas > 1 or cfg.feat > 1:
        raise ConfigError(
            "--replicas/--feat > 1 are single-host for now (multi-host "
            "processes map to parts slots only); run with --replicas 1 "
            "--feat 1 across hosts")
    if ppn < 1:
        raise ConfigError(f"--parts-per-node must be >= 1, got {ppn}")
    if n * ppn < P:
        raise ConfigError(
            f"--n-nodes {n} x --parts-per-node {ppn} = {n * ppn} ranks "
            f"cannot host --n-partitions {P}; raise either to cover it")
    if k * ppn >= P:
        raise ConfigError(
            f"process {k} hosts no partition: node {k} would start at rank "
            f"{k * ppn} of --n-partitions {P} (--parts-per-node {ppn}); use "
            f"n_partitions > {k} x {ppn}, or fewer --n-nodes")
    return range(k * ppn, min((k + 1) * ppn, P))


def config_from_args(args: argparse.Namespace, training: bool = True
                     ) -> Config:
    """Namespace -> Config, refusing every selected feature the port lacks;
    `training` False (the server) skips the checks of the training
    launch's ranks."""
    parser = create_parser()
    flags = {a.dest: a.option_strings[0] for a in parser._actions
             if a.option_strings and a.dest != "help"}
    d = vars(args).copy()
    for dests, _, what in _NOT_PORTED:
        for dest in dests:
            ok = accepted_values(dest, parser)
            if dest in d and d[dest] not in ok:
                v = d[dest]
                shown = "" if isinstance(v, bool) else f" {v}"
                raise ConfigError(f"{flags[dest]}{shown} is not ported yet "
                                  f"({what})")
    rate = d.get("sampling_rate", 1.0)
    if not 0.0 <= rate <= 1.0:
        # rate 0 is the paper's p=0 row: every pair sends only padding
        raise ConfigError(f"--sampling-rate must be in [0, 1], got {rate}")
    for flag in ("replicas", "feat"):
        if d.get(flag, 1) < 1:
            raise ConfigError(f"--{flag} must be >= 1, got {d[flag]}")
    if d.get("halo_refresh", 1) < 1:
        raise ConfigError(f"--halo-refresh must be >= 1, got "
                          f"{d['halo_refresh']}")
    if d.get("norm") == "none":
        d["norm"] = None
    ranks = (d.get("n_partitions", 1) * d.get("replicas", 1)
             * d.get("feat", 1))
    if (training and ranks > 1 and d.get("device") == "cpu"
            and d.get("dist_backend") != "gloo"):
        raise ConfigError("--device cpu with --n-partitions, --replicas or "
                          "--feat > 1 needs --dist-backend gloo: NCCL runs "
                          "on CUDA devices only")
    valid = {f.name for f in dataclasses.fields(Config)}
    return Config(**{k: v for k, v in d.items() if k in valid})


def parse_config(argv=None, training: bool = True) -> Config:
    return config_from_args(create_parser().parse_args(argv), training)
