"""Offline partitioning (counterpart of bnsgcn_tpu/partition_cli.py).

    python -m bnsgcn_tpu_torch.partition_cli --dataset synth-reddit:0.5 \\
        --n-partitions 4 [--inductive [--eval-device mesh]]

Writes the artifact directory {part_path}/{graph_name}/ (meta.json,
shared.npz, part{p}.npz: the JAX package's format v2), overwriting one
that exists; under --inductive it partitions the train subgraph, and with
--eval-device mesh too it also writes the eval graphs' directories,
{graph_name}-val (the train+val subgraph) and {graph_name}-test (the full
graph), which the ranks' evaluation reads. A later run with the same flags
and --skip-partition trains from them. It takes the training CLI's flags;
a feature the port lacks exits 2 by name. --streaming-artifacts always (or
auto above run.STREAMING_MIN_EDGES edges) writes every directory through
the streaming builder, one part resident at a time, with the features
stored as --feat-storage (bfloat16: half the bytes), as
scripts/ogbn-papers100m_torch.sh's PARTITION=1 step does.
"""

from __future__ import annotations

import sys

from bnsgcn_tpu_torch.config import ConfigError, parse_config


def main(argv=None) -> int:
    try:
        cfg = parse_config(argv)
        if not cfg.graph_name:
            cfg = cfg.replace(graph_name=cfg.derive_graph_name())
        from bnsgcn_tpu_torch.run import (artifacts_dir, eval_cfg,
                                          prepare_partition)
        build_eval = cfg.inductive and cfg.eval_device == "mesh"
        g = train_g = None
        if build_eval:
            # the dataset once, for the train and the eval partitions
            from bnsgcn_tpu_torch.data.datasets import load_data
            from bnsgcn_tpu_torch.data.graph import inductive_split
            g, _, _ = load_data(cfg)
            train_g, val_g, test_g = inductive_split(g)
        prepare_partition(cfg, train_g, force=True, load=False)
        print(f"partition artifacts written to {artifacts_dir(cfg)}")
        if build_eval:
            for suffix, sub in (("-val", val_g), ("-test", test_g)):
                cfg_e = eval_cfg(cfg, suffix)
                prepare_partition(cfg_e, sub, force=True, load=False)
                print(f"eval partition artifacts written to "
                      f"{artifacts_dir(cfg_e)}")
    except ConfigError as e:
        print(f"[config] {e}", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
