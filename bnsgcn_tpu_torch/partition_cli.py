"""Offline partitioning (counterpart of bnsgcn_tpu/partition_cli.py).

    python -m bnsgcn_tpu_torch.partition_cli --dataset synth-reddit:0.5 \\
        --n-partitions 4 [--inductive]

Writes the artifact directory {part_path}/{graph_name}/ (meta.json,
shared.npz, part{p}.npz: the JAX package's format v2), overwriting one
that exists; under --inductive it partitions the train subgraph. A later
run with the same flags and --skip-partition trains from it. It takes the
training CLI's flags; a feature the port lacks (--eval-device mesh, which
would also partition the eval subgraphs, among them) exits 2 by name.
"""

from __future__ import annotations

import sys

from bnsgcn_tpu_torch.config import ConfigError, parse_config


def main(argv=None) -> int:
    try:
        cfg = parse_config(argv)
        if not cfg.graph_name:
            cfg = cfg.replace(graph_name=cfg.derive_graph_name())
        from bnsgcn_tpu_torch.run import artifacts_dir, prepare_partition
        prepare_partition(cfg, force=True)
    except ConfigError as e:
        print(f"[config] {e}", file=sys.stderr)
        return 2
    print(f"partition artifacts written to {artifacts_dir(cfg)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
