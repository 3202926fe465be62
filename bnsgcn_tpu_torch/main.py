"""CLI entry point: `python -m bnsgcn_tpu_torch.main [flags]`.

It takes the JAX CLI's command line (python -m bnsgcn_tpu.main); the
flagship recipe is scripts/reddit_torch.sh. Runs on the GPU unless
--device cpu is given. A flag whose feature is not ported yet, and the JAX
CLI's subcommands (serve, serve-router, serve-backend, continual), exit 2
with a `[config] ... not ported yet` line. As in the JAX CLI (and the
reference), the seed is drawn at random unless --fix-seed is given; it is
drawn here, before any rank is spawned, so every rank keys its boundary
sample from the same seed (--resume adopts the checkpoint's instead). The
artifact directory is named by --graph-name, else derived from the flags.

The last two lines are machine-readable: the JAX CLI's `RESULT final_loss=
... best_val=... test=...`, then `LOSSES from_epoch=E l_E,l_E+1,...`, every
epoch's loss this run trained.
"""

from __future__ import annotations

import random
import sys

from bnsgcn_tpu_torch.config import (SUBCOMMANDS, ConfigError,
                                     config_from_args, create_parser)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    try:
        if argv and argv[0] in SUBCOMMANDS:
            raise ConfigError(f"{argv[0]} is not ported yet")
        cfg = config_from_args(create_parser().parse_args(argv))
        if not cfg.fix_seed:
            cfg = cfg.replace(seed=random.randrange(1 << 31))
            print(f"seed {cfg.seed} (drawn; --fix-seed --seed {cfg.seed} "
                  f"repeats this run)")
        if not cfg.graph_name:
            cfg = cfg.replace(graph_name=cfg.derive_graph_name())
        from bnsgcn_tpu_torch.run import run_training
        res = run_training(cfg)
    except ConfigError as e:
        print(f"[config] {e}", file=sys.stderr)
        return 2
    final = res.losses[-1] if res.losses else float("nan")
    print("RESULT final_loss=%.9e best_val=%.6f test=%.6f"
          % (final, res.best_val_acc, res.test_acc))
    print("LOSSES from_epoch=%d %s" % (
        res.start_epoch, ",".join("%.9e" % x for x in res.losses)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
