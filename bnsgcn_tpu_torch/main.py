"""CLI entry point: `python -m bnsgcn_tpu_torch.main [flags]`.

Flag names follow the JAX CLI (python -m bnsgcn_tpu.main). Runs on the GPU
unless --device cpu is given; a flag whose feature is not ported yet exits 2
with a `[config] ... not ported yet` line. As in the JAX CLI (and the
reference), the seed is drawn at random unless --fix-seed is given; it is
drawn here, before any rank is spawned, so every rank keys its boundary
sample from the same seed.
"""

from __future__ import annotations

import random
import sys

from bnsgcn_tpu_torch.config import (ConfigError, config_from_args,
                                     create_parser)


def main(argv=None) -> int:
    try:
        args = create_parser().parse_args(argv)
        cfg = config_from_args(args)
        if not args.fix_seed:
            cfg = cfg.replace(seed=random.randrange(1 << 31))
            print(f"seed {cfg.seed} (drawn; --fix-seed --seed {cfg.seed} "
                  f"repeats this run)")
        from bnsgcn_tpu_torch.run import run_training
        res = run_training(cfg)
    except ConfigError as e:
        print(f"[config] {e}", file=sys.stderr)
        return 2
    print(f"epoch time {res.epoch_time:.4f} s (mean after warm-up), final "
          f"loss {res.losses[-1] if res.losses else float('nan'):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
