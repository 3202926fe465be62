"""CLI entry point: `python -m bnsgcn_tpu_torch.main [flags]`.

Flag names follow the JAX CLI (python -m bnsgcn_tpu.main). Runs on the GPU
unless --device cpu is given; a flag whose feature is not ported yet exits 2
with a `[config] ... not ported yet` line.
"""

from __future__ import annotations

import sys

from bnsgcn_tpu_torch.config import ConfigError, parse_config


def main(argv=None) -> int:
    try:
        cfg = parse_config(argv)
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
