"""CLI entry point: `python -m bnsgcn_tpu_torch.main [flags]`.

It takes the JAX CLI's command line (python -m bnsgcn_tpu.main); the
flagship recipe is scripts/reddit_torch.sh. Runs on the GPU unless
--device cpu is given. `main serve ...` runs the online inference server
(serve.py: exit 0 after its `shutdown` op, 75 after SIGTERM/SIGINT with
the delta log flushed, 2 a config error); `main serve-router ...` and
`main serve-backend ...` run the partition-sharded serving fleet
(serve_router.py, serve_backend.py; the same exit codes). A flag whose
feature is not ported yet, and the JAX CLI's `continual` subcommand, exit
2 with a `[config] ... not ported yet` line. As in the JAX CLI (and the
reference), the seed is drawn at random unless --fix-seed is given; it is
drawn here, before any rank is spawned, so every rank keys its boundary
sample from the same seed (--resume adopts the checkpoint's instead). The
artifact directory is named by --graph-name, else derived from the flags.

Across nodes, one launcher per node (the JAX CLI's multi-host flags):

    node 0:  python -m bnsgcn_tpu_torch.main ... --n-nodes N --node-rank 0 \
                 --master-addr ADDR --port PORT --parts-per-node PPN
    node k:  the same with --node-rank k

Node k starts global ranks [k * PPN, min((k + 1) * PPN, P)); a node that
would host none, too few slots for P, or nccl with more ranks on a node
than its cards exit 2. Node 0 draws the seed, picks the checkpoint to
resume from and partitions (unless --skip-partition; the others never
load the dataset), serving the launchers' store at ADDR:PORT; the ranks
meet at ADDR:PORT+1. A launcher that cannot reach node 0 exits 1 with a
`[launch]` line. Every launcher prints the RESULT and LOSSES lines of its
first rank: the same losses everywhere (the loss is all-reduced); under
--eval-device host a node other than 0 reports best_val and test 0, as a
JAX process other than 0 does, since rank 0 alone evaluates.

The last two lines are machine-readable: the JAX CLI's `RESULT final_loss=
... best_val=... test=...`, then `LOSSES from_epoch=E l_E,l_E+1,...`, every
epoch's loss this run trained.

Coordinated launches (parallel/coord.py): with --n-nodes > 1, or in the
JAX CLI's harness mode `--coord-world W --coord-rank r` (W independent
launches of the same command, each training every part, coupled only
through the coordinator, which rank 0 serves at --coord-port), the
launches agree every step's verdict out of band; `--elastic on` (harness
only) turns a lost launch into a resize of the world, and `--obs-log PATH`
writes the telemetry bus's events (coordination rank r > 0: PATH.r<r>).

Exit codes (resilience.py, the JAX CLI's): 0 done, or a launch dropped by
an injected `ranklost` (no RESULT line); 2 a named config error; 75
preempted (SIGTERM/SIGINT to the launcher or a rank, or an agreed
preemption; a resumable checkpoint is on disk, relaunch with --resume); 76
divergence that no rollback cured (the report on stderr and beside the
checkpoints); 77 a hung step (a rank's watchdog fired, a step collective
timed out on a hung peer, or a coordinator exchange timed out: a
`[watchdog]` line names the rank whose step-boundary beat is oldest, the
coordinator's liveness table the launch that stalled); 78 the launches
agreed to abort (one cannot restore the chosen checkpoint: triage, not a
blind requeue); 1 anything else.
"""

from __future__ import annotations

import gc
import os
import random
import sys

from bnsgcn_tpu_torch.config import (UNPORTED_SUBCOMMANDS, ConfigError,
                                     config_from_args, create_parser,
                                     node_ranks)
from bnsgcn_tpu_torch.parallel.coord import CoordAbort, CoordTimeout
from bnsgcn_tpu_torch.resilience import (EXIT_COORD_ABORT, EXIT_DIVERGED,
                                         EXIT_PREEMPTED, EXIT_WATCHDOG,
                                         DivergenceError, PreemptedError,
                                         RankLostExit, StepHung)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    code = None
    if argv and argv[0] == "serve":
        # a long-running server with its own lifecycle (drain on SIGTERM)
        from bnsgcn_tpu_torch import serve
        return serve.serve_main(argv[1:])
    if argv and argv[0] == "serve-router":
        # the fleet's router: routing and the delta fan-out, no model and
        # no torch
        from bnsgcn_tpu_torch import serve_router
        return serve_router.router_main(argv[1:])
    if argv and argv[0] == "serve-backend":
        # one process per (part, replica): that shard's table, CSR slices
        # and delta log
        from bnsgcn_tpu_torch import serve_backend
        return serve_backend.backend_main(argv[1:])
    # here, not at the top: the router's process never imports torch
    from bnsgcn_tpu_torch.parallel.mesh import NodeUnreachable
    try:
        if argv and argv[0] in UNPORTED_SUBCOMMANDS:
            raise ConfigError(f"{argv[0]} is not ported yet")
        cfg = config_from_args(create_parser().parse_args(argv))
        node_ranks(cfg)
        if not cfg.fix_seed and cfg.node_rank == 0:
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
    except NodeUnreachable as e:
        print(f"[launch] {e}", file=sys.stderr)
        return 1
    except PreemptedError as e:
        print(f"[resilience] {e}")
        code = EXIT_PREEMPTED
    except DivergenceError as e:
        print(f"[resilience] {e}", file=sys.stderr)
        return EXIT_DIVERGED
    except StepHung as e:
        print(f"[watchdog] {e}", file=sys.stderr)
        code = EXIT_WATCHDOG
    except CoordTimeout as e:
        # the coordinator printed the liveness table naming the launch
        # that stalled
        print(f"[coord] {e}", file=sys.stderr)
        code = EXIT_WATCHDOG
    except CoordAbort as e:
        print(f"[coord] {e}", file=sys.stderr)
        code = EXIT_COORD_ABORT
    except RankLostExit as e:
        # the injected loss of this launch: its survivors must see the
        # heartbeats stop, so it leaves without a goodbye
        print(f"[resilience] injected rank loss at epoch {e.epoch}: "
              f"exiting without goodbye (survivors must detect via "
              f"liveness and RESIZE)")
        code = 0
    if code is not None:
        # os._exit, not a return: interpreter shutdown would join an
        # in-flight host eval's thread (or a hung one) and could overrun
        # the platform's grace window; the resumable checkpoint is already
        # fsync'd. Collected first, the launcher's queue frees its
        # semaphores.
        gc.collect()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(code)
    final = res.losses[-1] if res.losses else float("nan")
    print("RESULT final_loss=%.9e best_val=%.6f test=%.6f"
          % (final, res.best_val_acc, res.test_acc))
    print("LOSSES from_epoch=%d %s" % (
        res.start_epoch, ",".join("%.9e" % x for x in res.losses)))
    return 0


if __name__ == "__main__":
    # a long run's lines reach a pipe (a scheduler's log, a wrapper waiting
    # for an epoch line) as they are printed
    sys.stdout.reconfigure(line_buffering=True)
    sys.exit(main())
