"""The replica and feat axes' rank map (counterpart of
bnsgcn_tpu/parallel/replicas.py).

`--replicas R --feat T` trains on R x P x T ranks. Global rank g is
(replica r, part p, feat shard f), replica-major with feat innermost, the
order of the JAX package's `stacked_spec` rows: g = (r P + p) T + f. Each
replica trains the whole partitioned graph under its own boundary sample
and dropout masks (the keys fold r first, parallel/sampling.pair_key and
trainer.dropout_key); the gradient is the mean over the replicas. The T
ranks of one (r, p) hold the same part and shard its weights
(parallel/feat.py).

Each rank gets one Comm per axis (`make_axes`):
  * 'parts': the P ranks of its (r, f), rank = p, world = P: the halo
    exchange and every strategy, wire, --overlap split and --halo-refresh
    run inside a replica row as they run at R = T = 1;
  * 'feat': the T ranks of its (r, p), rank = f (T > 1 only);
  * the world, every rank: the gradient reduce, SyncBatchNorm's moments,
    the barriers and the checkpoint broadcast.
R = T = 1 builds no group at all: the run is the P-rank run as it was.
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass
from typing import Optional

import torch.distributed as dist

from bnsgcn_tpu_torch.parallel.mesh import PG_TIMEOUT_S, Comm


def rank_coords(g: int, P: int, T: int) -> tuple[int, int, int]:
    """Global rank g -> (replica, part, feat shard)."""
    return g // (P * T), (g // T) % P, g % T


def global_rank(r: int, p: int, f: int, P: int, T: int) -> int:
    return (r * P + p) * T + f


def mesh_desc(R: int, P: int, T: int) -> str:
    """The JAX package's mesh shape for run headers: '2x4x2 replicas x parts
    x feat', '2x4 replicas x parts', '4x2 parts x feat' or '4 parts'."""
    present = [(n, label) for n, label, on in
               ((R, "replicas", R > 1), (P, "parts", True),
                (T, "feat", T > 1)) if on]
    if len(present) == 1:
        return f"{P} parts"
    return ("x".join(str(n) for n, _ in present) + " "
            + " x ".join(label for _, label in present))


@dataclass
class Axes:
    """One rank's place on the R x P x T mesh and its Comm per axis."""
    R: int
    P: int
    T: int
    r: int
    p: int
    f: int
    world: Comm
    parts: Comm
    feat: Optional[Comm] = None

    @property
    def replica(self) -> Optional[int]:
        """The replica index to fold into the keys, None without a replica
        axis (no fold: the R = 1 keys)."""
        return self.r if self.R > 1 else None


def n_replicas(axes: Optional[Axes]) -> int:
    return 1 if axes is None else axes.R


def make_axes(world: Comm, R: int, P: int, T: int) -> Optional[Axes]:
    """This rank's Axes on an R x P x T world, or None at R = T = 1 (no
    group). Every rank creates every group, in the same order (the parts
    groups by (r, f), then the feat groups by (r, p)), as
    torch.distributed requires."""
    if R == 1 and T == 1:
        return None
    if world.world != R * P * T:
        raise ValueError(f"a world of {world.world} ranks is not {R} "
                         f"replicas x {P} parts x {T} feat shards")
    r, p, f = rank_coords(world.rank, P, T)
    timeout = datetime.timedelta(seconds=PG_TIMEOUT_S)

    def group(ranks):
        return ranks, dist.new_group(ranks, timeout=timeout)

    parts = {(rr, ff): group([global_rank(rr, q, ff, P, T) for q in range(P)])
             for rr in range(R) for ff in range(T)}
    feat = ({(rr, q): group([global_rank(rr, q, ff, P, T)
                             for ff in range(T)])
             for rr in range(R) for q in range(P)} if T > 1 else {})
    return Axes(R, P, T, r, p, f, world,
                world.sub(*parts[r, f]),
                world.sub(*feat[r, p]) if T > 1 else None)


def dedup_replica0(reports: list, R: int, P: int, T: int) -> list:
    """Replica 0's, feat shard 0's reports of a list in global rank order:
    part p's at rank p T (bnsgcn_tpu/parallel/replicas.py
    dedup_replica0)."""
    if len(reports) != R * P * T:
        raise ValueError(f"{len(reports)} reports for {R} x {P} x {T} ranks")
    return [reports[global_rank(0, p, 0, P, T)] for p in range(P)]
