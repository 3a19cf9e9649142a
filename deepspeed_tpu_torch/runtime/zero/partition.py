"""ZeRO partitioning across dp ranks (port of
``deepspeed_tpu/runtime/zero/partition.py``).

The JAX package declares each leaf's placement as a ``PartitionSpec``
and lets XLA partition the step. The port runs one process per rank and
places the state itself, in the fused optimizer's V-interleaved layout
(``ops/fused_update.py``): rank d of dp owns rows ``[d*V/dp,
(d+1)*V/dp)`` of every group buffer (``row_plan``), which is a
contiguous 1/dp of the buffer and, in each leaf's flattened order, one
contiguous range of the padded leaf. Grads (stage 2), moments (stages
1-3) and parameters (stage 3) are held as those rows. Where dp does not
divide V (dp 3, 5, 6, 7 at V = 8) a rank owns what JAX's ``_leaf_spec``
gives its device of the flat ``[V * Lpad]`` buffer: the d-th of dp
equal ranges when dp divides it, else the whole buffer (replicated).

Stage 3 with a bound ``Zero3Scan`` holds the groups in the per-layer
form of that layout (``ShardGroup(..., layers=)``): each stacked leaf
the scan covers enters as its L layer slices, so a rank's rows hold
1/dp of every layer and one layer's gather is an equal-size all-gather.

The JAX per-leaf stage-3 rule (``stage3_param_specs``: each leaf split
on its first dim divisible by dp, a covered leaf on its first such dim
past the layer axis) is ``stage3_dims``. The port places by it where a
leaf is held split along a dim rather than as rows: the host partition
and the card's parameter shards of stage 3 with ZeRO-Offload
(``runtime/zero/offload.py``), and the gather working set that the
engine reports (``runtime/zero/stage3.gather_working_set_bytes``).
``describe_sharding`` is the engine's one-line report at construction.
"""
from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Optional, Tuple

from ...ops.fused_update import float_groups, tree_flatten, virtual_shards


class RowPlan(NamedTuple):
    """Rank ``rank``'s part of a V-interleaved group buffer. Where dp
    divides V: rows ``[row0, row1)``. Elsewhere (``rows`` False) the
    part is a range of the flat buffer, which depends on the group's
    row length (``elements``)."""
    shards: int          # V
    rows_per_rank: int   # V / dp (0 when dp does not divide V)
    row0: int            # first owned row
    row1: int            # one past the last owned row
    dp: int = 1
    rank: int = 0

    @property
    def rows(self) -> bool:
        return self.shards % self.dp == 0

    def elements(self, Lpad: int) -> Tuple[int, int]:
        """The owned range of the flat ``[V * Lpad]`` buffer: the rows';
        where dp does not divide V, JAX's placement of the flat buffer
        (``_leaf_spec``: split in dp equal parts along its one dim when
        dp divides it, else replicated, the whole buffer)."""
        if self.rows:
            return self.row0 * Lpad, self.row1 * Lpad
        n = self.shards * Lpad
        if n % self.dp:
            return 0, n
        return self.rank * n // self.dp, (self.rank + 1) * n // self.dp


def row_plan(dp: int, rank: int) -> RowPlan:
    """Which part of the V-layout rank ``rank`` of ``dp`` owns (the one
    source of a ShardGroup's rows and base): rows where dp divides V,
    else a range of each group's flat buffer (``RowPlan.elements``)."""
    shards = virtual_shards(dp)
    if shards % dp:
        return RowPlan(shards, 0, 0, 0, dp, rank)
    per = shards // dp
    return RowPlan(shards, per, rank * per, (rank + 1) * per, dp, rank)


def split_dim(shape: Tuple[int, ...], dp: int,
              start: int = 0) -> Optional[int]:
    """The first dim from ``start`` on that ``dp`` divides (and is at
    least ``dp``), or None: the JAX ``stage3_param_specs`` rule for one
    leaf without tensor parallelism."""
    for d in range(start, len(shape)):
        if shape[d] >= dp and shape[d] % dp == 0:
            return d
    return None


def stage3_dims(shapes: List[Tuple[int, ...]], dp: int,
                covered: Optional[List[bool]] = None
                ) -> List[Optional[int]]:
    """Each leaf's stage-3 split dim (JAX ``stage3_param_specs``): the
    first dim dp divides, past the layer axis (dim 0) for a leaf the
    model's scan gathers itself (``covered``); None when none does (the
    leaf stays whole on every rank)."""
    covered = covered or [False] * len(shapes)
    return [split_dim(s, dp, 1 if c else 0) if len(s) else None
            for s, c in zip(shapes, covered)]


def covered_leaves(params: Any, covers: Optional[Callable[[str], bool]]
                   ) -> List[bool]:
    """Which leaves (tree order) ``covers`` marks, by their
    ``jax.tree_util.keystr`` path (``Zero3Scan.covers``)."""
    from ...monitor.health import keystr_paths
    paths = keystr_paths(params)
    return [bool(covers(p)) if covers is not None else False
            for p in paths]


def describe_sharding(params: Any, dp: int, stage: int,
                      layout: Optional[str] = None) -> str:
    """A one-line partition report (the JAX ``describe_sharding``): the
    share of optimizer-state elements split over dp, and, when given,
    the layout they are split in (``layout``: the engine names it). In
    the V-layout a stage >= 1 engine at dp > 1 splits every group
    buffer, padding included; the count is replicated."""
    leaves = tree_flatten(params)[0]
    total = sum(leaves[i].numel() for _, idxs in float_groups(leaves)
                for i in idxs)
    sharded = total if (stage >= 1 and dp > 1) else 0
    tot = max(1, total)
    return (f"ZeRO sharding: {sharded / tot:.1%} of optimizer-state "
            f"elements partitioned, {(tot - sharded) / tot:.1%} replicated "
            f"(stage {stage}, dp {dp}"
            + (f", layout: {layout})" if layout else ")"))


__all__ = ["RowPlan", "row_plan", "split_dim", "stage3_dims",
           "covered_leaves", "describe_sharding"]
