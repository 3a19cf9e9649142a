"""ZeRO partitioning across dp ranks (port of
``deepspeed_tpu/runtime/zero/partition.py``).

The JAX package declares each leaf's placement as a ``PartitionSpec``
and lets XLA partition the step. The port runs one process per rank and
places the state itself, in the fused optimizer's V-interleaved layout
(``ops/fused_update.py``): rank d of dp owns rows ``[d*V/dp,
(d+1)*V/dp)`` of every group buffer (``row_plan``), which is a
contiguous 1/dp of the buffer and, in each leaf's flattened order, one
contiguous range of the padded leaf. Grads (stage 2), moments (stages
1-3) and parameters (stage 3) are held as those rows.

The JAX package's per-leaf stage-3 rule (``stage3_param_specs``: each
leaf split on its first dim divisible by dp) has no counterpart: the
port's stage 3 holds the parameters as the same V-layout rows as the
moments. ``describe_sharding`` is the engine's one-line report at
construction.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

from ...ops.fused_update import float_groups, tree_flatten, virtual_shards


class RowPlan(NamedTuple):
    """Rank ``rank``'s part of a V-interleaved group buffer."""
    shards: int          # V
    rows_per_rank: int   # V / dp
    row0: int            # first owned row
    row1: int            # one past the last owned row

    def elements(self, Lpad: int) -> Tuple[int, int]:
        """The owned range of the flat ``[V * Lpad]`` buffer."""
        return self.row0 * Lpad, self.row1 * Lpad


def row_plan(dp: int, rank: int) -> RowPlan:
    """Which V-layout rows rank ``rank`` of ``dp`` owns (the one source
    of a ShardGroup's rows and base). dp divides V: the configuration
    refuses any other dp (``DeepSpeedConfig.unported_features``)."""
    shards = virtual_shards(dp)
    per = shards // dp
    return RowPlan(shards, per, rank * per, (rank + 1) * per)


def describe_sharding(params: Any, dp: int, stage: int) -> str:
    """A one-line partition report (the JAX ``describe_sharding``): the
    share of optimizer-state elements split over dp. In the V-layout a
    stage >= 1 engine at dp > 1 splits every group buffer, padding
    included; the count is replicated."""
    leaves = tree_flatten(params)[0]
    total = sum(leaves[i].numel() for _, idxs in float_groups(leaves)
                for i in idxs)
    sharded = total if (stage >= 1 and dp > 1) else 0
    tot = max(1, total)
    return (f"ZeRO sharding: {sharded / tot:.1%} of optimizer-state "
            f"elements partitioned, {(tot - sharded) / tot:.1%} replicated "
            f"(stage {stage}, dp {dp})")


__all__ = ["RowPlan", "row_plan", "describe_sharding"]
