"""The one process-identity resolver of the monitor subsystem (port of
``deepspeed_tpu/monitor/hostinfo.py``).

``JsonlSink`` and ``TraceWriter`` ask it who writes files: rank 0 writes
the primary stream, rank K writes ``<name>.rankK.<ext>`` when
``telemetry.per_host_shards`` is on, and every other rank writes
nothing, with a logged notice. The identity is the default
``torch.distributed`` process group's rank and world size once one is
initialized; ``DS_PROC_INDEX`` / ``DS_PROC_COUNT`` override it first, as
in the JAX package (a test hook for the shard path in one process).
"""
from __future__ import annotations

import os
from typing import Optional, Tuple


def process_identity() -> Tuple[int, int]:
    """(process_index, process_count): the environment override first,
    then the default process group, then a single process."""
    env_idx = os.environ.get("DS_PROC_INDEX")
    if env_idx is not None:
        return int(env_idx), int(os.environ.get("DS_PROC_COUNT",
                                                int(env_idx) + 1))
    try:
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            return int(dist.get_rank()), int(dist.get_world_size())
    except Exception:
        pass
    return 0, 1


def resolve_writer(is_writer: Optional[bool] = None,
                   per_host: bool = False,
                   rank: Optional[int] = None,
                   world: Optional[int] = None
                   ) -> Tuple[bool, int, int]:
    """(writes_a_file, rank, world). An explicit ``is_writer`` wins;
    otherwise rank 0 always writes, and other ranks write their own
    shard iff ``per_host``."""
    if rank is None:
        rank, world = process_identity()
    elif world is None:
        world = rank + 1
    if is_writer is None:
        is_writer = rank == 0 or per_host
    return bool(is_writer), int(rank), int(world)


def shard_path(path: str, rank: int) -> str:
    """Per-host shard name: ``runs/job.jsonl`` -> ``runs/job.rank3.jsonl``
    for rank 3; rank 0 keeps the primary path."""
    if rank == 0:
        return path
    root, ext = os.path.splitext(path)
    return f"{root}.rank{rank}{ext}"


__all__ = ["process_identity", "resolve_writer", "shard_path"]
