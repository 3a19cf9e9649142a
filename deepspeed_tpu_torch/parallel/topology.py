"""The data-parallel topology of the default process group (the part of
``deepspeed_tpu/parallel/topology.py`` that data parallelism needs).

The JAX package factors its devices into a mesh of named axes (pipe,
data, slice, expert, seq, model). The port runs one process per card
and so far only the data axis: every rank of the default group is a dp
rank. Model, pipeline and sequence parallelism raise at configuration
(``runtime/config.py::unported_features``).
"""
from __future__ import annotations

from . import comm

DP_AXIS = "data"


def dp_world_size() -> int:
    """The number of data-parallel ranks (1 without a process group)."""
    return comm.get_world_size()


def dp_rank() -> int:
    """This process's data-parallel rank (0 without a process group)."""
    return comm.get_rank()


__all__ = ["DP_AXIS", "dp_world_size", "dp_rank"]
