"""The process topology: named axes over the ranks, and the process
groups made from them (port of ``deepspeed_tpu/parallel/topology.py``).

``ProcessTopology`` maps each global rank to a coordinate on named axes
(axis 0 outermost, row-major), as the reference and the JAX package do.
The port runs one process per rank, so where the JAX package turns a
topology into a mesh of devices, the port turns it into
``torch.distributed`` groups: ``PipelineParallelGrid`` makes, on every
process and in the same order, the data-parallel group of each pipeline
stage, the pipe group of each data-parallel column, and the tied group
of each column (its first and last stage, which share the tied
embedding). Two axes run: ``pipe`` × ``data``
(``PipeDataParallelTopology``). Tensor parallelism, and so the
three-axis ``PipeModelDataParallelTopology``, raises (ROADMAP queue 1
item 7).

Without a pipeline every rank of the default group is a dp rank:
``dp_world_size``/``dp_rank`` are the default group's unless a group
is named (a pipeline stage's engine names its stage's dp group).
"""
from __future__ import annotations

from collections import namedtuple
from itertools import product
from typing import Any, Dict, List, Sequence

from . import comm

DP_AXIS = "data"
PP_AXIS = "pipe"
MP_AXIS = "model"


def dp_world_size(group=None) -> int:
    """The number of data-parallel ranks (1 without a process group)."""
    return comm.get_world_size(group)


def dp_rank(group=None) -> int:
    """This process's data-parallel rank (0 without a process group)."""
    return comm.get_rank(group)


class ProcessTopology:
    """Cartesian product of named axes; axis 0 is outermost (row-major)."""

    def __init__(self, axes: Sequence[str], dims: Sequence[int]):
        assert len(axes) == len(dims), "axes and dims must align"
        self.axes = list(axes)
        self.dims = list(dims)
        self.ProcessCoord = namedtuple("ProcessCoord", self.axes)
        self.mapping: Dict[Any, int] = {}
        for global_rank, coord in enumerate(
                product(*[range(d) for d in self.dims])):
            self.mapping[self.ProcessCoord(**dict(zip(self.axes, coord)))] \
                = global_rank

    def get_rank(self, **coord_kwargs) -> int:
        if len(coord_kwargs) != len(self.axes):
            raise ValueError(f"get_rank() needs all axes {self.axes}, "
                             f"got {coord_kwargs}")
        key = self.ProcessCoord(**coord_kwargs)
        assert key in self.mapping, f"coord {coord_kwargs} not in topology"
        return self.mapping[key]

    def get_axis_names(self) -> List[str]:
        return self.axes

    def get_rank_repr(self, rank: int,
                      omit_axes: Sequence[str] = ("data", "pipe"),
                      inner_sep: str = "_", outer_sep: str = "-") -> str:
        axes = [a for a in self.axes if a not in list(omit_axes)]
        coord = self.get_coord(rank)
        return outer_sep.join(f"{ax}{inner_sep}{getattr(coord, ax):02d}"
                              for ax in axes)

    def get_dim(self, axis: str) -> int:
        if axis not in self.axes:
            return 0
        return self.dims[self.axes.index(axis)]

    def get_coord(self, rank: int):
        for coord, idx in self.mapping.items():
            if idx == rank:
                return coord
        raise ValueError(f"rank {rank} not in topology")

    def get_axis_comm_lists(self, axis: str) -> List[List[int]]:
        """Groups of ranks that vary along ``axis`` with all others
        fixed."""
        if axis not in self.axes:
            return []
        other = [a for a in self.axes if a != axis]
        lists = []
        for coord in product(*[range(self.get_dim(a)) for a in other]):
            fixed = dict(zip(other, coord))
            lists.append([self.get_rank(**{axis: i}, **fixed)
                          for i in range(self.get_dim(axis))])
        return lists

    def filter_match(self, **filter_kwargs) -> List[int]:
        """Ranks whose coordinates match all given axis=value filters."""
        return sorted(rank for coord, rank in self.mapping.items()
                      if all(getattr(coord, k) == v
                             for k, v in filter_kwargs.items()))

    def get_axis_list(self, axis: str, idx: int) -> List[int]:
        n = self.axes.index(axis)
        return sorted(rank for coord, rank in self.mapping.items()
                      if coord[n] == idx)

    def world_size(self) -> int:
        out = 1
        for d in self.dims:
            out *= d
        return out

    def __str__(self) -> str:
        return str(self.mapping)


class PipeDataParallelTopology(ProcessTopology):
    """(pipe, data): the ranks of one stage are adjacent, so a stage's
    dp group is a contiguous block of ranks."""

    def __init__(self, num_pp: int, num_dp: int):
        super().__init__(axes=[PP_AXIS, DP_AXIS], dims=[num_pp, num_dp])


class PipeModelDataParallelTopology(ProcessTopology):
    """(pipe, data, model): 3D parallelism. The port has no tensor
    parallelism yet, so this raises."""

    def __init__(self, num_pp: int, num_mp: int, num_dp: int):
        raise NotImplementedError(
            "PipeModelDataParallelTopology needs tensor parallelism, which "
            "the port does not run yet (ROADMAP queue 1 item 7: pipeline x "
            "tensor parallelism)")


class PipelineParallelGrid:
    """The "mpu" contract over a ``ProcessTopology``, with the
    ``torch.distributed`` groups a pipeline engine uses. Building one
    is a collective: every process builds the same grid (the groups
    are made in one order on every rank; none without a process group).
    ``global_rank`` defaults to this process's rank."""

    def __init__(self, topology: ProcessTopology = None,
                 global_rank: int = None):
        if topology is None:
            topology = PipeDataParallelTopology(1, comm.global_world_size())
        self._topo = topology
        self.global_rank = comm.global_rank() if global_rank is None \
            else int(global_rank)
        self.world_size = topology.world_size()
        coord = topology.get_coord(self.global_rank)
        self.data_parallel_size = max(1, topology.get_dim(DP_AXIS))
        self.pipe_parallel_size = max(1, topology.get_dim(PP_AXIS))
        self.model_parallel_size = max(1, topology.get_dim(MP_AXIS))
        self.data_parallel_id = getattr(coord, DP_AXIS, 0)
        self.stage_id = getattr(coord, PP_AXIS, 0)
        self.model_parallel_id = getattr(coord, MP_AXIS, 0)
        self.dp_groups = topology.get_axis_comm_lists(DP_AXIS)
        self.pp_groups = topology.get_axis_comm_lists(PP_AXIS)
        # The first and last stage of each dp column (the tied pair).
        self.tied_groups = [sorted({col[0], col[-1]})
                            for col in self.pp_groups]
        self.stage_to_global = {
            s: topology.get_rank(**{PP_AXIS: s, DP_AXIS:
                                    self.data_parallel_id})
            for s in range(self.pipe_parallel_size)}
        self.dp_ranks = next(g for g in self.dp_groups
                             if self.global_rank in g)
        self.pp_ranks = next(g for g in self.pp_groups
                             if self.global_rank in g)
        # (a middle stage is in no tied group)
        self.tied_ranks = next((g for g in self.tied_groups
                                if self.global_rank in g), [])
        self.dp_group = self.pp_group = self.tied_group = None
        if comm.is_initialized():
            for ranks in self.dp_groups:
                g = comm.new_group(ranks)
                if ranks == self.dp_ranks:
                    self.dp_group = g
            for ranks in self.pp_groups:
                g = comm.new_group(ranks)
                if ranks == self.pp_ranks:
                    self.pp_group = g
            for ranks in self.tied_groups:
                g = comm.new_group(ranks)
                if ranks == self.tied_ranks:
                    self.tied_group = g

    @property
    def topology(self) -> ProcessTopology:
        return self._topo

    def get_global_rank(self) -> int:
        return self.global_rank

    def get_data_parallel_rank(self) -> int:
        return self.data_parallel_id

    def get_data_parallel_world_size(self) -> int:
        return self.data_parallel_size

    def get_data_parallel_group(self):
        return self.dp_group

    def get_model_parallel_rank(self) -> int:
        return self.model_parallel_id

    def get_model_parallel_world_size(self) -> int:
        return self.model_parallel_size

    def get_stage_id(self) -> int:
        return self.stage_id

    def get_pipe_parallel_rank(self) -> int:
        return self.stage_id

    def get_pipe_parallel_world_size(self) -> int:
        return self.pipe_parallel_size

    def get_pipe_parallel_group(self):
        return self.pp_group

    def is_first_stage(self) -> bool:
        return self.stage_id == 0

    def is_last_stage(self) -> bool:
        return self.stage_id == self.pipe_parallel_size - 1

    def stage_to_global_rank(self, stage_id: int) -> int:
        return self.stage_to_global[stage_id]


__all__ = ["DP_AXIS", "PP_AXIS", "MP_AXIS", "dp_world_size", "dp_rank",
           "ProcessTopology", "PipeDataParallelTopology",
           "PipeModelDataParallelTopology", "PipelineParallelGrid"]
