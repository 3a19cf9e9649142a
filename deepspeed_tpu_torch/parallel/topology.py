"""The process topology: named axes over the ranks, and the process
groups made from them (port of ``deepspeed_tpu/parallel/topology.py``).

``ProcessTopology`` maps each global rank to a coordinate on named axes
(axis 0 outermost, row-major), as the reference and the JAX package do.
The port runs one process per rank, so where the JAX package turns a
topology into a mesh of devices, the port turns it into
``torch.distributed`` groups: ``PipelineParallelGrid`` makes, on every
process and in the same order, the data-parallel group of each (pipe,
seq, model) column, the pipe group of each data-parallel column, the
tied group of each column (its first and last stage, which share the
tied embedding), the model-parallel (tensor) group and the sequence
group. Two topologies run: ``pipe`` × ``data``
(``PipeDataParallelTopology``) and ``data`` × ``seq`` × ``model``
(``DataSeqModelTopology``, JAX ``build_mesh``'s axis order, model
innermost). ``PipeModelDataParallelTopology`` builds, but a grid with a
pipeline AND tensor parallelism raises (ROADMAP queue 1 item 7: pp ×
mp).

``build_mesh(dp, mp, pp, sp)`` is the JAX function's counterpart: the
grid over the default group's ranks (a collective), which the engines
and ``ops/ring_attention.ring_attention_fn`` take as ``mesh``; its
``shape`` maps each axis name to its size, as a JAX mesh's does.
``PartitionSpec`` (``P``) is the port's copy of JAX's spec type: one
entry a dimension, an axis name or None.

Without a grid every rank of the default group is a dp rank:
``dp_world_size``/``dp_rank`` are the default group's unless a group
is named (a pipeline stage's or a tensor-parallel column's dp group).
"""
from __future__ import annotations

from collections import namedtuple
from itertools import product
from typing import Any, Dict, List, Optional, Sequence

from . import comm

DP_AXIS = "data"
PP_AXIS = "pipe"
MP_AXIS = "model"
SP_AXIS = "seq"


class PartitionSpec(tuple):
    """A leaf's placement over the named axes (JAX's ``PartitionSpec``):
    one entry a leading dimension, an axis name or None (replicated);
    dimensions past the last entry are replicated."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"

    def axis_of(self, name: str) -> Optional[int]:
        """The dimension split over axis ``name``, or None."""
        for i, part in enumerate(self):
            if part == name or (isinstance(part, tuple) and name in part):
                return i
        return None


P = PartitionSpec


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
    """(pipe, data, model): 3D parallelism, model innermost (a tensor
    group is a contiguous block of ranks). A grid over it with pp > 1
    and mp > 1 raises (``PipelineParallelGrid``)."""

    def __init__(self, num_pp: int, num_mp: int, num_dp: int):
        super().__init__(axes=[PP_AXIS, DP_AXIS, MP_AXIS],
                         dims=[num_pp, num_dp, num_mp])


class DataSeqModelTopology(ProcessTopology):
    """(data, seq, model): JAX ``build_mesh``'s axis order without a
    pipeline, model innermost, so rank = (d * sp + s) * mp + m."""

    def __init__(self, num_dp: int, num_sp: int, num_mp: int):
        super().__init__(axes=[DP_AXIS, SP_AXIS, MP_AXIS],
                         dims=[num_dp, num_sp, num_mp])


PP_MP_UNPORTED = ("pipeline x tensor parallelism (pp > 1 with mp > 1) is "
                  "not ported yet (ROADMAP queue 1 item 7: pp x mp)")


class PipelineParallelGrid:
    """The "mpu" contract over a ``ProcessTopology``, with the
    ``torch.distributed`` groups of its axes (module docstring; no group
    for the tied, model or sequence axis where it has one rank). Building
    one
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
        self.seq_parallel_size = max(1, topology.get_dim(SP_AXIS))
        if self.pipe_parallel_size > 1 and self.model_parallel_size > 1:
            raise NotImplementedError(PP_MP_UNPORTED)
        self.data_parallel_id = getattr(coord, DP_AXIS, 0)
        self.stage_id = getattr(coord, PP_AXIS, 0)
        self.model_parallel_id = getattr(coord, MP_AXIS, 0)
        self.seq_parallel_id = getattr(coord, SP_AXIS, 0)
        # (an axis the topology lacks is a group of one rank each)
        solo = [[r] for r in range(self.world_size)]
        self.dp_groups = topology.get_axis_comm_lists(DP_AXIS) or solo
        self.pp_groups = topology.get_axis_comm_lists(PP_AXIS) or solo
        self.mp_groups = topology.get_axis_comm_lists(MP_AXIS) or solo
        self.sp_groups = topology.get_axis_comm_lists(SP_AXIS) or solo
        # The first and last stage of each dp column (the tied pair).
        self.tied_groups = [sorted({col[0], col[-1]})
                            for col in self.pp_groups] \
            if PP_AXIS in topology.axes else []
        self.stage_to_global = {
            s: topology.get_rank(**{a: (s if a == PP_AXIS else
                                        getattr(coord, a))
                                    for a in topology.axes})
            for s in range(self.pipe_parallel_size)} \
            if PP_AXIS in topology.axes else {0: self.global_rank}

        def mine(groups):
            return next((g for g in groups if self.global_rank in g), [])

        self.dp_ranks = mine(self.dp_groups)
        self.pp_ranks = mine(self.pp_groups)
        self.mp_ranks = mine(self.mp_groups)
        self.sp_ranks = mine(self.sp_groups)
        # (a middle stage is in no tied group)
        self.tied_ranks = mine(self.tied_groups)
        self.dp_group = self.pp_group = self.tied_group = None
        self.mp_group = self.sp_group = None
        if comm.is_initialized():
            for name in ("dp", "pp", "tied", "mp", "sp"):
                lists = getattr(self, name + "_groups")
                if name in ("tied", "mp", "sp") and \
                        all(len(g) == 1 for g in lists):
                    continue        # (nothing crosses an axis of one rank)
                for ranks in lists:
                    g = comm.new_group(ranks)
                    if ranks == getattr(self, name + "_ranks"):
                        setattr(self, name + "_group", g)

    @property
    def shape(self) -> Dict[str, int]:
        """Each axis's size, as a JAX mesh's ``shape`` maps it."""
        return {DP_AXIS: self.data_parallel_size,
                PP_AXIS: self.pipe_parallel_size,
                SP_AXIS: self.seq_parallel_size,
                MP_AXIS: self.model_parallel_size}

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

    def get_model_parallel_group(self):
        return self.mp_group

    def get_sequence_parallel_rank(self) -> int:
        return self.seq_parallel_id

    def get_sequence_parallel_world_size(self) -> int:
        return self.seq_parallel_size

    def get_sequence_parallel_group(self):
        return self.sp_group

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


def build_mesh(dp: Optional[int] = None, mp: int = 1, pp: int = 1,
               sp: int = 1) -> PipelineParallelGrid:
    """The grid over the default group's ranks (JAX ``build_mesh``): dp
    None takes the world over mp * pp * sp. Without a pipeline the axes
    are (data, seq, model), model innermost; with one (pipe, data). A
    collective: every rank builds it, in the same order. pp > 1 with
    mp > 1 raises (ROADMAP queue 1 item 7)."""
    world = comm.global_world_size()
    if dp is None:
        denom = mp * pp * sp
        if world % denom:
            # (JAX build_mesh's message)
            raise ValueError(f"{world} devices not divisible by "
                             f"mp*pp*sp*ep*slices={denom}")
        dp = world // denom
    sizes = {PP_AXIS: pp, DP_AXIS: dp, SP_AXIS: sp, MP_AXIS: mp}
    if dp * mp * pp * sp != world:
        raise ValueError(f"mesh {sizes} needs {dp * mp * pp * sp} devices, "
                         f"have {world}")
    if pp > 1 and (mp > 1 or sp > 1):
        raise NotImplementedError(PP_MP_UNPORTED)
    topo = PipeDataParallelTopology(pp, dp) if pp > 1 else \
        DataSeqModelTopology(dp, sp, mp)
    return PipelineParallelGrid(topo)


__all__ = ["DP_AXIS", "PP_AXIS", "MP_AXIS", "SP_AXIS", "PartitionSpec", "P",
           "dp_world_size", "dp_rank", "ProcessTopology",
           "PipeDataParallelTopology", "PipeModelDataParallelTopology",
           "DataSeqModelTopology", "PipelineParallelGrid", "build_mesh",
           "PP_MP_UNPORTED"]
