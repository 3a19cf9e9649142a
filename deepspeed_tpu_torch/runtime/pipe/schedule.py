"""Pipeline instruction schedules (port of
``deepspeed_tpu/runtime/pipe/schedule.py``).

``PipeSchedule`` yields one stage's program as per-step lists of
instructions (reference ``runtime/pipe/schedule.py``): ``TrainSchedule``
the interleaved 1F1B program, ``InferenceSchedule`` the forward-only
wavefront, ``DataParallelSchedule`` the one-stage degenerate case; the
instruction classes are the reference's. In the JAX package the
schedules specify a program that one SPMD scan runs; in the port each
stage process *interprets* its own schedule (``interpret``, as the
reference's engine dispatches ``_INSTRUCTION_MAP``):
``runtime/pipe/engine.py`` maps each instruction to the stage's work
and its point-to-point sends and receives. ``train_schedule_events``
is the JAX package's oracle extraction, kept as it is.
"""
from __future__ import annotations

from typing import Iterator, List


# --------------------------------------------------------------------- #
# Instruction taxonomy (schedule.py:317-475)
# --------------------------------------------------------------------- #
class PipeInstruction:
    def __init__(self, **kwargs):
        self.name = self.__class__.__name__
        self.kwargs = kwargs
        for k, v in kwargs.items():
            setattr(self, k, v)

    def __repr__(self) -> str:
        if self.kwargs:
            args = ", ".join(f"{k}={v}" for k, v in self.kwargs.items())
            return f"{self.name}({args})"
        return self.name

    def __eq__(self, other) -> bool:
        return type(self) is type(other) and self.kwargs == other.kwargs


class OptimizerStep(PipeInstruction):
    pass


class ReduceGrads(PipeInstruction):
    pass


class ReduceTiedGrads(PipeInstruction):
    pass


class BufferOpInstruction(PipeInstruction):
    def __init__(self, buffer_id: int, **kwargs):
        super().__init__(buffer_id=buffer_id, **kwargs)


class LoadMicroBatch(BufferOpInstruction):
    pass


class ForwardPass(BufferOpInstruction):
    pass


class BackwardPass(BufferOpInstruction):
    pass


class SendActivation(BufferOpInstruction):
    pass


class RecvActivation(BufferOpInstruction):
    pass


class SendGrad(BufferOpInstruction):
    pass


class RecvGrad(BufferOpInstruction):
    pass


# --------------------------------------------------------------------- #
# Schedules
# --------------------------------------------------------------------- #
class PipeSchedule:
    """Yields step-wise lists of instructions for one stage
    (schedule.py:6-127)."""

    def __init__(self, micro_batches: int, stages: int, stage_id: int):
        assert 0 <= stage_id < stages
        self.micro_batches = micro_batches
        self.stages = stages
        self.stage_id = stage_id
        self.prev_stage = stage_id - 1
        self.next_stage = stage_id + 1

    def steps(self) -> Iterator[List[PipeInstruction]]:
        raise NotImplementedError

    def num_pipe_buffers(self) -> int:
        return self.micro_batches

    @property
    def stage(self) -> int:
        return self.stage_id

    @property
    def num_stages(self) -> int:
        return self.stages

    @property
    def is_first_stage(self) -> bool:
        return self.stage_id == 0

    @property
    def is_last_stage(self) -> bool:
        return self.stage_id == self.stages - 1

    def _valid_micro_batch(self, micro_batch_id: int) -> bool:
        return 0 <= micro_batch_id < self.micro_batches

    def _valid_stage(self, stage_id: int) -> bool:
        return 0 <= stage_id < self.stages

    def __iter__(self):
        return iter(self.steps())


class InferenceSchedule(PipeSchedule):
    """Forward-only wavefront (schedule.py:129-180)."""

    def steps(self):
        total_steps = self.micro_batches + self.stages - 1
        for step_id in range(total_steps):
            cmds: List[PipeInstruction] = []
            micro_batch_id = step_id - self.stage_id
            buf = micro_batch_id % 2 \
                if self._valid_micro_batch(micro_batch_id) else step_id % 2

            if self._valid_micro_batch(micro_batch_id):
                if self.is_first_stage:
                    cmds.append(LoadMicroBatch(buf))
                else:
                    cmds.append(RecvActivation(buf))
                cmds.append(ForwardPass(buf))
                if not self.is_last_stage:
                    cmds.append(SendActivation(buf))
            yield cmds

    def num_pipe_buffers(self) -> int:
        return 2


class TrainSchedule(PipeSchedule):
    """Interleaved 1F1B (schedule.py:182-290): forwards fill the pipeline,
    then each stage alternates backward/forward, draining with backwards.
    ``2 * (micro_batches + stages - 1)`` total steps; even steps forward-ish,
    odd steps backward-ish, with earlier stages starting later."""

    def steps(self):
        """Clock program: forward of micro m runs on stage s at tick
        ``2m + s``; its backward at tick ``2m + 2P - 1 - s``. The two
        families have opposite tick parity per stage, so a stage never does
        both in one tick; each send lands exactly one tick before the
        matching recv; in-flight forwards peak at ``P - s`` — the 1F1B
        wavefront (reference schedule.py:182-290 computes the same program
        step-by-step)."""
        M, Pstages, s = self.micro_batches, self.stages, self.stage_id
        total_steps = 2 * (M + Pstages - 1)
        for t in range(total_steps):
            cmds: List[PipeInstruction] = []
            if (t - s) % 2 == 0:
                m = (t - s) // 2
                if self._valid_micro_batch(m):
                    buf = self._buffer_idx(m)
                    if self.is_first_stage:
                        cmds.append(LoadMicroBatch(buf))
                    else:
                        cmds.append(RecvActivation(buf))
                    cmds.append(ForwardPass(buf))
                    if not self.is_last_stage:
                        cmds.append(SendActivation(buf))
            else:
                tb = t - (2 * Pstages - 1 - s)
                m = tb // 2
                if tb % 2 == 0 and self._valid_micro_batch(m):
                    buf = self._buffer_idx(m)
                    if not self.is_last_stage:
                        cmds.append(RecvGrad(buf))
                    cmds.append(BackwardPass(buf))
                    if not self.is_first_stage:
                        cmds.append(SendGrad(buf))

            # Model step at the very end of the batch.
            if t == total_steps - 1:
                cmds.append(ReduceTiedGrads())
                cmds.append(ReduceGrads())
                cmds.append(OptimizerStep())
            yield cmds

    def _buffer_idx(self, micro_batch_id: int) -> int:
        assert self._valid_micro_batch(micro_batch_id)
        return micro_batch_id % self.num_pipe_buffers()

    def num_pipe_buffers(self) -> int:
        """min(stages - stage_id, micro_batches) in-flight buffers
        (1F1B memory profile, schedule.py:237-242)."""
        buffers = min(self.stages - self.stage_id, self.micro_batches)
        return max(2, buffers)


def train_schedule_events(micro_batches: int, stages: int):
    """Walk TrainSchedule's instruction streams for every stage and
    return ``{stage: [(tick, kind, micro), ...]}`` with kind
    ``"F"``/``"B"``, micro ids assigned by arrival order per family
    (1F1B runs micros in order within each family per stage)."""
    events = {}
    for s in range(stages):
        prog = TrainSchedule(micro_batches=micro_batches, stages=stages,
                             stage_id=s).steps()
        fwd = bwd = 0
        evs = []
        for u, cmds in enumerate(prog):
            for cmd in cmds:
                if isinstance(cmd, ForwardPass):
                    evs.append((u, "F", fwd))
                    fwd += 1
                elif isinstance(cmd, BackwardPass):
                    evs.append((u, "B", bwd))
                    bwd += 1
        assert fwd == bwd == micro_batches, (s, fwd, bwd)
        events[s] = evs
    return events


class DataParallelSchedule(PipeSchedule):
    """Degenerate single-stage schedule (schedule.py end): forward+backward
    every step, reduce at the end."""

    def steps(self):
        for step_id in range(self.micro_batches):
            cmds = [LoadMicroBatch(0), ForwardPass(0), BackwardPass(0)]
            if step_id == self.micro_batches - 1:
                cmds.extend([ReduceGrads(), OptimizerStep()])
            yield cmds

    def num_pipe_buffers(self) -> int:
        return 1


def interpret(schedule: PipeSchedule, handlers) -> int:
    """Run ``schedule``'s program: each instruction, step by step, goes
    to ``handlers[type(instruction)]``. Returns the number of steps.
    Every handler of an instruction the program holds must be given."""
    steps = 0
    for cmds in schedule.steps():
        for cmd in cmds:
            fn = handlers.get(type(cmd))
            if fn is None:
                raise TypeError(f"no handler for pipeline instruction "
                                f"{cmd!r}")
            fn(cmd)
        steps += 1
    return steps


__all__ = ["PipeInstruction", "OptimizerStep", "ReduceGrads",
           "ReduceTiedGrads", "BufferOpInstruction", "LoadMicroBatch",
           "ForwardPass", "BackwardPass", "SendActivation",
           "RecvActivation", "SendGrad", "RecvGrad", "PipeSchedule",
           "InferenceSchedule", "TrainSchedule", "DataParallelSchedule",
           "train_schedule_events", "interpret"]
