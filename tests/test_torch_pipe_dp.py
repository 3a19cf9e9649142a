"""The port's pipeline engine with more ranks: pp 2 x dp 2 (ZeRO 1 and
2) and pp 4 x dp 1, ``gpipe`` and ``1f1b``, against the JAX
``PipelineEngine`` on ``build_mesh(pp=P, dp=D)`` and the port's own
non-pipelined engine at the same dp (tests/test_torch_pipe.py's harness
and checks: gpt2-tiny with 4 layers, fp32, dropout 0, 3 steps, losses and
the whole tree within 1e-5, the tied leaves bit-equal on the first and
last stage). pp 2 x dp 3 (a dp that does not divide 8) runs in
tests/test_torch_zero_dp3.py, beside the other dp-3 worlds.

- 1F1B at pp 4 with M 8: stage s holds at most min(P - s, M) stage
  inputs (within ``num_pipe_buffers()``), GPipe all M; a stage sends its
  activations and grads, M of each a step, and nothing else.
"""
import numpy as np
import pytest

from deepspeed_tpu_torch.runtime.pipe.schedule import TrainSchedule
from test_torch_pipe import (CASES, GAS, MICRO, UNIFORM, GAS_OF,
                             check_matches_jax, check_matches_unpipelined,
                             check_tied_shared_bit_equal, run_pipe_cases)

NAMES = ["pp22_gpipe", "pp22_1f1b", "pp4_gpipe", "pp4_1f1b"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_pipe_cases(str(tmp_path_factory.mktemp("pipe_dp")), NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_pipeline_matches_jax(runs, name):
    check_matches_jax(runs, name)


@pytest.mark.parametrize("name", [n for n in UNIFORM
                                  if n in NAMES and n not in GAS_OF])
def test_pipeline_matches_unpipelined_engine(runs, name):
    check_matches_unpipelined(runs, name)


@pytest.mark.parametrize("name", NAMES)
def test_tied_shared_bit_equal_on_first_and_last_stage(runs, name):
    check_tied_shared_bit_equal(runs, name)


def test_live_stage_inputs_follow_the_schedule(runs):
    """1F1B at pp 4, M 8: stage s's most live stage inputs are
    min(P - s, M), within num_pipe_buffers(); GPipe holds all M."""
    for s, r in enumerate(runs["port"]["pp4_1f1b"]):
        nb = TrainSchedule(micro_batches=8, stages=4,
                           stage_id=s).num_pipe_buffers()
        assert set(r["live"]) == {min(4 - s, 8)} and min(4 - s, 8) <= nb
    for r in runs["port"]["pp4_gpipe"]:
        assert set(r["live"]) == {GAS}
    # each stage but the last sends M activations a step, and the grads
    # back from the others
    acts = MICRO * 32 * 128 * 4 * GAS
    p2p = [int(r["p2p"][0]) for r in runs["port"]["pp4_gpipe"]]
    assert p2p == [acts, 2 * acts, 2 * acts, acts]
    assert CASES["pp4_1f1b"][:2] == (4, 1)
