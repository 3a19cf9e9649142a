"""The port's data-parallel training against the JAX engine at dp 4 and
in fp16, bf16 and master-free bf16 (the harness and recipe of
tests/test_torch_dp.py: gpt2-tiny, N gloo processes of
tests/torch_dp_worker.py beside the JAX engine on an N-device CPU mesh,
5 steps, gas 2, micro 2 a rank, dropout 0).

- dp 4 at stages 2 and 3, fp32: losses within 1e-5 relative and the
  final params within 1e-5 absolute of JAX, and of the port's dp 1 on
  the same global batch;
- dp 2 stage 2 fp16 (initial scale 2^21: skipped steps, then taken
  ones): equal loss-scale and skip sequences, losses within 1e-3;
- dp 2 stage 3 bf16 with fp32 masters: losses within 1e-2; dp 2 stage 2
  master-free (bf16 stochastic rounding): within 1e-2, the bf16 class
  (at dp > 1 the master-free update draws JAX's noise at every element,
  tests/test_torch_zero.py);
- every rank holds the same params bit for bit after every step.
"""
import numpy as np
import pytest

from test_torch_dp import STEPS, check_against_dp1, check_ranks_equal, \
    run_cases

DP2 = ["fp16_s2", "bf16_s3", "mf_s2"]
DP4 = ["s2", "s3"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_cases(tmp_path_factory.mktemp("dpp"),
                     {2: DP2, 4: DP4, 1: [4]},
                     [(2, n) for n in DP2] + [(4, n) for n in DP4])


@pytest.mark.parametrize("name", DP4)
def test_dp4_fp32_matches_jax(runs, name):
    port, jres = runs
    got, want = port[(4, name)][0], jres[(4, name)]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["params"], want["params"], atol=1e-5)


def test_dp4_matches_port_dp1(runs):
    check_against_dp1(runs[0], 4)


def test_dp2_fp16_matches_jax(runs):
    port, jres = runs
    got, want = port[(2, "fp16_s2")][0], jres[(2, "fp16_s2")]
    assert list(got["loss_scale"]) == list(want["loss_scale"])
    assert list(got["skipped"]) == list(want["skipped"])
    assert 0 < want["skipped"][-1] < STEPS
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-3)


@pytest.mark.parametrize("name", ["bf16_s3", "mf_s2"])
def test_dp2_bf16_matches_jax(runs, name):
    port, jres = runs
    np.testing.assert_allclose(port[(2, name)][0]["loss"],
                               jres[(2, name)]["loss"], rtol=1e-2)


@pytest.mark.parametrize("world,name", [(2, n) for n in DP2] +
                         [(4, n) for n in DP4],
                         ids=[f"dp2-{n}" for n in DP2] +
                         [f"dp4-{n}" for n in DP4])
def test_every_rank_holds_the_same_params(runs, world, name):
    check_ranks_equal(runs[0][(world, name)])
