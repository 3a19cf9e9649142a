"""Activation recomputation and progressive layer drop at dp 2 over gloo
(the processes of ``tests/torch_dp_worker.py``, the harness of
``tests/test_torch_dp.py``), on gpt2-tiny, fp32, dropout 0.1, 5 steps.

- Stage 3 with ``remat_policy="full"`` is bit-identical to stage 2 with
  ``full`` (params each step by digest, losses, final params, moments),
  as the dp tests hold stage 3 to stage 2: the recompute hands the
  gathered weights to stage 3's re-gather, never holding them.
- Stage 2 with ``full`` is bit-identical to stage 2 with ``none``: the
  recompute replays each rank's dropout stream.
- A ``progressive_layer_drop`` block at stage 2 trains: both ranks hold
  the same params after every step, losses finite.
"""
import numpy as np
import pytest

import torch_dp_worker as W
from test_torch_dp import (check_ranks_equal, load, make_batches, params_np,
                           save_params, spawn, wait)

JOBS = {  # name: (stage, remat, extra ds keys)
    "s2_none": (2, "none", None),
    "s2_full": (2, "full", None),
    "s3_full": (3, "full", None),
    "s2_pld": (2, "none", {"progressive_layer_drop": {
        "enabled": True, "theta": 0.5, "gamma": 0.1}}),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("remat_dp")
    ppath = str(d / "params.npz")
    save_params(params_np(), ppath)
    np.save(str(d / "b2.npy"), make_batches(2, 1))
    jobs = [dict(name=n, precision="fp32", stage=st, remat=rm, dropout=0.1,
                 ds=extra, batches=str(d / "b2.npy"), out=str(d / n))
            for n, (st, rm, extra) in JOBS.items()]
    wait(spawn(d, 2, jobs, "remat", ppath))
    return {n: load(str(d / n), 2) for n in JOBS}


def _bit_equal(a, b):
    assert list(a["digest"]) == list(b["digest"])
    np.testing.assert_array_equal(a["loss"], b["loss"])
    np.testing.assert_array_equal(a["params"], b["params"])


def test_stage3_full_is_bit_identical_to_stage2_full(runs):
    for r in range(2):
        s2, s3 = runs["s2_full"][r], runs["s3_full"][r]
        _bit_equal(s2, s3)
        for k in s2:
            if k[0] in "mv" and k[1:].isdigit():
                np.testing.assert_array_equal(s2[k], s3[k])


def test_full_is_bit_identical_to_none_at_dp2(runs):
    for r in range(2):
        _bit_equal(runs["s2_none"][r], runs["s2_full"][r])


@pytest.mark.parametrize("name", list(JOBS))
def test_every_rank_holds_the_same_params(runs, name):
    check_ranks_equal(runs[name])


def test_pld_trains_at_dp2(runs):
    got, base = runs["s2_pld"][0], runs["s2_none"][0]
    assert np.isfinite(got["loss"]).all()
    assert not np.array_equal(got["params"], base["params"])
    assert W.GAS == 2
