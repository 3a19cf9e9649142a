"""Per-rank checkpoint writers and the collective preemption save at
dp > 1 (``runtime/engine.py::_per_rank_snapshot``,
``runtime/async_ckpt.commit_snapshot``, ``PreemptSaver``), on the CPU.

- Writers: at dp 2, gpt2-tiny after 2 steps, each rank writes its own
  ``zero_pp_rank_{d}`` file. Every file of the tag is byte-equal to the
  rank-0 writer's (every rank's rows gathered to rank 0, the writer the
  per-rank one replaced) at the same step, and the meta equal, at ZeRO
  stages 0, 1 and 2, sync and async, and at stage 3 under a bound
  ``Zero3Scan`` (the per-layer rows, exchanged into JAX's rows before
  the write). The JAX engine on a 2-device mesh loads the stage-2 tag:
  its parameters and moments equal the port's bit for bit.
- A rank killed mid-write (the ``mid_blob_write`` crash point in rank 1)
  commits nothing: rank 0's wait for its file times out, ``latest``
  still names the previous tag, which loads, and the torn tag is not
  there.
- The collective preemption save (the harness's MLP job at dp 2 through
  ``tools/crashkill_torch.py child``): a SIGTERM to rank 1 alone makes
  both ranks save the same ``global_step{N}`` at the next step boundary
  (both rank files in the tag) and exit by SIGTERM; the resume at dp 2
  is bit-equal to the uninterrupted run, and the JAX engine (one
  process, a 2-device mesh, JAX's ``PreemptSaver`` tag rule) loads the
  tag to the same parameters as the port.
- A SIGTERM to one rank with no step in flight is not swallowed: held
  after the last step, the next ``eval_batch`` takes it up (every rank
  saves the same tag and exits by SIGTERM); ``engine.close()`` or the
  interpreter's exit makes the signalled rank exit by it without a save
  (the other rank ends normally); and when any rank's step raised, no
  rank saves (the ranks agree on that as on the flag).
"""
import subprocess
import glob
import json
import os
import signal
import sys
import time

import jax
import numpy as np
import pytest

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import convert
from deepspeed_tpu_torch.models import gpt2 as tgpt2

import torch_dp_worker as W
from test_torch_dp import (jax_engine, jax_flat_params, load, make_batches,
                           params_np, save_params, spawn)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import crashkill as jck  # noqa: E402  (JAX's harness)
import crashkill_torch as ck  # noqa: E402
sys.path.pop(0)

CASES = {  # name: (stage, async, scan)
    "s0": (0, False, False), "s1": (1, False, False),
    "s2": (2, False, False), "s2_async": (2, True, False),
    "s3_scan": (3, False, True)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory, boundary_started):
    # (boundary_started's processes run beside this fixture's)
    d = tmp_path_factory.mktemp("writers")
    ppath = str(d / "params.npz")
    save_params(params_np(), ppath)
    np.save(str(d / "b2.npy"), make_batches(2, 5, steps=2))
    jobs = []
    for name, (stage, asy, scan) in CASES.items():
        job = dict(name=name, precision="fp32", stage=stage,
                   batches=str(d / "b2.npy"), out=str(d / name),
                   save={"dir": str(d / name / "per_rank"), "after": 2,
                         "gathered": str(d / name / "gathered")})
        if asy:
            job["ds"] = {"checkpoint": {"async": True}}
        if scan:
            job["scan"] = {"depth": 1}
        jobs.append(job)
    crash_dir = str(d / "crash")
    jobs.append(dict(name="crash", precision="fp32", stage=2,
                     batches=str(d / "b2.npy"), out=str(d / "crash"),
                     ds={"checkpoint": {"writer_timeout_s": 3}},
                     save={"dir": crash_dir, "after": 1},
                     crash={"rank": 1, "point": "mid_blob_write",
                            "after": 2, "dir": crash_dir}))
    procs = spawn(d, 2, jobs, "writers", ppath)
    outs = [p.communicate(timeout=400)[0].decode(errors="replace")
            for p in procs]
    # (rank 1 kills itself in the last job)
    assert [p.returncode for p in procs] == [0, -9], outs[0][-4000:] + \
        outs[1][-4000:]
    return d


def _files(tag_dir):
    return sorted(os.listdir(tag_dir))


@pytest.mark.parametrize("name", list(CASES))
def test_rank_files_byte_equal_to_rank0_writer(runs, name):
    a = runs / name / "per_rank" / "global_step2"
    b = runs / name / "gathered" / "global_step2"
    assert (runs / name / "per_rank" / "latest").read_text() == \
        "global_step2"
    assert _files(a) == _files(b) and \
        "zero_pp_rank_1_mp_rank_00_optim_states.msgpack" in _files(a)
    for f in _files(a):
        if f == "engine_meta.json":
            assert json.loads((a / f).read_text()) == \
                json.loads((b / f).read_text())
        else:
            assert (a / f).read_bytes() == (b / f).read_bytes(), f
    # no staging dir or part file left behind
    assert not glob.glob(str(runs / name / "per_rank" / "*.tmp*"))


def test_jax_loads_the_per_rank_files(runs):
    ranks = load(str(runs / "s2"), 2)
    eng = jax_engine("fp32", 2, 2, params_np())
    assert eng.load_checkpoint(str(runs / "s2" / "per_rank"))[0] is not None
    np.testing.assert_array_equal(jax_flat_params(eng), ranks[0]["params"])
    st = jax.device_get(eng.state.opt_state)
    for g, (m, v) in enumerate(zip(st.m, st.v)):
        np.testing.assert_array_equal(np.asarray(m).reshape(-1),
                                      np.concatenate([r[f"m{g}"]
                                                      for r in ranks]))
        np.testing.assert_array_equal(np.asarray(v).reshape(-1),
                                      np.concatenate([r[f"v{g}"]
                                                      for r in ranks]))


def test_a_rank_killed_mid_write_commits_nothing(runs):
    d = runs / "crash"
    assert "did not land" in (runs / "crash.rank0.crash").read_text()
    assert not (runs / "crash.rank1.crash").exists()   # (killed)
    assert (d / "latest").read_text() == "global_step1"
    assert not (d / "global_step2").exists()
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=tgpt2.gpt2_loss_fn(tgpt2.GPT2_CONFIGS["gpt2-tiny"]),
        model_params=convert.from_jax_params(params_np()),
        config=W.ds_config("fp32", 1, 2), device="cpu")
    path, _ = eng.load_checkpoint(str(d))
    assert path is not None and eng.global_steps == 1


# --------------------------------------------------------------------- #
# The collective preemption save
# --------------------------------------------------------------------- #
def _group(ckdir, steps, out="", world=2):
    return ck._spawn("child", ckdir, steps, 0, "cpu", out=out, world=world)


def test_sigterm_to_one_rank_saves_every_rank(tmp_path):
    steps = 30
    ref = _group(str(tmp_path / "ref"), steps, str(tmp_path / "ref.npz"))
    ckdir = str(tmp_path / "ck")
    procs = _group(ckdir, steps)
    marker = os.path.join(ckdir, "PROGRESS")
    t0 = time.time()
    while time.time() - t0 < 240:
        try:
            with open(marker) as f:
                if int(f.read() or 0) >= 5:
                    break
        except (OSError, ValueError):
            pass
        time.sleep(0.005)
    procs[1].send_signal(signal.SIGTERM)        # rank 1 alone
    rcs, _, logs = ck._finish(procs, 240)
    assert rcs == [-15, -15], logs[-3000:]
    tag = open(os.path.join(ckdir, "latest")).read()
    n = int(tag.replace("global_step", ""))
    assert 5 <= n < steps, tag
    assert {f"zero_pp_rank_{r}_mp_rank_00_optim_states.msgpack"
            for r in range(2)} <= set(os.listdir(os.path.join(ckdir, tag)))
    rcs, _, logs = ck._finish(ref, 240)
    assert rcs == [0, 0], logs[-3000:]
    rcs, _, logs = ck._finish(_group(ckdir, steps, str(tmp_path /
                                                       "got.npz")), 240)
    assert rcs == [0, 0], logs[-3000:]
    assert ck._max_delta(str(tmp_path / "ref.npz"),
                         str(tmp_path / "got.npz")) == 0.0

    # JAX's single-process engine on a 2-device mesh loads the tag
    jeng = jck._engine(2, str(tmp_path / "jax"), 0, False)
    assert jeng.load_checkpoint(ckdir)[0] is not None
    assert int(jeng.state.step) == n
    teng = ck._engine(str(tmp_path / "probe"), 0, False, "cpu")
    assert teng.load_checkpoint(ckdir)[0] is not None
    jp = jax.device_get(jeng.state.params)
    for k, t in teng.state.params.items():
        np.testing.assert_array_equal(t.detach().numpy(), np.asarray(jp[k]))


# A SIGTERM held with no step in flight (the harness's MLP at dp 2, two
# steps, no auto-saves): who takes it up, and with what save.
_BOUNDARY = r"""
import os, signal, sys
sys.path.insert(0, sys.argv[5])
import torch.distributed as dist
import crashkill_torch as ck
import deepspeed_tpu_torch
mode, rank, store, ckdir = sys.argv[1], int(sys.argv[2]), sys.argv[3], \
    sys.argv[4]
deepspeed_tpu_torch.init_distributed(
    dist_backend="gloo", store=dist.FileStore(store, 2), world_size=2,
    rank=rank, verbose=False)
eng = ck._engine(ckdir, 0, False, "cpu", 2)
for step in range(2):
    eng.train_batch(ck._rank_rows(ck.batch_for(step), 2, rank))
signalled = 0 if mode == "raised" else 1
if rank == signalled:
    os.kill(os.getpid(), signal.SIGTERM)     # held: no step in flight
print("HELD", flush=True)
if mode == "eval":
    eng.eval_batch(ck._rank_rows(ck.batch_for(9), 2, rank))
elif mode == "close":
    eng.close()
elif mode == "raised":
    # rank 1's step raised: its boundary says so
    eng._preempt_saver.fire_held(save=rank == 0)
print("FELL_THROUGH", flush=True)
"""
BOUNDARY_MODES = {  # mode: (return codes, the tag latest names or None)
    "eval": ([-15, -15], "global_step2"),
    "close": ([0, -15], None),
    "exit": ([0, -15], None),
    "raised": ([-15, -15], None),
}


@pytest.fixture(scope="module")
def boundary_started(tmp_path_factory):
    """The boundary jobs' processes, started (``boundary`` waits)."""
    d = tmp_path_factory.mktemp("boundary")
    script = d / "boundary.py"
    script.write_text(_BOUNDARY)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return d, {m: [subprocess.Popen(
        [sys.executable, str(script), m, str(r), str(d / f"{m}.store"),
         str(d / m), os.path.join(REPO, "tools")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env) for r in range(2)]
        for m in BOUNDARY_MODES}


@pytest.fixture(scope="module")
def boundary(boundary_started):
    d, procs = boundary_started
    out = {}
    for m, ps in procs.items():
        logs = [p.communicate(timeout=240)[0] for p in ps]
        out[m] = ([p.returncode for p in ps], logs, str(d / m))
    return out


@pytest.mark.parametrize("mode", list(BOUNDARY_MODES))
def test_sigterm_between_steps_is_taken_up(boundary, mode):
    rcs, logs, ckdir = boundary[mode]
    want_rcs, want_tag = BOUNDARY_MODES[mode]
    assert rcs == want_rcs, "\n".join(logs)[-3000:]
    for rc, log in zip(rcs, logs):
        assert "HELD" in log, log[-3000:]
        # a rank exits by the signal where the boundary takes it up (at
        # the interpreter's exit: after the script's end)
        assert ("FELL_THROUGH" in log) == (rc == 0 or mode == "exit"), \
            log[-3000:]
    latest = os.path.join(ckdir, "latest")
    if want_tag is None:
        assert not os.path.exists(latest)
        assert not glob.glob(os.path.join(ckdir, "global_step*"))
    else:
        assert open(latest).read() == want_tag
        assert {f"zero_pp_rank_{r}_mp_rank_00_optim_states.msgpack"
                for r in range(2)} <= set(os.listdir(
                    os.path.join(ckdir, want_tag)))
