"""The port's launcher (``deepspeed_tpu_torch/launcher/``) against the JAX
package's, and its process model on the CPU.

- Hostfile parsing, the ``--include`` / ``--exclude`` filters and the
  world info: the same results, and the same errors on the same bad input,
  as ``deepspeed_tpu.launcher.runner`` (``tests/test_launcher.py``'s
  cases).
- The PDSH and SSH commands: JAX's, apart from the env names.
- A two-process launch through ``python -m
  deepspeed_tpu_torch.launcher.runner`` on gloo via ``env://``: both ranks
  all-reduce, and each sees its ``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``,
  ``CUDA_VISIBLE_DEVICES`` and ``--local_rank``; a failing child takes
  its sibling down.
- ``init_distributed``'s device rule (``cuda:LOCAL_RANK % device_count``)
  and ``distributed_port``, with ``torch.cuda`` mocked.
- ``tools/crashkill_torch.py run --quick --device cpu``: the same-dp tier
  bit-exact; and a SIGTERM landing inside a step (``train_batch`` or the
  trio's ``step()``) saved at the step's end, under the tag of the state
  it holds (fault F10 in ROADMAP §3).
"""
import argparse
import json
import os
import socket
import subprocess
import sys
import textwrap
import time

import pytest
import torch

from deepspeed_tpu.launcher import multinode_runner as jmr
from deepspeed_tpu.launcher import runner as jrunner
from deepspeed_tpu_torch.launcher import launch as tlaunch
from deepspeed_tpu_torch.launcher import multinode_runner as tmr
from deepspeed_tpu_torch.launcher import runner as trunner
from deepspeed_tpu_torch.parallel import comm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _outcome(fn, *args):
    try:
        return "ok", fn(*args)
    except Exception as e:  # compare the error's type across packages
        return "raises", type(e).__name__


HOSTFILES = {
    "parse": "worker-0 slots=4\nworker-1 slots=4\n\n# comment\n"
             "worker-2 slots=8\n",
    "duplicate_host": "worker-0 slots=4\nworker-0 slots=2\n",
    "slot_not_int": "worker-0 slots=four\n",
    "no_slots": "worker-0\n",
    "three_fields": "worker-0 slots=2 extra\n",
    "no_equals": "worker-0 slots4\n",
    "empty": "\n# only a comment\n",
}


@pytest.mark.parametrize("name", list(HOSTFILES))
def test_fetch_hostfile_matches_jax(name, tmp_path):
    path = tmp_path / "hostfile"
    path.write_text(HOSTFILES[name])
    got = _outcome(trunner.fetch_hostfile, str(path))
    want = _outcome(jrunner.fetch_hostfile, str(path))
    assert got == want
    if got[0] == "ok":
        assert list(got[1]) == list(want[1])


def test_missing_hostfile_returns_none(tmp_path):
    missing = str(tmp_path / "none")
    assert trunner.fetch_hostfile(missing) is None
    assert jrunner.fetch_hostfile(missing) is None


POOL = {"worker-0": 4, "worker-1": 4}
FILTERS = [("worker-0@worker-1:0,2", ""), ("", "worker-1:0"),
           ("", "worker-1"), ("worker-0", "worker-1"), ("worker-9", ""),
           ("worker-0:7", ""), ("", "worker-0:1,3@worker-1"),
           ("worker-1:3,1,1", ""), ("", ""), ("worker-1@worker-0", ""),
           ("worker-0:x", ""), ("", "worker-9:0")]


@pytest.mark.parametrize("include,exclude", FILTERS)
def test_inclusion_exclusion_matches_jax(include, exclude):
    got = _outcome(trunner.parse_inclusion_exclusion, POOL, include, exclude)
    want = _outcome(jrunner.parse_inclusion_exclusion, POOL, include,
                    exclude)
    assert got == want
    if got[0] == "ok":
        assert list(got[1].items()) == list(want[1].items())


def test_resource_filter_keeps_hostfile_order():
    hosts = {"a": [0, 1], "b": [0, 1], "c": [0, 1]}
    got = trunner.parse_resource_filter(hosts, include_str="c@a")
    assert list(got.items()) == list(
        jrunner.parse_resource_filter(hosts, include_str="c@a").items())
    assert list(got) == ["a", "c"]


@pytest.mark.parametrize("world", [{"worker-0": [0, 1], "worker-1": [0]},
                                   {"localhost": [0, 1, 2, 3, 4, 5, 6, 7]},
                                   {"a": [3], "b": [0, 2], "c": [1]}])
def test_world_info_round_trip_matches_jax(world):
    enc = trunner.encode_world_info(world)
    assert enc == jrunner.encode_world_info(world)
    assert trunner.decode_world_info(enc) == world
    assert jrunner.decode_world_info(enc) == world


def _runner_args(**kw):
    ns = argparse.Namespace(user_args=["--flag", "a b"],
                            user_script="train.py", procs_per_node=2,
                            launcher_args="")
    ns.master_port = ns.coordinator_port = 29511
    for k, v in kw.items():
        setattr(ns, k, v)
    return ns


def _as_port(cmd):
    """JAX's command in the port's names."""
    out = []
    for part in cmd:
        for a, b in (("deepspeed_tpu.launcher.launch",
                      "deepspeed_tpu_torch.launcher.launch"),
                     ("--coordinator_addr=", "--master_addr="),
                     ("--coordinator_port=", "--master_port=")):
            part = part.replace(a, b)
        out.append(part)
    return out


@pytest.mark.parametrize("launcher_args", ["", "-R ssh -u 30"])
def test_pdsh_command_matches_jax(launcher_args):
    world = {"worker-0": [0, 1], "worker-1": [0, 1]}
    t = tmr.PDSHRunner(_runner_args(launcher_args=launcher_args), "V0RMRA==")
    j = jmr.PDSHRunner(_runner_args(launcher_args=launcher_args), "V0RMRA==")
    for r in (t, j):
        r.add_export("NCCL_DEBUG", "INFO")
        r.add_export("PYTHONPATH", "/x y")
    t_env, j_env = {}, {}
    got = t.get_cmd(t_env, world, "10.0.0.2")
    assert got == _as_port(j.get_cmd(j_env, world, "10.0.0.2"))
    assert t_env == j_env == {"PDSH_RCMD_TYPE": "ssh"}
    assert got[:6] == ["pdsh", "-S", "-f", "1024", "-w", "worker-0,worker-1"]
    assert "export NCCL_DEBUG=INFO; export PYTHONPATH='/x y'; " in got[-1]
    assert "--node_rank=-1" in got[-1] and "--master_addr=10.0.0.2" in got[-1]


def test_ssh_command_matches_jax():
    world = {"a": [0], "b": [0], "c": [0]}
    t = tmr.SSHRunner(_runner_args(), "V0RMRA==")
    j = jmr.SSHRunner(_runner_args(), "V0RMRA==")
    for r in (t, j):
        r.add_export("CUDA_HOME", "/usr/local/cuda")
    got = t.get_cmd({}, world, "10.0.0.2")
    assert got == _as_port(j.get_cmd({}, world, "10.0.0.2"))
    assert got[:2] == ["/bin/bash", "-c"]
    for rank, host in enumerate(world):
        assert f"ssh {host} " in got[2]
        assert f"--node_rank={rank}" in got[2]
    assert "exit $rc" in got[2]


def test_exports_are_the_cuda_prefixes(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    (tmp_path / ".deepspeed_env").write_text("FOO=bar=baz\n")
    env = {"NCCL_IB_HCA": "mlx5", "CUDA_HOME": "/c", "TORCH_HOME": "/t",
           "PYTHONPATH": "/p", "DS_X": "1", "TPU_NAME": "n",
           "XLA_FLAGS": "f", "JAX_PLATFORMS": "cpu", "HOME": str(tmp_path)}
    got = trunner._collect_exports(env)
    assert got == {"NCCL_IB_HCA": "mlx5", "CUDA_HOME": "/c",
                   "TORCH_HOME": "/t", "PYTHONPATH": "/p", "DS_X": "1",
                   "FOO": "bar=baz"}


def test_gcloud_launcher_is_not_planned():
    with pytest.raises(NotImplementedError, match="not planned"):
        trunner.main(["--launcher", "gcloud", "train.py"])


def test_runner_argument_errors():
    with pytest.raises(ValueError, match="include/exclude"):
        trunner.main(["--num_gpus", "1", "--include", "localhost",
                      "train.py"])
    with pytest.raises(ValueError, match="num_nodes > 1"):
        trunner.main(["--hostfile", "/nonexistent", "--num_nodes", "2",
                      "train.py"])


def test_worker_env_ranks_across_nodes():
    world = {"a": [0, 1], "b": [2, 3, 5]}
    ranks = []
    for node in (0, 1):
        for local in range(tlaunch.node_processes(world, 2)[node]):
            env = tlaunch.worker_env({"KEEP": "1"}, world, node, local, 2,
                                     "10.0.0.1", 29500)
            assert env["WORLD_SIZE"] == "10" and env["KEEP"] == "1"
            assert env["LOCAL_RANK"] == str(local)
            assert env["CUDA_VISIBLE_DEVICES"] == \
                ",".join(map(str, list(world.values())[node]))
            assert (env["MASTER_ADDR"], env["MASTER_PORT"]) == \
                ("10.0.0.1", "29500")
            ranks.append(int(env["RANK"]))
    assert ranks == list(range(10))


# --------------------------------------------------------------------- #
# Launches on the CPU
# --------------------------------------------------------------------- #
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(tmp_path, body, extra=(), timeout=120):
    script = tmp_path / "user_script.py"
    script.write_text(textwrap.dedent(body))
    hostfile = tmp_path / "hostfile"
    hostfile.write_text("localhost slots=2\n")
    env = dict(os.environ, OUT_DIR=str(tmp_path))
    env["PYTHONPATH"] = REPO + ":" + env.get("PYTHONPATH", "")
    cmd = [sys.executable, "-m", "deepspeed_tpu_torch.launcher.runner",
           "--hostfile", str(hostfile), "--master_port", str(_free_port()),
           *extra, str(script), "--tag", "x y"]
    t0 = time.time()
    res = subprocess.run(cmd, env=env, cwd=str(tmp_path),
                         capture_output=True, text=True, timeout=timeout)
    return res, time.time() - t0


def test_two_process_launch_env_and_all_reduce(tmp_path):
    res, _ = _launch(tmp_path, """\
        import argparse, json, os
        import torch, torch.distributed as dist
        import deepspeed_tpu_torch
        ap = argparse.ArgumentParser()
        ap.add_argument("--local_rank", type=int)
        ap.add_argument("--tag")
        a = ap.parse_args()
        deepspeed_tpu_torch.init_distributed(dist_backend="gloo")
        t = torch.tensor([float(dist.get_rank() + 1)])
        dist.all_reduce(t)
        rec = {k: os.environ[k] for k in ("RANK", "LOCAL_RANK",
               "WORLD_SIZE", "CUDA_VISIBLE_DEVICES", "MASTER_ADDR")}
        rec.update(arg=a.local_rank, tag=a.tag, sum=t.item(),
                   rank=dist.get_rank(), world=dist.get_world_size())
        with open(os.path.join(os.environ["OUT_DIR"],
                               f"rank{rec['RANK']}.json"), "w") as f:
            json.dump(rec, f)
        dist.destroy_process_group()
    """)
    assert res.returncode == 0, res.stdout + res.stderr
    for r in (0, 1):
        rec = json.loads((tmp_path / f"rank{r}.json").read_text())
        assert rec == {"RANK": str(r), "LOCAL_RANK": str(r),
                       "WORLD_SIZE": "2", "CUDA_VISIBLE_DEVICES": "0,1",
                       "MASTER_ADDR": "127.0.0.1", "arg": r, "tag": "x y",
                       "sum": 3.0, "rank": r, "world": 2}


def test_failed_child_kills_its_sibling(tmp_path):
    res, took = _launch(tmp_path, """\
        import os, sys, time
        if os.environ["RANK"] == "1":
            sys.exit(3)
        time.sleep(300)   # only a kill ends it
    """)
    assert res.returncode == 3, res.stdout + res.stderr
    assert took < 60, took
    assert "killing node" in res.stdout + res.stderr


# --------------------------------------------------------------------- #
# init_distributed: the card a launched rank takes
# --------------------------------------------------------------------- #
@pytest.fixture
def fake_group(monkeypatch):
    calls = {"set_device": [], "init": []}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda i: calls["set_device"].append(i))
    monkeypatch.setattr(comm, "is_initialized", lambda: False)
    monkeypatch.setattr(comm.dist, "init_process_group",
                        lambda **kw: calls["init"].append(kw))
    for k in ("LOCAL_RANK", "RANK", "WORLD_SIZE", "MASTER_ADDR",
              "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    return calls


@pytest.mark.parametrize("local_rank,card", [("0", 0), ("3", 3), ("6", 2)])
def test_init_distributed_takes_local_rank_card(fake_group, monkeypatch,
                                                local_rank, card):
    monkeypatch.setenv("LOCAL_RANK", local_rank)
    monkeypatch.setenv("RANK", local_rank)
    monkeypatch.setenv("WORLD_SIZE", "8")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "29400")
    comm.init_distributed(dist_backend="gloo")
    assert fake_group["set_device"] == [card]
    assert fake_group["init"] == [dict(backend="gloo", world_size=8,
                                       rank=int(local_rank),
                                       init_method="env://")]


def test_init_distributed_without_local_rank_keeps_the_device(fake_group):
    comm.init_distributed(dist_backend="gloo", world_size=1, rank=0)
    assert fake_group["set_device"] == []
    assert fake_group["init"][0]["world_size"] == 1


def test_init_distributed_port_keyword(fake_group, monkeypatch):
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    comm.init_distributed(dist_backend="gloo", world_size=1, rank=0,
                          distributed_port=29777)
    assert os.environ["MASTER_PORT"] == "29777"
    assert fake_group["init"][0]["init_method"] == "env://"
    # an explicit MASTER_PORT wins
    monkeypatch.setenv("MASTER_PORT", "29001")
    comm.init_distributed(dist_backend="gloo", world_size=1, rank=0,
                          distributed_port=29778)
    assert os.environ["MASTER_PORT"] == "29001"


def test_init_distributed_keeps_its_keyword_callers(fake_group, tmp_path):
    store = torch.distributed.FileStore(str(tmp_path / "store"), 2)
    comm.init_distributed(dist_backend="gloo", store=store, world_size=2,
                          rank=1, verbose=False)
    comm.init_distributed(dist_backend="gloo", world_size=2, rank=0,
                          init_method="tcp://localhost:29555")
    assert fake_group["init"] == [
        dict(backend="gloo", world_size=2, rank=1, store=store),
        dict(backend="gloo", world_size=2, rank=0,
             init_method="tcp://localhost:29555")]
    assert fake_group["set_device"] == []


# --------------------------------------------------------------------- #
# The crash-kill harness
# --------------------------------------------------------------------- #
def test_crashkill_quick_same_dp_bit_exact(tmp_path):
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "crashkill_torch.py"),
         "run", "--quick", "--device", "cpu", "--workdir",
         str(tmp_path / "work")],
        capture_output=True, text=True, timeout=400, cwd=REPO,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-4000:]
    out = res.stdout
    assert "kill #1: SIGTERM" in out and "kill #2: SIGKILL" in out, out
    assert out.count("probe: PROBE_") == 2, out
    assert "same-dp trajectory: BIT-IDENTICAL" in out
    assert "crashkill: PASS" in out


SIGTERM_IN_STEP = """\
import os, signal, sys
sys.path[:0] = [{repo!r}, {tools!r}]
import crashkill_torch as ck
eng = ck._engine({ckdir!r}, 0, False, "cpu")
orig = type(eng)._finish_step

def finish(self, *a):
    # the signal lands inside step 5, after its update
    if self.global_steps == 5:
        os.kill(os.getpid(), signal.SIGTERM)
    return orig(self, *a)

type(eng)._finish_step = finish
for s in range(10):
    if {trio!r}:
        eng.backward(eng.forward(ck.batch_for(s)))
        eng.step()
    else:
        eng.train_batch(ck.batch_for(s))
"""


@pytest.mark.parametrize("trio", [False, True])
def test_sigterm_inside_a_step_saves_that_step(tmp_path, trio):
    """A SIGTERM that lands inside a step (after its update) is handled at
    the step's end: the preemption save's tag names the state it holds
    (it used to commit step 6's params as global_step5)."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import crashkill_torch as ck
    finally:
        sys.path.pop(0)
    ckdir = str(tmp_path / "ck")
    code = SIGTERM_IN_STEP.format(repo=REPO, tools=os.path.join(REPO,
                                                                "tools"),
                                  ckdir=ckdir, trio=trio)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(tmp_path))
    assert res.returncode == -15, res.stdout[-3000:] + res.stderr[-3000:]
    assert (tmp_path / "ck" / "latest").read_text().strip() == \
        "global_step6"
    ref = ck._engine(str(tmp_path / "ref"), 0, False, "cpu")
    for s in range(6):
        ref.train_batch(ck.batch_for(s))
    got = ck._engine(ckdir, 0, False, "cpu")
    path, _ = got.load_checkpoint(ckdir)
    assert path is not None and got.global_steps == 6
    for name, t in (("ref", ref), ("got", got)):
        ck._dump_state(t, str(tmp_path / f"{name}.npz"))
    assert ck._max_delta(str(tmp_path / "ref.npz"),
                         str(tmp_path / "got.npz")) == 0.0
