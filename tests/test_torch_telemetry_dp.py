"""The port's telemetry across processes (one process a rank over gloo)
against the JAX engine on an N-device CPU mesh.

- ``meta``'s wire bytes a step equal the JAX engine's at dp 2 and 4,
  ZeRO stages 0-3 (gpt2-tiny, fp32; the ring model of the grad sync the
  engine runs: all-reduce below stage 2, reduce-scatter at stage 2, the
  two param gathers and the grad reduce-scatter a micro-step at stage
  3), exactly.
- Only rank 0 writes the stream (its ``meta`` says process_index 0 of
  N); with ``per_host_shards`` every rank writes ``run.rankK.jsonl``,
  whose ``meta`` names its rank, and every stream ends in ``final``.

The workers import no JAX; each runs every case in turn in one process
group (about 10 s a group on the CPU).
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import pytest

import deepspeed_tpu
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.parallel.topology import build_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGES = (0, 1, 2, 3)

WORKER = r"""
import json, os, sys
import numpy as np, torch
torch.set_num_threads(1)
import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import gpt2 as g
rank, world, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
deepspeed_tpu_torch.init_distributed(
    dist_backend="gloo", store=torch.distributed.FileStore(
        os.path.join(out, "store"), world), world_size=world, rank=rank)
cfg = g.GPT2_CONFIGS["gpt2-tiny"]
cfg = type(cfg)(**{**cfg.__dict__, "dtype": torch.float32})
params = g.gpt2_init(cfg, torch.Generator().manual_seed(0), "cpu")
rows = np.random.default_rng(rank).integers(0, 512, (2, 33))
cases = [(s, False) for s in (0, 1, 2, 3)] + [(0, True)]
for stage, per_host in cases:
    d = os.path.join(out, f"stage{stage}" + ("_shards" if per_host else ""))
    ds = {"train_batch_size": 2 * world, "gradient_accumulation_steps": 1,
          "steps_per_print": 10 ** 9,
          "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
          "zero_optimization": {"stage": stage},
          "telemetry": {"enabled": True, "output_path": d,
                        "job_name": "run", "report_steps": 1,
                        "per_host_shards": per_host}}
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=g.gpt2_loss_fn(cfg), model_params=params, config=ds,
        device="cpu", rng=0)
    eng.train_batch(rows)
    eng.close()
    torch.distributed.barrier()
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{dp: output dir} after each dp's process group ran every case."""
    out, procs = {}, []
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    for dp in (2, 4):
        d = tmp_path_factory.mktemp(f"dp{dp}")
        out[dp] = d
        for r in range(dp):
            procs.append(subprocess.Popen(
                [sys.executable, "-c", WORKER, str(r), str(dp), str(d)],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    logs = [p.communicate(timeout=600)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return out


def _jax_wire_bytes(dp, stage):
    cfg = dataclasses.replace(jgpt2.GPT2_CONFIGS["gpt2-tiny"])
    eng, *_ = deepspeed_tpu.initialize(
        model=jgpt2.gpt2_loss_fn(cfg),
        model_params=jgpt2.gpt2_init(jax.random.PRNGKey(0), cfg),
        config={"train_batch_size": 2 * dp,
                "gradient_accumulation_steps": 1,
                "steps_per_print": 10 ** 9,
                "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
                "zero_optimization": {"stage": stage}},
        mesh=build_mesh(devices=jax.devices()[:dp]))
    return int(eng._wire_bytes)


def _read(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


@pytest.mark.parametrize("dp", [2, 4])
@pytest.mark.parametrize("stage", STAGES)
def test_meta_wire_bytes_match_jax(runs, dp, stage):
    recs = _read(runs[dp] / f"stage{stage}" / "run.jsonl")
    meta = recs[0]
    assert meta["kind"] == "meta" and meta["dp"] == dp
    assert meta["zero_stage"] == stage
    assert meta["process_index"] == 0 and meta["process_count"] == dp
    assert meta["wire_bytes_per_step"] == _jax_wire_bytes(dp, stage) > 0
    step = next(r for r in recs if r["kind"] == "step")
    assert step["wire_bytes"] == meta["wire_bytes_per_step"]
    assert recs[-1]["kind"] == "final"
    # Only rank 0 writes without per_host_shards.
    assert not [n for n in os.listdir(runs[dp] / f"stage{stage}")
                if ".rank" in n]


@pytest.mark.parametrize("dp", [2, 4])
def test_per_host_shards_write_rank_streams(runs, dp):
    d = runs[dp] / "stage0_shards"
    for rank in range(dp):
        name = "run.jsonl" if rank == 0 else f"run.rank{rank}.jsonl"
        recs = _read(d / name)
        assert recs[0]["kind"] == "meta" and \
            recs[0]["process_index"] == rank
        assert [r["kind"] for r in recs].count("step") == 1
        assert recs[-1]["kind"] == "final"
