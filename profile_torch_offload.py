#!/usr/bin/env python3
"""ZeRO-Offload steps of the PyTorch port, serial against overlapped, on
one card, in one process.

    python3 profile_torch_offload.py [--steps N]
    python3 profile_torch_offload.py --after-gloo [--runs R]

gpt2-small under ``examples/gpt2/ds_config_offload.json`` (bf16, stage
2, the fp32 masters and Adam moments in host memory) — chip_smoke.py's
``train_offload`` cell. Three engines from the same seed take the same
batches, interleaved step by step in a rotating order, so that a drift
of the host or the card over the run reaches all three alike: the
serial pipeline, the overlapped one (``overlap_comm``) as the engine
runs it (the copies' CUDA events blocking: a waiting thread sleeps), and
the overlapped one with spinning events. The card is synchronized
around each step. Per engine: step time p50 and mean over all but the
first two steps (CUDA events around ``train_batch``) and the means of
``offload_timings`` over the same steps. The losses of the three must
be the same bits. One JSON line, ``{"overlap_ab": ...}``. Needs a CUDA
device.

``--after-gloo``: whether the gloo phases of chip_smoke.py
(``train_pipe``, ``train_zero_dp3``: stage and rank processes that
share the card through host memory) leave a load behind that takes the
overlapped pipeline's ``overlap_fraction`` to 0. The overlapped engine
as ``train_offload`` builds it takes 10 steps, R times before those
phases and R times after them. Per run: each step's ``overlap_fraction``,
its span and work (ms), and the host's runnable tasks
(``procs_running`` of ``/proc/stat``) and this process's live children
before each step. One JSON line, ``{"overlap_after_gloo": ...}``.
"""
import argparse
import contextlib
import io
import json
import os
import subprocess

import numpy as np
import torch

import chip_smoke as cs
from deepspeed_tpu_torch.ops import op_builder

KEYS = ("device_step_ms", "d2h_ms", "host_norm_ms", "host_step_ms",
        "h2d_dispatch_ms", "pipeline_span_ms", "overlap_fraction",
        "wall_ms")
SKIP = 2


def _host_load():
    """The host's runnable tasks and this process's live children."""
    with open("/proc/stat") as f:
        running = next(int(line.split()[1]) for line in f
                       if line.startswith("procs_running"))
    me, kids = str(os.getpid()), 0
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat") as f:
                kids += f.read().rsplit(")", 1)[1].split()[1] == me
        except OSError:
            pass
    return running, kids


def after_gloo(smi, runs):
    cfg = cs.GPT2_CONFIGS["gpt2-small"]
    micro = cs.offload_config()["train_batch_size"]
    batches = cs.token_stream(cfg, cs.OFFLOAD_STEPS, seq=cs.TRAIN_SEQ,
                              micro=micro // cs.TRAIN_GAS)

    def overlapped():
        cs.fresh_card()
        eng = cs.offload_engine(cfg, cs.offload_config(overlap=True))
        rec = {"fraction": [], "span_ms": [], "work_ms": [],
               "procs_running": [], "children": []}
        for b in batches:
            running, kids = _host_load()
            rec["procs_running"].append(running)
            rec["children"].append(kids)
            eng.train_batch(b)
            t = eng.offload_timings
            rec["fraction"].append(t["overlap_fraction"])
            rec["span_ms"].append(t["pipeline_span_ms"])
            rec["work_ms"].append(t["pipeline_work_ms"])
        torch.cuda.synchronize()
        del eng
        return rec
    dev = torch.device("cuda")
    out = {"card": smi, "steps": cs.OFFLOAD_STEPS,
           "before": [overlapped() for _ in range(runs)]}
    with contextlib.redirect_stdout(io.StringIO()):
        cs.train_pipe(dev, smi)
        cs.train_zero_dp3(dev, smi)
    out["after"] = [overlapped() for _ in range(runs)]
    print(json.dumps({"overlap_after_gloo": out}), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=14)
    ap.add_argument("--after-gloo", action="store_true")
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    with contextlib.redirect_stdout(io.StringIO()):
        op_builder.load()
    if args.after_gloo:
        return after_gloo(smi, args.runs)
    cfg = cs.GPT2_CONFIGS["gpt2-small"]
    micro = cs.offload_config()["train_batch_size"]
    batches = cs.token_stream(cfg, args.steps, seq=cs.TRAIN_SEQ,
                              micro=micro // cs.TRAIN_GAS)
    engs = {"serial": cs.offload_engine(cfg, cs.offload_config()),
            "overlap_block": cs.offload_engine(
                cfg, cs.offload_config(overlap=True)),
            "overlap_spin": cs.offload_engine(
                cfg, cs.offload_config(overlap=True))}
    spin = engs["overlap_spin"]
    mark = type(spin)._mark
    spin._mark = lambda stream=None, blocking=False: mark(spin, stream,
                                                          False)
    names = list(engs)
    rec = {n: {"ms": [], "timings": [], "losses": []} for n in names}
    for s, b in enumerate(batches):
        for n in names[s % 3:] + names[:s % 3]:
            eng = engs[n]
            torch.cuda.synchronize()
            st = torch.cuda.Event(enable_timing=True)
            en = torch.cuda.Event(enable_timing=True)
            st.record()
            loss = eng.train_batch(b)
            en.record()
            torch.cuda.synchronize()
            rec[n]["ms"].append(st.elapsed_time(en))
            rec[n]["losses"].append(float(loss))
            rec[n]["timings"].append(dict(eng.offload_timings))
    assert rec["serial"]["losses"] == rec["overlap_block"]["losses"] == \
        rec["overlap_spin"]["losses"], rec
    out = {"card": smi, "steps": args.steps, "skip_first": SKIP}
    for n in names:
        r = rec[n]
        out[n] = {"step_ms_p50": float(np.median(r["ms"][SKIP:])),
                  "step_ms_mean": float(np.mean(r["ms"][SKIP:])),
                  "step_ms": r["ms"],
                  **{k: float(np.mean([t[k] for t in r["timings"][SKIP:]]))
                     for k in KEYS}}
    print(json.dumps({"overlap_ab": out}), flush=True)


if __name__ == "__main__":
    main()
