#!/usr/bin/env python3
"""Training step of the PyTorch port with dense attention against flash
attention, on one card, in one process.

    python3 profile_torch_train.py

gpt2-small, bf16 with fp32 masters, AdamW, gas 2 x micro-batch 8 x 1024,
dropout 0.1 — chip_smoke.py's training cell. Each path builds its own
engine from the same seed and runs 12 steps on the same batches; the paths run in the order dense, flash, flash, dense, so a
drift of the card over the run shows as a gap between the two readings
of one path. Per path and turn: step time p50 over all but the first
two steps (CUDA events around ``train_batch``), tokens/s, peak device
memory of the turn (``max_memory_allocated`` after a reset), and the
device time by kernel group of three profiled steps (torch.profiler).
"dense" is ``dense_attention`` passed as the loss function's
``attention_fn`` — the port's attention before the flash kernels;
"flash" is the default, ``auto_attention``. One JSON line per turn, then
a summary line. Needs a CUDA device.
"""
import json
import subprocess
import sys

import numpy as np
import torch

import chip_smoke as cs
import deepspeed_tpu_torch
from deepspeed_tpu_torch.models.gpt2 import GPT2_CONFIGS, gpt2_init, \
    gpt2_loss_fn
from deepspeed_tpu_torch.models.transformer import dense_attention

STEPS = 12

def run_turn(cfg, attention, batches, prof_batches):
    dev = torch.device("cuda")
    params = gpt2_init(cfg, torch.Generator(device=dev).manual_seed(cs.SEED))
    attn = dense_attention if attention == "dense" else None
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=gpt2_loss_fn(cfg, attention_fn=attn), model_params=params,
        config=cs.train_config("bf16", len(batches)), rng=cs.SEED)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    losses, _, ms, counts = cs.run_path(eng, batches)
    peak = torch.cuda.max_memory_allocated() / 1e9
    prof = cs.profile_train_steps(eng, prof_batches)
    del eng
    torch.cuda.empty_cache()
    step = float(np.median(ms[2:]))
    return {"attention": attention, "steps": len(batches),
            "step_ms_p50": step, "step_ms_all": ms,
            "tokens_per_s": cs.TRAIN_GAS * cs.TRAIN_MICRO *
            (batches[0].shape[1] - 1) / (step / 1e3),
            "peak_memory_gb": peak, "losses": losses,
            "flash_launches": {k: v for k, v in counts.items()
                               if k.startswith("flash") and v},
            "profile": {k: prof[k] for k in (
                "wall_ms_per_step_profiled", "device_busy_ms_per_step",
                "device_ms_per_step_by_group", "device_idle_share",
                "kernel_launches_per_step",
                "top_kernels_ms_and_launches_per_step")}}


def main():
    if not torch.cuda.is_available():
        print("profile_torch_train: no CUDA device is available",
              file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = GPT2_CONFIGS["gpt2-small"]
    batches = cs.token_stream(cfg, STEPS + 3)
    turns = []
    for attention in ("dense", "flash", "flash", "dense"):
        rec = run_turn(cfg, attention, batches[:STEPS], batches[STEPS:])
        rec["card"] = smi
        cs.emit({"turn": rec})
        turns.append(rec)
    summary = {}
    for attention in ("dense", "flash"):
        mine = [t for t in turns if t["attention"] == attention]
        summary[attention] = {
            "step_ms_p50": [t["step_ms_p50"] for t in mine],
            "tokens_per_s": [t["tokens_per_s"] for t in mine],
            "peak_memory_gb": [t["peak_memory_gb"] for t in mine],
            "device_busy_ms_per_step": [
                t["profile"]["device_busy_ms_per_step"] for t in mine]}
    cs.emit({"summary": summary, "seq": cs.TRAIN_SEQ, "card": smi})
    return 0


if __name__ == "__main__":
    sys.exit(main())
