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

    python3 profile_torch_train.py --parts elementwise [--label NAME]

reads instead the LayerNorm and bias+GELU kernels (K3f, K3b, K4f, K4b;
K4f and K4b in both forms) at the training shapes (8192 rows of 768 or
3072, bf16), and K3f at a decode step's 8 rows, three ways each (CUDA
events around a loop of wrapper calls, graph replay, and one call after
a 64 MB write that leaves the L2 cold), beside ``F.layer_norm``,
``native_layer_norm_backward`` and ``aten.gelu_backward`` (dz alone)
read the same ways, then one flash turn of the training step and one of
its ``gelu_exact`` variant (step p50, device busy, and the in-step
device time of each port kernel a launch). It uses only what
every checkout since the erf form's port has, so a copy of this file
run from the root of an earlier checkout (``git archive`` into the
git-ignored ``runs/``) reads that checkout's kernels on the same card:
run parent, change, change, parent in one call.
"""
import argparse
import dataclasses
import json
import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F

import chip_smoke as cs
import deepspeed_tpu_torch
from deepspeed_tpu_torch.models.gpt2 import GPT2_CONFIGS, gpt2_init, \
    gpt2_loss_fn
from deepspeed_tpu_torch.models.transformer import dense_attention
from deepspeed_tpu_torch.ops import fused_elementwise as fe

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
                "top_kernels_ms_and_launches_per_step",
                "port_kernel_device_ms_per_launch")}}


def elementwise_kernels():
    """K3f, K3b, K4f and K4b at the training shapes (and K3f at 8 rows),
    and the library calls beside them: {name: {kernel_ms, device_ms,
    cold_ms}}."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    H, Fw, R, dt = 768, 3072, cs.TRAIN_ROWS, torch.bfloat16

    def rnd(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    x = (2 * rnd(R, H) + 0.5).to(dt)
    d, dy, gs = (rnd(R, H).to(dt) for _ in range(3))
    sc, bi = 1 + 0.1 * rnd(H), 0.1 * rnd(H)
    y, b, g = (3 * rnd(R, Fw)).to(dt), rnd(Fw), rnd(R, Fw).to(dt)
    mean, rstd = cs._native_ln_bwd_inputs(x, sc, bi)
    sc_t, bi_t = sc.to(dt), bi.to(dt)
    x8, d8 = x[:8].clone(), d[:8].clone()
    z = (y.float() + b).to(dt)
    fns = {
        "K3f": lambda: fe.fused_layer_norm(x, sc, bi),
        "K3f_residual": lambda: fe.fused_residual_layer_norm(x, d, sc, bi),
        "K3f_8rows": lambda: fe.fused_layer_norm(x8, sc, bi),
        "K3f_8rows_residual":
            lambda: fe.fused_residual_layer_norm(x8, d8, sc, bi),
        "K3b": lambda: fe.layer_norm_backward(x, sc, dy, None),
        "K3b_residual": lambda: fe.layer_norm_backward(x, sc, dy, gs),
        "K4f": lambda: fe.fused_bias_gelu(y, b),
        "K4f_exact": lambda: fe.fused_bias_gelu(y, b, True),
        "K4b": lambda: fe.bias_gelu_backward(y, b, g),
        "K4b_exact": lambda: fe.bias_gelu_backward(y, b, g, True),
        "F.layer_norm": lambda: F.layer_norm(x, (H,), sc_t, bi_t),
        "F.layer_norm_8rows": lambda: F.layer_norm(x8, (H,), sc_t, bi_t),
        "x + d, F.layer_norm":
            lambda: F.layer_norm(x + d, (H,), sc_t, bi_t),
        "aten.gelu_backward_tanh": lambda: torch.ops.aten.gelu_backward(
            g, z, approximate="tanh"),
        "aten.gelu_backward_erf": lambda: torch.ops.aten.gelu_backward(
            g, z, approximate="none"),
        "native_layer_norm_backward":
            lambda: torch.ops.aten.native_layer_norm_backward(
                dy, x, [H], mean, rstd, sc_t, bi_t, [True, True, True]),
    }
    return {name: {"kernel_ms": cs.time_ms(fn), "device_ms": cs.device_ms(fn),
                   "cold_ms": cs.cold_ms(fn)} for name, fn in fns.items()}


def elementwise(smi, label):
    cfg = GPT2_CONFIGS["gpt2-small"]
    batches = cs.token_stream(cfg, STEPS + 3)
    rec = {"label": label, "card": smi, "shapes": {
        "rows": cs.TRAIN_ROWS, "H": 768, "F": 3072, "dtype": "bf16"},
        "kernels": elementwise_kernels()}
    rec["flash_step"] = run_turn(cfg, "flash", batches[:STEPS],
                                 batches[STEPS:])
    rec["gelu_exact_step"] = run_turn(
        dataclasses.replace(cfg, gelu_exact=True), "flash",
        batches[:STEPS], batches[STEPS:])
    cs.emit({"elementwise": rec})


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
    ap = argparse.ArgumentParser()
    ap.add_argument("--parts", default="attention",
                    choices=("attention", "elementwise"))
    ap.add_argument("--label", default="this checkout")
    args = ap.parse_args()
    if args.parts == "elementwise":
        elementwise(smi, args.label)
        return 0
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
