#!/usr/bin/env python3
"""A serving decode step under each ``inference.quantize`` mode (none,
bf16, int8), for the PyTorch port (deepspeed_tpu_torch) on one NVIDIA
GPU.

    python3 profile_torch_quant.py [--turns 8] [--steps 10] [--context 128]

Builds gpt2-small (bf16, random weights from a seed) behind three
``InferenceEngine``s, one a mode, with the smoke's serve geometry (8
slots, capacity 1024, block 16, chunk 32), fills every slot of each with
a prompt of ``--context`` tokens, then interleaves them: ``--turns``
turns, each running ``--steps`` decode iterations of every engine in a
rotated order, each iteration timed on the host clock (``decode_once``
ends in the sampled-token fetch, so its wall is the step's). The host
and the card drift between engines run one after another, so only the
interleaved readings are compared. Then one ``torch.profiler`` window of
``--steps`` iterations an engine: device busy ms and CUDA kernels a
step, the idle share (1 - busy / wall), and the device ms a step by
kernel group. Prints one JSON object; where the profiler records no
device time the device fields say "not measured".
"""
import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from deepspeed_tpu_torch.inference import InferenceEngine
from deepspeed_tpu_torch.models.gpt2 import GPT2_CONFIGS, gpt2_init
from deepspeed_tpu_torch.ops import op_builder
from profile_torch_serve import _device_us, _group

MODES = ("none", "bf16", "int8")


def profiled(eng, steps):
    """Device ms a step by kernel group, busy ms and kernels a step."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(steps):
            eng.decode_once()
        torch.cuda.synchronize()
    groups, busy, launches = {}, 0.0, 0
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us > 0 and "cuda" in str(getattr(evt, "device_type", "")).lower():
            ms = us / 1e3 / steps
            busy += ms
            launches += evt.count
            g = _group(evt.key)
            groups[g] = groups.get(g, 0.0) + ms
    if busy == 0:
        return {"device_busy_ms_per_step": "not measured"}
    return {"device_busy_ms_per_step": busy,
            "kernel_launches_per_step": launches / steps,
            "device_ms_per_step_by_group": dict(sorted(
                groups.items(), key=lambda kv: -kv[1]))}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--turns", type=int, default=8)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--context", type=int, default=128)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_quant: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    cfg = GPT2_CONFIGS["gpt2-small"]
    dev = torch.device("cuda")
    op_builder.load()
    params = gpt2_init(cfg, torch.Generator(device=dev).manual_seed(0))
    engines = {m: InferenceEngine(cfg, params, {"inference": {
        "max_slots": 8, "max_seq_len": 1024, "block_size": 16,
        "prefill_chunk": 32, "quantize": m}}) for m in MODES}
    del params
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, args.context)
               for _ in range(8)]
    n_new = (args.turns + 1) * args.steps + 16
    for eng in engines.values():
        for s, prompt in enumerate(prompts):
            tok, _ = eng.prefill(prompt, s, max_new_tokens=n_new)
            eng.activate_slot(s, args.context, tok)
        for _ in range(5):                               # warm-up
            eng.decode_once()
    torch.cuda.synchronize()

    walls = {m: [] for m in MODES}
    turn_p50 = {m: [] for m in MODES}
    for turn in range(args.turns):
        order = MODES[turn % 3:] + MODES[:turn % 3]
        for m in order:
            eng, w = engines[m], []
            for _ in range(args.steps):
                t = time.perf_counter()
                eng.decode_once()
                w.append((time.perf_counter() - t) * 1e3)
            walls[m] += w
            turn_p50[m].append(float(np.median(w)))
    out = {"card": smi, "model": "gpt2-small", "dtype": "bf16",
           "slots": 8, "context_start": args.context, "turns": args.turns,
           "steps_per_turn": args.steps, "modes": {}}
    for m in MODES:
        eng = engines[m]
        wall = float(np.median(walls[m]))
        rec = {"param_bytes": eng.param_bytes,
               "decode_step_wall_ms_p50": wall,
               "turn_p50s": turn_p50[m]}
        rec.update(profiled(eng, args.steps))
        if isinstance(rec["device_busy_ms_per_step"], float):
            rec["device_idle_share"] = \
                1.0 - rec["device_busy_ms_per_step"] / wall
        out["modes"][m] = rec
    none = out["modes"]["none"]["decode_step_wall_ms_p50"]
    for m in MODES:
        out["modes"][m]["wall_vs_none"] = \
            out["modes"][m]["decode_step_wall_ms_p50"] / none
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
