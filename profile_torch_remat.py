#!/usr/bin/env python3
"""Steady-state train steps of the PyTorch port under each activation
recomputation policy, on one card, in one process.

    python3 profile_torch_remat.py [--steps N]

gpt2-medium on chip_smoke.py's ``train_remat`` recipe (bf16, fp32
masters, gas 2 x 8 x 1024, dropout 0.1, flash attention). One engine a
policy (``none``, ``full``, ``dots``, ``dots_flash``, ``attn``) from the
same seed takes the same batches, interleaved step by step in a rotating
order, so that a drift of the host or the card over the run reaches
every policy alike; the card is synchronized around each step. Per
policy: step time p50, min and max over all but the first two steps
(CUDA events around ``train_batch``). The losses of every policy must
be the same bits. One JSON line, ``{"remat_steady": ...}``. Needs a
CUDA device.
"""
import argparse
import contextlib
import dataclasses
import io
import json
import subprocess

import numpy as np
import torch

import chip_smoke as cs
from deepspeed_tpu_torch.ops import op_builder

SKIP = 2


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=12)
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    with contextlib.redirect_stdout(io.StringIO()):
        op_builder.load()
    cfg = cs.GPT2_CONFIGS["gpt2-medium"]
    batches = cs.token_stream(cfg, args.steps)
    engs = {p: cs.make_engine(dataclasses.replace(cfg, remat_policy=p),
                              "bf16") for p in cs.REMAT_POLICIES}
    ms = {p: [] for p in engs}
    losses = {p: [] for p in engs}
    order = list(engs)
    for i, b in enumerate(batches):
        for p in order[i % len(order):] + order[:i % len(order)]:
            st, en = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
            torch.cuda.synchronize()
            st.record()
            losses[p].append(float(engs[p].train_batch(b)))
            en.record()
            torch.cuda.synchronize()
            ms[p].append(st.elapsed_time(en))
    out = {"model": "gpt2-medium", "batch": [cs.TRAIN_GAS, cs.TRAIN_MICRO,
                                             cs.TRAIN_SEQ],
           "steps": args.steps, "skipped": SKIP, "card": smi,
           "losses_bit_equal": all(losses[p] == losses["none"]
                                   for p in engs),
           "policies": {p: {"step_ms_p50": float(np.median(ms[p][SKIP:])),
                            "step_ms_min": float(min(ms[p][SKIP:])),
                            "step_ms_max": float(max(ms[p][SKIP:])),
                            "step_ms_all": ms[p]} for p in engs}}
    print(json.dumps({"remat_steady": out}), flush=True)
    assert out["losses_bit_equal"], losses


if __name__ == "__main__":
    main()
