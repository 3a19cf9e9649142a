#!/usr/bin/env python3
"""Readings of K9 and the MoE training path on one card, in one process.

    python3 profile_torch_moe.py [--parts dtype,tiles,sass,moe]

Parts (all by default, in this order):

- ``dtype``: K9 (``ops/grouped_gemm.py``, ``csrc/grouped_gemm.cu``) by
  dtype at the seven shapes of one MoE layer and micro-batch
  (chip_smoke.py's ``_gg_cases``: 8 experts, capacity 2560, hidden 768,
  FFN 3072, the backward's operands as transposed views), bf16 and fp16
  on the same values (drawn in fp32 from one seed, cast to each), read
  in the order bf16, fp16, fp16, bf16 at the plan's tile. Each reading:
  20 warm launches, then about a second of launches between CUDA
  events; while the card works through them, ``nvidia-smi`` reads its
  SM clock and power draw. ``torch.bmm`` on the same operands in both
  dtypes is the control.
- ``tiles``: the same seven shapes in bf16 at both wgmma tiles (BN 128
  and 256), read in the order 128, 256, 256, 128, each beside the plan's
  pick (``_gg_plan``) and the block count of each tile.
- ``sass``: the instruction mix of each K9 instantiation in the built
  library (``cuobjdump -sass``): all instructions, HGMMA (wgmma), UTMALDG
  (TMA loads), the barrier and shared-memory traffic, stores.
- ``moe``: the drop fraction: chip_smoke.py's ``train_moe`` recipe
  (gpt2-small, 8 experts top-2 in every block, gas 2 x 8 x 1024) for 12
  steps three ways, from one seed and one token stream: bf16 with K9
  (the main path), bf16 with the expert FFN's plain version
  (``grouped_ffn_plain`` in place of the kernel), and fp32 with K9
  (model and ds_config). Each prints its losses, drop fractions, aux and
  z losses and step ms per step.

One JSON line per reading, then a summary line. Needs a CUDA device.
"""
import argparse
import dataclasses
import re
import subprocess
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
import deepspeed_tpu_torch
from deepspeed_tpu_torch.models.gpt2 import GPT2_CONFIGS, gpt2_init, \
    gpt2_loss_fn
from deepspeed_tpu_torch.models.transformer import KERNEL_OPS
from deepspeed_tpu_torch.moe import MoEConfig
from deepspeed_tpu_torch.ops import grouped_gemm as gg
from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig

READING_MS = 1000.0
MAX_LAUNCHES = 800          # below the launch queue's depth
STEPS = 12


def smi_query(fields):
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def reading(fn):
    """Mean ms a call over about READING_MS of calls, and the SM clock
    and power draw read while the card works through them."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(5):
        fn()
    e.record()
    torch.cuda.synchronize()
    est = s.elapsed_time(e) / 5
    n = int(min(MAX_LAUNCHES, max(20, READING_MS / est)))
    s.record()
    for _ in range(n):
        fn()
    e.record()
    during = smi_query("clocks.sm,power.draw")
    torch.cuda.synchronize()
    return {"ms": s.elapsed_time(e) / n, "launches": n,
            "sm_clock_power_during": during}


def gg_cases(dev):
    """(case, a, b, bias, act) in fp32 at the path's seven shapes."""
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    E, C = cs.MOE_EXPERTS, cs.MOE_CAPACITY
    small = GPT2_CONFIGS["gpt2-small"]
    H, Fw = small.hidden_size, small.ffn_size

    def r(*shape, scale=1.0):
        return scale * torch.randn(*shape, device=dev, generator=gen)
    x, w1, b1 = r(E, C, H), r(E, H, Fw, scale=H ** -0.5), r(E, Fw, scale=.1)
    h, dy, dz = r(E, C, Fw), r(E, C, H), r(E, C, Fw, scale=0.1)
    w2, b2 = r(E, Fw, H, scale=Fw ** -0.5), r(E, H, scale=0.1)
    sw = lambda t: t.transpose(1, 2)  # noqa: E731
    return [("fwd_up", x, w1, b1, "gelu_tanh"), ("fwd_down", h, w2, b2, None),
            ("bwd_z1", x, w1, b1, None), ("bwd_dh", dy, sw(w2), None, None),
            ("bwd_dw2", sw(h), dy, None, None),
            ("bwd_dw1", sw(x), dz, None, None),
            ("bwd_dx", dz, sw(w1), None, None)]


def cast_view(t, dt):
    """``t`` in ``dt`` with t's layout (a transposed view stays one)."""
    if t.is_contiguous():
        return t.to(dt)
    return t.transpose(1, 2).contiguous().to(dt).transpose(1, 2)


def k9_by_dtype(dev, smi):
    out = []
    for case, a, b, bias, act in gg_cases(dev):
        # the same values in both dtypes, with the path's strides
        ops16 = {dt: (cast_view(a, dt), cast_view(b, dt))
                 for dt in (torch.bfloat16, torch.float16)}
        rec = {"case": case, "shape": [a.shape[0], a.shape[1], a.shape[2],
                                       b.shape[2]],
               "strides": {"a": list(ops16[torch.bfloat16][0].stride()),
                           "b": list(ops16[torch.bfloat16][1].stride())},
               "act": act, "bias": bias is not None, "card": smi}
        for turn, dt in enumerate((torch.bfloat16, torch.float16,
                                   torch.float16, torch.bfloat16)):
            aa, bb = ops16[dt]
            rec[f"k9_{turn}_{str(dt)[6:]}"] = reading(
                lambda: gg.grouped_matmul(aa, bb, bias, act))
        for dt in (torch.bfloat16, torch.float16):
            aa, bb = ops16[dt]
            rec[f"bmm_{str(dt)[6:]}"] = reading(lambda: torch.bmm(aa, bb))
        bf = [rec[f"k9_{i}_bfloat16"]["ms"] for i in (0, 3)]
        fp = [rec[f"k9_{i}_float16"]["ms"] for i in (1, 2)]
        rec["k9_bf16_over_fp16"] = float(np.mean(bf) / np.mean(fp))
        rec["bmm_bf16_over_fp16"] = rec["bmm_bfloat16"]["ms"] / \
            rec["bmm_float16"]["ms"]
        cs.emit({"k9_dtype": rec})
        out.append(rec)
        del ops16
    torch.cuda.empty_cache()
    return out


def k9_by_tile(dev, smi):
    """The seven bf16 shapes at both tiles, in the order 128, 256, 256,
    128."""
    out = []
    for case, a, b, bias, act in gg_cases(dev):
        aa, bb = cast_view(a, torch.bfloat16), cast_view(b, torch.bfloat16)
        E, M, K = aa.shape
        N = bb.shape[2]
        plan = gg._gg_plan(aa, bb, act)
        rec = {"case": case, "shape": [E, M, K, N], "act": act,
               "bias": bias is not None, "majors": [plan.a_major,
                                                    plan.b_major],
               "plan_tile": list(plan.tile), "card": smi}
        for turn, bn in enumerate((128, 256, 256, 128)):
            rec[f"bn{bn}_{turn}"] = reading(
                lambda: gg.grouped_matmul(aa, bb, bias, act, bn))
        for bn in (128, 256):
            ms = [rec[f"bn{bn}_{i}"]["ms"] for i in range(4)
                  if f"bn{bn}_{i}" in rec]
            rec[f"bn{bn}_ms"] = float(np.mean(ms))
            tiles = E * -(-M // 128) * -(-N // bn)
            rec[f"bn{bn}_blocks"] = tiles
        rec["faster"] = 128 if rec["bn128_ms"] < rec["bn256_ms"] else 256
        cs.emit({"k9_tile": rec})
        out.append(rec)
    torch.cuda.empty_cache()
    return out


def k9_sass():
    """Instruction counts of each grouped-GEMM instantiation."""
    lib = op_builder.build()
    tool = Path(op_builder.find_nvcc()).with_name("cuobjdump")
    dump = subprocess.run([str(tool), "-sass", str(lib)],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    funcs = {}
    name = None
    for line in dump.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1) if "grouped_gemm" in m.group(1) else None
            if name:
                funcs[name] = Counter()
            continue
        if name is None:
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)"
                      r"(\.[A-Z0-9_.]+)?", line)
        if m:
            funcs[name]["all"] += 1
            op = m.group(1)
            if op in ("HGMMA", "UTMALDG", "SYNCS", "WARPGROUP", "HMMA",
                      "LD", "LDS", "LDSM", "STS", "BAR", "LDG", "STG",
                      "SHFL", "F2FP", "MUFU"):
                funcs[name][op + (m.group(2) or "")] += 1
    rec = {name: dict(sorted(c.items())) for name, c in funcs.items()}
    cs.emit({"k9_sass": rec})
    return rec


def moe_cfg():
    ds_moe = DeepSpeedConfig(dict(cs.train_config("bf16", STEPS),
                                  moe=cs.moe_block())).moe_config
    return dataclasses.replace(GPT2_CONFIGS["gpt2-small"],
                               moe=MoEConfig.from_ds_config(ds_moe))


def train_turn(cfg, precision, expert, batches, smi, dev):
    ds = dict(cs.train_config("bf16", STEPS), moe=cs.moe_block())
    if precision == "fp32":
        # the model computes in its config's dtype, the engine casts the
        # params to the ds_config's
        del ds["bf16"]
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
    ops = KERNEL_OPS if expert == "kernel" else \
        KERNEL_OPS._replace(expert_ffn=gg.grouped_ffn_plain)
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=gpt2_loss_fn(cfg, ops=ops),
        model_params=gpt2_init(cfg, torch.Generator(device=dev)
                               .manual_seed(cs.SEED), dev),
        config=ds, rng=cs.SEED, device=dev)
    losses, metrics, ms, counts = cs.run_path(eng, batches)
    rec = {"precision": precision, "model_dtype": str(cfg.dtype),
           "expert_ffn": expert,
           "losses": losses,
           "drop_fraction": [float(m["moe_drop_fraction"]) for m in metrics],
           "aux_loss": [float(m["moe_aux_loss"]) for m in metrics],
           "z_loss": [float(m["moe_z_loss"]) for m in metrics],
           "expert_tokens_last_step":
               metrics[-1]["moe_expert_tokens"].tolist(),
           "step_ms_p50": float(np.median(ms[2:])),
           "k9_launches": counts["grouped_matmul"], "card": smi}
    cs.emit({"moe_turn": rec})
    assert all(np.isfinite(losses)), rec
    del eng
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parts", default="dtype,tiles,sass,moe")
    parts = ap.parse_args().parts.split(",")
    if not torch.cuda.is_available():
        print("profile_torch_moe: no CUDA device is available",
              file=sys.stderr)
        return 2
    smi = smi_query("name,power.limit")
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    op_builder.load()
    summary = {"card": smi}
    if "dtype" in parts:
        dtype = k9_by_dtype(dev, smi)
        summary["k9_bf16_over_fp16"] = {r["case"]: r["k9_bf16_over_fp16"]
                                        for r in dtype}
        summary["bmm_bf16_over_fp16"] = {
            r["case"]: r["bmm_bf16_over_fp16"] for r in dtype}
        summary["k9_bf16_ms"] = {r["case"]: float(np.mean(
            [r["k9_0_bfloat16"]["ms"], r["k9_3_bfloat16"]["ms"]]))
            for r in dtype}
        summary["bmm_bf16_ms"] = {r["case"]: r["bmm_bfloat16"]["ms"]
                                  for r in dtype}
    if "tiles" in parts:
        tiles = k9_by_tile(dev, smi)
        summary["k9_bf16_ms_by_tile"] = {
            r["case"]: {"128": r["bn128_ms"], "256": r["bn256_ms"],
                        "plan": r["plan_tile"][1]} for r in tiles}
    if "sass" in parts:
        sass = k9_sass()
        summary["k9_sass_mma_and_loads"] = {
            n: {k: v for k, v in c.items()
                if k.startswith(("HGMMA", "UTMALDG", "HMMA", "LD", "all"))}
            for n, c in sass.items()}
    if "moe" in parts:
        cfg = moe_cfg()
        batches = cs.token_stream(cfg, STEPS)
        turns = [train_turn(cfg, p, e, batches, smi, dev)
                 for p, e in (("bf16", "kernel"), ("bf16", "plain"),
                              ("fp32", "kernel"))]
        base = turns[0]["drop_fraction"]
        summary["drop_fraction"] = {f"{t['precision']}_{t['expert_ffn']}":
                                    t["drop_fraction"] for t in turns}
        summary["drop_fraction_max_abs_diff_vs_bf16_kernel"] = {
            f"{t['precision']}_{t['expert_ffn']}":
                float(np.max(np.abs(np.subtract(t["drop_fraction"], base))))
            for t in turns[1:]}
        summary["step_ms_p50"] = {f"{t['precision']}_{t['expert_ffn']}":
                                  t["step_ms_p50"] for t in turns}
    cs.emit({"summary": summary})
    return 0


if __name__ == "__main__":
    sys.exit(main())
