#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (deepspeed_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero (no phase's error is caught):

1. The card (``nvidia-smi`` name and power limit) and the torch/CUDA
   versions.
2. Build the port's CUDA kernels from ``deepspeed_tpu_torch/csrc`` into
   ``build/deepspeed_tpu_torch/`` (one nvcc per source, in parallel;
   printed: the build seconds and ptxas' register/shared-memory report,
   and on the build line the registers and spills of the paged-attention
   and flash forward and backward kernels with their dynamic shared
   memory).
3. Hold each kernel against its plain PyTorch version on the card: the
   serving kernels at the serving path's gpt2-small shapes (LayerNorm
   rows 8 and 32 x 768, bias+GELU rows 8 and 32 x 3072, paged attention
   decode/verify/prefill and the serving decode step's shape, each
   launched twice and compared bit for bit, timed also by the card's own
   time and with a cold L2), then every kernel of the training path at its
   gpt2-small training shapes (micro-batch 8 x 1024 = 8192 rows, bf16):
   LayerNorm forward and backward (8192 x 768, with and without the
   residual; the backward launched twice and compared bit for bit),
   bias+GELU forward and backward (8192 x 3072, the tanh and the erf
   form, each launched twice and compared bit for bit), each of these
   also timed by the card's own time (graph replay) and with a cold L2,
   as are the library calls beside them, the grad sum
   of squares and the fused Adam step over the 124M-element fp32
   parameter group, the latter for each flag set the engine uses; then
   the flash attention kernels (bf16, 12 heads of 64, causal): the
   forward and the fused backward at the training shape (8 x 1024), the
   forward and the split dq / dk-dv backward at sequence 768 and at the
   dense causal step's 2 x 4096, each with dropout 0 and 0.1, and the
   forward at the whole-prompt prefill shape (1 x 1024), each also
   launched twice and compared bit for bit (the 8 x 1024 forward also
   timed with a cold L2, the backward kernels also by the card's own
   time, graph replay, and with a cold L2); then
   the block-sparse kernels (``check_sparse``): K7, K8b, K8c and K8a at
   the sparse path's shape (2 x 4096, 12 heads of 64, bf16, the Fixed
   layout, causal) at tile (1, 1) with dropout 0 and 0.1 and at the
   JAX-picked super-tile (2, 8), and on a BigBird layout (bidirectional,
   random blocks, a layout per head) at 2 x 2048; the layout-gated K1,
   K2a, K2b at the path's shape, and the dense causal K1 at 2 x 4096;
   then the grouped GEMM (K9, ``check_grouped_gemm``) at the seven
   shapes of one MoE layer and micro-batch on the MoE path (8 experts,
   capacity 2560, 768 x 3072, bf16: the forward's up- and down-projection,
   the backward's recompute and its four products on transposed views),
   and the up-projection in fp32 and fp16, each launched twice and
   compared bit for bit, with its route (``_gg_plan``: the operands'
   majors, the tile, no staged copy) and also timed by the card's own
   time (graph replay), with a cold L2 and on the host's clock (the
   wrapper's Python a call). One JSON line per shape: the kernel's, the
   plain version's and a library call's time (CUDA events), the least
   time the card could take (``bound_ms``, over the (q, k) pairs kept)
   and the largest error.
4. Serve gpt2-small (full width and depth, random bf16 weights from a
   seed) through ``InferenceEngine.serve``: 16 shared-prefix requests,
   then the same stream with ``spec_k: 3``, then with whole-prompt
   prefill (``prefill_chunk: 0``, the flash forward). Each serve is its
   own path: the launch counters are zeroed just before it and read just
   after it, and every serving kernel must have launched in it. Every
   token each serve emitted is held against the plain ``gpt2_apply``
   teacher-forced over the same history (``check_streams``). Then the
   exact launches of one step of each attention mode, and the chunked
   and the whole-prompt engines' prefill logits against the plain
   ``gpt2_apply`` on the card.
5. Train gpt2-small through ``initialize`` → ``train_batch``: bf16 with
   fp32 masters, AdamW, WarmupLR, clip 1.0, gas 2 x micro-batch 8 x
   1024, dropout 0.1, on a seeded learnable token stream. First one
   step's loss and grad norm against a plain-autograd step on the card
   (plain LayerNorm/GELU, the flash forward's plain version, same params,
   batch and dropout masks); then
   the main path, 30 steps, read on its own: every loss finite, the last
   5 below the first 5, and exactly the expected launches per step of
   every training kernel. Step time p50, tokens/s and model TFLOP/s;
   then three profiled steps (device time by kernel group, idle share)
   and one step under CUDA's sync debug mode (the host syncs it makes).
   Then the fp16 path (dynamic loss scale from 2^32: skipped steps, then
   taken ones), the master-free bf16 path (stochastic rounding), a bf16
   path at sequence 768 (the split flash backward) and
   ``train_gelu_exact`` (``gelu_exact=True``, the erf form of K4f/K4b:
   its first loss against a plain-autograd step, 5 steps, finite losses,
   exact launches), each read on its own.
5b. Train gpt2-small at sequence 4096 (gas 2 x micro-batch 2) with the
   ds_config's block-sparse attention (Fixed unidirectional, block 128)
   as the model's ``attention_fn``: one step against a plain-autograd
   yardstick (the attention recomputed per layer by
   ``torch.utils.checkpoint``), then ``train_sparse`` (the LUT kernels
   K7/K8b/K8c, 12 steps: losses finite and falling, exact launches, step
   ms, tokens/s, peak memory, a profile), ``train_sparse_fused``
   (``DS_SPARSE_FUSED_BWD=1``, K8a, 3 steps), ``train_sparse_gated`` (the
   layout as a CUDA tensor, the gated K1/K2a/K2b, 3 steps; first loss
   within 2e-3 of train_sparse's) and ``train_flash_s4096`` (dense causal
   flash, 5 steps), each read on its own.
5c. Train gpt2-small with an 8-expert top-2 MoE FFN (capacity factor
   1.25) in every block, the ds_config ``moe`` block building the model's
   ``MoEConfig``, at the main path's recipe: a yardstick step against
   plain autograd (the grouped FFN's plain version), ``train_moe`` (12
   bf16 steps: losses finite and falling, exactly 168 K9 launches a step,
   no staged K9 operand and no bias+GELU kernel, step ms, tokens/s,
   TFLOP/s by the routed count, peak memory, drop fraction), 2 profiled
   steps (K9's share of device time, the step's idle share) and
   ``train_moe_fp16`` (3 steps: finite, the last below the first, no
   staged operand), each read on its own.
6. The ``{"kernels": [...]}`` summary line, then the result line
   ``{"ok": true, "device": {...}}``.
"""
import contextlib
import dataclasses
import io
import json
import math
import os
import random
import re
import subprocess
import sys
import time
import warnings

import numpy as np
import torch
import torch.nn.functional as F

import deepspeed_tpu_torch
from deepspeed_tpu_torch import ops
from deepspeed_tpu_torch.inference import InferenceEngine, \
    shared_prefix_requests
from deepspeed_tpu_torch.models.gpt2 import GPT2_CONFIGS, gpt2_apply, \
    gpt2_flops_per_token, gpt2_init, gpt2_loss_fn, gpt2_num_params
from deepspeed_tpu_torch.models.transformer import PLAIN_OPS
from deepspeed_tpu_torch.moe import MoEConfig
from deepspeed_tpu_torch.ops import flash_attention as fa
from deepspeed_tpu_torch.ops import fused_elementwise as fe
from deepspeed_tpu_torch.ops import fused_update as fu
from deepspeed_tpu_torch.ops import grouped_gemm as gg
from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops import paged_attention as pa
from deepspeed_tpu_torch.ops import sparse_flash as sf
from deepspeed_tpu_torch.ops.fused_update import tree_flatten, \
    tree_unflatten
from deepspeed_tpu_torch.ops.sparse_attention import \
    BigBirdSparsityConfig, SparseSelfAttention, sparse_attention
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig

# Published peaks of the H100 SXM (NVIDIA data sheet, dense, 700 W): HBM
# bytes/s, the bf16 rate and the fp32 rate outside the tensor cores. The
# operations term of a bound is priced at the rate of the inputs' type:
# bf16 for the serving kernels and the LayerNorm/GELU kernels, fp32 for
# the grad norm and the Adam step, whose inputs are fp32.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
FP32_FLOPS_PER_S = 67e12
# Kernel against its plain version: both accumulate in fp32 and round once
# to bf16, so they may differ by a rounding step. Allowed: 2 bf16 ulp of
# the larger magnitude, floored at 1e-5 (GELU's cancelling tail; see the
# CPU tests).
ULP_FLOOR = 1e-5
# bf16 engine (paged, chunked) against the plain gpt2_apply on one prompt:
# about twice the largest difference measured on the H100 (0.03125, i.e.
# 2 bf16 ulp of the largest logit), and the argmax must be equal.
LOGIT_TOL = 0.0625
# A served token's reference margin (check_streams): an engine whose
# logits lie within LOGIT_TOL of the reference's picks a token whose
# reference logit trails the reference's largest by at most twice that.
PICK_MARGIN_TOL = 2 * LOGIT_TOL
SEED = 0
# The training main path: gpt2-small, micro-batch 8 x 1024 tokens (the
# kernels' rows), gas 2.
TRAIN_MICRO, TRAIN_SEQ, TRAIN_GAS = 8, 1024, 2
TRAIN_ROWS = TRAIN_MICRO * TRAIN_SEQ
TRAIN_STEPS = 30
# The kernel-path training step against the plain-autograd step on the
# card (bf16 compute, fp32 masters, same params, batch and dropout
# masks). The two differ in where the LayerNorm/GELU forward and backward
# round to bf16, and in where the attention rounds p to bf16 (the flash
# kernels' online softmax against the plain whole-row formula).
TRAIN_LOSS_RTOL = 2e-3
TRAIN_GRAD_NORM_RTOL = 2e-2
SERVE_KERNELS = ("fused_layer_norm", "fused_bias_gelu", "paged_attention")
# The second training path: sequence 768 takes the split flash backward.
SPLIT_SEQ, SPLIT_STEPS = 768, 5
# The gelu_exact path: the main path's recipe with the erf form of GELU.
GELU_EXACT_STEPS = 5
# Flash kernels against their plain versions (bf16): both round p and ds
# to bf16 at the same points, but the kernel's online softmax does so at
# running maxima over 64-column tiles and the plain version at the row
# maximum, and the sums run in other orders. Outputs within this fraction
# of their largest magnitude (2 bf16 ulp of it); lse (fp32) absolute.
FLASH_REL_TOL = 2.0 ** -7
FLASH_LSE_TOL = 1e-4
FLASH_SEED = 20240917
# Block-sparse attention (slice 4): gpt2-small at sequence 4096, gas 2 x
# micro-batch 2 (16384 tokens a step, as the main path), with the
# ds_config's Fixed unidirectional layout of 128-blocks: 192 live blocks
# a head of 528 causal ones, the LUT route, pick_tile (2, 8).
SPARSE_SEQ, SPARSE_MICRO = 4096, 2
# (case, batch, sequence, dropout): 12 heads of 64, causal, bf16. At
# 2 x 4096 (the dense causal step of the sparse phase) the backward is
# the split pair.
FLASH_CASES = (("train", TRAIN_MICRO, TRAIN_SEQ, 0.0),
               ("train", TRAIN_MICRO, TRAIN_SEQ, 0.1),
               ("train_split", TRAIN_MICRO, SPLIT_SEQ, 0.0),
               ("train_split", TRAIN_MICRO, SPLIT_SEQ, 0.1),
               ("train_s4096", SPARSE_MICRO, SPARSE_SEQ, 0.0),
               ("train_s4096", SPARSE_MICRO, SPARSE_SEQ, 0.1),
               ("prefill", 1, 1024, 0.0))
SPARSE_SECTION = {"mode": "fixed", "block": 128, "num_local_blocks": 4,
                  "num_global_blocks": 1, "attention": "unidirectional"}
SPARSE_STEPS, SPARSE_SIDE_STEPS, FLASH_S4096_STEPS = 12, 3, 5
# The BigBird kernel check (bidirectional, random blocks, a layout per
# head): batch and sequence.
BIGBIRD_B, BIGBIRD_SEQ = 2, 2048
# The gated path's first loss against the LUT path's, same state, batch
# and dropout masks: the same function, tiles visited in another order.
GATED_LOSS_TOL = 2e-3
FRACTION_BITS = {"bf16": 7, "fp16": 10}
# MoE at expert-parallel size 1 (slice 4b): gpt2-small with 8 experts,
# top-2, capacity factor 1.25 on every block (the repo's MoE tutorial,
# docs/tutorials/moe.md); a micro-batch of 8 x 1024 routes 8192 tokens,
# so each expert has C = ceil(1.25 * 2 * 8192 / 8) = 2560 slots.
MOE_EXPERTS, MOE_TOP_K, MOE_CF, MOE_CAPACITY = 8, 2, 1.25, 2560
MOE_STEPS, MOE_PROFILE_STEPS, MOE_FP16_STEPS = 12, 2, 3


# Kernels whose ptxas report (registers, spills, static shared memory) the
# build line carries: the paged attention (K10), the forward tile (K1,
# and K7 on the same tile), the backward tiles (K2a-K2c, and K8a-K8c
# on the same tiles) of the main paths, the grouped GEMM (K9), and the
# LayerNorm (K3f, K3b) and bias+GELU (K4f, K4b) instances.
PTXAS_KERNELS = ("paged_attn_mma_kernel", "paged_attn_fma_kernel",
                 "paged_combine_kernel", "flash_fwd_kernel",
                 "sparse_fwd_kernel", "flash_bwd_dq_kernel",
                 "flash_bwd_dkv_kernel", "flash_bwd_fused_kernel",
                 "sparse_dq_kernel", "sparse_dkv_kernel",
                 "sparse_fused_bwd_kernel", "grouped_gemm_wgmma_kernel",
                 "grouped_gemm_f32_kernel", "ln_fwd_kernel",
                 "ln_bwd_kernel", "bias_gelu_kernel",
                 "bias_gelu_bwd_kernel")


def ptxas_summary(log):
    """{kernel<template args>: registers, spill bytes, static smem} from
    ``nvcc -Xptxas -v`` output, for PTXAS_KERNELS."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = [n for n in PTXAS_KERNELS if n in m.group(1)]
            name = None
            if k:
                targs = m.group(1).split(k[0], 1)[1]
                name = k[0] + re.sub(r"^I|EE.*$|E?Ev.*$", "", targs)
                out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[name]["spill_stores"] = int(m.group(1))
            out[name]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            out[name]["static_smem"] = int(sm.group(1)) if sm else 0
            name = None
    return out


def dynamic_smem_bytes():
    """Dynamic shared memory of one block at the main paths' shapes (bf16,
    head dim 64), by the carve-ups in csrc/: the forward tile's Q + two
    (K, V) buffers of 64 rows at pitch 72 (flash_tiles.cuh fwd_smem); the
    dq tile's two (K, V) buffers (dq_smem); the dk/dv tile's K, V and two
    (Q, dO) buffers with two (lse, delta) rows, and with the staged dS^T
    (64 x 72) of the sparse fused pass (dkv_smem), the fused K2c taking
    the larger of the dq and dk/dv tiles; and K10's three-stage ring of K
    and V (64 rows at pitch 72) with live flags, 16 Q rows and the block
    ids of one split (paged_attention.cu smem_bytes; decode, 64 table
    entries over 3 splits); and K9's ring at each tile: stages of a
    128 x 64 A tile and a BN x 64 B tile, 1 KB of alignment slack and
    two 8-byte barriers a stage (grouped_gemm.cu Ring: 3 stages at BN
    128, two blocks an SM; 4 at BN 256)."""
    tile = 64 * 72 * 2
    dkv = 6 * tile + 4 * 64 * 4
    ring = 3 * (2 * tile + 64 * 4)
    k10 = ring + 16 * 72 * 2 + -(-64 // pa.paged_splits(8, 12, 64, 1)) * 4
    return {"flash_fwd_kernel<bf16, 64>": 4 * tile,
            "flash_bwd_dq_kernel<bf16, 64>": 4 * tile,
            "flash_bwd_dkv_kernel<bf16, 64>": dkv,
            "flash_bwd_fused_kernel<bf16, 64>": max(4 * tile, dkv),
            "sparse_fused_bwd_kernel<bf16, 64>": dkv + tile,
            "paged_attn_mma_kernel<bf16, 64>, decode": k10,
            **{f"grouped_gemm_wgmma_kernel<bf16, {bn}>":
               stages * (128 + bn) * 64 * 2 + 1024 + 16 * stages
               for bn, stages in ((128, 3), (256, 4))}}


def emit(obj):
    print(json.dumps(obj), flush=True)


def time_ms(fn, iters=100, warmup=10):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_of(fn, n=20):
    """``fn`` called ``n`` times, captured in one CUDA graph; returns its
    replay. A replay runs the launches with no Python between them."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(n):
            fn()
    return g.replay


def device_ms(fn, n=20, reps=10):
    """Device time of one call: CUDA events around replays of a graph of
    ``n`` calls. Where the host takes longer to issue a call than the
    card to run it, ``time_ms`` reads the host; this reads the card."""
    replay = graph_of(fn, n)
    replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (n * reps)


def cold_ms(fn, iters=20):
    """One call with a cold L2: a 64 MB buffer (more than the 50 MB L2)
    is written before each call, and CUDA events bracket the call alone
    (a one-call graph replay, so the host's issue time stays out)."""
    replay = graph_of(fn, 1)
    flush = torch.empty(64 * 2 ** 20 // 4, dtype=torch.float32,
                        device="cuda")
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for i, (a, b) in enumerate(pairs):
        flush.fill_(float(i))
        a.record()
        replay()
        b.record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def bound(nbytes, flops, flops_per_s=BF16_FLOPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bf16_ulp_excess(a, b, bits=7):
    """Largest |a - b| in units of 2 ulp (of a type with ``bits``
    fraction bits: bf16 7, fp16 10) of the larger magnitude, floored at
    ULP_FLOOR; at most 1.0 passes."""
    a, b = a.float(), b.float()
    mag = torch.maximum(a.abs(), b.abs()).clamp_min(1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - bits)
    return float(((a - b).abs() / torch.clamp_min(2 * ulp, ULP_FLOOR)).max())


# --------------------------------------------------------------------- #
# Phase 3: kernels against their plain versions
# --------------------------------------------------------------------- #
def kernel_times(fn):
    """A wrapper's time three ways: CUDA events around a loop of calls
    (``kernel_ms``, the host's issue time included), graph replay
    (``device_ms``, the card's alone) and one call after a 64 MB write
    (``cold_ms``, the L2 cold, as inside a training step)."""
    return {"kernel_ms": time_ms(fn), "device_ms": device_ms(fn),
            "cold_ms": cold_ms(fn)}


def library_times(fn):
    return {"library_ms": time_ms(fn), "library_device_ms": device_ms(fn),
            "library_cold_ms": cold_ms(fn)}


def check_layer_norm(dev, gen):
    """K3f without and with the residual at a decode step's 8 rows, 32
    and the training path's 8192 (H 768, bf16): within 2 bf16 ulp of its
    plain version, ``s`` bit-equal to ``x + d``, bit-equal across two
    launches."""
    H, dt, out = 768, torch.bfloat16, []
    for rows in (8, 32, TRAIN_ROWS):
        x = torch.randn(rows, H, device=dev, generator=gen).to(dt)
        d = torch.randn(rows, H, device=dev, generator=gen).to(dt)
        sc = 1 + 0.1 * torch.randn(H, device=dev, generator=gen)
        bi = 0.1 * torch.randn(H, device=dev, generator=gen)
        y = fe.fused_layer_norm(x, sc, bi)
        s, yr = fe.fused_residual_layer_norm(x, d, sc, bi)
        y2 = fe.fused_layer_norm(x, sc, bi)
        s2, yr2 = fe.fused_residual_layer_norm(x, d, sc, bi)
        y_ref = fe.layer_norm_plain(x, None, sc, bi)[1]
        s_ref, yr_ref = fe.layer_norm_plain(x, d, sc, bi)
        torch.cuda.synchronize()
        ulps = max(bf16_ulp_excess(y, y_ref), bf16_ulp_excess(yr, yr_ref))
        assert ulps <= 1.0, f"layer_norm rows={rows}: {ulps} x 2 ulp"
        assert torch.equal(s, s_ref), "residual sum not bit-equal"
        assert torch.equal(s, x + d), "residual sum not x + d"
        assert torch.equal(y, y2) and torch.equal(s, s2) and \
            torch.equal(yr, yr2), f"layer_norm rows={rows}: not bit-equal"
        err = float(max((y.float() - y_ref.float()).abs().max(),
                        (yr.float() - yr_ref.float()).abs().max()))
        # The library call's parameters in its dtype, cast outside its
        # timing.
        sc_t, bi_t = sc.to(dt), bi.to(dt)
        for resid in (False, True):
            if resid:
                kern = lambda: fe.fused_residual_layer_norm(x, d, sc, bi)  # noqa: E731
                plain = lambda: fe.layer_norm_plain(x, d, sc, bi)  # noqa: E731
                lib = lambda: F.layer_norm(x + d, (H,), sc_t, bi_t)  # noqa: E731
            else:
                kern = lambda: fe.fused_layer_norm(x, sc, bi)  # noqa: E731
                plain = lambda: fe.layer_norm_plain(x, None, sc, bi)  # noqa: E731
                lib = lambda: F.layer_norm(x, (H,), sc_t, bi_t)  # noqa: E731
            n_io = (4 if resid else 2) * rows * H * x.element_size()
            b_ms, b_by = bound(n_io + 2 * H * 4, 8 * rows * H)
            rec = {"kernel": "layer_norm", "residual": resid,
                   "shape": [rows, H], "dtype": "bf16", **kernel_times(kern),
                   "host_ms": host_ms(kern),
                   "plain_ms": time_ms(plain), **library_times(lib),
                   "library": "x + d, F.layer_norm" if resid
                   else "F.layer_norm",
                   "bound_ms": b_ms, "bound_by": b_by,
                   "max_err": err, "max_err_in_2ulp": ulps,
                   "bit_equal_repeat": True}
            emit(rec)
            out.append(rec)
    return out


def check_bias_gelu(dev, gen):
    """K4f in the tanh form (the main path's first) and the erf form:
    within 2 bf16 ulp of its plain version and bit-equal across two
    launches."""
    Fw, dt, out = 3072, torch.bfloat16, []
    for rows in (8, 32, TRAIN_ROWS):
        y = (3 * torch.randn(rows, Fw, device=dev, generator=gen)).to(dt)
        b = torch.randn(Fw, device=dev, generator=gen)
        for exact in (False, True):
            g = fe.fused_bias_gelu(y, b, exact)
            again = fe.fused_bias_gelu(y, b, exact)
            g_ref = fe.bias_gelu_plain(y, b, exact)
            torch.cuda.synchronize()
            ulps = bf16_ulp_excess(g, g_ref)
            assert ulps <= 1.0, \
                f"bias_gelu rows={rows} exact={exact}: {ulps} x 2 ulp"
            assert torch.equal(g, again), \
                f"bias_gelu rows={rows} exact={exact}: not bit-equal"
            b_ms, b_by = bound(2 * rows * Fw * y.element_size() + Fw * 4,
                               12 * rows * Fw)
            rec = {"kernel": "bias_gelu", "exact": exact,
                   "shape": [rows, Fw], "dtype": "bf16",
                   **kernel_times(lambda: fe.fused_bias_gelu(y, b, exact)),
                   "plain_ms": time_ms(
                       lambda: fe.bias_gelu_plain(y, b, exact)),
                   "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
                   "max_err": float((g.float() - g_ref.float()).abs().max()),
                   "max_err_in_2ulp": ulps, "bit_equal_repeat": True}
            emit(rec)
            out.append(rec)
    return out


def _attn_case(dev, gen, contexts, K, nH=12, D=64, bs=16, J=64, B=512):
    """One group of len(contexts) streams; context 0 = dead stream. Row k
    of a stream attends through position ctx-1+k; blocks are distinct."""
    Q = len(contexts)
    dt = torch.bfloat16
    pk = torch.randn(1, B, nH, bs, D, device=dev, generator=gen).to(dt)
    pv = torch.randn(1, B, nH, bs, D, device=dev, generator=gen).to(dt)
    q = torch.randn(1, Q, K, nH, D, device=dev, generator=gen).to(dt)
    perm = np.random.default_rng(SEED).permutation(B).tolist()
    bt = np.full((1, Q, J), -1, np.int32)
    pos = np.zeros((1, Q, K), np.int32)
    for s, ctx in enumerate(contexts):
        if ctx <= 0:
            continue
        nblk = (ctx - 1 + K - 1) // bs + 1
        bt[0, s, :nblk] = [perm.pop() for _ in range(nblk)]
        pos[0, s] = ctx - 1 + np.arange(K)
    return (q, pk, pv, torch.from_numpy(bt).to(dev),
            torch.from_numpy(pos).to(dev), 1.0 / math.sqrt(D))


def _attn_work(q, pk, bt, pos):
    """Bytes the attend must move (q in, out written, the K and V tiles
    of every live table entry once, tables) and its operations (4*D per
    attended key per row and head: the QK^T and PV products)."""
    nH, bs, D = pk.shape[2], pk.shape[3], pk.shape[4]
    n = pa.live_block_counts(bt, pos, bs)
    live = (bt >= 0) & (torch.arange(bt.shape[-1], device=bt.device)
                        < n[..., None])
    blocks = int(torch.unique(bt[live]).numel())
    nbytes = (2 * q.numel() * q.element_size()
              + 2 * blocks * nH * bs * D * pk.element_size()
              + bt.numel() * 4 + pos.numel() * 4)
    alive = (n > 0)[..., None]
    keys = int(((pos.long() + 1) * alive).sum())
    return nbytes, 4 * D * nH * keys


def _sdpa_inputs(q, pk, pv, bt, pos):
    """Contiguous per-stream K/V gathered through the tables, and the
    boolean mask — the library call's inputs, built outside its timing."""
    G, Q, K, nH, D = q.shape
    bs, J = pk.shape[3], bt.shape[-1]
    idx = bt.long().clamp(min=0)
    kk = pk[0][idx[0]].permute(0, 2, 1, 3, 4).reshape(Q, nH, J * bs, D)
    vv = pv[0][idx[0]].permute(0, 2, 1, 3, 4).reshape(Q, nH, J * bs, D)
    col = torch.arange(J * bs, device=q.device)
    mask = (col <= pos[0].long()[..., None])[:, None]            # [Q,1,K,T]
    return q[0].permute(0, 2, 1, 3).contiguous(), kk.contiguous(), \
        vv.contiguous(), mask


def check_paged_attention(dev, gen):
    """K10 at decode, verify and chunked-prefill shapes and at the serving
    smoke's own decode step (8 slots near context 128, J = 64). Times:
    ``kernel_ms`` CUDA events around the Python loop of wrapper calls (as
    every kernel here; below the host's issue time it reads the host),
    ``device_ms`` the card's time per call (graph replay), ``cold_ms``
    one call after a 64 MB write (each layer's pool slice, 25 MB here, is
    read once per step, so warm repeats understate it); the library's
    ``device_ms`` likewise."""
    cases = {
        "decode": dict(contexts=[1024, 700, 333, 129, 64, 17, 1, 0], K=1),
        "verify": dict(contexts=[1021, 650, 300, 100, 48, 16, 5, 0], K=4),
        "prefill": dict(contexts=[993], K=32),
        "serve_decode": dict(contexts=[128, 131, 126, 140, 120, 133, 129,
                                       127], K=1),
    }
    out = []
    for name, spec in cases.items():
        q, pk, pv, bt, pos, scale = _attn_case(dev, gen, **spec)
        o = pa.paged_attention(q, pk, pv, bt, pos, scale)
        ref = pa.paged_attention_plain(q, pk, pv, bt, pos, scale)
        torch.cuda.synchronize()
        err = float((o.float() - ref.float()).abs().max())
        assert torch.isfinite(o.float()).all(), name
        ulps = bf16_ulp_excess(o, ref)
        assert ulps <= 1.0, f"paged {name}: {err} ({ulps} x 2 ulp)"
        for s, ctx in enumerate(spec["contexts"]):
            if ctx <= 0:
                assert bool((o[0, s] == 0).all()), "dead stream not zero"
        nbytes, flops = _attn_work(q, pk, bt, pos)
        b_ms, b_by = bound(nbytes, flops)
        again = pa.paged_attention(q, pk, pv, bt, pos, scale)
        torch.cuda.synchronize()
        assert torch.equal(o, again), f"paged {name}: two launches differ"
        sq, sk, sv, mask = _sdpa_inputs(q, pk, pv, bt, pos)
        kern = lambda: pa.paged_attention(q, pk, pv, bt, pos, scale)  # noqa: E731
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            sq, sk, sv, attn_mask=mask, scale=scale)
        G, Q, K = pos.shape
        rec = {"kernel": "paged_attention", "case": name,
               "shape": {"streams": len(spec["contexts"]), "K": spec["K"],
                         "heads": 12, "head_dim": 64, "block_size": 16,
                         "contexts": spec["contexts"]},
               "dtype": "bf16",
               "splits": pa.paged_splits(G * Q, 12, bt.shape[-1], K),
               "kernel_ms": time_ms(kern),
               "device_ms": device_ms(kern), "cold_ms": cold_ms(kern),
               "plain_ms": time_ms(lambda: pa.paged_attention_plain(
                   q, pk, pv, bt, pos, scale), iters=20),
               "library_ms": time_ms(lib),
               "library_device_ms": device_ms(lib),
               "library_cold_ms": cold_ms(lib),
               "library": "F.scaled_dot_product_attention (pre-gathered)",
               "bit_equal_across_launches": True,
               "bound_ms": b_ms, "bound_by": b_by,
               "bytes": nbytes, "flops": flops, "max_err": err,
               "max_err_in_2ulp": ulps}
        emit(rec)
        out.append(rec)
    return out


# --------------------------------------------------------------------- #
# Phase 4: the serving main path at gpt2-small
# --------------------------------------------------------------------- #
def check_streams(cfg, params, dev, requests, reports):
    """Every token of every serve against the plain ``gpt2_apply``,
    teacher-forced over the request's prompt and the tokens the engine
    emitted before it: the reference's largest logit less its logit of
    the engine's pick (0 where the pick is its argmax). The engines'
    logits lie within LOGIT_TOL of gpt2_apply's, so a greedy pick may
    trail the reference's argmax by at most PICK_MARGIN_TOL; more is a
    wrong token. Where a serve's stream leaves the chunked spec_k=0 one,
    the reference at the first differing position (same context on both
    sides) gives both picks' margins and its top-2 gap: a near-tie split
    by rounding, or a fault."""
    def teacher_forced(req, toks):
        seq = np.concatenate([req.prompt, toks[:-1]]).astype(np.int64)
        with torch.no_grad():
            logits = gpt2_apply(params, torch.from_numpy(seq).to(dev)[None],
                                cfg)[0, len(req.prompt) - 1:].float()
        picked = torch.tensor(toks, device=dev)
        return logits, logits.amax(-1) - logits.gather(
            1, picked[:, None])[:, 0]

    chunked = {}                               # rid -> (tokens, logits)
    for k, rep in reports.items():
        n, at_argmax, worst, diverged = 0, 0, 0.0, []
        for req, rec in zip(requests, rep["requests"]):
            assert rec["rid"] == req.rid, (k, rec["rid"], req.rid)
            toks = rec["tokens"]
            logits, margin = teacher_forced(req, toks)
            n += len(toks)
            at_argmax += int((margin == 0).sum())
            worst = max(worst, float(margin.max()))
            if k == 0:
                chunked[req.rid] = (toks, logits)
                continue
            base, base_logits = chunked[req.rid]
            j = next((i for i, (a, b) in enumerate(zip(base, toks))
                      if a != b), None)
            if j is None:
                continue
            row = base_logits[j]
            top2 = row.topk(2).values
            diverged.append({
                "rid": req.rid, "position": j,
                "picks_chunked_and_this": [base[j], toks[j]],
                "ref_margins": [float(row.max() - row[base[j]]),
                                float(row.max() - row[toks[j]])],
                "ref_top2_gap": float(top2[0] - top2[1])})
        rec = {"path": k, "tokens": n, "picks_at_ref_argmax": at_argmax,
               "max_pick_margin": worst, "tol": PICK_MARGIN_TOL}
        if k != 0:
            rec.update({"streams_equal_chunked_spec0":
                        f"{len(requests) - len(diverged)}/{len(requests)}",
                        "first_divergences": diverged})
        emit({"serve_streams_vs_gpt2_apply": rec})
        assert worst <= PICK_MARGIN_TOL, rec
        assert all(max(d["ref_margins"]) <= PICK_MARGIN_TOL
                   for d in diverged), rec


def serve_gpt2_small(dev):
    cfg = GPT2_CONFIGS["gpt2-small"]                 # bf16 compute
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = gpt2_init(cfg, gen)                     # on cuda by default
    base = {"max_slots": 8, "max_seq_len": 1024, "block_size": 16,
            "prefill_chunk": 32}
    reqs = lambda: shared_prefix_requests(  # noqa: E731
        16, prefix_len=64, tail_len=(16, 48), max_new_tokens=32,
        vocab_size=cfg.vocab_size, seed=SEED)
    # Paths: chunked prefill with spec_k 0 and 3, and whole-prompt
    # prefill (the flash forward, one admission at a time, no sharing).
    paths = {0: dict(spec_k=0), 3: dict(spec_k=3),
             "whole": dict(spec_k=0, prefill_chunk=0)}
    engines = {k: InferenceEngine(cfg, params, {"inference": dict(
        base, **inf)}) for k, inf in paths.items()}
    for eng in engines.values():                     # warm-up, not counted
        eng.serve(shared_prefix_requests(
            2, prefix_len=16, tail_len=(4, 8), max_new_tokens=4,
            vocab_size=cfg.vocab_size, seed=SEED + 1))
        eng.reset_serving_stats()
    torch.cuda.synchronize()

    # Each path is read on its own: counts zeroed just before its serve,
    # read just after it, and every kernel of the path must have launched.
    reports, counts = {}, {}
    for k, eng in engines.items():
        ops.reset_launch_counts()
        reports[k] = eng.serve(reqs())
        torch.cuda.synchronize()
        counts[k] = ops.launch_counts()
        rep = reports[k]
        assert rep["completed"] == 16 and rep["unfinished"] == 0, \
            (k, rep["completed"], rep["unfinished"])
        assert all(counts[k][name] > 0 for name in SERVE_KERNELS), \
            (k, counts[k])
        L = cfg.num_layers
        assert counts[k]["flash_attention_fwd"] == \
            (16 * L if k == "whole" else 0), (k, counts[k])
        emit({"serve": {"path": k, "spec_k": paths[k]["spec_k"],
                        "prefill_chunk": paths[k].get("prefill_chunk", 32),
                        "requests": 16,
                        "completed": rep["completed"],
                        "ttft_ms_p50": rep["ttft_ms"]["p50"],
                        "tpot_ms_p50": rep["tpot_ms"]["p50"],
                        "tokens_per_s": rep["tokens_per_s"],
                        "decode_step_ms_p50": rep["decode_step_ms"]["p50"],
                        "iterations": rep["iterations"],
                        "wall_s": rep["wall_s"],
                        "prefix_hit_rate": rep["prefix"]["hit_rate"],
                        "spec": rep.get("spec"),
                        "launches": counts[k]}})

    check_streams(cfg, engines[0]._params, dev, reqs(), reports)

    # Launches of one step of each attention mode: chunked prefill (K=32),
    # plain decode (K=1) and speculative verify (K=4). Each chunk or step
    # runs 12 layers of 2 LN + 1 GELU + 1 attend, plus ln_f. The 100-token
    # prompt comes from the stream's seed, so its first 64 tokens are the
    # served stream's shared prefix: the engine shares those 4 cached
    # blocks and prefills only the 36-token tail, in 2 chunks.
    L = cfg.num_layers
    prompt = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, 100).astype(np.int32)

    def one_step(fn):
        ops.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        return out, ops.launch_counts()

    def per_step(n, attend="paged_attention"):
        c = {name: 0 for name in ops.launch_counts()}
        c.update({"fused_layer_norm": n * (2 * L + 1),
                  "fused_bias_gelu": n * L, attend: n * L})
        return c

    ref = gpt2_apply(engines[0]._params, torch.from_numpy(prompt).long()
                     .to(dev)[None], cfg)[0, -1].float().cpu().numpy()

    def check_logits(name, logits):
        err = float(np.abs(logits - ref).max())
        argmax_equal = int(np.argmax(logits)) == int(np.argmax(ref))
        emit({f"{name}_logits_vs_gpt2_apply": {
            "max_abs_err": err, "tol": LOGIT_TOL,
            "ref_max_abs": float(np.abs(ref).max()),
            "argmax_equal": argmax_equal}})
        assert np.isfinite(logits).all() and \
            logits.shape == (cfg.vocab_size,)
        assert err <= LOGIT_TOL, (name, err)
        assert argmax_equal, (name, int(np.argmax(logits)),
                              int(np.argmax(ref)))

    steps = {}
    eng = engines["whole"]
    (_, logits), steps["prefill_whole_prompt"] = one_step(
        lambda: eng.prefill(prompt, slot=0, return_logits=True,
                            max_new_tokens=4))
    check_logits("whole_prompt_prefill", logits)
    eng.release_slot(0)
    eng = engines[0]
    (tok, logits), steps["prefill_prefix_hit"] = one_step(
        lambda: eng.prefill(prompt, slot=0, return_logits=True,
                            max_new_tokens=4))
    check_logits("prefill", logits)
    eng.activate_slot(0, len(prompt), tok)
    _, steps["decode"] = one_step(eng.decode_once)
    eng.release_slot(0)

    eng = engines[3]
    tok, _ = eng.prefill(prompt, slot=0, max_new_tokens=8)
    eng.activate_slot(0, len(prompt), tok)
    _, steps["verify_k4"] = one_step(eng.spec_decode_once)
    eng.release_slot(0)
    emit({"launches_per_step": steps})
    for name, n in (("prefill_prefix_hit", 2), ("decode", 1),
                    ("verify_k4", 1)):
        assert steps[name] == per_step(n), (name, steps[name])
    assert steps["prefill_whole_prompt"] == per_step(
        1, "flash_attention_fwd"), steps["prefill_whole_prompt"]
    return counts, reports


# --------------------------------------------------------------------- #
# Phase 3b: the training kernels at gpt2-small training shapes
# --------------------------------------------------------------------- #
# Flag sets of the fused Adam step the engine runs, with a scalar row
# [neg_lr, bc1, bc2, coeff, inv, skip]: (name, param dtype, cast dtype,
# flags, scalars).
ADAM_FLAG_SETS = (
    ("fp32_adamw_clip", torch.float32, None,
     dict(wd=0.01, coupled=False, use_inv=False, use_coeff=True, sr=False),
     [-6e-4, 0.271, 0.00299, 0.37, 1.0, 0.0]),
    ("fp32_adam_coupled_clip", torch.float32, None,
     dict(wd=0.01, coupled=True, use_inv=False, use_coeff=True, sr=False),
     [-6e-4, 0.271, 0.00299, 0.37, 1.0, 0.0]),
    ("fp16_cast_inv_scale_skip", torch.float32, torch.float16,
     dict(wd=0.01, coupled=False, use_inv=True, use_coeff=True, sr=False),
     [-6e-4, 0.1, 0.001, 0.5, 2.0 ** -16, 1.0]),
    ("bf16_cast_cache", torch.float32, torch.bfloat16,
     dict(wd=0.01, coupled=False, use_inv=False, use_coeff=True, sr=False),
     [-6e-4, 0.19, 0.001999, 0.9, 1.0, 0.0]),
    ("master_free_sr", torch.bfloat16, None,
     dict(wd=0.01, coupled=False, use_inv=False, use_coeff=True, sr=True),
     [-6e-4, 0.271, 0.00299, 0.8, 1.0, 0.0]),
)


def _native_ln_bwd_inputs(s, sc, bi):
    """The mean/rstd that ``native_layer_norm_backward`` takes, computed
    outside the library call's timing."""
    _, mean, rstd = torch.ops.aten.native_layer_norm(
        s, [s.shape[-1]], sc.to(s.dtype), bi.to(s.dtype), 1e-5)
    return mean, rstd


def check_layer_norm_backward(dev, gen):
    H, dt, out = 768, torch.bfloat16, []
    s = (2 * torch.randn(TRAIN_ROWS, H, device=dev, generator=gen)
         + 0.5).to(dt)
    dy = torch.randn(TRAIN_ROWS, H, device=dev, generator=gen).to(dt)
    gs = torch.randn(TRAIN_ROWS, H, device=dev, generator=gen).to(dt)
    sc = 1 + 0.1 * torch.randn(H, device=dev, generator=gen)
    bi = 0.1 * torch.randn(H, device=dev, generator=gen)
    mean, rstd = _native_ln_bwd_inputs(s, sc, bi)
    # The library call's parameters in its dtype, cast outside its timing.
    sc_t, bi_t = sc.to(dt), bi.to(dt)
    for resid in (False, True):
        g = gs if resid else None
        dx, dsc, dbi = fe.layer_norm_backward(s, sc, dy, g)
        again = fe.layer_norm_backward(s, sc, dy, g)
        rdx, rdsc, rdbi = fe.ln_backward_plain(s, sc, dy, g)
        torch.cuda.synchronize()
        ulps = bf16_ulp_excess(dx, rdx)
        assert ulps <= 1.0, f"layer_norm_backward: {ulps} x 2 ulp"
        rel = max(float(((a - b).abs() / b.abs().clamp_min(1.0)).max())
                  for a, b in ((dsc, rdsc), (dbi, rdbi)))
        assert rel <= 1e-4, f"layer_norm_backward dscale/dbias: {rel}"
        assert all(torch.equal(a, b) for a, b in
                   zip((dx, dsc, dbi), again)), \
            f"layer_norm_backward residual={resid}: not bit-equal"
        n_io = (4 if resid else 3) * TRAIN_ROWS * H * 2
        b_ms, b_by = bound(n_io + 3 * H * 4, 12 * TRAIN_ROWS * H)
        lib = {"library_ms": None} if resid else library_times(
            lambda: torch.ops.aten.native_layer_norm_backward(
                dy, s, [H], mean, rstd, sc_t, bi_t, [True, True, True]))
        rec = {"kernel": "layer_norm_backward", "residual": resid,
               "shape": [TRAIN_ROWS, H], "dtype": "bf16",
               **kernel_times(lambda: fe.layer_norm_backward(s, sc, dy, g)),
               "plain_ms": time_ms(
                   lambda: fe.ln_backward_plain(s, sc, dy, g), iters=20),
               **lib,
               "library": None if resid
               else "torch.ops.aten.native_layer_norm_backward",
               "bound_ms": b_ms, "bound_by": b_by,
               "max_err": float((dx.float() - rdx.float()).abs().max()),
               "max_err_in_2ulp": ulps, "dscale_dbias_max_rel": rel,
               "bit_equal_repeat": True}
        emit(rec)
        out.append(rec)
    return out


def check_bias_gelu_backward(dev, gen):
    """K4b in the tanh form (the main path's, first) and the erf form:
    dz within 2 bf16 ulp of its plain version, dbias within 1e-4
    relative, both bit-equal across two launches. The yardstick
    ``aten.gelu_backward`` computes dz alone (no dbias) from a z = y + b
    made outside its timing."""
    Fw, dt, out = 3072, torch.bfloat16, []
    y = (3 * torch.randn(TRAIN_ROWS, Fw, device=dev, generator=gen)).to(dt)
    b = torch.randn(Fw, device=dev, generator=gen)
    g = torch.randn(TRAIN_ROWS, Fw, device=dev, generator=gen).to(dt)
    z = (y.float() + b).to(dt)
    for exact in (False, True):
        dz, db = fe.bias_gelu_backward(y, b, g, exact)
        again = fe.bias_gelu_backward(y, b, g, exact)
        rdz, rdb = fe.bias_gelu_backward_plain(y, b, g, exact)
        torch.cuda.synchronize()
        ulps = bf16_ulp_excess(dz, rdz)
        assert ulps <= 1.0, f"bias_gelu_backward exact={exact}: {ulps}"
        rel = float(((db - rdb).abs() / rdb.abs().clamp_min(1.0)).max())
        assert rel <= 1e-4, f"bias_gelu_backward dbias: {rel}"
        assert torch.equal(dz, again[0]) and torch.equal(db, again[1]), \
            f"bias_gelu_backward exact={exact}: not bit-equal"
        b_ms, b_by = bound(3 * TRAIN_ROWS * Fw * 2 + 2 * Fw * 4,
                           20 * TRAIN_ROWS * Fw)
        kern = lambda: fe.bias_gelu_backward(y, b, g, exact)  # noqa: E731
        approx = "none" if exact else "tanh"
        rec = {"kernel": "bias_gelu_backward", "exact": exact,
               "shape": [TRAIN_ROWS, Fw], "dtype": "bf16",
               **kernel_times(kern), "host_ms": host_ms(kern),
               "plain_ms": time_ms(
                   lambda: fe.bias_gelu_backward_plain(y, b, g, exact),
                   iters=20),
               **library_times(lambda: torch.ops.aten.gelu_backward(
                   g, z, approximate=approx)),
               "library": f"torch.ops.aten.gelu_backward(approximate="
                          f"'{approx}') on a precomputed z: dz only, not "
                          f"dbias",
               "bound_ms": b_ms, "bound_by": b_by,
               "max_err": float((dz.float() - rdz.float()).abs().max()),
               "max_err_in_2ulp": ulps, "dbias_max_rel": rel,
               "bit_equal_repeat": True}
        emit(rec)
        out.append(rec)
    return out


def check_sqnorm(dev, gen, n):
    g = 1e-3 * torch.randn(n, device=dev, generator=gen)
    got, want = fu.sqnorm(g), fu.sqnorm_plain(g)
    torch.cuda.synchronize()
    rel = abs(float(got) - float(want)) / float(want)
    assert rel <= 1e-5, f"sqnorm: relative {rel}"
    b_ms, b_by = bound(4 * n + 4, 2 * n, FP32_FLOPS_PER_S)
    rec = {"kernel": "sqnorm", "shape": [n], "dtype": "fp32",
           "kernel_ms": time_ms(lambda: fu.sqnorm(g)),
           "plain_ms": time_ms(lambda: fu.sqnorm_plain(g), iters=20),
           "library_ms": time_ms(lambda: torch.linalg.vector_norm(g)),
           "library": "torch.linalg.vector_norm",
           "bound_ms": b_ms, "bound_by": b_by,
           "max_err": abs(float(got) - float(want)), "max_rel_err": rel}
    emit(rec)
    return [rec]


def check_fused_adam(dev, gen, n):
    """Each flag set over an n-element group: bit-equal to the plain
    version (both round op by op); timed in place."""
    out = []
    for name, p_dt, c_dt, flags, sc in ADAM_FLAG_SETS:
        g = 0.05 * torch.randn(n, device=dev, generator=gen)
        if flags["use_inv"]:
            g = g * 2.0 ** 16
        p = (0.2 * torch.randn(n, device=dev, generator=gen)).to(p_dt)
        m = 0.01 * torch.randn(n, device=dev, generator=gen)
        v = 1e-4 * torch.rand(n, device=dev, generator=gen)
        scalars = torch.tensor(sc + [0.0, 0.0], device=dev)
        seed = torch.tensor([123456789, 4096], dtype=torch.int32,
                            device=dev)
        cast = None if c_dt is None else torch.empty(n, dtype=c_dt,
                                                     device=dev)
        kw = dict(b1=0.9, b2=0.999, eps=1e-8, one_pass=True, **flags)
        ref = fu.fused_adam_plain(g, p, m, v, scalars, seed, cast_dtype=c_dt,
                                  **kw)
        p0 = p.clone()
        fu.fused_adam_apply(g, p, m, v, scalars, seed, cast_out=cast, **kw)
        torch.cuda.synchronize()
        outs = [(p, ref[0]), (m, ref[1]), (v, ref[2])] + \
            ([] if cast is None else [(cast, ref[3])])
        err = max(float((a.float() - b.float()).abs().max()) for a, b in outs)
        assert all(torch.equal(a, b) for a, b in outs), (name, err)
        if sc[5] > 0:
            assert torch.equal(p, p0), name
        del ref
        p_b = p.element_size()
        nbytes = n * (4 + p_b + 8 + p_b + 8 +
                      (0 if cast is None else cast.element_size()))
        b_ms, b_by = bound(nbytes, 20 * n, FP32_FLOPS_PER_S)
        lib = None
        if p_dt == torch.float32:
            steps = [torch.tensor(3.0, device=dev)]
            fused = torch._fused_adam_ if flags["coupled"] \
                else torch._fused_adamw_
            lib = time_ms(lambda: fused(
                [p], [g], [m], [v], [], steps, lr=6e-4, beta1=0.9,
                beta2=0.999, weight_decay=0.01, eps=1e-8, amsgrad=False,
                maximize=False))
        rec = {"kernel": "fused_adam", "flags": name, "shape": [n],
               "param_dtype": str(p_dt).replace("torch.", ""),
               "kernel_ms": time_ms(lambda: fu.fused_adam_apply(
                   g, p, m, v, scalars, seed, cast_out=cast, **kw)),
               "plain_ms": time_ms(lambda: fu.fused_adam_plain(
                   g, p, m, v, scalars, seed, cast_dtype=c_dt, **kw),
                   iters=5, warmup=2),
               "library_ms": lib,
               "library": None if lib is None else
               ("torch._fused_adam_" if flags["coupled"]
                else "torch._fused_adamw_") + " (no cast copy, no skip)",
               "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
               "max_err": err}
        emit(rec)
        out.append(rec)
        del g, p, m, v, cast
        torch.cuda.empty_cache()
    return out


def _rel_err(a, b):
    """Largest |a - b| over the largest |b|."""
    return float((a.float() - b.float()).abs().max() /
                 b.float().abs().max().clamp_min(1e-30))


def _flash_record(kernel, case, B, S, drop, got, want, again, nbytes, flops,
                  kern, plain, lib, lib_name, causal=True, cold=False,
                  device=False, **extra):
    errs = [_rel_err(a, b) for a, b in zip(got, want)]
    assert max(errs) <= FLASH_REL_TOL, (kernel, case, drop, errs)
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    assert same, (kernel, case, drop, "two launches differ")
    b_ms, b_by = bound(nbytes, flops)
    rec = {"kernel": kernel, "case": case,
           "shape": {"batch": B, "heads": 12, "seq": S, "head_dim": 64,
                     "causal": causal},
           "dtype": "bf16", "dropout": drop,
           "kernel_ms": time_ms(kern, iters=20, warmup=3),
           "plain_ms": time_ms(plain, iters=3, warmup=1),
           "library_ms": None if lib is None else time_ms(lib, iters=20,
                                                          warmup=3),
           "library": lib_name, "bound_ms": b_ms, "bound_by": b_by,
           "bytes": nbytes, "flops": flops,
           "max_err": max(float((a.float() - b.float()).abs().max())
                          for a, b in zip(got, want)),
           "max_rel_err": max(errs), "rel_tol": FLASH_REL_TOL,
           "bit_equal_across_launches": same, **extra}
    # The kernel's own time a call (graph replay; the library's backward,
    # an autograd call, is not captured) and one launch after a 64 MB
    # write, beside the warm mean.
    if device:
        rec["device_ms"] = device_ms(kern)
    if cold or device:
        rec["cold_ms"] = cold_ms(kern)
    if cold:
        rec["library_cold_ms"] = None if lib is None else cold_ms(lib)
    emit(rec)
    return rec


def check_flash(dev, gen):
    """K1, K2a, K2b and K2c against their plain versions at the shapes
    the training and whole-prompt prefill paths give them. Inputs are
    the strided split of one [B, S, 3H] projection, as the model's. The
    bound's operations are the matmul FLOPs over the (q, k) pairs the
    causal rule keeps, at the bf16 rate; its bytes read each input and
    write each output once."""
    nH, D, dt, out = 12, 64, torch.bfloat16, []
    scale = D ** -0.5
    seed = torch.tensor(FLASH_SEED, dtype=torch.int32, device=dev)
    for case, B, S, drop in FLASH_CASES:
        qkv = torch.randn(B, S, 3 * nH * D, device=dev, generator=gen).to(dt)
        q, k, v = (t.reshape(B, S, nH, D) for t in qkv.split(nH * D, -1))
        do = torch.randn(B, S, nH, D, device=dev, generator=gen).to(dt)
        BH, N = B * nH, B * nH * S * D
        pairs = BH * S * (S + 1) // 2
        # The library call's inputs, laid out and built outside its timing.
        sq, sk, sv = (t.transpose(1, 2).contiguous().requires_grad_()
                      for t in (q, k, v))
        sdo = do.transpose(1, 2).contiguous()

        def sdpa():
            return F.scaled_dot_product_attention(sq, sk, sv, is_causal=True,
                                                  dropout_p=drop)

        fwd = lambda: fa.flash_attention_fwd(q, k, v, True, scale, drop,  # noqa: E731
                                             seed)
        o, lse = fwd()
        want = fa.flash_fwd_plain(q, k, v, True, scale, drop, seed)
        again = fwd()
        torch.cuda.synchronize()
        lse_err = float((lse - want[1]).abs().max())
        assert lse_err <= FLASH_LSE_TOL, (case, drop, lse_err)
        with torch.no_grad():
            out.append(_flash_record(
                "flash_attention_fwd", case, B, S, drop, (o, lse), want,
                again, 4 * N * 2 + BH * S * 4, 4 * D * pairs, fwd,
                lambda: fa.flash_fwd_plain(q, k, v, True, scale, drop, seed),
                sdpa, "F.scaled_dot_product_attention(is_causal=True)",
                cold=case == "train", lse_max_abs_err=lse_err))
        del want, again
        if case == "prefill":
            continue
        delta = fa.flash_delta(do, o)
        args = (q, k, v, do, lse, delta, True, scale, drop, seed)
        want = fa.flash_bwd_plain(*args)
        lib_out = sdpa()
        lib_bwd = lambda: torch.autograd.grad(  # noqa: E731
            lib_out, (sq, sk, sv), sdo, retain_graph=True)
        plain = lambda: fa.flash_bwd_plain(*args)  # noqa: E731
        lse_delta = 2 * BH * S * 4
        if fa.use_fused_bwd(S, S):
            kern = lambda: fa.flash_attention_bwd_fused(*args)  # noqa: E731
            out.append(_flash_record(
                "flash_attention_bwd_fused", case, B, S, drop, kern(), want,
                kern(), 7 * N * 2 + lse_delta, 10 * D * pairs, kern, plain,
                lib_bwd, "F.scaled_dot_product_attention backward "
                "(torch.autograd.grad)", device=True))
        else:
            # No library call computes dq alone or dk/dv alone: each of the
            # pair carries the library's whole backward (dq, dk and dv) as
            # library_ms_pair, to set against the pair's summed kernel ms.
            kq = lambda: (fa.flash_attention_bwd_dq(*args),)  # noqa: E731
            kkv = lambda: fa.flash_attention_bwd_dkv(*args)  # noqa: E731
            pair = {"library_ms_pair": time_ms(lib_bwd, iters=20, warmup=3),
                    "library_pair": "F.scaled_dot_product_attention "
                    "backward (torch.autograd.grad): dq, dk and dv"}
            out.append(_flash_record(
                "flash_attention_bwd_dq", case, B, S, drop, kq(), want[:1],
                kq(), 5 * N * 2 + lse_delta, 6 * D * pairs, kq, plain, None,
                None, device=True, **pair))
            out.append(_flash_record(
                "flash_attention_bwd_dkv", case, B, S, drop, kkv(), want[1:],
                kkv(), 6 * N * 2 + lse_delta, 8 * D * pairs, kkv, plain,
                None, None, device=True, **pair))
        del want, lib_out, sq, sk, sv
        torch.cuda.empty_cache()
    return out


def sparse_layout(nH, S):
    """The ds_config section's layout, through the port's config
    normalizer and SparseSelfAttention's layout cache."""
    section = DeepSpeedConfig({"train_batch_size": 1, "sparse_attention":
                               SPARSE_SECTION}).sparse_attention
    return SparseSelfAttention.from_config(section, nH).get_layout(S)


def check_sparse(dev, gen):
    """K7, K8b, K8c and K8a against their plain versions (the flash plain
    versions over the layout's element mask): at the sparse path's shape
    (2 x 4096, the Fixed layout, causal) at tile (1, 1) with dropout 0
    and 0.1 and at the JAX-picked super-tile with dropout 0.1, and on a
    BigBird layout (bidirectional, random blocks, a layout per head) at
    2 x 2048; then the layout-gated K1, K2a, K2b (the Fixed layout as a
    CUDA tensor) at the path's shape, and the dense causal K1 at 2 x
    4096 beside them. Each launched twice and compared bit for bit. The
    bound counts the (q, k) pairs that the layout and the causal rule
    keep; the library yardstick is F.scaled_dot_product_attention with
    the boolean element mask at dropout 0, and its backward alone."""
    nH, D, dt, out = 12, 64, torch.bfloat16, []
    scale = D ** -0.5
    seed = torch.tensor(FLASH_SEED, dtype=torch.int32, device=dev)
    fixed = sparse_layout(nH, SPARSE_SEQ)
    random.seed(SEED)
    bigbird = BigBirdSparsityConfig(
        num_heads=nH, block=128, num_random_blocks=1,
        different_layout_per_head=True).make_layout(BIGBIRD_SEQ)
    pick = sf.pick_tile(fixed)
    cases = (("sparse_path", fixed, SPARSE_MICRO, SPARSE_SEQ, True, 0.0,
              (1, 1)),
             ("sparse_path", fixed, SPARSE_MICRO, SPARSE_SEQ, True, 0.1,
              (1, 1)),
             ("sparse_path_supertile", fixed, SPARSE_MICRO, SPARSE_SEQ, True,
              0.1, pick),
             ("sparse_bigbird", bigbird, BIGBIRD_B, BIGBIRD_SEQ, False, 0.1,
              (1, 1)),
             ("gated_path", fixed, SPARSE_MICRO, SPARSE_SEQ, True, 0.0, None),
             ("gated_path", fixed, SPARSE_MICRO, SPARSE_SEQ, True, 0.1, None),
             ("dense_causal_s4096", None, SPARSE_MICRO, SPARSE_SEQ, True, 0.1,
              None))
    for case, lay, B, S, causal, drop, tile in cases:
        qkv = torch.randn(B, S, 3 * nH * D, device=dev, generator=gen).to(dt)
        q, k, v = (t.reshape(B, S, nH, D) for t in qkv.split(nH * D, -1))
        do = torch.randn(B, S, nH, D, device=dev, generator=gen).to(dt)
        BH, N = B * nH, B * nH * S * D
        keep = None if lay is None else \
            fa.layout_element_mask(lay, S, causal, dev)
        pairs = B * (int(keep.sum()) if keep is not None
                     else nH * S * (S + 1) // 2)
        lse_delta = 2 * BH * S * 4
        extra = {"layout": None if lay is None else
                 ("bigbird" if lay is bigbird else "fixed"),
                 "kept_pairs": pairs, "causal": causal}
        if tile is not None:
            extra["tile_qwiden_widen"] = list(tile)
        # The library call's inputs, laid out and built outside its timing.
        sq, sk, sv = (t.transpose(1, 2).contiguous().requires_grad_()
                      for t in (q, k, v))
        sdo = do.transpose(1, 2).contiguous()
        mask = None if keep is None else keep[None]

        def sdpa():
            if mask is None:
                return F.scaled_dot_product_attention(
                    sq, sk, sv, is_causal=True, dropout_p=drop)
            return F.scaled_dot_product_attention(sq, sk, sv,
                                                  attn_mask=mask)
        lib_name = "F.scaled_dot_product_attention(is_causal=True)" \
            if mask is None else ("F.scaled_dot_product_attention(attn_mask="
                                  "layout and causal element mask), "
                                  "dropout 0")
        if case.startswith("sparse"):
            qw, w = tile
            fwd = lambda: sf.sparse_flash_fwd(q, k, v, lay, causal, scale,  # noqa: E731
                                              drop, seed, w, qw)
            plain = lambda: sf.sparse_fwd_plain(q, k, v, lay, causal,  # noqa: E731
                                                scale, drop, seed)
            name = "sparse_flash_fwd"
        else:
            glay = None if lay is None else \
                torch.from_numpy(lay).to(dev, torch.int32)
            fwd = lambda: fa.flash_attention_fwd(q, k, v, causal, scale,  # noqa: E731
                                                 drop, seed, glay)
            plain = lambda: fa.flash_fwd_plain(q, k, v, causal, scale,  # noqa: E731
                                               drop, seed, glay)
            name = "flash_attention_fwd"
        o, lse = fwd()
        want = plain()
        again = fwd()
        torch.cuda.synchronize()
        lse_err = float((lse - want[1]).abs().max())
        assert lse_err <= FLASH_LSE_TOL, (case, drop, lse_err)
        with torch.no_grad():
            out.append(_flash_record(
                name, case, B, S, drop, (o, lse), want, again,
                4 * N * 2 + BH * S * 4, 4 * D * pairs, fwd, plain, sdpa,
                lib_name, lse_max_abs_err=lse_err, **extra))
        del want, again
        if case == "dense_causal_s4096":
            continue
        delta = fa.flash_delta(do, o)
        if case.startswith("sparse"):
            args = (q, k, v, do, lse, delta, lay, causal, scale, drop, seed,
                    w, qw)
            plain_b = lambda: sf.sparse_bwd_plain(*args[:11])  # noqa: E731
            kq = lambda: (sf.sparse_flash_bwd_dq(*args),)  # noqa: E731
            kkv = lambda: sf.sparse_flash_bwd_dkv(*args)  # noqa: E731
            names = ("sparse_flash_bwd_dq", "sparse_flash_bwd_dkv")
        else:
            args = (q, k, v, do, lse, delta, causal, scale, drop, seed, glay)
            plain_b = lambda: fa.flash_bwd_plain(*args)  # noqa: E731
            kq = lambda: (fa.flash_attention_bwd_dq(*args),)  # noqa: E731
            kkv = lambda: fa.flash_attention_bwd_dkv(*args)  # noqa: E731
            names = ("flash_attention_bwd_dq", "flash_attention_bwd_dkv")
        want = plain_b()
        lib_out = sdpa()
        lib_bwd = lambda: torch.autograd.grad(  # noqa: E731
            lib_out, (sq, sk, sv), sdo, retain_graph=True)
        pair = {"library_ms_pair": time_ms(lib_bwd, iters=20, warmup=3),
                "library_pair": "the library's backward alone "
                "(torch.autograd.grad over a built graph): dq, dk and dv"}
        out.append(_flash_record(
            names[0], case, B, S, drop, kq(), want[:1], kq(),
            5 * N * 2 + lse_delta, 6 * D * pairs, kq, plain_b, None, None,
            **pair, **extra))
        out.append(_flash_record(
            names[1], case, B, S, drop, kkv(), want[1:], kkv(),
            6 * N * 2 + lse_delta, 8 * D * pairs, kkv, plain_b, None, None,
            **pair, **extra))
        if case.startswith("sparse"):
            kf = lambda: sf.sparse_flash_bwd_fused(*args)  # noqa: E731
            plan = sf.sparse_plan(lay, S, dt, causal, dev, w, qw)
            ws = BH * plan.slots_per_head * plan.tile * D * 4
            out.append(_flash_record(
                "sparse_flash_bwd_fused", case, B, S, drop, kf(), want, kf(),
                7 * N * 2 + lse_delta, 10 * D * pairs, kf, plain_b, lib_bwd,
                "the library's backward alone (torch.autograd.grad over a "
                "built graph)", dq_partials_workspace_bytes=ws, **extra))
        del want, lib_out, sq, sk, sv, keep, mask
        torch.cuda.empty_cache()
    return out


def _gg_within(a, b, dtype_name, terms):
    """Largest |a - b| in units of the tolerance (at most 1.0 passes).
    The kernel and the plain version both sum the K products in fp32, in
    other orders, so they may differ by that sum's rounding noise, which
    scales with the products' magnitudes and not with the result's:
    ``terms`` is Σ_k |a_k·b_k| per element. Allowed: fp32 1e-5 absolute
    and relative, or 2^-20 of ``terms``; bf16/fp16 2 ulp of the larger
    magnitude, floored at ULP_FLOOR, or 2^-16 of ``terms`` (a bf16 ulp
    of the sum's own scale is 2^-8 of it)."""
    a, b, terms = a.float(), b.float(), terms.float()
    if dtype_name == "fp32":
        tol = torch.maximum(1e-5 + 1e-5 * b.abs(), terms * 2.0 ** -20)
    else:
        mag = torch.maximum(a.abs(), b.abs()).clamp_min(1e-30)
        ulp = torch.exp2(torch.floor(torch.log2(mag)) -
                         FRACTION_BITS[dtype_name])
        tol = torch.maximum(torch.clamp_min(2 * ulp, ULP_FLOOR),
                            terms * 2.0 ** -16)
    return float(((a - b).abs() / tol).max())


def _gg_cases(dev, gen):
    """K9's seven launches in one MoE layer and micro-batch at the path's
    shapes (8 experts, capacity 2560, hidden 768, FFN 3072), as (case, a,
    b, bias, act): the forward's two, then the backward's recompute of
    the pre-activation and its four products on swapped operands (views,
    no copies). bf16, and the up-projection also in fp32 and fp16."""
    small = GPT2_CONFIGS["gpt2-small"]
    E, C, H, Fw = MOE_EXPERTS, MOE_CAPACITY, small.hidden_size, \
        small.ffn_size
    cases = []
    for dt in (torch.bfloat16, torch.float32, torch.float16):
        def r(*shape, scale=1.0):
            return (scale * torch.randn(*shape, device=dev,
                                        generator=gen)).to(dt)
        x = r(E, C, H)
        w1 = r(E, H, Fw, scale=H ** -0.5)
        # the biases as the path hands them over: cast to the compute
        # dtype, read as fp32
        b1 = r(E, Fw, scale=0.1).float()
        if dt != torch.bfloat16:
            cases.append(("fwd_up", x, w1, b1, "gelu_tanh"))
            continue
        h, dy, dz = r(E, C, Fw), r(E, C, H), r(E, C, Fw, scale=0.1)
        w2 = r(E, Fw, H, scale=Fw ** -0.5)
        b2 = r(E, H, scale=0.1).float()
        sw = lambda t: t.transpose(1, 2)  # noqa: E731
        cases += [("fwd_up", x, w1, b1, "gelu_tanh"),
                  ("fwd_down", h, w2, b2, None),
                  ("bwd_z1", x, w1, b1, None),
                  ("bwd_dh", dy, sw(w2), None, None),
                  ("bwd_dw2", sw(h), dy, None, None),
                  ("bwd_dw1", sw(x), dz, None, None),
                  ("bwd_dx", dz, sw(w1), None, None)]
    return cases


def host_ms(fn, iters=50):
    """The host's time to issue one call: a loop of ``iters`` calls on
    the host clock, read before the card is waited for (the launch queue
    holds them all)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    return ms


def check_grouped_gemm(dev, gen):
    """K9 against its plain version at the MoE path's shapes: the
    pre-activation z = round(a @ b + bias) within the tolerance
    (``_gg_within``: 2 ulp, or the fp32 sums' order noise), and with an
    activation the output within 2 ulp of the plain epilogue of the
    kernel's own z (a z one rounding step apart moves a GELU output by
    the curve's slope, many ulp of a small output; the direct error is
    recorded too); two launches bit-equal; no operand staged.
    Each record carries the route (``gg._gg_plan``: majors, tile), the
    event-timed mean of warm calls (``kernel_ms``, which includes the
    wrapper's Python where that is the longer), the card's own time a
    call (``device_ms``, graph replay), one call with a cold L2
    (``cold_ms``) and the wrapper's host time a call (``host_ms``: the
    plan and the tensor maps' encoding included).
    The library yardstick is ``torch.bmm``, ``torch.baddbmm`` with the
    bias, and for the up-projection ``torch.baddbmm`` then ``F.gelu``
    (two calls)."""
    out = []
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for case, a, b, bias, act in _gg_cases(dev, gen):
        dt = a.dtype
        name = {torch.bfloat16: "bf16", torch.float16: "fp16",
                torch.float32: "fp32"}[dt]
        E, M, K = a.shape
        N = b.shape[2]
        plan = gg._gg_plan(a, b, act, sms)
        ops.reset_launch_counts()
        got = gg.grouped_matmul(a, b, bias, act)
        again = gg.grouped_matmul(a, b, bias, act)
        z = gg.grouped_matmul(a, b, bias) if act else got
        z_ref = gg.grouped_matmul_plain(a, b, bias)
        want = gg.grouped_matmul_plain(a, b, bias, act) if act else z_ref
        terms = torch.matmul(a.float().abs(), b.float().abs())
        torch.cuda.synchronize()
        staged = gg.grouped_matmul.staged
        assert torch.equal(got, again), (case, name, "two launches differ")
        assert staged == 0 and not plan.staged, (case, name, plan)
        within = _gg_within(z, z_ref, name, terms)
        if act:
            epi = fe.gelu_f32(z.float(), act == "gelu_exact").to(dt)
            within = max(within, _gg_within(got, epi, name,
                                            torch.zeros_like(terms)))
        assert within <= 1.0, (case, name, within)
        isz = a.element_size()
        nbytes = (E * M * K + E * K * N + E * M * N) * isz + \
            (0 if bias is None else E * N * 4)
        flops = 2.0 * E * M * K * N
        b_ms, b_by = bound(nbytes, flops, FP32_FLOPS_PER_S
                           if dt == torch.float32 else BF16_FLOPS_PER_S)
        bias_dt = None if bias is None else bias.to(dt)[:, None, :]
        if act:
            lib = lambda: F.gelu(torch.baddbmm(bias_dt, a, b),  # noqa: E731
                                 approximate="tanh")
            lib_name = "torch.baddbmm + F.gelu(approximate='tanh') " \
                "(two calls)"
        elif bias is not None:
            lib = lambda: torch.baddbmm(bias_dt, a, b)  # noqa: E731
            lib_name = "torch.baddbmm"
        else:
            lib = lambda: torch.bmm(a, b)  # noqa: E731
            lib_name = "torch.bmm"
        kern = lambda: gg.grouped_matmul(a, b, bias, act)  # noqa: E731
        rec = {"kernel": "grouped_gemm", "case": case, "dtype": name,
               "shape": [E, M, K, N], "act": act, "bias": bias is not None,
               "strides": {"a": list(a.stride()), "b": list(b.stride())},
               "route": plan.route, "majors": [plan.a_major, plan.b_major],
               "tile": list(plan.tile), "staged": staged,
               "kernel_ms": time_ms(kern, iters=20, warmup=3),
               "device_ms": device_ms(kern), "cold_ms": cold_ms(kern),
               "host_ms": host_ms(kern),
               "plain_ms": time_ms(
                   lambda: gg.grouped_matmul_plain(a, b, bias, act), iters=5,
                   warmup=1),
               "library_ms": time_ms(lib, iters=20, warmup=3),
               "library_device_ms": device_ms(lib),
               "library": lib_name, "bound_ms": b_ms, "bound_by": b_by,
               "flops": flops, "bytes": nbytes,
               "max_err": float((got.float() - want.float()).abs().max()),
               "max_err_z": float((z.float() - z_ref.float()).abs().max()),
               "max_err_in_tol": within, "bit_equal_relaunch": True}
        emit(rec)
        out.append(rec)
        del got, again, z, z_ref, want, terms
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------- #
# Phase 5: the training main path at gpt2-small
# --------------------------------------------------------------------- #
def token_stream(cfg, steps, seed=SEED, seq=TRAIN_SEQ, micro=TRAIN_MICRO):
    """Seeded learnable batches [gas*micro, S+1]: a Markov chain over a
    1024-token subset of the vocab that follows a fixed successor map
    with probability 0.9."""
    rng = np.random.default_rng(seed)
    n = min(1024, cfg.vocab_size // 2)
    vocab = rng.choice(cfg.vocab_size, n, replace=False)
    succ = rng.permutation(n)
    B = TRAIN_GAS * micro
    out = []
    for _ in range(steps):
        toks = np.empty((B, seq + 1), np.int64)
        cur = rng.integers(0, n, B)
        for t in range(seq + 1):
            toks[:, t] = cur
            jump = rng.random(B) < 0.1
            cur = np.where(jump, rng.integers(0, n, B), succ[cur])
        out.append(torch.from_numpy(vocab[toks]))
    return out


def train_config(precision, steps, micro=TRAIN_MICRO):
    ds = {"train_batch_size": TRAIN_GAS * micro,
          "train_micro_batch_size_per_gpu": micro,
          "gradient_clipping": 1.0, "steps_per_print": 10 ** 9,
          "optimizer": {"type": "AdamW", "params": {
              "lr": 6e-4, "betas": [0.9, 0.95], "weight_decay": 0.01}},
          "scheduler": {"type": "WarmupLR", "params": {
              "warmup_num_steps": 10, "warmup_max_lr": 6e-4,
              "warmup_type": "linear"}}}
    if precision == "fp16":
        ds["fp16"] = {"enabled": True, "initial_scale_power": 32}
    else:
        ds["bf16"] = {"enabled": True,
                      "stochastic_rounding": precision == "master_free"}
    return ds


def per_train_step(cfg, seq=TRAIN_SEQ):
    """Launches of one train step: per micro-batch and layer one flash
    forward and, by the JAX rule, the fused backward (S = 1024) or the
    dq + dk/dv pair (S = 768)."""
    L = cfg.num_layers
    c = {name: 0 for name in ops.launch_counts()}
    c.update({"fused_layer_norm": TRAIN_GAS * (L + 1),
              "fused_residual_layer_norm": TRAIN_GAS * L,
              "fused_bias_gelu": TRAIN_GAS * L,
              "layer_norm_backward": TRAIN_GAS * (2 * L + 1),
              "bias_gelu_backward": TRAIN_GAS * L,
              "sqnorm": 1, "fused_adam_apply": 1,
              "flash_attention_fwd": TRAIN_GAS * L})
    bwd = ("flash_attention_bwd_fused",) if fa.use_fused_bwd(seq, seq) \
        else ("flash_attention_bwd_dq", "flash_attention_bwd_dkv")
    c.update({name: TRAIN_GAS * L for name in bwd})
    return c


def make_engine(cfg, precision, seed=SEED, attention_fn=None,
                micro=TRAIN_MICRO, extra=None):
    dev = torch.device("cuda")
    params = gpt2_init(cfg, torch.Generator(device=dev).manual_seed(seed))
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=gpt2_loss_fn(cfg, attention_fn=attention_fn),
        model_params=params,
        config=dict(train_config(precision, TRAIN_STEPS, micro),
                    **(extra or {})), rng=seed)
    return eng


def plain_reference_step(eng, cfg, batch,
                         attention_fn=fa.flash_attention_plain):
    """One step's mean loss and global grad norm by plain autograd
    (plain LayerNorm/GELU, and the attention's plain version, which
    draws the same attention seeds) on the engine's bf16 params, its
    batch split and a copy of its generator (the same dropout masks)."""
    gen = torch.Generator(device=eng.device)
    gen.set_state(eng.generator.get_state())
    cast, spec = tree_flatten(eng.state.cast_params)
    leaves = [t.detach().clone().requires_grad_() for t in cast]
    tree = tree_unflatten(spec, leaves)
    loss_fn = gpt2_loss_fn(cfg, attention_fn=attention_fn, ops=PLAIN_OPS)
    acc = [torch.zeros(t.shape, dtype=torch.float32, device=t.device)
           for t in leaves]
    mean = 0.0
    for mb in batch.to(eng.device).chunk(TRAIN_GAS):
        loss = loss_fn(tree, mb, gen)
        if isinstance(loss, tuple):            # (loss, {"moe": stats})
            loss = loss[0]
        grads = torch.autograd.grad(loss.float() / TRAIN_GAS, leaves)
        for a, g in zip(acc, grads):
            a.add_(g)
        mean += float(loss.detach()) / TRAIN_GAS
    norm = float(torch.sqrt(sum(torch.sum(a * a) for a in acc)))
    return mean, norm


def profile_train_steps(eng, batches):
    """Device time by kernel group over a few train steps
    (torch.profiler), with the window's wall (ended by a sync)."""
    groups = (("sparse", ("sparse_",)),
              ("flash", ("flash_",)),
              ("grouped_gemm", ("grouped_gemm",)),
              ("gemm", ("gemm", "cutlass", "nvjet", "sm90_", "cublas")),
              ("port_kernels", ("ln_fwd_kernel", "ln_bwd_",
                                "bias_gelu", "sqnorm_kernel",
                                "fused_adam_kernel")),
              ("softmax", ("softmax",)),
              ("dropout_rand", ("philox", "uniform", "random")),
              ("index_and_copy", ("index", "copy", "gather", "scatter",
                                  "cat", "embedding")),
              ("reduce", ("reduce",)))

    def group(name):
        low = name.lower()
        for g, keys in groups:
            if any(k in low for k in keys):
                return g
        return "other_elementwise"

    def device_us(evt):
        for attr in ("self_device_time_total", "self_cuda_time_total"):
            v = getattr(evt, attr, None)
            if v is not None:
                return float(v)
        return 0.0

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for b in batches:
            eng.train_batch(b)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / len(batches)
    per, top, port = {}, {}, {}
    launches = 0
    for evt in prof.key_averages():
        us = device_us(evt)
        if us > 0 and "cuda" in str(getattr(evt, "device_type", "")).lower():
            ms = us / 1e3 / len(batches)
            g = group(evt.key)
            per[g] = per.get(g, 0.0) + ms
            top[evt.key[:80]] = (ms, evt.count / len(batches))
            launches += evt.count
            if g in ("port_kernels", "flash", "sparse", "grouped_gemm"):
                # e.g. "ln_fwd_kernel<__nv_bfloat16, true>": the device
                # time of one launch, free of the host's enqueue cost
                # that CUDA events around a launch loop include.
                m = re.search(r"(ln_fwd|ln_bwd_colsum|ln_bwd|bias_gelu|"
                              r"bias_gelu_bwd|bias_gelu_bwd_colsum|"
                              r"sqnorm|fused_adam|flash_fwd|flash_bwd_dq|"
                              r"flash_bwd_dkv|flash_bwd_fused|sparse_fwd|"
                              r"sparse_dq|sparse_dkv|sparse_fused_bwd|"
                              r"sparse_dq_reduce|grouped_gemm_wgmma|"
                              r"grouped_gemm_f32)"
                              r"_kernel(<[^()]*>)?",
                              evt.key)
                port[m.group(0) if m else evt.key[:80]] = \
                    us / evt.count / 1e3
    busy = sum(per.values())
    return {"steps": len(batches), "wall_ms_per_step_profiled": wall,
            "device_busy_ms_per_step": busy,
            "device_ms_per_step_by_group": dict(sorted(
                per.items(), key=lambda kv: -kv[1])),
            "top_kernels_ms_and_launches_per_step": sorted(
                ([k, v[0], v[1]] for k, v in top.items()),
                key=lambda r: -r[1])[:15],
            "port_kernel_device_ms_per_launch": port,
            "kernel_launches_per_step": launches / len(batches),
            "device_idle_share": (1 - busy / wall) if busy > 0 else None}


def count_host_syncs(eng, batches):
    """Train steps under ``torch.cuda.set_sync_debug_mode("warn")``: the
    operations that made the host wait for the card, which the engine's
    step is written to have none of."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for b in batches:
                eng.train_batch(b)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    syncs = [str(w.message).splitlines()[0][:200] for w in caught
             if "called a synchronizing" in str(w.message)]
    return {"steps": len(batches), "host_syncs": len(syncs),
            "first": syncs[:3]}


def run_path(eng, batches):
    """Drive ``train_batch`` over ``batches`` as one path: counts zeroed
    just before, read just after. Returns (losses, metrics per step,
    step ms by CUDA events, counts)."""
    starts = [torch.cuda.Event(enable_timing=True) for _ in batches]
    ends = [torch.cuda.Event(enable_timing=True) for _ in batches]
    losses, metrics = [], []
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    for b, st, en in zip(batches, starts, ends):
        st.record()
        losses.append(eng.train_batch(b))
        en.record()
        metrics.append(eng.last_metrics)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    ms = [s.elapsed_time(e) for s, e in zip(starts, ends)]
    return [float(l) for l in losses], metrics, ms, counts


def train_gpt2_small(dev, smi):
    cfg = GPT2_CONFIGS["gpt2-small"]          # dropout 0.1, bf16 compute
    batches = token_stream(cfg, TRAIN_STEPS + 4)
    tokens_per_step = TRAIN_GAS * TRAIN_MICRO * TRAIN_SEQ
    flops_per_token = gpt2_flops_per_token(cfg, TRAIN_SEQ)
    expect = per_train_step(cfg)
    counts, out = {}, {}

    # bf16 with fp32 masters: yardstick step, then the main path.
    eng = make_engine(cfg, "bf16")
    ref_loss, ref_norm = plain_reference_step(eng, cfg, batches[0])
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    losses, metrics, ms, counts["train"] = run_path(
        eng, batches[:TRAIN_STEPS])
    k_norm = float(metrics[0]["grad_norm"])
    check = {"loss_kernel": losses[0], "loss_plain": ref_loss,
             "loss_rel": abs(losses[0] - ref_loss) / abs(ref_loss),
             "loss_rtol": TRAIN_LOSS_RTOL,
             "grad_norm_kernel": k_norm, "grad_norm_plain": ref_norm,
             "grad_norm_rel": abs(k_norm - ref_norm) / ref_norm,
             "grad_norm_rtol": TRAIN_GRAD_NORM_RTOL}
    emit({"train_step_vs_plain_autograd": check})
    assert check["loss_rel"] <= TRAIN_LOSS_RTOL, check
    assert check["grad_norm_rel"] <= TRAIN_GRAD_NORM_RTOL, check
    assert all(math.isfinite(l) for l in losses), losses
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    assert last < first, (first, last)
    want = {k: TRAIN_STEPS * v for k, v in expect.items()}
    assert counts["train"] == want, (counts["train"], want)
    step_ms = float(np.median(ms[3:]))
    tok_s = tokens_per_step / (step_ms / 1e3)
    out["train"] = {
        "model": "gpt2-small", "precision": "bf16, fp32 masters",
        "batch": [TRAIN_GAS, TRAIN_MICRO, TRAIN_SEQ], "steps": TRAIN_STEPS,
        "dropout": cfg.hidden_dropout, "losses": losses,
        "loss_first5_mean": first, "loss_last5_mean": last,
        "grad_norm_last": float(metrics[-1]["grad_norm"]),
        "launches_per_step": expect,
        "step_ms_p50": step_ms, "step_ms_all": ms, "tokens_per_s": tok_s,
        "model_tflops_per_s": flops_per_token * tok_s / 1e12,
        "flops_per_token": flops_per_token,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "peak_memory_of": "the 30 steps (reset after the yardstick)",
        "card": smi}
    emit({"train_path": out["train"]})
    prof = profile_train_steps(eng, batches[TRAIN_STEPS:TRAIN_STEPS + 3])
    prof["card"] = smi
    emit({"train_profile": prof})
    syncs = count_host_syncs(eng, batches[TRAIN_STEPS + 3:TRAIN_STEPS + 4])
    emit({"train_host_syncs": syncs})
    assert syncs["host_syncs"] == 0, syncs
    del eng
    torch.cuda.empty_cache()

    # fp16, dynamic loss scale from 2^32: skipped steps, then taken ones.
    eng = make_engine(cfg, "fp16")
    fp16_batches = batches[:TRAIN_STEPS + 4]
    losses, metrics, ms, counts["train_fp16"] = run_path(eng, fp16_batches)
    skipped = int(eng.state.skipped_steps)
    taken = int(eng.state.step)
    scales = [float(m["loss_scale"]) for m in metrics]
    emit({"train_fp16_path": {"steps": len(fp16_batches),
                              "skipped": skipped, "taken": taken,
                              "loss_scales": scales, "losses": losses,
                              "step_ms_p50": float(np.median(ms)),
                              "card": smi}})
    assert skipped > 0 and taken > 0, (skipped, taken)
    assert all(math.isfinite(l) for l in losses), losses
    assert counts["train_fp16"] == {k: len(fp16_batches) * v
                                    for k, v in expect.items()}
    del eng
    torch.cuda.empty_cache()

    # master-free bf16: bf16 params, stochastic rounding in the kernel.
    eng = make_engine(cfg, "master_free")
    assert all(t.dtype == torch.bfloat16
               for t in tree_flatten(eng.state.params)[0])
    mf_batches = batches[:5]
    losses, metrics, ms, counts["train_master_free"] = run_path(
        eng, mf_batches)
    emit({"train_master_free_path": {"steps": len(mf_batches),
                                     "losses": losses,
                                     "step_ms_p50": float(np.median(ms)),
                                     "card": smi}})
    assert all(math.isfinite(l) for l in losses), losses
    assert counts["train_master_free"] == {k: len(mf_batches) * v
                                           for k, v in expect.items()}
    del eng
    torch.cuda.empty_cache()

    # bf16 at sequence 768: the split flash backward (dq + dk/dv).
    eng = make_engine(cfg, "bf16")
    split_batches = token_stream(cfg, SPLIT_STEPS, seq=SPLIT_SEQ)
    losses, metrics, ms, counts["train_s768"] = run_path(eng, split_batches)
    expect_split = per_train_step(cfg, SPLIT_SEQ)
    step_ms = float(np.median(ms[1:]))
    emit({"train_s768_path": {
        "batch": [TRAIN_GAS, TRAIN_MICRO, SPLIT_SEQ], "steps": SPLIT_STEPS,
        "losses": losses, "launches_per_step": expect_split,
        "step_ms_p50": step_ms, "step_ms_all": ms,
        "tokens_per_s": TRAIN_GAS * TRAIN_MICRO * SPLIT_SEQ / (step_ms / 1e3),
        "card": smi}})
    assert all(math.isfinite(l) for l in losses), losses
    assert counts["train_s768"] == {k: SPLIT_STEPS * v
                                    for k, v in expect_split.items()}, \
        counts["train_s768"]
    del eng
    torch.cuda.empty_cache()

    # gelu_exact: the main path's recipe with the erf form of GELU in
    # K4f/K4b; a yardstick step against plain autograd first.
    cfg_x = dataclasses.replace(cfg, gelu_exact=True)
    eng = make_engine(cfg_x, "bf16")
    ref_loss, _ = plain_reference_step(eng, cfg_x, batches[0])
    losses, metrics, ms, counts["train_gelu_exact"] = run_path(
        eng, batches[:GELU_EXACT_STEPS])
    check = {"loss_kernel": losses[0], "loss_plain": ref_loss,
             "loss_rel": abs(losses[0] - ref_loss) / abs(ref_loss),
             "loss_rtol": TRAIN_LOSS_RTOL}
    emit({"train_gelu_exact_path": {
        "steps": GELU_EXACT_STEPS, "losses": losses,
        "step_vs_plain_autograd": check,
        "step_ms_p50": float(np.median(ms[1:])), "card": smi}})
    assert check["loss_rel"] <= TRAIN_LOSS_RTOL, check
    assert all(math.isfinite(l) for l in losses), losses
    assert counts["train_gelu_exact"] == {
        k: GELU_EXACT_STEPS * v for k, v in expect.items()}, \
        counts["train_gelu_exact"]
    del eng
    torch.cuda.empty_cache()
    return counts



# --------------------------------------------------------------------- #
# Phase 5b: the block-sparse paths at gpt2-small, sequence 4096
# --------------------------------------------------------------------- #
def sparse_attention_fn(layout):
    """The ``attention_fn`` closure the JAX package builds from a
    SparsityConfig (``sparse_attention_utils``): ``sparse_attention``
    over ``layout`` — a host array takes the LUT kernels, a CUDA tensor
    the layout-gated ones."""
    def fn(q, k, v, mask=None, causal=False, attn_dropout=0.0, rng=None,
           deterministic=True):
        return sparse_attention(q, k, v, layout, causal=causal, mask=mask,
                                attn_dropout=attn_dropout, rng=rng,
                                deterministic=deterministic)
    return fn


def sparse_plain_fn(layout):
    """The yardstick's sparse attention: the kernel path's seed draw,
    then the flash forward's plain version over the layout's element
    mask, recomputed in the backward (``torch.utils.checkpoint``; the
    seed is drawn outside it, so the recompute sees the same masks) so
    that no ``[B*nH, S, S]`` tensor outlives its layer: 12 layers of
    them at 2 x 4096 would not fit the card."""
    def fn(q, k, v, mask=None, causal=False, attn_dropout=0.0, rng=None,
           deterministic=True):
        drop = fa._dropout_rate(attn_dropout, rng, deterministic)
        seed = fa.draw_seed(rng, q.device) if drop > 0.0 else None
        scale = 1.0 / math.sqrt(q.shape[-1])
        return torch.utils.checkpoint.checkpoint(
            lambda a, b, c: fa.flash_fwd_plain(a, b, c, causal, scale, drop,
                                               seed, layout)[0],
            q, k, v, use_reentrant=False)
    return fn


def per_sparse_step(cfg, route):
    """Launches of one train step at sequence 4096: per micro-batch and
    layer one attention forward and its backward — K7 + K8b/K8c (the
    LUT route), K7 + K8a (DS_SPARSE_FUSED_BWD=1), the gated K1 + K2a/K2b,
    or dense causal flash (K1 + K2a/K2b: one 1024-block does not cover
    4096, so the JAX rule takes the split backward)."""
    c = per_train_step(cfg, SPARSE_SEQ)
    if route == "flash":
        return c
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv", "flash_attention_bwd_fused"):
        c[name] = 0
    n = TRAIN_GAS * cfg.num_layers
    names = {"lut": ("sparse_flash_fwd", "sparse_flash_bwd_dq",
                     "sparse_flash_bwd_dkv"),
             "fused": ("sparse_flash_fwd", "sparse_flash_bwd_fused"),
             "gated": ("flash_attention_fwd", "flash_attention_bwd_dq",
                       "flash_attention_bwd_dkv")}[route]
    c.update({name: n for name in names})
    return c


def train_sparse(dev, smi):
    """gpt2-small at sequence 4096 through ``initialize`` → ``train_batch``
    with the ds_config's sparse attention: a yardstick step against plain
    autograd, then the paths, each read on its own — train_sparse (LUT
    kernels, 12 steps), train_sparse_fused (DS_SPARSE_FUSED_BWD=1, 3
    steps), train_sparse_gated (the layout as a CUDA tensor, 3 steps) —
    and train_flash_s4096 (dense causal flash, 5 steps) beside them."""
    cfg = dataclasses.replace(GPT2_CONFIGS["gpt2-small"],
                              max_seq_length=SPARSE_SEQ)
    layout = sparse_layout(cfg.num_heads, SPARSE_SEQ)
    extra = {"sparse_attention": SPARSE_SECTION}
    batches = token_stream(cfg, SPARSE_STEPS, seq=SPARSE_SEQ,
                           micro=SPARSE_MICRO)
    tokens_per_step = TRAIN_GAS * SPARSE_MICRO * SPARSE_SEQ
    L, H, S = cfg.num_layers, cfg.hidden_size, SPARSE_SEQ
    keys_per_query = float(fa.layout_element_mask(layout, S, True, dev)
                           .sum()) / (cfg.num_heads * S)
    flops_dense = gpt2_flops_per_token(cfg, S)
    flops_sparse = flops_dense - 12.0 * L * H * (S - keys_per_query)
    counts, out = {}, {}

    def engine(attention_fn, with_section=True):
        return make_engine(cfg, "bf16", attention_fn=attention_fn,
                           micro=SPARSE_MICRO,
                           extra=extra if with_section else None)

    def finish(eng):
        del eng
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    # LUT route: yardstick step, then the main sparse path.
    eng = engine(sparse_attention_fn(layout))
    assert eng.config.sparse_attention["block"] == 128, \
        eng.config.sparse_attention
    ref_loss, ref_norm = plain_reference_step(eng, cfg, batches[0],
                                              sparse_plain_fn(layout))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    losses, metrics, ms, counts["train_sparse"] = run_path(eng, batches)
    k_norm = float(metrics[0]["grad_norm"])
    check = {"loss_kernel": losses[0], "loss_plain": ref_loss,
             "loss_rel": abs(losses[0] - ref_loss) / abs(ref_loss),
             "loss_rtol": TRAIN_LOSS_RTOL,
             "grad_norm_kernel": k_norm, "grad_norm_plain": ref_norm,
             "grad_norm_rel": abs(k_norm - ref_norm) / ref_norm,
             "grad_norm_rtol": TRAIN_GRAD_NORM_RTOL}
    emit({"train_sparse_step_vs_plain_autograd": check})
    assert check["loss_rel"] <= TRAIN_LOSS_RTOL, check
    assert check["grad_norm_rel"] <= TRAIN_GRAD_NORM_RTOL, check
    assert all(math.isfinite(l) for l in losses), losses
    first, last = float(np.mean(losses[:4])), float(np.mean(losses[-4:]))
    assert last < first, (first, last)
    expect = per_sparse_step(cfg, "lut")
    assert counts["train_sparse"] == {k: SPARSE_STEPS * v
                                      for k, v in expect.items()}, \
        counts["train_sparse"]
    step_ms = float(np.median(ms[3:]))
    tok_s = tokens_per_step / (step_ms / 1e3)
    out["sparse"] = {
        "model": "gpt2-small, max_seq_length 4096",
        "sparse_attention": eng.config.sparse_attention,
        "layout_live_blocks_per_head": int((layout[0] != 0).sum()),
        "tile_qwiden_widen": list(sf.pick_tile(layout)),
        "precision": "bf16, fp32 masters",
        "batch": [TRAIN_GAS, SPARSE_MICRO, SPARSE_SEQ],
        "steps": SPARSE_STEPS, "dropout": cfg.hidden_dropout,
        "losses": losses, "loss_first4_mean": first,
        "loss_last4_mean": last, "launches_per_step": expect,
        "step_ms_p50": step_ms, "step_ms_all": ms, "tokens_per_s": tok_s,
        "model_tflops_per_s": flops_dense * tok_s / 1e12,
        "flops_per_token": flops_dense,
        "model_tflops_per_s_kept_pairs": flops_sparse * tok_s / 1e12,
        "flops_per_token_kept_pairs": flops_sparse,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "peak_memory_of": "the 12 steps (reset after the yardstick)",
        "card": smi}
    emit({"train_sparse_path": out["sparse"]})
    prof = profile_train_steps(eng, batches[:2])
    prof["card"] = smi
    emit({"train_sparse_profile": prof})
    finish(eng)

    # The fused backward (K8a), from the same state and batches.
    os.environ["DS_SPARSE_FUSED_BWD"] = "1"
    try:
        eng = engine(sparse_attention_fn(layout))
        f_losses, _, f_ms, counts["train_sparse_fused"] = run_path(
            eng, batches[:SPARSE_SIDE_STEPS])
    finally:
        del os.environ["DS_SPARSE_FUSED_BWD"]
    finish(eng)

    # The layout as a CUDA tensor: the gated K1/K2a/K2b.
    eng = engine(sparse_attention_fn(torch.from_numpy(layout).to(
        dev, torch.int32)))
    g_losses, _, g_ms, counts["train_sparse_gated"] = run_path(
        eng, batches[:SPARSE_SIDE_STEPS])
    finish(eng)

    # Dense causal flash at the same shape, beside them.
    eng = engine(None, with_section=False)
    d_losses, _, d_ms, counts["train_flash_s4096"] = run_path(
        eng, batches[:FLASH_S4096_STEPS])
    d_prof = profile_train_steps(eng, batches[:2])
    d_prof["card"] = smi
    finish(eng)

    side = {}
    for path, ls, t, route in (("train_sparse_fused", f_losses, f_ms, "fused"),
                               ("train_sparse_gated", g_losses, g_ms,
                                "gated"),
                               ("train_flash_s4096", d_losses, d_ms, "flash")):
        want = per_sparse_step(cfg, route)
        side[path] = {"steps": len(ls), "losses": ls,
                      "first_loss_rel_to_train_sparse":
                      abs(ls[0] - losses[0]) / abs(losses[0]),
                      "step_ms_p50": float(np.median(t[1:])),
                      "step_ms_all": t, "launches_per_step": want,
                      "card": smi}
        assert all(math.isfinite(l) for l in ls), (path, ls)
        assert counts[path] == {k: len(ls) * v for k, v in want.items()}, \
            (path, counts[path])
    side["train_flash_s4096"]["profile"] = d_prof
    emit({"train_sparse_side_paths": side,
          "step_ms_p50_sparse_vs_flash": [
              step_ms, side["train_flash_s4096"]["step_ms_p50"]]})
    # The same function from the same state, batch and masks: the gated
    # and the fused paths' first losses against the LUT path's.
    for path in ("train_sparse_fused", "train_sparse_gated"):
        rel = side[path]["first_loss_rel_to_train_sparse"]
        assert rel <= GATED_LOSS_TOL, (path, rel)
    return counts


# --------------------------------------------------------------------- #
# Phase 5c: MoE at expert-parallel size 1, gpt2-small 8 experts top-2
# --------------------------------------------------------------------- #
def moe_block():
    return {"num_experts": MOE_EXPERTS, "top_k": MOE_TOP_K,
            "capacity_factor": MOE_CF}


def per_moe_step(cfg):
    """Launches of one MoE train step: the dense step's, with every FFN
    an expert FFN — seven K9 per layer and micro-batch (two forward, the
    backward's recompute and four products) and no bias+GELU kernel."""
    c = per_train_step(cfg)
    c.update({"fused_bias_gelu": 0, "bias_gelu_backward": 0,
              "grouped_matmul": 7 * TRAIN_GAS * cfg.num_layers})
    return c


def moe_flops_per_token(cfg, seq=TRAIN_SEQ):
    """The routed count: ``gpt2_flops_per_token`` (one dense FFN a
    token) plus the second expert's FFN, 12·L·H·F·(k−1), plus the
    router, 6·L·H·E. Capacity padding and dropped tokens do not count."""
    L, H = cfg.num_layers, cfg.hidden_size
    return gpt2_flops_per_token(cfg, seq) + \
        12.0 * L * H * cfg.ffn_size * (MOE_TOP_K - 1) + \
        6.0 * L * H * MOE_EXPERTS


def train_moe(dev, smi):
    """gpt2-small with an 8-expert top-2 MoE FFN in every block (the
    ds_config ``moe`` block → ``MoEConfig.from_ds_config``), through
    ``initialize`` → ``train_batch``: a yardstick step against plain
    autograd (plain LayerNorm/GELU, the plain flash forward, the grouped
    FFN's plain version), then ``train_moe`` (bf16 with fp32 masters, 12
    steps: losses finite and falling, exact launches, step ms, tokens/s,
    peak memory, drop fraction), a profile of 2 steps (K9's share of
    device time), and ``train_moe_fp16`` (3 steps, loss scale from
    2^16), each read on its own."""
    extra = {"moe": moe_block()}
    ds_moe = DeepSpeedConfig(dict(train_config("bf16", MOE_STEPS),
                                  **extra)).moe_config
    cfg = dataclasses.replace(GPT2_CONFIGS["gpt2-small"],
                              moe=MoEConfig.from_ds_config(ds_moe))
    batches = token_stream(cfg, MOE_STEPS + MOE_PROFILE_STEPS)
    tokens_per_step = TRAIN_GAS * TRAIN_MICRO * TRAIN_SEQ
    flops_per_token = moe_flops_per_token(cfg)
    expect = per_moe_step(cfg)
    L, H, Fw = cfg.num_layers, cfg.hidden_size, cfg.ffn_size
    k9_flops_per_step = expect["grouped_matmul"] * 2.0 * MOE_EXPERTS * \
        MOE_CAPACITY * H * Fw
    counts = {}

    eng = make_engine(cfg, "bf16", extra=extra)
    n_params = sum(t.numel() for t in tree_flatten(eng.state.params)[0])
    ref_loss, ref_norm = plain_reference_step(eng, cfg, batches[0])
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    losses, metrics, ms, counts["train_moe"] = run_path(
        eng, batches[:MOE_STEPS])
    staged = gg.grouped_matmul.staged
    k_norm = float(metrics[0]["grad_norm"])
    check = {"loss_kernel": losses[0], "loss_plain": ref_loss,
             "loss_rel": abs(losses[0] - ref_loss) / abs(ref_loss),
             "loss_rtol": TRAIN_LOSS_RTOL,
             "grad_norm_kernel": k_norm, "grad_norm_plain": ref_norm,
             "grad_norm_rel": abs(k_norm - ref_norm) / ref_norm,
             "grad_norm_rtol": TRAIN_GRAD_NORM_RTOL}
    emit({"train_moe_step_vs_plain_autograd": check})
    assert check["loss_rel"] <= TRAIN_LOSS_RTOL, check
    assert check["grad_norm_rel"] <= TRAIN_GRAD_NORM_RTOL, check
    assert all(math.isfinite(l) for l in losses), losses
    first, last = float(np.mean(losses[:4])), float(np.mean(losses[-4:]))
    assert last < first, (first, last)
    assert counts["train_moe"] == {k: MOE_STEPS * v
                                   for k, v in expect.items()}, \
        counts["train_moe"]
    assert staged == 0, staged
    drops = [float(m["moe_drop_fraction"]) for m in metrics]
    tokens = metrics[-1]["moe_expert_tokens"].tolist()
    assert abs(sum(tokens) - MOE_TOP_K * TRAIN_MICRO * TRAIN_SEQ) < 1e-3, \
        tokens
    step_ms = float(np.median(ms[3:]))
    tok_s = tokens_per_step / (step_ms / 1e3)
    path = {
        "model": "gpt2-small, 8 experts top-2, capacity factor 1.25, "
                 "moe_layer_freq 1", "parameters": n_params,
        "precision": "bf16, fp32 masters",
        "batch": [TRAIN_GAS, TRAIN_MICRO, TRAIN_SEQ],
        "capacity_per_expert": MOE_CAPACITY, "steps": MOE_STEPS,
        "dropout": cfg.hidden_dropout, "losses": losses,
        "loss_first4_mean": first, "loss_last4_mean": last,
        "drop_fraction": drops, "expert_tokens_last_step": tokens,
        "aux_loss_last": float(metrics[-1]["moe_aux_loss"]),
        "z_loss_last": float(metrics[-1]["moe_z_loss"]),
        "launches_per_step": expect, "k9_staged_copies": staged,
        "step_ms_p50": step_ms,
        "step_ms_all": ms, "tokens_per_s": tok_s,
        "model_tflops_per_s_routed": flops_per_token * tok_s / 1e12,
        "flops_per_token_routed": flops_per_token,
        "k9_flops_per_step": k9_flops_per_step,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "peak_memory_of": "the 12 steps (reset after the yardstick)",
        "card": smi}
    emit({"train_moe_path": path})
    prof = profile_train_steps(eng, batches[MOE_STEPS:])
    k9_ms = prof["device_ms_per_step_by_group"].get("grouped_gemm", 0.0)
    busy = prof["device_busy_ms_per_step"]
    # the profiled wall carries the profiler's cost; the unprofiled
    # steps' p50 against the same device busy gives the step's idle share
    prof.update(card=smi, k9_device_ms_per_step=k9_ms,
                k9_share_of_device_time=k9_ms / busy,
                idle_share_of_step_p50=1 - busy / step_ms,
                k9_tflops_per_s=k9_flops_per_step / (k9_ms / 1e3) / 1e12
                if k9_ms > 0 else None)
    emit({"train_moe_profile": prof})
    assert k9_ms > 0, prof
    del eng
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # fp16: the model computes in its config's dtype (the ds_config's
    # fp16 block sets the params' cast and the loss scale), so the model
    # is made fp16 too and K9 runs in half precision on the path; loss
    # scale from 2^16.
    cfg16 = dataclasses.replace(cfg, dtype=torch.float16)
    eng = make_engine(cfg16, "fp16", extra=dict(
        extra, fp16={"enabled": True, "initial_scale_power": 16}))
    f_losses, f_metrics, f_ms, counts["train_moe_fp16"] = run_path(
        eng, batches[:MOE_FP16_STEPS])
    staged = gg.grouped_matmul.staged
    emit({"train_moe_fp16_path": {
        "steps": MOE_FP16_STEPS, "model_dtype": str(cfg16.dtype),
        "losses": f_losses,
        "skipped": int(eng.state.skipped_steps),
        "loss_scales": [float(m["loss_scale"]) for m in f_metrics],
        "step_ms_all": f_ms, "k9_staged_copies": staged, "card": smi}})
    assert all(math.isfinite(l) for l in f_losses), f_losses
    assert f_losses[-1] < f_losses[0], f_losses
    assert staged == 0, staged
    assert counts["train_moe_fp16"] == {k: MOE_FP16_STEPS * v
                                        for k, v in expect.items()}
    del eng
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return counts


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda")
    device_name = torch.cuda.get_device_name(0)
    emit({"torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0], "device": device_name,
          "peaks_used": {"card": "H100 SXM",
                         "hbm_bytes_per_s": HBM_BYTES_PER_S,
                         "bf16_flops_per_s": BF16_FLOPS_PER_S,
                         "fp32_flops_per_s": FP32_FLOPS_PER_S}})
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = t0 = time.perf_counter()
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        op_builder.load(verbose=True)
    print(log.getvalue(), end="", flush=True)
    emit({"build_s": time.perf_counter() - t0,
          "library": str(op_builder.build()),
          "ptxas": ptxas_summary(log.getvalue()),
          "dynamic_smem_bytes": dynamic_smem_bytes()})

    gen = torch.Generator(device=dev).manual_seed(SEED)
    ln = check_layer_norm(dev, gen)
    gelu = check_bias_gelu(dev, gen)
    attn = check_paged_attention(dev, gen)
    n_params = gpt2_num_params(GPT2_CONFIGS["gpt2-small"])
    ln_bwd = check_layer_norm_backward(dev, gen)
    gelu_bwd = check_bias_gelu_backward(dev, gen)
    sq = check_sqnorm(dev, gen, n_params)
    adam = check_fused_adam(dev, gen, n_params)
    flash = check_flash(dev, gen)
    sparse = check_sparse(dev, gen)
    grouped = check_grouped_gemm(dev, gen)
    torch.cuda.synchronize()

    serve_counts, _ = serve_gpt2_small(dev)
    torch.cuda.synchronize()
    counts = {"whole_prompt" if k == "whole" else f"spec_k={k}": c
              for k, c in serve_counts.items()}
    counts.update(train_gpt2_small(dev, smi))
    counts.update(train_sparse(dev, smi))
    counts.update(train_moe(dev, smi))

    def summary(name, source, replaces, wrappers, rec, recs):
        by_path = {path: sum(c[w] for w in wrappers)
                   for path, c in counts.items()}
        pair = {k: rec[k] for k in ("library_ms_pair", "library_pair")
                if k in rec}
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": sum(by_path.values()),
                "launches_by_path": by_path,
                "max_abs_err": max(r["max_err"] for r in recs),
                "ms": rec["kernel_ms"], "plain_ms": rec["plain_ms"],
                "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
                "library_ms": rec["library_ms"], "shape": rec["shape"],
                **{k: rec[k] for k in ("device_ms", "cold_ms",
                                       "library_device_ms",
                                       "library_cold_ms") if k in rec},
                "ms_by_shape": [[r["shape"], r.get("residual", r.get(
                    "flags", r.get("dropout", r.get("exact")))),
                    r["kernel_ms"]] +
                    ([r["case"], r["max_err"]] if "case" in r else [])
                    for r in recs], **pair}

    fe_src = "deepspeed_tpu_torch/csrc/fused_elementwise.cu"
    fu_src = "deepspeed_tpu_torch/csrc/fused_update.cu"
    ref = "deepspeed_tpu/ops/"
    train_ln = [r for r in ln if r["shape"][0] == TRAIN_ROWS]
    train_gelu = [r for r in gelu if r["shape"][0] == TRAIN_ROWS]
    kernels = [
        summary("layer_norm_fwd", fe_src, ref + "fused_elementwise.py:187",
                ("fused_layer_norm", "fused_residual_layer_norm"),
                train_ln[0], ln),
        summary("layer_norm_bwd", fe_src, ref + "fused_elementwise.py:212",
                ("layer_norm_backward",), ln_bwd[0], ln_bwd),
        summary("bias_gelu_fwd", fe_src, ref + "fused_elementwise.py:392",
                ("fused_bias_gelu",), train_gelu[0], gelu),
        summary("bias_gelu_bwd", fe_src, ref + "fused_elementwise.py:398",
                ("bias_gelu_backward",), gelu_bwd[0], gelu_bwd),
        summary("sqnorm", fu_src, ref + "fused_update.py:257", ("sqnorm",),
                sq[0], sq),
        summary("fused_adam", fu_src, ref + "fused_update.py:267",
                ("fused_adam_apply",), [r for r in adam if r["flags"] ==
                                        "bf16_cast_cache"][0], adam),
        summary("paged_attention", "deepspeed_tpu_torch/csrc/"
                "paged_attention.cu", ref + "paged_attention.py:126",
                ("paged_attention",), attn[0], attn),
    ]
    # Flash rows: the main training path's record (dropout 0.1) first.
    fl_src = "deepspeed_tpu_torch/csrc/flash_attention.cu"
    # (the gated mode's and the dense 2 x 4096 records join ms_by_shape)
    for wrapper, line, case in (
            ("flash_attention_fwd", 167, "train"),
            ("flash_attention_bwd_dq", 378, "train_split"),
            ("flash_attention_bwd_dkv", 425, "train_split"),
            ("flash_attention_bwd_fused", 482, "train")):
        recs = [r for r in flash + sparse if r["kernel"] == wrapper]
        main_rec = [r for r in recs if r["case"] == case and
                    r["dropout"] > 0][0]
        kernels.append(summary(wrapper, fl_src,
                               ref + f"flash_attention.py:{line}",
                               (wrapper,), main_rec, recs))
    # Sparse rows: the path's record (JAX-picked super-tile, dropout 0.1).
    for wrapper, line in (("sparse_flash_fwd", 114),
                          ("sparse_flash_bwd_dq", 171),
                          ("sparse_flash_bwd_dkv", 294),
                          ("sparse_flash_bwd_fused", 219)):
        recs = [r for r in sparse if r["kernel"] == wrapper]
        main_rec = [r for r in recs
                    if r["case"] == "sparse_path_supertile"][0]
        kernels.append(summary(wrapper, "deepspeed_tpu_torch/csrc/"
                               "sparse_flash.cu",
                               ref + f"sparse_flash.py:{line}", (wrapper,),
                               main_rec, recs))
    # K9: the up-projection (bias + GELU, bf16) as the row's record; the
    # seven path shapes, fp32 and fp16 join ms_by_shape.
    main_gg = [r for r in grouped if r["case"] == "fwd_up" and
               r["dtype"] == "bf16"][0]
    row = summary("grouped_gemm", "deepspeed_tpu_torch/csrc/grouped_gemm.cu",
                  ref + "grouped_gemm.py:132", ("grouped_matmul",), main_gg,
                  grouped)
    row["ms_per_moe_layer_and_micro_batch"] = sum(
        r["kernel_ms"] for r in grouped if r["dtype"] == "bf16")
    kernels.append(row)
    assert len(kernels) == 16, [k["name"] for k in kernels]
    emit({"smoke_wall_s": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": device_name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
