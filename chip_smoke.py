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
   parameter group, the latter for each flag set the engine uses, and
   both in their shard-local mode (``check_fused_adam_sharded``: the
   group in the V-interleaved layout split over dp 2, 4 and 8, each
   rank's rows launched with its base, K6 joined bit-equal to one
   whole-buffer launch in every flag set, K5's partials summed within
   1e-6, each local launch timed); then
   the flash attention kernels (bf16, 12 heads of 64, causal): the
   forward and the fused backward at the training shape (8 x 1024), the
   forward and the split dq / dk-dv backward at sequence 768 and at the
   dense causal step's 2 x 4096, each with dropout 0 and 0.1, and the
   forward at the whole-prompt prefill shape (1 x 1024), and BERT-large's
   bidirectional attention (``bert_s512``: 8 x 512, 16 heads of 64,
   ``causal=False``, dropout 0 and 0.1: the forward and the fused
   backward, the forward's dropout mask read out of the kernel and held
   bit-equal to the plain version's), each also
   launched twice and compared bit for bit (the 8 x 1024 forward also
   timed with a cold L2, the backward kernels also by the card's own
   time, graph replay, and with a cold L2); then
   the block-sparse kernels (``check_sparse``): K7, K8b, K8c and K8a at
   the sparse path's shape (2 x 4096, 12 heads of 64, bf16, the Fixed
   layout, causal) at tile (1, 1) with dropout 0 and 0.1 and at the
   path's super-tile (the resolver's, (2, 8) on an H100), and on a
   BigBird layout (bidirectional, random blocks, a layout per head) at
   2 x 2048; the layout-gated K1,
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
   and the largest error. Then the host Adam of ZeRO-Offload
   (``check_cpu_adam``: ``csrc/cpu_adam.cpp`` built by g++ for this host,
   at gpt2-small's 124,475,904 parameters as one span and as its 16
   leaves, bf16 grads with the bf16 copy): masters and moments within 4
   fp32 ulp of the plain step's, the copy bit-equal to the masters'
   cast; its time, the plain step's, ``torch._fused_adamw_``'s and the
   bound (28 B a parameter over the host's memory rate: the fastest rate
   at which the same run moved those bytes, by native and torch streams,
   the step itself or the library call), with the host's CPU and
   cores.
3b. ``autotune`` (after the flash kernels' checks): the tile resolver
   (``ops/autotune.py``) on a fresh registry (``DS_AUTOTUNE_REGISTRY``
   points into this run's temporary directory for the whole run, child
   processes included, so each path resolves its tiles on this card and
   outside its counted window). K9 at the MoE path's seven launches (the
   expert FFN forward and backward, bf16 and fp16) and K7 at
   ``train_sparse``'s shape (2 x 4096, the Fixed layout, causal; K8b and
   K8c take its tile): the first resolve of each key searches (4 launches
   a candidate), the second hits with no candidate launch, the winner's
   outputs and gradients bit-equal to the heuristic's, ``DS_AUTOTUNE=0``
   today's tiles (``_gg_tile``, ``pick_tile``). Printed: each key's
   candidate times, winner, heuristic and speedup, and the search's wall
   time. K10 at ``check_paged_attention``'s four shapes at every split
   count from 1 to the table width: which counts change the bits (the
   split stays ``paged_splits``'), and each count's time. Every counted
   path asserts that no search ran inside it (``run_path``); the
   sparse-encoder swap of ``bert_inject`` resolves its tile in a warm-up
   draw.
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
4b. ``serve_extras``, on the serve phase's weights, geometry and
   stream, each serve its own path: ``inference.quantize`` none (with an
   ``inference.slo`` block), bf16 and int8 — each mode's ``param_bytes``,
   peak device memory over the serve, TTFT/TPOT/tokens per second, the
   CUDA kernels of one decode step (torch.profiler) and its host syncs,
   the exact launches of a prefill and a decode step, the prefill logits
   against the unquantized engine's (correlation at least 0.99), every
   stream through ``check_streams`` on the engine's own (dequantized)
   weights, int8's bytes at most 0.55 of bf16's, and the SLO report
   (attainment, burn) with a consistent goodput ledger; then
   ``ReplicaRouter`` over two engines sharing the card (32 requests:
   both replicas used, the prefix hit rate above 0, the merged
   TTFT/TPOT, every stream checked); then the slot-major cache
   (``block_size: 0``) with chunked and whole-prompt prefill: every
   greedy stream equal to the paged serve's of phase 4, the whole
   cache's bytes, K10 and K1 launches and the exact launches a step.
4c. ``serve_telemetry``, on the serve phase's weights, geometry and
   stream: two gpt2-small engines, one with ``telemetry`` (report every
   16 iterations, a Perfetto trace, ``fail_on_recompile``), one
   without, serving the stream in 4 rounds ordered off, on, on, off, ...
   (each serve its own path): the greedy streams bit-equal on and off
   and the launches equal, a decode step's host syncs equal on and off,
   ``recompiles`` 0, the report's ``trace`` (16 completed, none
   dropped), every ``request_trace`` event of the JSONL passing
   ``validate_timeline``, ``tools/telemetry_report.py`` reading it (the
   serving section, a worst-request exemplar with its spans); the
   on/off decode-step p50 ratio is printed. Then ``ReplicaRouter`` over
   two replicas with telemetry on and two without (32 requests): streams
   equal, 0 recompiles, the fleet trace's 32 completed requests, every
   replica stream's timelines valid.
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
5a. ``train_telemetry`` (after the train phase): the train recipe on
   two gpt2-small engines from seed 0, one with ``telemetry`` (report
   every 10 steps, a Chrome trace, the grad taps, the cost model) and
   ``flops_profiler`` at step 5, one with neither, 30 steps interleaved
   a step at a time. Fails unless the losses are bit-equal, steps 21-29
   make no host sync on either, the JSONL holds its meta, 30 steps, 3
   reports, the cost model and its final record with nothing dropped
   and no recompile, ``tools/telemetry_report.py`` reads it, every step
   carries an MFU, the analytic state footprint counts the masters,
   moments and copy, and the telemetry-on step p50 is within 1.10 x
   the other's. Prints the MFU p50, the cost model's verdict, flops and
   bytes a step (against 16384 x ``gpt2_flops_per_token``), the memory
   sample beside ``max_memory_allocated`` and the flops table's top
   modules; its launches (the telemetry-on engine's steps) join the
   summary's ``launches_by_path`` as ``train_telemetry``.
5j. ``train_bert`` (after ``train_telemetry``): K3b as a post-LN block
   runs it (4096 x 1024, the residual LN's sum unused: no gs) bit-equal
   to the zero-gs launch, and the time of each and of the library's LN
   backward; then BERT-large
   (post-LN, 24 x 1024, 16 heads, vocab 30528, 335M parameters) on
   ``examples/bert/train.py``'s recipe (bf16, ZeRO-1, Adam 3e-3 under
   WarmupLR, clip 1.0) at 8 x 512, over MLM batches of the corpus's
   bytes (``examples/data/corpus.txt``, 15% masked, a numpy seed): the
   first loss within 2e-3 and the first grad norm within 2e-2 of a
   plain-autograd step (``PLAIN_OPS``, the flash forward's plain
   version), 30 steps as the path (finite, the last
   5 below the first 5, exact launches ``per_bert_step``), two profiled
   steps, one step under the sync debug mode (0 host syncs); then
   bert-large-preln 10 steps (the pre-LN bidirectional block, K3b with
   gs).
5k. ``bert_inject``: ``module_inject`` at bert-large's widths from a
   HF-named ``state_dict`` made on the card (``hidden_act`` "gelu", the
   erf form; no ``transformers`` on that machine): restore ∘ extract
   bit-equal, and a gpt2-small ``Conv1D`` round trip; the injected
   encoder at 8 x 512 in bf16 on the kernels against the plain route
   (each layer teacher-forced within 1e-2, the whole encoder within
   5e-2, relative norms); then ``SparseAttentionUtils``: positions 512
   -> 2048, 2 x 2000 tokens padded to the block, the sparse encoder
   (Fixed bidirectional, 16 heads, block 128: K7, K8b, K8c) forward and
   backward against the dense route with the layout as a mask (fp32
   within 1e-4, bf16 within 3e-2 over 3 input draws: output, dx, dqkv,
   dfc; and, as a negative control, fp32 above 1e-4 against the mask
   with one block dropped), and K7, K8b, K8c at the swap's 2 x 2048
   against their plain versions.
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
5d. ``train_checkpoint``: save, resume and serve from a checkpoint at
   the main path's recipe (gpt2-small, gas 2 x 8 x 1024, dropout 0.1,
   WarmupLR), the files in a ``tempfile.mkdtemp()`` directory that the
   phase removes. bf16 with fp32 masters: engine A trains 3 steps, saves
   (sync), trains 3 more; engine B, from another init seed, loads
   ``latest`` and trains the same 3 (``train_resume``, read on its own):
   its losses, loss scales, skips and final flat buffers (params, cast
   copy, moments, scalars) equal A's bit for bit. A's step 6 saved with
   ``checkpoint.async`` writes the bytes of a sync save of the same
   state. The same resume on the fp16 recipe from initial_scale_power
   19 (``train_resume_fp16``: taken and skipped steps; equal scales
   and skips). Then ``InferenceEngine.from_train_checkpoint`` on A's
   step-6 tag serves the shared-prefix requests
   (``serve_from_checkpoint``, read on its own) and gives the greedy
   tokens, and prefill logits, of an engine built from A's params in
   memory, bit for bit. Printed: the sync save's ms, the async save's
   exposed snapshot ms, the background write's s, the load's ms and the
   bytes written.
5e. ``train_zero``: data parallelism and ZeRO stages 1, 2 and 3 at
   gpt2-small (bf16 with fp32 masters, dropout 0, 5 steps a stage) as
   two processes on the one card joined by gloo (this script again, as
   ``--train-zero-rank R SPEC``), each rank on its 2 x 4 x 1024 rows of
   the main path's global batch. Asserted: both ranks' params bit-equal,
   stage 3 bit-equal to stage 2 (losses, params, moments), the first
   loss within 2e-3 of the world-1 step on the same global batch, and
   the launch counts (paths ``train_zero_s1`` .. ``_s3``, both ranks)
   exactly the main path's a step and rank. Printed: each rank's step
   p50 and peak memory (gloo stages every collective through host
   memory, so those step times are the host's). Then dense stage 0,
   sparse gradients and 1-bit Adam (freeze_step 2), 4 steps each (paths
   ``train_zero_s0``, ``_sparse``, ``_onebit``): the ranks' params
   bit-equal after every step, the sparse step's params bit-equal to
   dense stage 0's, the ranks' worker errors different after the
   freeze; printed: ``sparse_comm_stats`` and ``comm_bytes`` a step.
5f. ``train_offload``: ZeRO-Offload at gpt2-small under
   ``examples/gpt2/ds_config_offload.json`` read from the file (bf16,
   stage 2, the masters and Adam moments in host memory, AdamW 3e-3,
   clip 1.0, 8 x 1024 a step, dropout 0.1): the device-optimizer engine
   (the same config without ``cpu_offload``) 5 steps, then the serial
   offload engine 10 steps, the overlapped one (``overlap_comm``) 10
   from the same init, and 5 fp16 steps each way from
   initial_scale_power 20. Asserted: serial and overlapped bit-equal
   (losses, masters, moments, device params), ``overlap_fraction`` > 0,
   fp16 skips with equal scales, the loss falls, the first loss equal
   to the device engine's and the first 5 within 1e-2, the peak device
   memory at least 1.4 GB below the device engine's, exact launches
   (no K5/K6; 16 host Adam calls a taken step). Printed: step ms each
   way, the ``offload_timings`` breakdown, the peaks.
5g. ``train_remat`` (after ``train_moe``): gpt2-medium (H 1024, 16
   heads of 64, 24 layers, FFN 4096, vocab 50304) at full width and depth
   on the main path's recipe, 2 warm-up and 6 timed steps under each
   ``remat_policy`` (``none``, ``full``, ``dots``, ``dots_flash``,
   ``attn``) from the same
   params and token stream, each its own path: losses bit-equal across
   the policies, exactly the launches ``per_remat_step`` derives (the
   forward kernels again in the backward), ``full``'s peak at least
   ``REMAT_PEAK_SAVING`` under ``none``'s, 0 host syncs under ``full``;
   printed per policy: step ms p50, peak, K1/K3f/K4f/K2c/K3b/K4b
   launches a step, device busy ms and idle share (one profiled step).
   Then ``train_pld`` (``PLD_BLOCK``, 10 steps): the kept layers a step
   and micro-step (host draws), K1 launches equal to them, 0 host syncs,
   the loss falls; then the ``train_moe`` block under ``full`` against
   ``none`` (3 steps each: equal losses and ``moe_*`` metrics, K9 up by
   two launches a layer and micro-step); then the checkpointing API
   (``check_checkpoint_api``: ``cpu_checkpointing`` on CUDA tensors, the
   held input in pinned host memory, the card's copy freed, gradients
   bit-equal to the plain call's).
5h. ``train_api`` (after ``train_remat``): the reference's training API
   at gpt2-small on the main path's recipe. ``train_api_trio`` (6 steps
   through ``forward``/``backward``/``step``) and ``train_api_batch``
   (6 through ``train_batch``) from the same init, interleaved step by
   step: params, cast copy, moments, count and loss-scale machine
   bit-equal after every step, exact launches, the step p50 and host ms
   of each, their peaks above a step's start within 2%; then each
   optimizer of ``MATRIX`` (Lamb, SGD with momentum, Adagrad, RMSprop,
   Lion, unfused AdamW; plain PyTorch over the flat buffers, no TPU
   kernel) 10 steps (``train_api_<name>``: K5 once a step, no K6, the
   loss at step 10 below step 1), its update over gpt2-small's
   124,475,904-parameter group against the leaf-by-leaf reference (4
   fp32 ulp; Lamb 2^-16 of the update more), the copy bit-equal, timed
   beside its bound and a library yardstick; then ``eval_batch`` at 8 x
   1024 against the train path's loss at dropout 0, and its time.
5i. ``train_onebit`` (after ``train_api``): 1-bit Adam at gpt2-small
   under ``examples/gpt2/ds_config_onebit.json`` read from its file
   (1 x 8 x 1024, bf16, OneBitAdam lr 0.002, freeze_step 20): 20 warmup
   and 20 compressed steps, each phase its own path (the model's
   kernels, no K5/K6): the loss falls over the warmup, every loss
   finite, the variance bit-unchanged after the freeze, no host sync in
   a compressed step; the fused Adam's engine on the same recipe (10
   steps) for its step time; 10 fp16 steps past freeze_step 3 (the
   compressed phase reached); then the flat step over gpt2-small's
   124,475,904 parameters against ``onebit_reference_step`` in both
   phases (``ONEBIT_ULP``, the rounding-level signs counted), timed
   beside the fused Adam's step and ``torch._fused_adamw_``, with its
   launches and its bound.
5l. ``launch`` (the port's front door, each part in its own processes
   from the checkout's root): ``bin/deepspeed_torch --num_gpus 1
   examples/gpt2/train_torch.py --config ds_config_zero2.json --model
   gpt2-small --data examples/data/corpus.txt --steps 20`` (bf16, ZeRO-2,
   8 x 1024 a step, full width and depth): the child exits 0 on
   ``cuda``, its loss falls (the last quarter's mean under 0.97 of the
   first's), and its launches, read from its JSON line, are exactly the
   main path's at gas 1 (the path ``launch_gpt2_small`` of the summary);
   two ranks through the launcher on the one card (``--procs_per_node
   2``, gloo, ZeRO-2, gpt2-small's widths at 2 layers, 3 steps): both on
   ``cuda:0`` with ``CUDA_VISIBLE_DEVICES=0``, params bit-equal; a child
   exiting 3 takes its sleeping sibling down, the launch exiting non-zero
   within 10 s of the failure; ``bin/ds_report_torch`` names the card
   and shows every kernel source's library built, loadable and current;
   ``tools/crashkill_torch.py run --quick`` on the card (SIGTERM and
   SIGKILL kills, a loadable latest after each, the resumed run
   bit-identical).
6. The ``{"host_kernels": [...]}`` line (the host Adam), the
   ``{"optimizers": [...]}`` line (the matrix's and 1-bit Adam's steps:
   ms, bytes, bound, library yardstick), then the ``{"kernels": [...]}`` summary
   line (the sqnorm and fused_adam rows also carry their shard-local
   launches by dp), then the result line ``{"ok": true, "device":
   {...}}``.
"""
import contextlib
import dataclasses
import filecmp
import gc
import io
import json
import math
import os
import random
import re
import shutil
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch
import torch.nn.functional as F

import deepspeed_tpu_torch
from deepspeed_tpu_torch import ops
from deepspeed_tpu_torch.inference import InferenceEngine, \
    ReplicaRouter, shared_prefix_requests
from deepspeed_tpu_torch.models.bert import BERT_CONFIGS, bert_init, \
    bert_mlm_loss_fn, bert_num_params
from deepspeed_tpu_torch.models.gpt2 import GPT2_CONFIGS, gpt2_apply, \
    gpt2_flops_per_token, gpt2_init, gpt2_loss_fn, gpt2_num_params
from deepspeed_tpu_torch.models.transformer import PLAIN_OPS, apply_blocks, \
    dense_attention
from deepspeed_tpu_torch.module_inject import get_policy, replace_module
from deepspeed_tpu_torch.monitor.request_trace import validate_timeline
from deepspeed_tpu_torch.moe import MoEConfig
from deepspeed_tpu_torch.ops import autotune
from deepspeed_tpu_torch.ops import costs
from deepspeed_tpu_torch.ops import flash_attention as fa
from deepspeed_tpu_torch.ops import fused_elementwise as fe
from deepspeed_tpu_torch.ops import fused_update as fu
from deepspeed_tpu_torch.ops import grouped_gemm as gg
from deepspeed_tpu_torch.ops import onebit as ob
from deepspeed_tpu_torch.ops import optimizers as topt
from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops import paged_attention as pa
from deepspeed_tpu_torch.ops import sparse_flash as sf
from deepspeed_tpu_torch.ops.fused_update import tree_flatten, \
    tree_unflatten
from deepspeed_tpu_torch.ops.sparse_attention import \
    BigBirdSparsityConfig, FixedSparsityConfig, SparseAttentionUtils, \
    SparseSelfAttention, sparse_attention
from deepspeed_tpu_torch.ops.sparse_attention.sparse_self_attention import \
    sparse_attention_reference
from deepspeed_tpu_torch.runtime.async_ckpt import AsyncCheckpointer
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.utils.timer import device_sync_count

# Published peaks of the H100 SXM (NVIDIA data sheet, dense, 700 W): HBM
# bytes/s, the bf16 rate and the fp32 rate outside the tensor cores. The
# operations term of a bound is priced at the rate of the inputs' type:
# bf16 for the serving kernels and the LayerNorm/GELU kernels, fp32 for
# the grad norm and the Adam step, whose inputs are fp32.
REPO = os.path.dirname(os.path.abspath(__file__))
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
# BERT-large's attention (train_bert): 16 heads of 64, bidirectional, at
# micro-batch 8 x 512; the backward is the fused kernel (S 512).
BERT_HEADS = 16
BERT_FLASH_CASES = (("bert_s512", 8, 512, 0.0), ("bert_s512", 8, 512, 0.1))
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
# train_checkpoint: steps before the save and after it. The fp16 resume
# starts from 2^19, near the edge where the recipe's early steps
# overflow (the main fp16 path, from 2^32, first took a step at 2^17),
# so its steps hold taken and skipped ones and the resume carries the
# hysteresis.
CKPT_STEPS = 3
CKPT_FP16_SCALE_POWER = 19
# train_remat (slice 6d): gpt2-medium at full width and depth on the main
# path's recipe, 6 steps under each remat policy from the same params and
# token stream; full's peak must sit at least this far under none's (the
# held activations fall from about 0.29 GB a layer and micro-batch to the
# block input's 16.8 MB; the floor is two thirds of that estimate's
# 6.5 GB).
REMAT_POLICIES = ("none", "full", "dots", "dots_flash", "attn")
# Each policy's path: 2 steps that warm the caching allocator (a fresh
# engine's first remat steps read 10-40% above its later ones as the
# re-run's blocks are first allocated), then the 6 steps it is timed on.
REMAT_WARMUP, REMAT_STEPS = 2, 6
REMAT_PEAK_SAVING = 4.0e9
# Progressive layer drop on the same model: theta 0.5 and gamma 0.1 take
# the keep probability from 1 to 0.70 in 10 steps, so layers drop (at
# gamma 0.001 the schedule keeps every layer for the first hundred steps:
# about 0.6 drops expected in 10).
PLD_BLOCK = {"enabled": True, "theta": 0.5, "gamma": 0.1}
PLD_STEPS = 10
# MoE (the train_moe block at gpt2-small) under full against none.
REMAT_MOE_STEPS = 3


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
    """(ms, "bytes" or "operations"): the larger of the bytes over the HBM
    rate and the operations over ``flops_per_s``. The kernels' counts
    come from their declared costs (``ops/costs.py``)."""
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
            c = costs.layer_norm_fwd(rows, H, x.element_size(), resid)
            b_ms, b_by = bound(c.bytes, c.flops)
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
            c = costs.bias_gelu_fwd(rows, Fw, y.element_size())
            b_ms, b_by = bound(c.bytes, c.flops)
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
    alive = (n > 0)[..., None]
    keys = int(((pos.long() + 1) * alive).sum())
    c = costs.paged_attention_cost(q.numel(), q.element_size(), blocks, nH,
                                   bs, D, pk.element_size(), bt.numel(),
                                   pos.numel(), keys)
    return c.bytes, c.flops


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
def check_streams(cfg, params, dev, requests, reports, label=None):
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
        rec = {"path": k if label is None else label, "tokens": n,
               "picks_at_ref_argmax": at_argmax,
               "max_pick_margin": worst, "tol": PICK_MARGIN_TOL}
        if k != 0:
            rec.update({"streams_equal_chunked_spec0":
                        f"{len(requests) - len(diverged)}/{len(requests)}",
                        "first_divergences": diverged})
        emit({"serve_streams_vs_gpt2_apply": rec})
        assert worst <= PICK_MARGIN_TOL, rec
        assert all(max(d["ref_margins"]) <= PICK_MARGIN_TOL
                   for d in diverged), rec


SERVE_BASE = {"max_slots": 8, "max_seq_len": 1024, "block_size": 16,
              "prefill_chunk": 32}


def serve_requests(cfg, n=16):
    """The serve phase's stream: ``n`` requests sharing a 64-token
    prefix, tails of 16-48 tokens, 32 new tokens each."""
    return shared_prefix_requests(
        n, prefix_len=64, tail_len=(16, 48), max_new_tokens=32,
        vocab_size=cfg.vocab_size, seed=SEED)


def serve_prompt(cfg):
    """A 100-token prompt from the stream's seed: its first 64 tokens
    are the served stream's shared prefix."""
    return np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, 100).astype(np.int32)


def serve_step_counts(L, n, attend="paged_attention"):
    """The serving kernels' launches of ``n`` chunks or steps: 12 layers
    of 2 LN + 1 GELU + 1 attend each, plus ln_f."""
    c = {name: 0 for name in ops.launch_counts()}
    c.update({"fused_layer_norm": n * (2 * L + 1),
              "fused_bias_gelu": n * L, attend: n * L})
    return c


def warm_serve(eng, cfg):
    """A short serve that is not counted, then a fresh aggregator."""
    eng.serve(shared_prefix_requests(
        2, prefix_len=16, tail_len=(4, 8), max_new_tokens=4,
        vocab_size=cfg.vocab_size, seed=SEED + 1))
    eng.reset_serving_stats()


def serve_gpt2_small(dev):
    cfg = GPT2_CONFIGS["gpt2-small"]                 # bf16 compute
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = gpt2_init(cfg, gen)                     # on cuda by default
    base = SERVE_BASE
    reqs = lambda: serve_requests(cfg)  # noqa: E731
    # Paths: chunked prefill with spec_k 0 and 3, and whole-prompt
    # prefill (the flash forward, one admission at a time, no sharing).
    paths = {0: dict(spec_k=0), 3: dict(spec_k=3),
             "whole": dict(spec_k=0, prefill_chunk=0)}
    engines = {k: InferenceEngine(cfg, params, {"inference": dict(
        base, **inf)}) for k, inf in paths.items()}
    for eng in engines.values():                     # warm-up, not counted
        warm_serve(eng, cfg)
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
    prompt = serve_prompt(cfg)
    per_step = lambda n, attend="paged_attention": \
        serve_step_counts(L, n, attend)  # noqa: E731

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
    return counts, reports, params


def one_step(fn):
    """``fn()`` with the launch counts zeroed just before and read just
    after."""
    ops.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, ops.launch_counts()


# --------------------------------------------------------------------- #
# Phase 4b: the serving leftovers — quantized weights, the replica
# router, the slot-major cache, the SLO tracker and goodput ledger
# --------------------------------------------------------------------- #
QUANT_MODES = ("none", "bf16", "int8")
# The SLO block of the "none" engine: targets a bf16 gpt2-small serve of
# the stream meets on its TTFT and mostly on its TPOT.
SERVE_SLO = {"ttft_ms": 500.0, "tpot_ms": 10.0, "availability": 0.99,
             "window_s": 600.0}
QUANT_LOGIT_CORR = 0.99
ROUTER_REQUESTS = 32


def step_host_syncs(fn):
    """Operations of one ``fn()`` that made the host wait for the card
    (CUDA's sync debug mode); a decode step's own is its sampled-token
    fetch."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sum("called a synchronizing" in str(w.message) for w in caught)


def nonzero(counts):
    return {k: v for k, v in counts.items() if v}


def free_card():
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()


def serve_path(eng, requests):
    """One serve as its own path: counts zeroed just before, read just
    after, the peak device memory over it."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    syncs = device_sync_count()
    ops.reset_launch_counts()
    rep = eng.serve(requests)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert device_sync_count() == syncs, "a timer synced inside the serve"
    assert rep["completed"] == len(requests) and rep["unfinished"] == 0, \
        (rep["completed"], rep["unfinished"])
    assert all(counts[name] > 0 for name in SERVE_KERNELS), counts
    return rep, counts, torch.cuda.max_memory_allocated()


def serve_extras(dev, params, paged_reports):
    """``inference.quantize`` none / bf16 / int8, the replica router over
    two engines, the slot-major cache (chunked and whole-prompt) and the
    SLO tracker, all at gpt2-small full width and depth on the serve
    phase's geometry, weights and stream. Returns the launch counts by
    path."""
    cfg = GPT2_CONFIGS["gpt2-small"]
    L = cfg.num_layers
    reqs = lambda: serve_requests(cfg)  # noqa: E731
    prompt = serve_prompt(cfg)
    counts, quant = {}, {}
    ref_logits = None

    def on_host(tree):
        return {k: on_host(v) if isinstance(v, dict) else v.cpu()
                for k, v in tree.items()}
    # The engines are built from a host copy of the weights, as
    # ``from_train_checkpoint`` gives them, so the build's peak is the
    # one a serve from a checkpoint pays.
    host_params = on_host(params)

    # --- weight quantization (the "none" engine carries the SLO block) ---
    for mode in QUANT_MODES:
        free_card()
        base_bytes = torch.cuda.memory_allocated()
        inf = dict(SERVE_BASE, quantize=mode)
        if mode == "none":
            inf["slo"] = SERVE_SLO
        torch.cuda.reset_peak_memory_stats()
        eng = InferenceEngine(cfg, host_params, {"inference": inf})
        torch.cuda.synchronize()
        build_peak = torch.cuda.max_memory_allocated() - base_bytes
        warm_serve(eng, cfg)
        rep, counts[f"serve_quant_{mode}"], peak = serve_path(eng, reqs())
        check_streams(cfg, eng._runtime_params(), dev, reqs(), {0: rep},
                      label=f"quantize={mode}")
        (tok, logits), pf = one_step(lambda: eng.prefill(
            prompt, slot=0, return_logits=True, max_new_tokens=8))
        eng.activate_slot(0, len(prompt), tok)
        n_kernels = kernel_launches(eng.decode_once)
        _, dec = one_step(eng.decode_once)
        syncs = step_host_syncs(eng.decode_once)
        eng.release_slot(0)
        assert pf == serve_step_counts(L, 2) and \
            dec == serve_step_counts(L, 1), (mode, pf, dec)
        assert np.isfinite(logits).all()
        if mode == "none":
            ref_logits = logits
        corr = float(np.corrcoef(logits, ref_logits)[0, 1])
        rec = {"quantize": mode, "param_bytes": eng.param_bytes,
               "peak_bytes": peak, "base_bytes": base_bytes,
               "peak_above_base": peak - base_bytes,
               "build_peak_above_base": build_peak,
               "ttft_ms_p50": rep["ttft_ms"]["p50"],
               "tpot_ms_p50": rep["tpot_ms"]["p50"],
               "tokens_per_s": rep["tokens_per_s"],
               "decode_step_ms_p50": rep["decode_step_ms"]["p50"],
               "decode_step_cuda_kernels": n_kernels,
               "decode_step_host_syncs": syncs,
               "prefill_logits_max_abs_diff_vs_none": float(
                   np.abs(logits - ref_logits).max()),
               "prefill_logits_corr_vs_none": corr,
               "launches": nonzero(counts[f"serve_quant_{mode}"])}
        emit({"serve_quantize": rec})
        assert corr >= QUANT_LOGIT_CORR, rec
        quant[mode] = rec
        if mode == "none":
            slo, led = rep["slo"], rep["ledger"]
            emit({"serve_slo": {"slo": slo, "ledger": led,
                                "decode_step_host_syncs": syncs}})
            assert led["consistent"] is True and slo["total"] == 16, rep
            assert led["decode_useful_s"] > 0 and led["prefill_s"] > 0
        del eng, rep
    assert quant["int8"]["param_bytes"] <= \
        0.55 * quant["bf16"]["param_bytes"], quant
    assert len({q["decode_step_host_syncs"] for q in quant.values()}) == 1

    # --- the replica router: two engines sharing the card ---
    free_card()
    engines = [InferenceEngine(cfg, params, {"inference": dict(
        SERVE_BASE, replica=f"r{i}")}) for i in range(2)]
    for eng in engines:
        warm_serve(eng, cfg)
    rreqs = lambda: serve_requests(cfg, ROUTER_REQUESTS)  # noqa: E731
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    rep = ReplicaRouter(engines).serve(rreqs())
    torch.cuda.synchronize()
    counts["serve_router"] = ops.launch_counts()
    check_streams(cfg, engines[0]._params, dev, rreqs(), {0: rep},
                  label="router")
    rec = {"replicas": 2, "requests": ROUTER_REQUESTS,
           "completed": rep["completed"], "routed": rep["router"]["routed"],
           "affinity_hits": rep["router"]["affinity_overrides"],
           "prefix_hit_rate": rep["prefix"]["hit_rate"],
           "ttft_ms_p50": rep["ttft_ms"]["p50"],
           "tpot_ms_p50": rep["tpot_ms"]["p50"],
           "tokens_per_s": rep["tokens_per_s"],
           "per_replica_tpot_ms_p50": [r["tpot_ms"]["p50"]
                                       for r in rep["replicas"]],
           "ledgers_consistent": [r["ledger"]["consistent"]
                                  for r in rep["replicas"]],
           "launches": nonzero(counts["serve_router"])}
    emit({"serve_router": rec})
    assert rep["completed"] == ROUTER_REQUESTS and rep["unfinished"] == 0
    assert min(rep["router"]["routed"]) > 0, rec
    assert rep["prefix"]["hit_rate"] > 0, rec
    assert all(counts["serve_router"][n] > 0 for n in SERVE_KERNELS), rec
    del engines, rep

    # --- the slot-major cache: chunked and whole-prompt prefill ---
    for name, inf, paged in (
            ("slot_major_chunked", dict(SERVE_BASE, block_size=0),
             paged_reports[0]),
            ("slot_major_whole", dict(SERVE_BASE, block_size=0,
                                      prefill_chunk=0),
             paged_reports["whole"])):
        free_card()
        eng = InferenceEngine(cfg, params, {"inference": inf})
        warm_serve(eng, cfg)
        rep, counts[f"serve_{name}"], peak = serve_path(eng, reqs())
        c = counts[f"serve_{name}"]
        check_streams(cfg, eng._params, dev, reqs(), {0: rep}, label=name)
        whole = inf["prefill_chunk"] == 0
        (tok, _), pf = one_step(lambda: eng.prefill(prompt, slot=0))
        eng.activate_slot(0, len(prompt), tok)
        _, dec = one_step(eng.decode_once)
        eng.release_slot(0)
        ours = [r["tokens"] for r in rep["requests"]]
        theirs = [r["tokens"] for r in paged["requests"]]
        equal = sum(a == b for a, b in zip(ours, theirs))
        rec = {"path": name, "completed": rep["completed"],
               "streams_equal_paged": f"{equal}/{len(ours)}",
               "cache_bytes": rep["cache_bytes_p95"],
               "paged_cache_bytes_p95": paged["cache_bytes_p95"],
               "paged_attention_launches": c["paged_attention"],
               "flash_attention_fwd_launches": c["flash_attention_fwd"],
               "ttft_ms_p50": rep["ttft_ms"]["p50"],
               "tpot_ms_p50": rep["tpot_ms"]["p50"],
               "tokens_per_s": rep["tokens_per_s"], "peak_bytes": peak,
               "launches_prefill_100": nonzero(pf),
               "launches_decode_step": nonzero(dec)}
        emit({"serve_slot_major": rec})
        assert equal == len(ours), rec
        assert rep["cache_bytes_p95"] == eng.cache_spec.nbytes(), rec
        assert c["flash_attention_fwd"] == (16 * L if whole else 0), rec
        assert pf == (serve_step_counts(L, 1, "flash_attention_fwd")
                      if whole else serve_step_counts(L, 4)), rec
        assert dec == serve_step_counts(L, 1), rec
        del eng, rep
    free_card()
    return counts


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
        c = costs.layer_norm_bwd(TRAIN_ROWS, H, s.element_size(), resid)
        b_ms, b_by = bound(c.bytes, c.flops)
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
        c = costs.bias_gelu_bwd(TRAIN_ROWS, Fw, y.element_size())
        b_ms, b_by = bound(c.bytes, c.flops)
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
    c = costs.sqnorm_cost(n)
    b_ms, b_by = bound(c.bytes, c.flops, FP32_FLOPS_PER_S)
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
        c = costs.fused_adam_cost(
            n, p.element_size(), 0 if cast is None else cast.element_size())
        nbytes = c.bytes
        b_ms, b_by = bound(c.bytes, c.flops, FP32_FLOPS_PER_S)
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


SHARD_DPS = (2, 4, 8)


def gpt2_leaf_sizes(cfg):
    """The sizes of the model's parameter leaves in tree order (one fp32
    master group), from an init on the meta device."""
    params = gpt2_init(cfg, torch.Generator().manual_seed(0), "meta")
    return [t.numel() for t in tree_flatten(params)[0]]


def check_fused_adam_sharded(dev, gen, sizes):
    """K5 and K6 in their shard-local mode at gpt2-small's group in the
    V-interleaved layout (8 x Lpad elements): for dp 2, 4 and 8, the
    launches over each rank's rows (K6 with the rank's base in the seed
    row), joined, against one whole-buffer launch — K6 bit-equal in
    every flag set, the K5 partials summed within 1e-6 relative — and
    that whole launch bit-equal to the plain version on the same inputs
    and seed row. Each
    local launch is timed (rank 0's rows; every rank's are the same
    size)."""
    Lpad = fu._group_row_len(sizes, 8)
    N = 8 * Lpad
    sq_recs, adam_recs = [], []
    g = 1e-3 * torch.randn(N, device=dev, generator=gen)
    whole = float(fu.sqnorm(g))
    for dp in SHARD_DPS:
        n = N // dp
        parts = sum(float(fu.sqnorm(g[d * n:(d + 1) * n]))
                    for d in range(dp))
        rel = abs(parts - whole) / whole
        assert rel <= 1e-6, ("sqnorm shard-local", dp, rel)
        c = costs.sqnorm_cost(n)
        b_ms, b_by = bound(c.bytes, c.flops, FP32_FLOPS_PER_S)
        rec = {"kernel": "sqnorm", "mode": "shard_local", "dp": dp,
               "shape": [n], "dtype": "fp32",
               "kernel_ms": time_ms(lambda: fu.sqnorm(g[:n])),
               "plain_ms": time_ms(lambda: fu.sqnorm_plain(g[:n]),
                                   iters=20),
               "bound_ms": b_ms, "bound_by": b_by,
               "max_err": abs(parts - whole), "max_rel_err": rel}
        emit(rec)
        sq_recs.append(rec)
    del g
    for name, p_dt, c_dt, flags, sc in ADAM_FLAG_SETS:
        g = 0.05 * torch.randn(N, device=dev, generator=gen)
        if flags["use_inv"]:
            g = g * 2.0 ** 16
        p = (0.2 * torch.randn(N, device=dev, generator=gen)).to(p_dt)
        m = 0.01 * torch.randn(N, device=dev, generator=gen)
        v = 1e-4 * torch.rand(N, device=dev, generator=gen)
        scalars = torch.tensor(sc + [0.0, 0.0], device=dev)
        kw = dict(b1=0.9, b2=0.999, eps=1e-8, one_pass=True, **flags)

        def seed_row(base):
            return torch.tensor([123456789, fu._int32(base)],
                                dtype=torch.int32, device=dev)

        def state():
            return [p.clone(), m.clone(), v.clone(),
                    None if c_dt is None else
                    torch.empty(N, dtype=c_dt, device=dev)]
        W = state()
        fu.fused_adam_apply(g, W[0], W[1], W[2], scalars, seed_row(0),
                            cast_out=W[3], **kw)
        # The whole launch against the plain version on these inputs:
        # bit-equal, as check_fused_adam holds it (both round op by op).
        ref = fu.fused_adam_plain(g, p, m, v, scalars, seed_row(0),
                                  cast_dtype=c_dt, **kw)
        torch.cuda.synchronize()
        pairs = [(a, b) for a, b in zip(W, ref) if a is not None]
        plain_err = max(float((a.float() - b.float()).abs().max())
                        for a, b in pairs)
        assert all(torch.equal(a, b) for a, b in pairs), \
            ("fused_adam whole launch vs plain", name, plain_err)
        del ref, pairs
        for dp in SHARD_DPS:
            n = N // dp
            S = state()
            for d in range(dp):
                sl = slice(d * n, (d + 1) * n)
                fu.fused_adam_apply(
                    g[sl], S[0][sl], S[1][sl], S[2][sl], scalars,
                    seed_row(d * n), cast_out=None if S[3] is None
                    else S[3][sl], **kw)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(S, W)
                       if a is not None)
            assert same, ("fused_adam shard-local", name, dp)
            c = costs.fused_adam_cost(
                n, p.element_size(),
                0 if c_dt is None else S[3].element_size())
            nbytes = c.bytes
            b_ms, b_by = bound(c.bytes, c.flops, FP32_FLOPS_PER_S)
            sr = seed_row(0)
            rec = {"kernel": "fused_adam", "mode": "shard_local",
                   "flags": name, "dp": dp, "shape": [n],
                   "param_dtype": str(p_dt).replace("torch.", ""),
                   "kernel_ms": time_ms(lambda: fu.fused_adam_apply(
                       g[:n], S[0][:n], S[1][:n], S[2][:n], scalars, sr,
                       cast_out=None if S[3] is None else S[3][:n], **kw)),
                   "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
                   "bit_equal_to_whole_launch": True, "max_err": 0.0,
                   "whole_launch_vs_plain_max_err": plain_err}
            emit(rec)
            adam_recs.append(rec)
            del S
        del g, p, m, v, W
        torch.cuda.empty_cache()
    return sq_recs, adam_recs


def _rel_err(a, b):
    """Largest |a - b| over the largest |b|."""
    return float((a.float() - b.float()).abs().max() /
                 b.float().abs().max().clamp_min(1e-30))


def _flash_record(kernel, case, B, S, drop, got, want, again, nbytes, flops,
                  kern, plain, lib, lib_name, causal=True, cold=False,
                  device=False, heads=12, **extra):
    errs = [_rel_err(a, b) for a, b in zip(got, want)]
    assert max(errs) <= FLASH_REL_TOL, (kernel, case, drop, errs)
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    assert same, (kernel, case, drop, "two launches differ")
    b_ms, b_by = bound(nbytes, flops)
    rec = {"kernel": kernel, "case": case,
           "shape": {"batch": B, "heads": heads, "seq": S, "head_dim": 64,
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


def kernel_dropout_mask_equal(dev, B, S, nH, D, drop, seed):
    """K1's bidirectional dropout mask read out of the kernel and held
    bit-equal to its plain version's (``_keep_grid``, the position hash
    the plain forward draws): with q = k = 0 every key has probability
    1/S, so with v one-hot over a D-key window each output column is
    that key's kept or dropped probability. S/D forward launches."""
    scale = D ** -0.5
    q = torch.zeros(B, S, nH, D, device=dev, dtype=torch.bfloat16)
    k = torch.zeros_like(q)
    got = torch.empty(B * nH, S, S, dtype=torch.bool, device=dev)
    eye = torch.eye(D, device=dev, dtype=torch.bfloat16)
    for base in range(0, S, D):
        v = torch.zeros_like(q)
        v[:, base:base + D] = eye[None, :, None, :]
        o, _ = fa.flash_attention_fwd(q, k, v, False, scale, drop, seed)
        got[:, :, base:base + D] = (o != 0).permute(0, 2, 1, 3).reshape(
            B * nH, S, D)
    want = fa._keep_grid(seed, B * nH, S, S, drop, dev)
    same = bool(torch.equal(got, want))
    assert same, ("K1's dropout mask differs from the plain version's",
                  float(got.float().mean()), float(want.float().mean()))
    return same


def check_flash(dev, gen):
    """K1, K2a, K2b and K2c against their plain versions at the shapes
    the training and whole-prompt prefill paths give them (GPT-2: 12
    heads, causal), and at BERT-large's (16 heads, ``causal=False``:
    ``bert_s512``). Inputs are the strided split of one [B, S, 3H]
    projection, as the model's. The bound's operations are the matmul
    FLOPs over the (q, k) pairs the causal rule keeps (all S² pairs
    without it), at the bf16 rate; its bytes read each input and write
    each output once."""
    D, dt, out = 64, torch.bfloat16, []
    scale = D ** -0.5
    seed = torch.tensor(FLASH_SEED, dtype=torch.int32, device=dev)
    cases = [c + (12, True) for c in FLASH_CASES] + \
        [c + (BERT_HEADS, False) for c in BERT_FLASH_CASES]
    for case, B, S, drop, nH, causal in cases:
        qkv = torch.randn(B, S, 3 * nH * D, device=dev, generator=gen).to(dt)
        q, k, v = (t.reshape(B, S, nH, D) for t in qkv.split(nH * D, -1))
        do = torch.randn(B, S, nH, D, device=dev, generator=gen).to(dt)
        pairs = costs.causal_pairs(B, nH, S, causal)
        fwd_c, fused_c, dq_c, dkv_c = (
            f(B, S, nH, D, pairs) for f in (
                costs.flash_fwd_cost, costs.flash_bwd_fused_cost,
                costs.flash_bwd_dq_cost, costs.flash_bwd_dkv_cost))
        # The library call's inputs, laid out and built outside its timing.
        sq, sk, sv = (t.transpose(1, 2).contiguous().requires_grad_()
                      for t in (q, k, v))
        sdo = do.transpose(1, 2).contiguous()

        def sdpa():
            return F.scaled_dot_product_attention(sq, sk, sv,
                                                  is_causal=causal,
                                                  dropout_p=drop)

        fwd = lambda: fa.flash_attention_fwd(q, k, v, causal, scale,  # noqa: E731
                                             drop, seed)
        o, lse = fwd()
        want = fa.flash_fwd_plain(q, k, v, causal, scale, drop, seed)
        again = fwd()
        torch.cuda.synchronize()
        lse_err = float((lse - want[1]).abs().max())
        assert lse_err <= FLASH_LSE_TOL, (case, drop, lse_err)
        extra = {}
        if drop > 0 and not causal:
            extra["dropout_mask_bit_equal_to_plain"] = \
                kernel_dropout_mask_equal(dev, B, S, nH, D, drop, seed)
        lib_name = f"F.scaled_dot_product_attention(is_causal={causal})"
        with torch.no_grad():
            out.append(_flash_record(
                "flash_attention_fwd", case, B, S, drop, (o, lse), want,
                again, fwd_c.bytes, fwd_c.flops, fwd,
                lambda: fa.flash_fwd_plain(q, k, v, causal, scale, drop,
                                           seed),
                sdpa, lib_name, causal=causal, heads=nH,
                cold=case in ("train", "bert_s512"),
                lse_max_abs_err=lse_err, **extra))
        del want, again
        if case == "prefill":
            continue
        delta = fa.flash_delta(do, o)
        args = (q, k, v, do, lse, delta, causal, scale, drop, seed)
        want = fa.flash_bwd_plain(*args)
        lib_out = sdpa()
        lib_bwd = lambda: torch.autograd.grad(  # noqa: E731
            lib_out, (sq, sk, sv), sdo, retain_graph=True)
        plain = lambda: fa.flash_bwd_plain(*args)  # noqa: E731
        if fa.use_fused_bwd(S, S):
            kern = lambda: fa.flash_attention_bwd_fused(*args)  # noqa: E731
            out.append(_flash_record(
                "flash_attention_bwd_fused", case, B, S, drop, kern(), want,
                kern(), fused_c.bytes, fused_c.flops, kern, plain,
                lib_bwd, "F.scaled_dot_product_attention backward "
                "(torch.autograd.grad)", device=True, causal=causal,
                heads=nH))
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
                kq(), dq_c.bytes, dq_c.flops, kq, plain, None,
                None, device=True, causal=causal, heads=nH, **pair))
            out.append(_flash_record(
                "flash_attention_bwd_dkv", case, B, S, drop, kkv(), want[1:],
                kkv(), dkv_c.bytes, dkv_c.flops, kkv, plain,
                None, None, device=True, causal=causal, heads=nH, **pair))
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
    and 0.1 and at the path's super-tile (the resolver's) with dropout
    0.1, and on a BigBird layout (bidirectional, random blocks, a layout per head) at
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
    pick = sparse_path_tile(fixed, SPARSE_MICRO, SPARSE_SEQ, nH, True, dev)
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
        out += sparse_case(dev, gen, case, lay, B, S, causal, drop, tile,
                           nH, seed, "bigbird" if lay is bigbird else "fixed")
    return out


def sparse_case(dev, gen, case, lay, B, S, causal, drop, tile, nH, seed,
                layout_name, with_fused=True):
    """One case of ``check_sparse``: the LUT kernels at super-tile
    ``tile`` (cases named ``sparse*``; K8a too ``with_fused``) or the
    gated and dense flash kernels, forward and backward, against their
    plain versions; returns the records."""
    D, dt, out = 64, torch.bfloat16, []
    scale = D ** -0.5
    qkv = torch.randn(B, S, 3 * nH * D, device=dev, generator=gen).to(dt)
    q, k, v = (t.reshape(B, S, nH, D) for t in qkv.split(nH * D, -1))
    do = torch.randn(B, S, nH, D, device=dev, generator=gen).to(dt)
    BH = B * nH
    keep = None if lay is None else \
        fa.layout_element_mask(lay, S, causal, dev)
    pairs = B * (int(keep.sum()) if keep is not None
                 else nH * S * (S + 1) // 2)
    fwd_c, fused_c, dq_c, dkv_c = (
        f(B, S, nH, D, pairs) for f in (
            costs.flash_fwd_cost, costs.flash_bwd_fused_cost,
            costs.flash_bwd_dq_cost, costs.flash_bwd_dkv_cost))
    extra = {"layout": None if lay is None else layout_name,
             "kept_pairs": pairs, "causal": causal, "heads": nH}
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
            fwd_c.bytes, fwd_c.flops, fwd, plain, sdpa,
            lib_name, lse_max_abs_err=lse_err, **extra))
    del want, again
    if case == "dense_causal_s4096":
        return out
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
        dq_c.bytes, dq_c.flops, kq, plain_b, None, None,
        **pair, **extra))
    out.append(_flash_record(
        names[1], case, B, S, drop, kkv(), want[1:], kkv(),
        dkv_c.bytes, dkv_c.flops, kkv, plain_b, None, None,
        **pair, **extra))
    if case.startswith("sparse") and with_fused:
        kf = lambda: sf.sparse_flash_bwd_fused(*args)  # noqa: E731
        plan = sf.sparse_plan(lay, S, dt, causal, dev, w, qw)
        ws = BH * plan.slots_per_head * plan.tile * D * 4
        out.append(_flash_record(
            "sparse_flash_bwd_fused", case, B, S, drop, kf(), want, kf(),
            fused_c.bytes, fused_c.flops, kf, plain_b, lib_bwd,
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
        plan = gg._gg_plan(a, b, act, sms, bias)
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
        c = costs.grouped_gemm_cost(E, M, K, N, a.element_size(),
                                    bias is not None)
        nbytes, flops = c.bytes, c.flops
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
# Phase 3b: the tile resolver (ops/autotune.py)
# --------------------------------------------------------------------- #
@contextlib.contextmanager
def env_set(**kw):
    """Environment variables set for the block (None: unset)."""
    old = {k: os.environ.get(k) for k in kw}
    try:
        for k, v in kw.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def registry_entries(prefix):
    """The registry's entries whose key starts with ``prefix``."""
    with open(autotune.registry_path()) as f:
        reg = json.load(f)
    return {k: v for k, v in reg.items() if k.startswith(prefix)}


def resolve_runs(run, launches):
    """``run()`` three times: under ``DS_AUTOTUNE=0`` (the heuristic
    tiles), then twice through the resolver (the first resolve of each
    new key searches, the second hits). Returns the three outputs and,
    for the two resolver runs, the counters' and ``launches()``'s deltas
    and the wall seconds (synchronized)."""
    with env_set(DS_AUTOTUNE="0"):
        ref = run()
    rec = []
    outs = []
    for _ in range(2):
        c0, l0 = dict(autotune.counters), launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(run())
        torch.cuda.synchronize()
        rec.append({"wall_s": time.perf_counter() - t0,
                    "counters": {k: autotune.counters[k] - c0[k]
                                 for k in c0},
                    "launches": {k: v - l0[k]
                                 for k, v in launches().items()}})
    return ref, outs, rec


def moe_ffn_operands(dev, gen, dt):
    """The MoE path's expert FFN operands at its shapes (8 experts,
    capacity 2560, 768 x 3072) in ``dt``, and an output gradient."""
    small = GPT2_CONFIGS["gpt2-small"]
    E, C, H, Fw = MOE_EXPERTS, MOE_CAPACITY, small.hidden_size, \
        small.ffn_size

    def r(*shape, scale=1.0):
        return (scale * torch.randn(*shape, device=dev,
                                    generator=gen)).to(dt)
    return (r(E, C, H), r(E, H, Fw, scale=H ** -0.5), r(E, Fw, scale=0.1),
            r(E, Fw, H, scale=Fw ** -0.5), r(E, H, scale=0.1), r(E, C, H))


def autotune_k9(dev, gen, sms):
    """K9 through the resolver at the MoE path's seven launches (the
    expert FFN forward and backward, ``grouped_ffn``), bf16 and fp16 as
    ``train_moe`` and ``train_moe_fp16`` run them."""
    out = []
    for dt in (torch.bfloat16, torch.float16):
        x, w1, b1, w2, b2, dy = moe_ffn_operands(dev, gen, dt)
        calls = []

        def run():
            xs = [t.detach().requires_grad_() for t in (x, w1, b1, w2, b2)]
            y = gg.grouped_ffn(*xs)
            y.backward(dy)
            return [y.detach()] + [t.grad for t in xs]

        real = gg._gg_plan     # each launch plans once: record them

        def plan(a, b, act=None, sms=gg.H100_SMS, bias=None, tile=None):
            calls.append((a, b, bias, act))
            return real(a, b, act, sms, bias, tile)
        gg._gg_plan = plan
        try:
            with env_set(DS_AUTOTUNE="0"):
                run()
        finally:
            gg._gg_plan = real
        assert len(calls) == 7, len(calls)
        with env_set(DS_AUTOTUNE="0"):
            today = [gg._gg_plan(a, b, act, sms, bias).tile[1]
                     for a, b, bias, act in calls]
        heur = [gg._gg_tile(a.shape[0], a.shape[1], b.shape[2], act, sms)
                for a, b, bias, act in calls]
        del calls
        ref, outs, rec = resolve_runs(
            run, lambda: {"K9": gg.grouped_matmul.launches})
        name = autotune.dtype_name(dt)
        entries = registry_entries(f"grouped_gemm|{name}[")
        first, second = rec
        res = {"kernel": "K9", "dtype": name, "keys": len(entries),
               "first": first, "second": second,
               "search_wall_s": first["wall_s"] - second["wall_s"],
               "disabled_tiles": today, "gg_tile": heur,
               "bit_equal_to_heuristic": all(
                   torch.equal(a, b) for o in outs for a, b in zip(o, ref)),
               "entries": entries}
        emit({"autotune": res})
        out.append(res)
        assert today == heur, res
        assert first["counters"]["search"] == len(entries) >= 1, res
        assert first["launches"]["K9"] == 7 + sum(
            4 * len(e["timings_s"]) for e in entries.values()), res
        assert second["counters"] == {"search": 0, "hit": 7,
                                      "heuristic": 0}, res
        assert second["launches"]["K9"] == 7, res
        assert res["bit_equal_to_heuristic"], res
        del x, w1, b1, w2, b2, dy, ref, outs
    return out


def autotune_sparse(dev, gen):
    """K7 (and K8b/K8c, which take its tile) through the resolver at
    ``train_sparse``'s shape: 2 x 4096, 12 heads of 64, the Fixed layout,
    causal, bf16, dropout 0.1, forward and backward."""
    nH, D = 12, 64
    lay = sparse_layout(nH, SPARSE_SEQ) != 0
    shape = (SPARSE_MICRO, SPARSE_SEQ, nH, D)
    q, k, v, do = (torch.randn(*shape, device=dev, generator=gen)
                   .to(torch.bfloat16) for _ in range(4))
    seed = torch.tensor(FLASH_SEED, dtype=torch.int32, device=dev)
    heur = sf.pick_tile(lay, block=SPARSE_SEQ // lay.shape[2])

    def run(tile=(0, 0)):
        xs = [t.detach().requires_grad_() for t in (q, k, v)]
        o = sf.sparse_flash_attention(*xs, lay, causal=True, scale=D ** -0.5,
                                      seed=seed, dropout=0.1,
                                      qwiden=tile[0], widen=tile[1])
        o.backward(do)
        return [o.detach()] + [t.grad for t in xs]

    kernels = ("sparse_flash_fwd", "sparse_flash_bwd_dq",
               "sparse_flash_bwd_dkv")
    ref, outs, rec = resolve_runs(
        run, lambda: {k: ops.launch_counts()[k] for k in kernels})
    entries = registry_entries("sparse_flash|bfloat16[")
    assert len(entries) == 1, entries
    ent = next(iter(entries.values()))
    pinned = run(tuple(ent["tile"]))
    with env_set(DS_AUTOTUNE="0"):
        today = sf.resolve_tile(lay, SPARSE_SEQ // lay.shape[2],
                                q=q, causal=True)
    first, second = rec
    res = {"kernel": "K7/K8b/K8c", "dtype": "bfloat16",
           "shape": list(shape), "layout": "fixed, causal",
           "first": first, "second": second,
           "search_wall_s": first["wall_s"] - second["wall_s"],
           "disabled_tile": list(today), "pick_tile": list(heur),
           "bit_equal_to_heuristic": all(
               torch.equal(a, b) for o in outs + [pinned]
               for a, b in zip(o, ref)),
           "entries": entries}
    emit({"autotune": res})
    assert today == heur, res
    assert tuple(ent["heuristic"]) == heur, res
    assert first["counters"]["search"] == 1, res
    assert first["launches"]["sparse_flash_fwd"] == \
        1 + 4 * len(ent["timings_s"]), res
    assert second["counters"] == {"search": 0, "hit": 1, "heuristic": 0}, \
        res
    assert second["launches"] == {k: 1 for k in kernels}, res
    assert res["bit_equal_to_heuristic"], res
    return res


def autotune_k10(dev, gen):
    """K10's split count, not behind the resolver: at check_paged_attention's
    four shapes, the output at every split count from 1 to the table
    width against ``paged_splits``' (bits and best-of-3 times)."""
    out = []
    cases = {"decode": dict(contexts=[1024, 700, 333, 129, 64, 17, 1, 0],
                            K=1),
             "verify": dict(contexts=[1021, 650, 300, 100, 48, 16, 5, 0],
                            K=4),
             "prefill": dict(contexts=[993], K=32),
             "serve_decode": dict(contexts=[128, 131, 126, 140, 120, 133,
                                            129, 127], K=1)}
    for name, spec in cases.items():
        q, pk, pv, bt, pos, scale = _attn_case(dev, gen, **spec)
        G, Q, K = pos.shape
        J = bt.shape[-1]
        heur = pa.paged_splits(G * Q, 12, J, K)

        def runner(n):
            return pa.paged_attention(q, pk, pv, bt, pos, scale, _splits=n)
        ref = runner(heur)
        measure = autotune.measure_from_runner(runner)
        times, differ = {}, []
        for n in range(1, J + 1):
            if not torch.equal(runner(n), ref):
                differ.append(n)
            times[n] = measure(n)
        best = min(times, key=times.get)
        res = {"kernel": "K10", "case": name, "paged_splits": heur,
               "splits_tried": J, "splits_with_other_bits": differ,
               "best_split": best, "best_ms": times[best] * 1e3,
               "paged_splits_ms": times[heur] * 1e3,
               "ms_by_split": {n: t * 1e3 for n, t in times.items()}}
        emit({"autotune": res})
        out.append(res)
    return out


def autotune_phase(dev, smi):
    """The tile resolver on a fresh registry (``DS_AUTOTUNE_REGISTRY`` in
    this run's temporary directory): K9 and K7/K8 search once a key, then
    hit with no candidate launch, the winner bit-equal to the heuristic,
    ``DS_AUTOTUNE=0`` today's tiles; K10's split counts read for bits."""
    assert not os.path.exists(autotune.registry_path())
    autotune.reset()
    gen = torch.Generator(device=dev).manual_seed(SEED + 20)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    t0 = time.perf_counter()
    k9 = autotune_k9(dev, gen, sms)
    sparse = autotune_sparse(dev, gen)
    k10 = autotune_k10(dev, gen)
    free_card()
    emit({"autotune_phase": {
        "registry": autotune.registry_path(), "counters": autotune.counters,
        "k9_search_wall_s": [r["search_wall_s"] for r in k9],
        "sparse_search_wall_s": sparse["search_wall_s"],
        "k10_bit_equal_across_splits": all(
            not r["splits_with_other_bits"] for r in k10),
        "phase_wall_s": time.perf_counter() - t0, "card": smi}})
    return k9, sparse, k10


def sparse_path_tile(layout, B, S, nH, causal, dev):
    """The super-tile a sparse path at ``[B, S, nH, 64]`` bf16 runs: the
    resolver's, a registry hit once the path (or the autotune phase) has
    resolved it."""
    searches = autotune.counters["search"]
    tile = sf.resolve_tile(np.asarray(layout) != 0,
                           S // np.asarray(layout).shape[2],
                           q=torch.empty(B, S, nH, 64, dtype=torch.bfloat16,
                                         device=dev), causal=causal)
    assert autotune.counters["search"] == searches, \
        "the path's tile was not resolved yet"
    return tile


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


def per_train_step(cfg, seq=TRAIN_SEQ, gas=TRAIN_GAS):
    """Launches of one train step: per micro-batch and layer one flash
    forward and, by the JAX rule, the fused backward (S = 1024) or the
    dq + dk/dv pair (S = 768)."""
    L = cfg.num_layers
    c = {name: 0 for name in ops.launch_counts()}
    c.update({"fused_layer_norm": gas * (L + 1),
              "fused_residual_layer_norm": gas * L,
              "fused_bias_gelu": gas * L,
              "layer_norm_backward": gas * (2 * L + 1),
              "bias_gelu_backward": gas * L,
              "sqnorm": 1, "fused_adam_apply": 1,
              "flash_attention_fwd": gas * L})
    bwd = ("flash_attention_bwd_fused",) if fa.use_fused_bwd(seq, seq) \
        else ("flash_attention_bwd_dq", "flash_attention_bwd_dkv")
    c.update({name: gas * L for name in bwd})
    return c


def make_engine(cfg, precision, seed=SEED, attention_fn=None,
                micro=TRAIN_MICRO, extra=None, rng=None):
    """An engine with params from ``seed``; its random stream's base
    seed is ``rng`` (default: ``seed``)."""
    dev = torch.device("cuda")
    params = gpt2_init(cfg, torch.Generator(device=dev).manual_seed(seed))
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=gpt2_loss_fn(cfg, attention_fn=attention_fn),
        model_params=params,
        config=dict(train_config(precision, TRAIN_STEPS, micro),
                    **(extra or {})), rng=seed if rng is None else rng)
    return eng


def plain_reference_step(eng, cfg, batch,
                         attention_fn=fa.flash_attention_plain):
    """One step's mean loss and global grad norm by plain autograd
    (plain LayerNorm/GELU, and the attention's plain version, which
    draws the same attention seeds) on the engine's bf16 params, its
    batch split and its next step's generator (the same dropout masks)."""
    gen = eng.step_generator()
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
    searches = autotune.counters["search"]
    ops.reset_launch_counts()
    for b, st, en in zip(batches, starts, ends):
        st.record()
        losses.append(eng.train_batch(b))
        en.record()
        metrics.append(eng.last_metrics)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    # a tile search inside the path would add its candidates' launches
    assert autotune.counters["search"] == searches, \
        "a tile search inside a counted path: resolve it in a warm-up"
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
# Phase 5a: training telemetry at gpt2-small
# --------------------------------------------------------------------- #
TELEMETRY_STEPS = 30
TELEMETRY_REPORT = 10
TELEMETRY_PROFILE_STEP = 5
# Host syncs are counted over the steps strictly between the second and
# the third report boundaries (global steps 21-29, batch indices 20-28).
TELEMETRY_SYNC_STEPS = range(20, 29)
TELEMETRY_OVERHEAD = 1.10


def train_telemetry(dev, smi, out_dir):
    """The main training recipe at gpt2-small (bf16, fp32 masters,
    AdamW, clip 1.0, gas 2 x 8 x 1024, dropout 0.1) on two engines from
    seed 0, interleaved a step at a time over the Markov stream: one
    with ``telemetry`` on (report_steps 10, a trace, the health taps, the
    cost model) and ``flops_profiler`` at step 5, one with neither.
    Fails unless the losses are bit-equal, the host syncs a step between
    boundaries are equal (and 0), the stream holds its meta, 30 steps, 3
    reports, its cost model and its final record with nothing dropped and
    no recompile, ``tools/telemetry_report.py`` reads it, and the
    telemetry-on step p50 is within 1.10 x the telemetry-off one. The
    path's launch counts are the telemetry-on engine's steps'."""
    cfg = GPT2_CONFIGS["gpt2-small"]
    free_card()
    batches = token_stream(cfg, TELEMETRY_STEPS, seed=0)
    trace = os.path.join(out_dir, "trace.json")
    tel = {"enabled": True, "output_path": out_dir, "job_name": "train",
           "report_steps": TELEMETRY_REPORT, "trace_path": trace,
           "health": {"grad_taps": True}, "cost_model": True}
    prof = {"enabled": True, "profile_step": TELEMETRY_PROFILE_STEP,
            "top_modules": 5, "detailed": False}
    log = io.StringIO()
    engines = {"on": make_engine(cfg, "bf16", seed=0, extra={
        "telemetry": tel, "flops_profiler": prof}),
        "off": make_engine(cfg, "bf16", seed=0)}
    torch.cuda.reset_peak_memory_stats()
    losses = {k: [] for k in engines}
    ms = {k: [] for k in engines}
    syncs = {k: 0 for k in engines}
    counts = {name: 0 for name in ops.launch_counts()}
    for i, b in enumerate(batches):
        for name, eng in engines.items():
            st = torch.cuda.Event(enable_timing=True)
            en = torch.cuda.Event(enable_timing=True)
            if name == "on":
                torch.cuda.synchronize()
                ops.reset_launch_counts()

            def step():
                st.record()
                losses[name].append(eng.train_batch(b))
                en.record()
            if i in TELEMETRY_SYNC_STEPS:
                syncs[name] += step_host_syncs(step)
            elif name == "on" and i == TELEMETRY_PROFILE_STEP:
                with contextlib.redirect_stdout(log):
                    step()
            else:
                step()
            ms[name].append((st, en))
            if name == "on":
                torch.cuda.synchronize()
                for k, v in ops.launch_counts().items():
                    counts[k] += v
    torch.cuda.synchronize()
    del eng, step
    ms = {k: [a.elapsed_time(e) for a, e in v] for k, v in ms.items()}
    losses = {k: [float(x) for x in v] for k, v in losses.items()}
    peak = torch.cuda.max_memory_allocated()
    on = engines["on"]
    on.close()
    with open(os.path.join(out_dir, "train.jsonl")) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    kinds = [r["kind"] for r in recs]
    steps = [r for r in recs if r["kind"] == "step"]
    reports = [r for r in recs if r["kind"] == "report"]
    cm = next((r for r in recs if r["kind"] == "cost_model"), None)
    events = [r["event"] for r in recs if r["kind"] == "event"]
    summary_path = os.path.join(out_dir, "TELEMETRY.json")
    tool = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "telemetry_report.py"),
         os.path.join(out_dir, "train.jsonl"), "-o", summary_path],
        capture_output=True, text=True, timeout=120)
    with open(trace) as f:
        spans = [e for e in json.load(f) if e.get("ph") == "X"]
    p50 = {k: float(np.median(v[1:])) for k, v in ms.items()}
    mfu = [r["mfu"] for r in steps if "mfu" in r]
    res = on.flops_profiler.result
    tokens = TRAIN_GAS * TRAIN_MICRO * TRAIN_SEQ
    analytic = tokens * gpt2_flops_per_token(cfg, TRAIN_SEQ)
    mem = reports[-1].get("memory", {}) if reports else {}
    rec = {
        "steps": TELEMETRY_STEPS, "report_steps": TELEMETRY_REPORT,
        "step_ms_p50_on": p50["on"], "step_ms_p50_off": p50["off"],
        "p50_ratio": p50["on"] / p50["off"],
        "step_ms_on": ms["on"], "step_ms_off": ms["off"],
        "mfu_p50": float(np.median(mfu)) if mfu else None,
        "cost_model": None if cm is None else {
            "bound": cm["step"]["bound"],
            "floor_ms": cm["step"]["floor_ms"],
            "flops_per_step": cm["step"]["flops_per_step"],
            "bytes_per_step_per_device":
                cm["step"]["bytes_per_step_per_device"],
            "chip": cm["chip"],
            "paths": {k: {"flops": v.get("analytic_flops"),
                          "bytes": v.get("hbm_bytes_per_device"),
                          "bound": v.get("bound"),
                          "kernels": v.get("kernels")}
                      for k, v in cm["paths"].items()}},
        "analytic_flops_per_step": analytic,
        "walked_over_analytic": None if cm is None else
        cm["step"]["flops_per_step"] / analytic,
        "memory_sample": {k: mem.get(k) for k in (
            "peak_bytes_in_use_max", "bytes_in_use_max", "bytes_limit_max")},
        "max_memory_allocated": peak,
        "analytic_state_bytes": recs[0].get("analytic_state_bytes"),
        "flops_profiler_top": {d: [[p, f] for p, f, _ in
                                   res.top_modules(6, depth=d)]
                               for d in (1, 6, 8)} if res else None,
        "flops_profiler_total": None if res is None else res.total_flops,
        "trace_spans": len(spans), "host_syncs": syncs,
        "kinds": {k: kinds.count(k) for k in set(kinds)},
        "events": events, "report_tool_rc": tool.returncode,
        "report_tool": tool.stdout.strip()[-300:],
        "losses_bit_equal": losses["on"] == losses["off"],
        "launches_per_step": {k: v // TELEMETRY_STEPS
                              for k, v in nonzero(counts).items()},
        "card": smi}
    emit({"train_telemetry": rec})
    del engines, on
    free_card()
    expect = per_train_step(cfg)
    assert rec["losses_bit_equal"], losses
    assert syncs["on"] == syncs["off"] == 0, syncs
    assert kinds[0] == "meta" and kinds[-1] == "final", kinds[:3]
    assert kinds.count("step") == TELEMETRY_STEPS and \
        kinds.count("report") == TELEMETRY_STEPS // TELEMETRY_REPORT and \
        kinds.count("cost_model") == 1, rec["kinds"]
    assert all(r["dropped_records"] == 0 for r in reports), reports
    assert "recompile" not in events and "cost_model_error" not in events, \
        events
    assert tool.returncode == 0, tool.stderr[-2000:]
    assert len(mfu) == TELEMETRY_STEPS and all(m > 0 for m in mfu), mfu
    assert res is not None and res.total_flops > 0
    # (the fp32 masters and two moments and the bf16 copy at least)
    assert rec["analytic_state_bytes"] >= 14 * gpt2_num_params(cfg), \
        rec["analytic_state_bytes"]
    assert rec["p50_ratio"] <= TELEMETRY_OVERHEAD, rec["p50_ratio"]
    assert counts == {k: TELEMETRY_STEPS * v for k, v in expect.items()}, \
        counts
    return {"train_telemetry": counts}


# --------------------------------------------------------------------- #
# Phase 5d: checkpointing at gpt2-small
# --------------------------------------------------------------------- #
def flat_state(eng):
    """Copies of everything a step carries: the flat params, the cast
    copy, the moments and the scalars."""
    st = eng.state
    out = [g.param for g in eng._groups]
    out += [g.cast for g in eng._groups if g.cast is not None]
    out += list(st.opt_state.m) + list(st.opt_state.v)
    out += [st.step, st.loss_scale, st.growth_count, st.hysteresis,
            st.skipped_steps, st.opt_state.count]
    return [t.detach().clone() for t in out]


def tag_bytes(path):
    return {fn: os.path.getsize(os.path.join(path, fn))
            for fn in sorted(os.listdir(path))}


def ckpt_history(losses, metrics):
    """(loss, the step's loss scale, skipped steps after it) a step."""
    return [(float(l), float(m["loss_scale"]), int(m["skipped_steps"]))
            for l, m in zip(losses, metrics)]


def ckpt_steps(eng, batches):
    losses, metrics = [], []
    for b in batches:
        losses.append(eng.train_batch(b))
        metrics.append(eng.last_metrics)
    return ckpt_history(losses, metrics)


def ckpt_resume(cfg, precision, batches, root, path_name, counts,
                extra=None):
    """A: CKPT_STEPS steps, a sync save, CKPT_STEPS more. B (params from
    another seed, the same base seed): load ``latest``, the same steps
    as one path. Returns A and the record; asserts bit equality."""
    d = os.path.join(root, precision)
    a = make_engine(cfg, precision, extra=extra)
    hist_a = ckpt_steps(a, batches[:CKPT_STEPS])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a.save_checkpoint(d)
    save_ms = (time.perf_counter() - t0) * 1e3
    tag = os.path.join(d, f"global_step{CKPT_STEPS}")
    nbytes = sum(tag_bytes(tag).values())
    hist_a += ckpt_steps(a, batches[CKPT_STEPS:2 * CKPT_STEPS])
    want = flat_state(a)

    b = make_engine(cfg, precision, seed=SEED + 1, extra=extra, rng=SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path, _ = b.load_checkpoint(d)
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    assert path is not None and b.global_steps == CKPT_STEPS, path
    losses, metrics, _, counts[path_name] = run_path(
        b, batches[CKPT_STEPS:2 * CKPT_STEPS])
    hist_b = ckpt_history(losses, metrics)
    got = flat_state(b)
    del b
    shutil.rmtree(d)
    equal = [bool(torch.equal(x, y)) for x, y in zip(want, got)]
    rec = {"precision": precision, "steps": [CKPT_STEPS, CKPT_STEPS],
           "history_a": hist_a, "history_resumed": hist_b,
           "resumed_equal_bitwise": hist_b == hist_a[CKPT_STEPS:],
           "flat_buffers_equal": f"{sum(equal)}/{len(equal)}",
           "sync_save_ms": save_ms, "load_ms": load_ms,
           "bytes_written": nbytes}
    assert rec["resumed_equal_bitwise"], rec
    assert all(equal), rec
    want_counts = {k: CKPT_STEPS * v for k, v in per_train_step(cfg).items()}
    assert counts[path_name] == want_counts, (counts[path_name], want_counts)
    return a, rec


def train_checkpoint(dev, smi):
    """Save, resume and serve from a checkpoint at gpt2-small."""
    cfg = GPT2_CONFIGS["gpt2-small"]          # dropout 0.1, bf16 compute
    batches = token_stream(cfg, 2 * CKPT_STEPS, seed=SEED + 5)
    counts, out = {}, {}
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        a, out["bf16"] = ckpt_resume(cfg, "bf16", batches, root,
                                     "train_resume", counts)

        # A's step 6, async and sync: the same bytes.
        a._async_ckpt = AsyncCheckpointer(writer_timeout_s=600.0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a.save_checkpoint(os.path.join(root, "async"), tag="step6")
        exposed_ms = (time.perf_counter() - t0) * 1e3
        assert a._async_ckpt.wait(timeout=600.0)
        assert a._async_ckpt.last_error is None, a._async_ckpt.last_error
        write_s = a._async_ckpt.write_wall_s
        a._async_ckpt.close()
        a._async_ckpt = None
        t0 = time.perf_counter()
        a.save_checkpoint(os.path.join(root, "sync"), tag="step6")
        sync_ms = (time.perf_counter() - t0) * 1e3
        ta, ts = (os.path.join(root, k, "step6") for k in ("async", "sync"))
        files = tag_bytes(ts)
        same = sorted(os.listdir(ta)) == sorted(files) and all(
            filecmp.cmp(os.path.join(ta, fn), os.path.join(ts, fn),
                        shallow=False) for fn in files)
        out["async"] = {"exposed_snapshot_ms": exposed_ms,
                        "background_write_s": write_s,
                        "sync_save_ms": sync_ms,
                        "bytes_written": sum(files.values()),
                        "files": files, "async_equals_sync_bytes": same}
        shutil.rmtree(os.path.join(root, "async"))
        assert same, out["async"]

        # Serving from A's step-6 tag against A's params in memory.
        base = {"max_slots": 8, "max_seq_len": 1024, "block_size": 16,
                "prefill_chunk": 32}
        reqs = lambda: shared_prefix_requests(  # noqa: E731
            16, prefix_len=64, tail_len=(16, 48), max_new_tokens=32,
            vocab_size=cfg.vocab_size, seed=SEED)
        leaves, spec = tree_flatten(a.state.params)
        mem = InferenceEngine(cfg, tree_unflatten(
            spec, [t.detach().clone() for t in leaves]), {"inference": base})
        del a
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ck = InferenceEngine.from_train_checkpoint(
            os.path.join(root, "sync"), cfg, {"inference": base},
            tag="step6")
        torch.cuda.synchronize()
        serve_load_ms = (time.perf_counter() - t0) * 1e3
        want = mem.serve(reqs())
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        got = ck.serve(reqs())
        torch.cuda.synchronize()
        counts["serve_from_checkpoint"] = ops.launch_counts()
        assert got["completed"] == 16 and got["unfinished"] == 0, got
        assert all(counts["serve_from_checkpoint"][k] > 0
                   for k in SERVE_KERNELS), counts["serve_from_checkpoint"]
        streams_equal = [g["tokens"] == w["tokens"] for g, w in
                         zip(got["requests"], want["requests"])]
        prompt = np.random.default_rng(SEED).integers(
            0, cfg.vocab_size, 100).astype(np.int32)
        _, lg_ck = ck.prefill(prompt, slot=0, return_logits=True)
        _, lg_mem = mem.prefill(prompt, slot=0, return_logits=True)
        logits_equal = bool(np.array_equal(np.asarray(lg_ck),
                                           np.asarray(lg_mem)))
        out["serve"] = {"requests": 16, "load_ms": serve_load_ms,
                        "streams_equal": f"{sum(streams_equal)}/16",
                        "prefill_logits_equal": logits_equal,
                        "tokens_per_s": got["tokens_per_s"],
                        "launches": counts["serve_from_checkpoint"]}
        assert all(streams_equal) and logits_equal, out["serve"]
        del mem, ck
        torch.cuda.empty_cache()

        # fp16: skipped then taken steps across the save.
        _, out["fp16"] = ckpt_resume(
            cfg, "fp16", batches, root, "train_resume_fp16", counts,
            extra={"fp16": {"enabled": True,
                            "initial_scale_power": CKPT_FP16_SCALE_POWER}})
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["card"] = smi
    emit({"train_checkpoint": out})
    return counts


# --------------------------------------------------------------------- #
# Phase 5b: the block-sparse paths at gpt2-small, sequence 4096
# --------------------------------------------------------------------- #
# --------------------------------------------------------------------- #
# Phase 5e: data parallelism and ZeRO 1/2/3 (two ranks on the one card)
# --------------------------------------------------------------------- #
ZERO_DP, ZERO_STEPS, ZERO_STAGES = 2, 5, (1, 2, 3)
# The two stage-0 train steps that replace the grad all-reduce, at dp 2
# beside the dense stage-0 step they are held against: 1-bit Adam (two
# warmup steps, two compressed) and sparse gradients (the CSR exchange of
# wte's grads).
ZERO_STAGE0_MODES, ZERO_STAGE0_STEPS, ZERO_ONEBIT_FREEZE = \
    ("s0", "sparse", "onebit"), 4, 2
# The sparse path's params against dense stage 0's after the run: at dp 2
# every sum of two terms is the same in either order and the 1/dp is a
# power of two, so they are held bit-equal.
SPARSE_VS_DENSE_ATOL = 0.0


def _zero_cfg():
    # dropout 0: the ranks' own dropout streams would differ from the
    # world-1 step's, which the first loss is held against.
    return dataclasses.replace(GPT2_CONFIGS["gpt2-small"],
                               hidden_dropout=0.0, attn_dropout=0.0)


def _zero_rank_rows(batch, micro):
    """Rank rows of a global batch, micro-step by micro-step (the JAX
    engine's sharding): micro-step i, rank d → rows i*micro*dp + d*micro
    onward."""
    rank = deepspeed_tpu_torch.parallel.comm.get_rank()
    return torch.cat([batch[i * micro * ZERO_DP + rank * micro:
                            i * micro * ZERO_DP + (rank + 1) * micro]
                      for i in range(TRAIN_GAS)])


def train_zero_rank(rank, spec_path):
    """One rank of ``train_zero`` (a child process): gloo on the shared
    card, the train recipe at each ZeRO stage, results to a JSON file."""
    import hashlib
    import torch.distributed as dist
    with open(spec_path) as f:
        spec = json.load(f)
    torch.cuda.set_device(0)
    deepspeed_tpu_torch.init_distributed(
        dist_backend="gloo", store=dist.FileStore(spec["store"], ZERO_DP),
        world_size=ZERO_DP, rank=rank, verbose=False)
    op_builder.load()
    cfg = _zero_cfg()
    micro = TRAIN_MICRO // ZERO_DP
    batches = [torch.from_numpy(b) for b in np.load(spec["batches"])]
    local = [_zero_rank_rows(b, micro) for b in batches]
    out = {}
    for stage in ZERO_STAGES:
        eng = make_engine(cfg, "bf16", micro=micro, extra={
            "train_batch_size": TRAIN_GAS * micro * ZERO_DP,
            "zero_optimization": {"stage": stage}})
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        losses, _, ms, counts = run_path(eng, local)
        peak = torch.cuda.max_memory_allocated()
        digest = hashlib.sha256()
        for t in tree_flatten(eng.full_params())[0]:
            digest.update(t.detach().float().cpu().numpy().tobytes())
        m_digest = hashlib.sha256()
        for t in list(eng.state.opt_state.m) + list(eng.state.opt_state.v):
            m_digest.update(t.cpu().numpy().tobytes())
        out[str(stage)] = {"losses": losses, "ms": ms, "counts": counts,
                           "peak_bytes": peak,
                           "params_sha256": digest.hexdigest(),
                           "moments_sha256": m_digest.hexdigest()}
        del eng
        torch.cuda.empty_cache()
    for mode in ZERO_STAGE0_MODES:
        extra = {"train_batch_size": TRAIN_GAS * micro * ZERO_DP,
                 "zero_optimization": {"stage": 0}}
        if mode == "sparse":
            extra["sparse_gradients"] = True
        if mode == "onebit":
            extra["optimizer"] = {"type": "OneBitAdam", "params": {
                "lr": 6e-4, "freeze_step": ZERO_ONEBIT_FREEZE}}
        eng = make_engine(cfg, "bf16", micro=micro, extra=extra)
        rec = {"losses": [], "ms": [], "params_sha256": [],
               "sparse_comm_stats": [], "comm_bytes": []}
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        for b in local[:ZERO_STAGE0_STEPS]:
            t0 = time.perf_counter()
            rec["losses"].append(float(eng.train_batch(b)))
            rec["ms"].append((time.perf_counter() - t0) * 1e3)
            digest = hashlib.sha256()
            for t in tree_flatten(eng.state.params)[0]:
                digest.update(t.detach().float().cpu().numpy().tobytes())
            rec["params_sha256"].append(digest.hexdigest())
            rec["sparse_comm_stats"].append(dict(eng.sparse_comm_stats))
            rec["comm_bytes"].append(eng.onebit_comm_bytes)
        torch.cuda.synchronize()
        rec["counts"] = ops.launch_counts()
        if mode == "onebit":
            w = hashlib.sha256()
            for t in eng.state.opt_state.worker_error:
                w.update(t.cpu().numpy().tobytes())
            rec["worker_error_sha256"] = w.hexdigest()
            rec["worker_error_abs_max"] = max(
                float(t.abs().max()) for t in eng.state.opt_state.worker_error)
        if rank == 0 and mode in ("s0", "sparse"):
            np.save(spec["params"].format(mode=mode),
                    torch.cat([t.detach().float().reshape(-1) for t in
                               tree_flatten(eng.state.params)[0]]
                              ).cpu().numpy())
        out[mode] = rec
        del eng
        torch.cuda.empty_cache()
    with open(spec["out"].format(rank=rank), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def train_zero(dev, smi):
    """Data parallelism and ZeRO stages 1, 2 and 3 at gpt2-small (the
    train recipe, bf16 with fp32 masters, dropout 0, gas 2 x 4 x 1024 a
    rank: the main path's global batch of 2 x 8 x 1024), as two
    processes on the one card joined by gloo (NCCL refuses two ranks on
    one device; gloo moves CUDA tensors through host memory). Each stage
    runs 5 steps (paths ``train_zero_s1`` .. ``_s3``, the launches of
    both ranks). Asserted: both ranks hold the same params bit for bit;
    stage 3 gives stage 2's losses, params and moments bit for bit; the
    first loss is within TRAIN_LOSS_RTOL of the world-1 step on the same
    global batch; every launch count is exactly the main path's a step
    and rank. Printed: each rank's step p50 and peak memory — the step
    times include gloo's staging of every collective through the host,
    so they are the host's, not what NCCL across cards would give."""
    cfg = _zero_cfg()
    batches = token_stream(cfg, ZERO_STEPS, seed=SEED + 5, seq=TRAIN_SEQ,
                           micro=TRAIN_MICRO)
    eng = make_engine(cfg, "bf16", micro=TRAIN_MICRO)
    ref_loss = float(eng.train_batch(batches[0]))
    del eng
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_zero_")
    try:
        np.save(os.path.join(tmp, "batches.npy"),
                np.stack([b.numpy() for b in batches]))
        spec = {"store": os.path.join(tmp, "store"),
                "batches": os.path.join(tmp, "batches.npy"),
                "out": os.path.join(tmp, "rank{rank}.json"),
                "params": os.path.join(tmp, "params_{mode}.npy")}
        with open(os.path.join(tmp, "spec.json"), "w") as f:
            json.dump(spec, f)
        t0 = time.perf_counter()
        logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+")
                for r in range(ZERO_DP)]
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--train-zero-rank",
             str(r), os.path.join(tmp, "spec.json")], stdout=logs[r],
            stderr=subprocess.STDOUT) for r in range(ZERO_DP)]
        try:
            rcs = [p.wait(timeout=600) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, lg in enumerate(logs):
            lg.seek(0)
            text = lg.read()
            lg.close()
            assert rcs[r] == 0, f"train_zero rank {r} failed:\n" + \
                text[-6000:]
        wall = time.perf_counter() - t0
        res = []
        for r in range(ZERO_DP):
            with open(spec["out"].format(rank=r)) as f:
                res.append(json.load(f))
        final = {mode: np.load(spec["params"].format(mode=mode))
                 for mode in ("s0", "sparse")}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    expect = per_train_step(cfg)
    counts, rec = {}, {"wall_s": wall}
    for stage in ZERO_STAGES:
        st = [x[str(stage)] for x in res]
        assert all(x["params_sha256"] == st[0]["params_sha256"]
                   for x in st), ("ranks differ", stage)
        assert all(x["losses"] == st[0]["losses"] for x in st), stage
        assert all(math.isfinite(l) for l in st[0]["losses"]), stage
        for x in st:
            want = {k: ZERO_STEPS * v for k, v in expect.items()}
            assert x["counts"] == want, (stage, x["counts"], want)
        counts[f"train_zero_s{stage}"] = {
            k: sum(x["counts"][k] for x in st) for k in st[0]["counts"]}
        rec[f"stage{stage}"] = {
            "losses": st[0]["losses"],
            "step_ms_p50_by_rank": [float(np.median(x["ms"][1:]))
                                    for x in st],
            "peak_gb_by_rank": [x["peak_bytes"] / 1e9 for x in st]}
    for x in res:
        for key in ("losses", "params_sha256", "moments_sha256"):
            assert x["2"][key] == x["3"][key], ("stage 3 != stage 2", key)
    rel = abs(res[0]["1"]["losses"][0] - ref_loss) / abs(ref_loss)
    rec.update({"first_loss_world1": ref_loss, "first_loss_rel": rel,
                "first_loss_rtol": TRAIN_LOSS_RTOL,
                "stage3_bit_equal_stage2": True, "ranks_bit_equal": True,
                "model": "gpt2-small", "dp": ZERO_DP,
                "precision": "bf16, fp32 masters",
                "per_rank_batch": f"{TRAIN_GAS} x {TRAIN_MICRO // ZERO_DP} x "
                                  f"{TRAIN_SEQ}",
                "note": "two ranks share one card through gloo, which "
                        "stages every collective through host memory: "
                        "the step times are the host's",
                "card": smi})
    assert rel <= TRAIN_LOSS_RTOL, rec
    emit({"train_zero": rec})

    # 1-bit Adam and sparse gradients at dp 2, beside dense stage 0.
    no_adam = dict(expect, sqnorm=0, fused_adam_apply=0)
    stage0 = {"card": smi, "dp": ZERO_DP, "steps": ZERO_STAGE0_STEPS,
              "onebit_freeze_step": ZERO_ONEBIT_FREEZE}
    for mode in ZERO_STAGE0_MODES:
        st = [x[mode] for x in res]
        assert all(x["params_sha256"] == st[0]["params_sha256"]
                   for x in st), ("ranks differ after a step", mode)
        assert all(math.isfinite(l) for l in st[0]["losses"]), mode
        want = {k: ZERO_STAGE0_STEPS * v for k, v in
                (no_adam if mode == "onebit" else expect).items()}
        for x in st:
            assert x["counts"] == want, (mode, x["counts"], want)
        counts[f"train_zero_{mode}"] = {
            k: sum(x["counts"][k] for x in st) for k in st[0]["counts"]}
        stage0[mode] = {
            "losses": st[0]["losses"],
            "step_ms_p50_by_rank": [float(np.median(x["ms"][1:]))
                                    for x in st],
            "ranks_bit_equal_every_step": True}
    ob = [x["onebit"] for x in res]
    assert ob[0]["worker_error_sha256"] != ob[1]["worker_error_sha256"], \
        "the ranks' worker errors should differ after the freeze"
    assert all(x["worker_error_abs_max"] > 0 for x in ob)
    stage0["onebit"]["comm_bytes_by_step"] = ob[0]["comm_bytes"]
    stage0["onebit"]["worker_errors_differ"] = True
    sp = res[0]["sparse"]
    stage0["sparse"]["sparse_comm_stats_by_step"] = sp["sparse_comm_stats"]
    diff = float(np.abs(final["sparse"] - final["s0"]).max())
    stage0["sparse_vs_s0"] = {
        "max_abs_param_diff": diff,
        "bit_equal": bool(np.array_equal(final["sparse"], final["s0"])),
        "losses_equal": sp["losses"] == res[0]["s0"]["losses"],
        "tolerance": SPARSE_VS_DENSE_ATOL,
        "why": "two ranks' terms add to the same bits in either order, "
               "and the 1/dp is a power of two: bit-equal expected"}
    emit({"train_zero_stage0": stage0})
    assert diff <= SPARSE_VS_DENSE_ATOL, stage0["sparse_vs_s0"]
    return counts


# --------------------------------------------------------------------- #
# Phase 5f: ZeRO-Offload (the host Adam, then the offload path)
# --------------------------------------------------------------------- #
OFFLOAD_CONFIG = os.path.join("examples", "gpt2", "ds_config_offload.json")
OFFLOAD_STEPS, OFFLOAD_DEVICE_STEPS, OFFLOAD_FP16_STEPS = 10, 5, 5
# The offload step against the device-optimizer step (K5/K6 on the card)
# from the same init and batches: the first loss bit-equal (the same
# params and dropout draws before any update), the first 5 within this
# relative gap (the two Adams differ by fp32 ulps each step); the device
# engine's fp32 masters and moments (12 B a parameter, 1.494 GB at
# gpt2-small) that offload keeps in host memory, less slack for the
# allocator's rounding.
OFFLOAD_LOSS_RTOL = 1e-2
# The fp16 runs' initial loss scale: this recipe's first two steps
# overflow at 2^20 (one skip holds the scale by the hysteresis, the next
# halves it) and its later steps are taken.
OFFLOAD_FP16_SCALE_POWER = 20
OFFLOAD_PEAK_SAVING = 1.4e9
# The host Adam's step: p, m, v read and written (24 B), bf16 grads read
# and the bf16 copy written (4 B) a parameter.
HOST_ADAM_BYTES = 28
# Its hyper-parameters in check_cpu_adam: the example's AdamW lr, a
# weight decay so the decoupled decay runs, a mid-run tick and a grad
# scale (unscale x clip).
CPU_ADAM_HP = dict(lr=3e-3, betas=(0.9, 0.999), eps=1e-8,
                   weight_decay=0.01)
CPU_ADAM_STEP, CPU_ADAM_SCALE = 10, 0.5
# The host Adam's timed runs (each followed by one pass of each rate
# probe).
HOST_ADAM_REPS = 7


def host_info():
    """The host's CPU model, its cores and OpenMP's default team (the
    host Adam's serial team)."""
    from deepspeed_tpu_torch.ops import cpu_adam as ca
    model = "unknown"
    with open("/proc/cpuinfo") as f:
        for line in f:
            if line.startswith("model name"):
                model = line.split(":", 1)[1].strip()
                break
    # (where /proc/cpuinfo names no model, the target g++ -march=native
    # resolves to says what the host kernel was built for)
    target = subprocess.run(
        [op_builder.find_cxx(), "-march=native", "-Q", "--help=target"],
        capture_output=True, text=True, timeout=60).stdout
    march = re.search(r"-march=\s+(\S+)", target)
    return {"cpu_model": model, "march_native": march and march.group(1),
            "cpu_count": os.cpu_count(),
            "omp_default_threads": ca.default_threads()}


class HostRates:
    """The host's memory rate, bytes a second: the fastest rate at which
    anything in ``check_cpu_adam`` moved the Adam step's bytes, or a
    stream of their kind. ``probe()`` runs three streams once each over
    ``n``-parameter buffers of their own: the step's traffic with an add
    for its arithmetic (``ds_stream_adam_traffic``, 28 B a parameter, on
    the calling thread's OpenMP team, the host Adam's), a read of one fp32
    span (``ds_stream_read``, 4 B) and a ``torch`` copy of one (8 B). The
    caller interleaves the probes with the kernel's runs, so both see the
    same host, and adds the runs that move the step's own bytes (the
    kernel's, the library's) with ``seen``. Each entry keeps its fastest
    pass; ``best`` is the fastest entry and ``best_by`` names it. On a
    host shared with other machines' work no stream is reliably faster
    than the kernel (a first version bounded by the streams alone was
    beaten by 12%), so the kernel's own fastest pass is in the maximum:
    its median time cannot beat the bound it gives."""

    def __init__(self, grad_bf16):
        from deepspeed_tpu_torch.ops import cpu_adam as ca
        self.lib = ca.native_lib()
        self.n = grad_bf16.numel()
        self.g = grad_bf16
        self.p, self.m, self.v = (torch.zeros(self.n) for _ in range(3))
        self.copy = torch.empty(self.n, dtype=torch.bfloat16)
        self.rates = {"adam_traffic": 0.0, "read": 0.0, "torch_copy": 0.0}

    def seen(self, name, moved, sec):
        """Keep ``moved`` bytes in ``sec`` seconds as a pass of ``name``."""
        self.rates[name] = max(self.rates.get(name, 0.0), moved / sec)

    def probe(self):
        n, lib = self.n, self.lib
        t0 = time.perf_counter()
        lib.ds_stream_adam_traffic(self.p.data_ptr(), self.g.data_ptr(),
                                   self.m.data_ptr(), self.v.data_ptr(),
                                   self.copy.data_ptr(), n)
        t1 = time.perf_counter()
        lib.ds_stream_read(self.m.data_ptr(), n)
        t2 = time.perf_counter()
        self.v.copy_(self.m)
        t3 = time.perf_counter()
        self.seen("adam_traffic", HOST_ADAM_BYTES * n, t1 - t0)
        self.seen("read", 4 * n, t2 - t1)
        self.seen("torch_copy", 8 * n, t3 - t2)

    def result(self):
        best_by = max(self.rates, key=self.rates.get)
        return dict(self.rates, best=self.rates[best_by], best_by=best_by)


def check_cpu_adam(smi):
    """The host Adam (``ops/cpu_adam.py`` over ``csrc/cpu_adam.cpp``,
    built by g++ for this host) at gpt2-small's 124,475,904 parameters,
    bf16 grads with the bf16 copy (``ds_adam_step_plus_copy_bf16g``, the
    offload path's entry point): as one flat span and as its 16 stacked
    leaves (the largest [12, 768, 3072], 113 MB of fp32), from a mid-run
    state. Held: masters and moments within 4 fp32 ulp of the largest
    term of their last add against the plain step (``adam_ulp_gaps``),
    the bf16 copy bit-equal to the masters' cast, the leaves run bit-equal
    to the flat one, the squared norm (on the host Adam's team, as the
    offload step runs it at its default pool width) the same bits on two
    calls and within 1e-12 relative of the plain fp64 sum. Timed on the
    host's clock: the step (median of HOST_ADAM_REPS after the checked
    one), the plain step, the norm on that team and on one thread, and
    ``torch._fused_adamw_`` on fp32 CPU tensors (no bf16 copy) where this
    torch has it; the bound is 28 B a parameter over the host's memory
    rate (``HostRates``: the fastest rate at which this run moved those
    bytes, by a stream probed between the step's runs, the step itself
    or the library call)."""
    from deepspeed_tpu_torch.ops import cpu_adam as ca
    sizes = gpt2_leaf_sizes(GPT2_CONFIGS["gpt2-small"])
    n = sum(sizes)
    g = torch.Generator().manual_seed(SEED)
    p0 = torch.randn(n, generator=g) * 0.02
    m0 = torch.randn(n, generator=g) * 1e-3
    v0 = (torch.randn(n, generator=g) * 1e-3) ** 2
    grad = (torch.randn(n, generator=g) * 1e-2).to(torch.bfloat16)
    kw = dict(step=CPU_ADAM_STEP, grad_scale=CPU_ADAM_SCALE)

    def split(buf, shapes):
        out, off = [], 0
        for k in shapes:
            out.append(buf[off:off + k])
            off += k
        return out

    rates = HostRates(grad)
    runs = {}
    for layout, shapes in (("flat", [n]), ("leaves", sizes)):
        p, m, v = p0.clone(), m0.clone(), v0.clone()
        copy = torch.empty(n, dtype=torch.bfloat16)
        pl, gl, cl = split(p, shapes), split(grad, shapes), split(copy,
                                                                  shapes)
        opt = ca.DeepSpeedCPUAdam(pl, **CPU_ADAM_HP)
        opt.exp_avg, opt.exp_avg_sq = split(m, shapes), split(v, shapes)
        ca.reset_host_launch_counts()
        t0 = time.perf_counter()
        opt.step_leaves(pl, gl, range(len(shapes)), bf16_out=cl, **kw)
        first_ms = (time.perf_counter() - t0) * 1e3
        calls = ca.host_launch_counts()["cpu_adam_step"]
        runs[layout] = (p, m, v, copy, opt, pl, gl, cl, first_ms, calls)
    p, m, v, copy, opt, pl, gl, cl, _, _ = runs["flat"]
    for x, y in zip(runs["flat"][:4], runs["leaves"][:4]):
        assert torch.equal(x.view(torch.int16) if x.dtype ==
                           torch.bfloat16 else x, y.view(torch.int16)
                           if y.dtype == torch.bfloat16 else y), \
            "leaves != flat"
    gaps = ca.adam_ulp_gaps(p0, grad, m0, v0, p, m, v, **kw, **CPU_ADAM_HP)
    copy_equal = torch.equal(copy.view(torch.int16),
                             p.to(torch.bfloat16).view(torch.int16))
    assert max(gaps.values()) <= 4 and copy_equal, (gaps, copy_equal)
    recs = []
    for layout, (p, m, v, copy, opt, pl, gl, cl, first, calls) in \
            runs.items():
        ms = []
        for _ in range(HOST_ADAM_REPS):
            t0 = time.perf_counter()
            opt.step_leaves(pl, gl, range(len(pl)), bf16_out=cl, **kw)
            sec = time.perf_counter() - t0
            ms.append(sec * 1e3)
            rates.seen("kernel", HOST_ADAM_BYTES * n, sec)
            rates.probe()
        recs.append({"layout": layout, "leaves": len(pl),
                     "calls_a_step": calls, "first_ms": first,
                     "ms": float(np.median(ms)), "ms_all": ms})
    del runs, p, m, v, copy, opt, pl, gl, cl
    pp, mp, vp = p0.clone(), m0.clone(), v0.clone()
    t0 = time.perf_counter()
    ca.cpu_adam_plain(pp, grad, mp, vp, **kw, **CPU_ADAM_HP)
    plain_ms = (time.perf_counter() - t0) * 1e3
    del pp, mp, vp
    nopt = ca.DeepSpeedCPUAdam([torch.zeros(1)])
    norm_ms, sqs = {}, {}
    for team in (nopt.threads, 1):
        t0 = time.perf_counter()
        sqs[team] = nopt.grad_norm_sq([grad], CPU_ADAM_SCALE, threads=team)
        norm_ms[team] = (time.perf_counter() - t0) * 1e3
    sq = sqs[nopt.threads]
    assert nopt.grad_norm_sq([grad], CPU_ADAM_SCALE) == sq
    sq_plain = ca.grad_norm_sq_plain(grad, CPU_ADAM_SCALE)
    assert abs(sq - sq_plain) <= 1e-12 * sq_plain, (sq, sq_plain)
    library_ms, library_note = None, None
    fused = getattr(torch, "_fused_adamw_", None)
    if fused is not None:
        lp, lm, lv = p0.clone(), m0.clone(), v0.clone()
        lg = grad.float()
        steps = torch.tensor(float(CPU_ADAM_STEP))
        lib_ms = []
        try:
            for _ in range(3):
                t0 = time.perf_counter()
                fused([lp], [lg], [lm], [lv], [], [steps],
                      lr=CPU_ADAM_HP["lr"], beta1=CPU_ADAM_HP["betas"][0],
                      beta2=CPU_ADAM_HP["betas"][1],
                      weight_decay=CPU_ADAM_HP["weight_decay"],
                      eps=CPU_ADAM_HP["eps"], amsgrad=False, maximize=False)
                sec = time.perf_counter() - t0
                lib_ms.append(sec * 1e3)
                # (fp32 grads read, p, m, v read and written: 28 B too)
                rates.seen("library", HOST_ADAM_BYTES * n, sec)
            library_ms = float(np.median(lib_ms))
        except (RuntimeError, NotImplementedError) as e:
            library_note = f"torch._fused_adamw_ on CPU tensors: {e}"[:200]
        del lp, lm, lv, lg
    else:
        library_note = "this torch has no torch._fused_adamw_"
    rates = rates.result()
    bound_ms = HOST_ADAM_BYTES * n / rates["best"] * 1e3
    flat = recs[0]
    rec = {"name": "cpu_adam", "route": "host C++ (g++ " + " ".join(
               f for f in op_builder.HOST_FLAGS if f.startswith(
                   ("-O", "-f", "-m"))) + ")",
           "source": "deepspeed_tpu_torch/csrc/cpu_adam.cpp",
           "replaces": "csrc/cpu_adam.cpp:122 ds_adam_step_plus_copy_bf16g "
                       "(the JAX package's host kernel; no TPU kernel)",
           "shape": [n], "max_ulp": gaps, "bf16_copy_bit_equal": copy_equal,
           "ms": flat["ms"], "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": "bytes", "library_ms": library_ms,
           "bound_note": "the step's 28 B a parameter over the fastest "
                         "rate this run moved them or a stream of their "
                         "kind (HostRates: three streams interleaved with "
                         "the step's runs, the step's own passes and "
                         "torch._fused_adamw_'s; best_by names the "
                         "fastest): a measured rate, not the host's "
                         "stated peak",
           "bound_set_by": rates["best_by"],
           "library": "torch._fused_adamw_ (fp32 grads, no bf16 copy)",
           "library_note": library_note,
           "norm_ms": norm_ms[nopt.threads],
           "norm_ms_one_thread": norm_ms[1],
           "norm_threads": nopt.threads, "by_layout": recs,
           "host_bytes_per_s": rates,
           "bytes_per_param": HOST_ADAM_BYTES, "host": host_info(),
           "card": smi}
    emit({"check_cpu_adam": rec})
    return rec


def offload_config(precision="bf16", overlap=False, offload=True):
    """``examples/gpt2/ds_config_offload.json`` as the file has it, with
    ``overlap_comm`` set, ``cpu_offload`` off for the device-optimizer
    yardstick, or fp16 (from OFFLOAD_FP16_SCALE_POWER) in place of
    bf16."""
    with open(OFFLOAD_CONFIG) as f:
        ds = json.load(f)
    zero = ds["zero_optimization"]
    if overlap:
        zero["overlap_comm"] = True
    if not offload:
        del zero["cpu_offload"]
    if precision == "fp16":
        del ds["bf16"]
        ds["fp16"] = {"enabled": True,
                      "initial_scale_power": OFFLOAD_FP16_SCALE_POWER}
    return ds


def offload_engine(cfg, ds):
    dev = torch.device("cuda")
    params = gpt2_init(cfg, torch.Generator(device=dev).manual_seed(SEED))
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=gpt2_loss_fn(cfg), model_params=params, config=ds, rng=SEED)
    return eng


def run_offload(eng, batches):
    """``run_path`` with the host kernel's calls and each step's
    ``offload_timings``; the peak device memory from the engine's
    construction on (the caller resets it before)."""
    from deepspeed_tpu_torch.ops import cpu_adam as ca
    ca.reset_host_launch_counts()
    starts = [torch.cuda.Event(enable_timing=True) for _ in batches]
    ends = [torch.cuda.Event(enable_timing=True) for _ in batches]
    losses, metrics, timings = [], [], []
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    for b, st, en in zip(batches, starts, ends):
        st.record()
        losses.append(eng.train_batch(b))
        en.record()
        metrics.append(eng.last_metrics)
        timings.append(dict(eng.offload_timings or {}))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    counts.update(ca.host_launch_counts())
    return {"losses": [float(l) for l in losses], "metrics": metrics,
            "timings": timings, "counts": counts,
            "ms": [s.elapsed_time(e) for s, e in zip(starts, ends)],
            "peak_bytes": torch.cuda.max_memory_allocated()}


def offload_state(eng):
    """Host copies of the offload engine's masters, moments and device
    params."""
    off = eng._offload
    return [t.clone() for t in off.masters + off.opt.exp_avg +
            off.opt.exp_avg_sq] + [t.detach().cpu() for t in
                                   tree_flatten(eng.state.params)[0]]


def fresh_card():
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def train_offload(dev, smi, host_adam):
    """ZeRO-Offload at gpt2-small (full width and depth, seed 0, dropout
    0.1, the train recipe's seeded Markov stream at the example's batch
    of 8 x 1024) under ``examples/gpt2/ds_config_offload.json`` read from
    the file: bf16, stage 2, the fp32 masters and Adam moments in host
    memory, AdamW 3e-3, clip 1.0. First the device-optimizer engine (the
    same config without ``cpu_offload``: K5/K6 on the card) takes 5
    steps; then the serial offload engine 10 (path ``train_offload``),
    the overlapped one (``overlap_comm``) the same 10 from the same init
    (``train_offload_overlap``), and 5 fp16 steps each way from
    initial_scale_power 20 (``train_offload_fp16``,
    ``train_offload_fp16_overlap``). Asserted: serial and overlapped give
    bit-equal losses, masters, moments and device params;
    ``overlap_fraction`` > 0 at every overlapped step after the first
    (which starts the pool); the fp16 runs skip
    at least one step with equal scale sequences and bit-equal losses;
    the loss falls (the last 3 of 10 below the first 3); the first loss
    equals the device engine's and the first 5 are within
    OFFLOAD_LOSS_RTOL of its; the peak device memory is at least
    OFFLOAD_PEAK_SAVING below the device engine's; the launches a step
    are exactly the main path's kernels at gas 1 with no K5/K6, and 16
    host Adam calls (one a leaf) and 16 norm calls. Printed: step ms
    p50 each way, the mean ``offload_timings`` breakdown (steps 2-10),
    the peaks, and the host Adam's time in the step against its
    bound."""
    cfg = GPT2_CONFIGS["gpt2-small"]
    ds = offload_config()
    micro = ds["train_batch_size"]
    batches = token_stream(cfg, OFFLOAD_STEPS, seq=TRAIN_SEQ,
                           micro=micro // TRAIN_GAS)
    expect = {k: v // TRAIN_GAS for k, v in per_train_step(cfg).items()}
    expect.update(sqnorm=0, fused_adam_apply=0)
    leaves = len(gpt2_leaf_sizes(cfg))
    counts, host_counts, runs = {}, {}, {}

    fresh_card()
    eng = offload_engine(cfg, offload_config(offload=False))
    assert eng._offload is None
    runs["device"] = run_offload(eng, batches[:OFFLOAD_DEVICE_STEPS])
    del eng
    fresh_card()
    eng = offload_engine(cfg, ds)
    assert eng._offload is not None and not eng._offload_overlap
    num_buckets = eng._offload.num_buckets()
    runs["serial"] = run_offload(eng, batches)
    serial_state = offload_state(eng)
    del eng
    fresh_card()
    eng = offload_engine(cfg, offload_config(overlap=True))
    assert eng._offload_overlap
    runs["overlap"] = run_offload(eng, batches)
    for a, b in zip(serial_state, offload_state(eng)):
        assert torch.equal(a, b), "serial and overlapped states differ"
    del eng, serial_state
    assert runs["serial"]["losses"] == runs["overlap"]["losses"], runs
    fracs = [t["overlap_fraction"] for t in runs["overlap"]["timings"]]
    assert min(fracs[1:]) > 0, fracs

    cfg16 = dataclasses.replace(cfg, dtype=torch.float16)
    fp16 = {}
    for name, overlap in (("fp16", False), ("fp16_overlap", True)):
        fresh_card()
        eng = offload_engine(cfg16, offload_config("fp16", overlap))
        runs[name] = run_offload(eng, batches[:OFFLOAD_FP16_STEPS])
        fp16[name] = {"scales": [float(m["loss_scale"])
                                 for m in runs[name]["metrics"]],
                      "skipped": int(eng.skipped_steps),
                      "losses": runs[name]["losses"]}
        del eng
    torch.cuda.empty_cache()
    assert fp16["fp16"] == fp16["fp16_overlap"], fp16
    assert fp16["fp16"]["skipped"] >= 1, fp16
    assert all(math.isfinite(l) for l in fp16["fp16"]["losses"]), fp16

    ser, dvc = runs["serial"], runs["device"]
    losses = ser["losses"]
    assert all(math.isfinite(l) for l in losses), losses
    first, last = float(np.mean(losses[:3])), float(np.mean(losses[-3:]))
    assert last < first, (first, last)
    assert losses[0] == dvc["losses"][0], (losses[0], dvc["losses"][0])
    rel = [abs(a - b) / abs(b) for a, b in zip(
        losses[:OFFLOAD_DEVICE_STEPS], dvc["losses"])]
    assert max(rel) <= OFFLOAD_LOSS_RTOL, rel
    saving = dvc["peak_bytes"] - ser["peak_bytes"]
    assert saving >= OFFLOAD_PEAK_SAVING, (dvc["peak_bytes"],
                                           ser["peak_bytes"])
    for name in ("serial", "overlap", "fp16", "fp16_overlap"):
        r = runs[name]
        steps = len(r["losses"])
        taken = steps - (fp16[name]["skipped"] if name in fp16 else 0)
        want = {k: steps * v for k, v in expect.items()}
        want.update(cpu_adam_step=taken * leaves,
                    cpu_adam_norm=steps * leaves)
        assert r["counts"] == want, (name, r["counts"], want)
        path = "train_offload" + ("" if name == "serial" else "_" + name)
        counts[path] = {k: v for k, v in r["counts"].items()
                        if not k.startswith("cpu_adam")}
        host_counts[path] = {k: v for k, v in r["counts"].items()
                             if k.startswith("cpu_adam")}
    keys = ("device_step_ms", "d2h_ms", "host_norm_ms", "host_step_ms",
            "h2d_dispatch_ms", "h2d_wait_ms", "pipeline_span_ms",
            "pipeline_work_ms", "overlap_fraction", "wall_ms")

    def breakdown(r):
        return {k: float(np.mean([t[k] for t in r["timings"][1:]]))
                for k in keys}
    n_params = gpt2_num_params(cfg)
    rec = {"config": OFFLOAD_CONFIG, "model": "gpt2-small",
           "batch": [1, micro, TRAIN_SEQ], "dropout": cfg.hidden_dropout,
           "steps": OFFLOAD_STEPS, "num_buckets": num_buckets,
           "losses": losses, "loss_first3_mean": first,
           "loss_last3_mean": last,
           "device_optimizer_losses": dvc["losses"],
           "first_loss_equal": True, "loss_rel_first5": rel,
           "serial_overlap_bit_equal": True,
           "step_ms_p50": {k: float(np.median(runs[k]["ms"][1:]))
                           for k in ("serial", "overlap", "device")},
           "breakdown_mean_steps_2_on": {k: breakdown(runs[k])
                                         for k in ("serial", "overlap")},
           "overlap_fraction_by_step": fracs,
           "omp_threads": runs["overlap"]["timings"][-1].get("omp_threads"),
           "peak_gb": {k: runs[k]["peak_bytes"] / 1e9
                       for k in ("device", "serial", "overlap")},
           "peak_saving_gb": saving / 1e9,
           "fp16": fp16, "launches_per_step": expect,
           "host_adam_calls_per_step": leaves,
           "host_adam_bound_ms": HOST_ADAM_BYTES * n_params /
           host_adam["host_bytes_per_s"]["best"] * 1e3,
           "host_adam_kernel_ms": host_adam["ms"],
           "host": host_adam["host"], "card": smi}
    emit({"train_offload": rec})
    return counts, host_counts


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
        "tile_qwiden_widen": list(sparse_path_tile(
            layout, SPARSE_MICRO, SPARSE_SEQ, cfg.num_heads, True, dev)),
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


# --------------------------------------------------------------------- #
# Phase 5g: activation recomputation and progressive layer drop
# --------------------------------------------------------------------- #
def per_remat_step(cfg, policy, expect=None):
    """Launches of one train step under ``policy``: the step's own, plus
    the forward kernels the backward re-runs a layer and micro-batch —
    both LayerNorms (K3f) and the GELU (K4f) under every policy but
    ``none``, the flash forward (K1) under all but ``none`` and
    ``dots_flash`` (models/remat.py)."""
    c = dict(expect or per_train_step(cfg))
    if policy != "none":
        n = TRAIN_GAS * cfg.num_layers
        for name in ("fused_layer_norm", "fused_residual_layer_norm",
                     "fused_bias_gelu"):
            c[name] += n if c[name] else 0
        if policy != "dots_flash":
            c["flash_attention_fwd"] += n
    return c


KERNEL_ALIASES = (("K1", ("flash_attention_fwd",)),
                  ("K3f", ("fused_layer_norm", "fused_residual_layer_norm")),
                  ("K4f", ("fused_bias_gelu",)),
                  ("K2c", ("flash_attention_bwd_fused",)),
                  ("K3b", ("layer_norm_backward",)),
                  ("K4b", ("bias_gelu_backward",)),
                  ("K9", ("grouped_matmul",)))


def by_kernel(counts, steps):
    return {k: sum(counts[w] for w in ws) / steps for k, ws in KERNEL_ALIASES}


def check_checkpoint_api(dev, smi):
    """``checkpointing.checkpoint`` with ``cpu_checkpointing`` on CUDA
    tensors at the medium path's activation shape (8 x 1024 x 1024,
    bf16): the held input sits in pinned host memory, the card frees it
    once the caller drops it, and the gradients equal the plain call's
    bit for bit (the recompute replays the CUDA generator's draws)."""
    from deepspeed_tpu_torch.runtime.activation_checkpointing import \
        checkpointing as ck
    g = torch.Generator(device=dev).manual_seed(SEED)
    H = 1024
    w = (torch.randn(H, H, device=dev, generator=g) * H ** -0.5).to(
        torch.bfloat16).requires_grad_()
    x0 = torch.randn(TRAIN_MICRO, TRAIN_SEQ, H, device=dev, generator=g).to(
        torch.bfloat16).requires_grad_()

    def fn(w, x):
        h = torch.tanh(x @ w)
        return (h * (torch.rand(h.shape, device=h.device) < 0.9)).float() \
            .square().sum()

    def grads(call):
        torch.manual_seed(SEED)
        x = x0 * 1.0
        out = call(w, x)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        del x
        torch.cuda.synchronize()
        freed = before - torch.cuda.memory_allocated()
        torch.manual_seed(SEED + 1)
        return out.detach(), torch.autograd.grad(out, (w, x0)), freed

    ck.reset()
    ck.configure(checkpoint_in_cpu=True)
    try:
        wrapped = ck.checkpoint_wrapper(fn)
        out, gr, freed = grads(wrapped)
        saved = wrapped.last_saved
        out_p, gp, freed_p = grads(fn)
    finally:
        ck.reset()
    rec = {"shape": [TRAIN_MICRO, TRAIN_SEQ, H], "dtype": "bf16",
           "saved": saved, "card_bytes_freed_when_the_input_is_dropped":
           freed, "plain_call_bytes_freed": freed_p,
           "input_bytes": x0.numel() * 2,
           "grads_bit_equal": all(torch.equal(a, b) for a, b in
                                  zip(gr, gp)) and torch.equal(out, out_p),
           "card": smi}
    emit({"activation_checkpointing_api": rec})
    assert rec["grads_bit_equal"], rec
    assert {s[1] for s in saved} == {"cpu"} and all(s[3] for s in saved), \
        saved
    assert freed >= x0.numel() * 2 and freed_p == 0, rec


def train_remat(dev, smi):
    """gpt2-medium (H 1024, 16 heads of 64, 24 layers, FFN 4096, vocab
    50304) through ``initialize`` → ``train_batch`` on the main path's
    recipe (bf16, fp32 masters, AdamW, WarmupLR, clip 1.0, gas 2 x 8 x
    1024, dropout 0.1, flash attention): 2 warm-up and 6 timed steps
    under each of the five remat policies from the same params and token
    stream (losses bit-equal across the policies, exact launches, full's
    peak under none's by ``REMAT_PEAK_SAVING``, step ms, peak, device
    busy ms from one profiled step); then ``train_pld`` (10 steps, PLD_BLOCK: K1 launches equal
    the kept layers summed over the micro-steps, known on the host, 0
    host syncs, the loss falls); then MoE (the train_moe block at
    gpt2-small) under ``full`` against ``none`` (3 steps each: equal
    losses and moe_* metrics, K9 up by the recompute's two forward
    launches a layer and micro-batch); then the checkpointing API. Each
    run is its own path."""
    from deepspeed_tpu_torch.models import transformer as tt
    cfg = GPT2_CONFIGS["gpt2-medium"]
    n_steps = REMAT_WARMUP + REMAT_STEPS
    batches = token_stream(cfg, max(n_steps, PLD_STEPS) + 1)
    tokens_per_step = TRAIN_GAS * TRAIN_MICRO * TRAIN_SEQ
    counts, runs = {}, {}
    for policy in REMAT_POLICIES:
        eng = make_engine(dataclasses.replace(cfg, remat_policy=policy),
                          "bf16")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        path = f"train_remat_{policy}"
        losses, metrics, ms, counts[path] = run_path(eng, batches[:n_steps])
        peak = torch.cuda.max_memory_allocated()
        expect = per_remat_step(cfg, policy)
        assert counts[path] == {k: n_steps * v
                                for k, v in expect.items()}, \
            (policy, counts[path], expect)
        prof = profile_train_steps(eng, batches[n_steps:n_steps + 1])
        syncs = count_host_syncs(eng, batches[:1]) if policy == "full" \
            else None
        step_ms = float(np.median(ms[REMAT_WARMUP:]))
        runs[policy] = {
            "losses": losses, "step_ms_p50": step_ms, "step_ms_all": ms,
            "tokens_per_s": tokens_per_step / (step_ms / 1e3),
            "peak_memory_gb": peak / 1e9,
            "launches_per_step": by_kernel(counts[path], n_steps),
            "device_busy_ms_per_step": prof["device_busy_ms_per_step"],
            "idle_share_of_step_p50":
                1 - prof["device_busy_ms_per_step"] / step_ms,
            "device_ms_per_step_by_group":
                prof["device_ms_per_step_by_group"]}
        if syncs is not None:
            runs[policy]["host_syncs"] = syncs
            assert syncs["host_syncs"] == 0, syncs
        del eng
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    out = {"model": "gpt2-medium", "precision": "bf16, fp32 masters",
           "batch": [TRAIN_GAS, TRAIN_MICRO, TRAIN_SEQ],
           "steps": n_steps, "timed_steps": REMAT_STEPS,
           "dropout": cfg.hidden_dropout,
           "step_ms_of": "the p50 of the steps after the warm-up",
           "peak_memory_of": "the steps of each policy (reset before)",
           "peak_saving_floor_gb": REMAT_PEAK_SAVING / 1e9,
           "policies": runs, "card": smi}
    emit({"train_remat": out})
    for policy in REMAT_POLICIES[1:]:
        assert runs[policy]["losses"] == runs["none"]["losses"], \
            (policy, runs[policy]["losses"], runs["none"]["losses"])
    assert all(math.isfinite(l) for l in runs["none"]["losses"])
    assert runs["full"]["peak_memory_gb"] * 1e9 <= \
        runs["none"]["peak_memory_gb"] * 1e9 - REMAT_PEAK_SAVING, runs

    # Progressive layer drop: the keep draws are the host's. The model is
    # gpt2_loss_fn behind a wrapper that reads, from the generator each
    # call gets, the layers that call keeps (pld_keep does not advance
    # it).
    inner, kept = gpt2_loss_fn(cfg), []

    def loss_fn(params, batch, rng=None, pld_theta=None):
        keep = tt.pld_keep(cfg.num_layers, pld_theta, rng)
        kept.append([i for i, k in enumerate(keep) if k])
        return inner(params, batch, rng, pld_theta=pld_theta)
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=loss_fn, model_params=gpt2_init(
            cfg, torch.Generator(device=dev).manual_seed(SEED)),
        config=dict(train_config("bf16", PLD_STEPS),
                    progressive_layer_drop=PLD_BLOCK), rng=SEED)
    assert eng._accepts_pld
    kept_steps, k1 = [], []
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(PLD_STEPS)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(PLD_STEPS)]
    losses = []
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    for b, st, en in zip(batches[:PLD_STEPS], starts, ends):
        kept.clear()
        before = ops.launch_counts()["flash_attention_fwd"]
        st.record()
        losses.append(eng.train_batch(b))
        en.record()
        kept_steps.append(list(kept))
        k1.append(ops.launch_counts()["flash_attention_fwd"] - before)
    torch.cuda.synchronize()
    counts["train_pld"] = ops.launch_counts()
    losses = [float(l) for l in losses]
    ms = [a.elapsed_time(b) for a, b in zip(starts, ends)]
    syncs = count_host_syncs(eng, batches[PLD_STEPS:PLD_STEPS + 1])
    n_kept = [sum(len(k) for k in ks) for ks in kept_steps]
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[5:]))
    pld = {"model": "gpt2-medium", "block": PLD_BLOCK, "steps": PLD_STEPS,
           "theta_by_step": [eng.progressive_layer_drop.theta_at(t)
                             for t in range(PLD_STEPS)],
           "kept_layers_by_step_and_micro_step": kept_steps,
           "kept_layers_per_step": n_kept, "k1_launches_per_step": k1,
           "losses": losses, "loss_first5_mean": first,
           "loss_last5_mean": last, "step_ms_p50": float(np.median(ms[1:])),
           "step_ms_all": ms, "host_syncs": syncs, "card": smi}
    emit({"train_pld": pld})
    assert k1 == n_kept, (k1, n_kept)
    assert all(len(ks) == TRAIN_GAS for ks in kept_steps), kept_steps
    assert sum(n_kept) < PLD_STEPS * TRAIN_GAS * cfg.num_layers, n_kept
    assert syncs["host_syncs"] == 0, syncs
    assert all(math.isfinite(l) for l in losses) and last < first, losses
    del eng
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # MoE under full against none.
    extra = {"moe": moe_block()}
    ds_moe = DeepSpeedConfig(dict(train_config("bf16", REMAT_MOE_STEPS),
                                  **extra)).moe_config
    mcfg = dataclasses.replace(GPT2_CONFIGS["gpt2-small"],
                               moe=MoEConfig.from_ds_config(ds_moe))
    mbatches = token_stream(mcfg, REMAT_MOE_STEPS)
    moe = {}
    for policy in ("none", "full"):
        eng = make_engine(dataclasses.replace(mcfg, remat_policy=policy),
                          "bf16", extra=extra)
        path = f"train_remat_moe_{policy}"
        losses, metrics, ms, counts[path] = run_path(eng, mbatches)
        moe[policy] = {
            "losses": losses, "step_ms_all": ms,
            "k9_launches_per_step": counts[path]["grouped_matmul"] /
            REMAT_MOE_STEPS,
            "moe_metrics": [{k: (v.tolist() if v.dim() else float(v))
                             for k, v in m.items() if k.startswith("moe_")}
                            for m in metrics]}
        del eng
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    emit({"train_remat_moe": dict(moe, model="gpt2-small, 8 experts top-2",
                                  steps=REMAT_MOE_STEPS, card=smi)})
    expect = per_moe_step(mcfg)
    assert counts["train_remat_moe_none"] == {
        k: REMAT_MOE_STEPS * v for k, v in expect.items()}
    full_expect = per_remat_step(mcfg, "full", expect)
    full_expect["grouped_matmul"] += 2 * TRAIN_GAS * mcfg.num_layers
    assert counts["train_remat_moe_full"] == {
        k: REMAT_MOE_STEPS * v for k, v in full_expect.items()}, \
        (counts["train_remat_moe_full"], full_expect)
    assert moe["full"]["losses"] == moe["none"]["losses"], moe
    assert moe["full"]["moe_metrics"] == moe["none"]["moe_metrics"], moe

    check_checkpoint_api(dev, smi)
    return counts


# train_api (slice 6e): the reference's training API at gpt2-small on the
# main path's recipe. The trio and train_batch 6 steps each, interleaved
# step by step from the same init; the trio's peak (above what a step
# starts with) within this share of train_batch's.
API_STEPS, API_PEAK_SHARE = 6, 0.02
# The optimizer matrix: 10 steps each from the same init and token
# stream, each with WarmupLR to its own lr (10 warm-up steps, as the
# recipe). The ds_config default lr (1e-3) is not what these optimizers
# train gpt2-small with; the lrs are chosen per optimizer from a sweep on
# the card (PERF.md §6, PR 15): at Adagrad 0.3 and RMSprop 1e-4 the
# loss climbs back by step 10.
MATRIX_STEPS = 10
MATRIX = (
    ("lamb", {"type": "Lamb", "params": {"lr": 6e-3,
                                         "weight_decay": 0.01}}),
    ("sgd_momentum", {"type": "SGD", "params": {"lr": 0.1,
                                                "momentum": 0.9}}),
    ("adagrad", {"type": "Adagrad", "params": {"lr": 0.1}}),
    ("rmsprop", {"type": "RMSprop", "params": {"lr": 3e-5}}),
    ("lion", {"type": "Lion", "params": {"lr": 1e-4,
                                         "weight_decay": 0.01}}),
    ("adamw_unfused", {"type": "AdamW", "params": {
        "lr": 6e-4, "betas": [0.9, 0.95], "weight_decay": 0.01,
        "fused": False}}),
)
# Ideal bytes a parameter of one optimizer step (fp32 masters, fp32
# grads, the bf16 cast copy): g, p read, p, copy written (14) and each
# state buffer read and written (8); Lamb in two passes (the update and
# its norms, then the ratio's apply: g, p, m, v read, m, v, u written,
# then u, p read, p, copy written).
OPT_BYTES = {"lamb": 42, "sgd_momentum": 22, "adagrad": 22, "rmsprop": 30,
             "lion": 22, "adamw_unfused": 30}
# The flat optimizers against their leaf-by-leaf reference (the same
# update in the optax order, ops/optimizers.reference_step): 4 fp32 ulp
# of the larger operand, and for Lamb also this share of the update (its
# trust ratio divides two norms that the two sum in other orders:
# tests/test_torch_cuda.py::LAMB_RATIO_REL).
OPT_ULP, LAMB_RATIO_REL = 4.0, 2.0 ** -16


def _fp32_ulp_excess(got, want, mag):
    """Largest |got - want| in fp32 ulp of ``mag`` (elementwise)."""
    ulp = torch.exp2(torch.floor(torch.log2(mag.clamp_min(1e-38))) - 23)
    return float(((got - want).abs() / ulp).max())


def engine_state_bits(eng):
    """Every tensor a step carries (the flat params, cast copy and
    optimizer buffers, the count and the loss-scale machine), copied."""
    st = eng.state
    out = [g.param.clone() for g in eng._groups]
    out += [g.cast.clone() for g in eng._groups if g.cast is not None]
    for bufs in topt.state_buffers(st.opt_state).values():
        out += [b.clone() for b in bufs]
    return out + [t.clone() for t in (st.opt_state.count, st.step,
                                      st.loss_scale, st.growth_count,
                                      st.hysteresis, st.skipped_steps)]


def trio_step(eng, batch):
    """One step through forward/backward/step, a call per micro-batch."""
    for mb in batch.chunk(TRAIN_GAS):
        loss = eng.forward(mb)
        eng.backward(loss)
        eng.step()
    return eng.last_metrics["loss"]


def check_optimizer_update(dev, gen, cfg, name, section):
    """One optimizer's step over gpt2-small's parameter group (its leaves
    as one flat fp32 group with a bf16 cast copy): the second update from
    seeded params, grads and state against ``reference_step`` on copies
    of the same inputs (``OPT_ULP``), the copy bit-equal to the masters'
    cast; then timed in place (``compute_norm`` off: the update alone, as
    K6's row), beside a library call that moves the same bytes where one
    exists (a time yardstick only: its formula differs)."""
    lr = section["params"]["lr"]
    opt = topt.build_optimizer(section["type"], dict(section["params"]),
                               lambda step: lr)
    params = gpt2_init(cfg, torch.Generator(device=dev).manual_seed(SEED),
                       dev)
    leaves = [t.float() for t in tree_flatten(params)[0]]
    del params
    grp = fu.FlatGroup(leaves, torch.float32, dev, torch.bfloat16)
    del leaves
    n = grp.numel
    st = opt.init([grp])
    for k in range(2):
        grp.grad.copy_(1e-4 * torch.randn(n, device=dev, generator=gen))
        if k == 1:
            p0 = [v.clone() for v in grp.views(grp.param)]
            g0 = [v.clone() for v in grp.views(grp.grad)]
            s0 = {b: [v.clone() for v in grp.views(bufs[0])]
                  for b, bufs in st.bufs.items()}
            want_p, want_s = topt.reference_step(opt, p0, g0, s0, k)
        st = opt.step([grp], st, compute_norm=False)[0]
    torch.cuda.synchronize()
    err = 0.0
    for got, want, old in zip(grp.views(grp.param), want_p, p0):
        u = (want - old).abs()
        mag = torch.maximum(torch.maximum(got.abs(), want.abs()),
                            torch.maximum(old.abs(), u))
        diff = (got - want).abs()
        if name == "lamb":
            diff = torch.clamp_min(diff - u * LAMB_RATIO_REL, 0.0)
        err = max(err, _fp32_ulp_excess(diff, torch.zeros_like(diff), mag))
    for b, bufs in st.bufs.items():
        for got, want, old in zip(grp.views(bufs[0]), want_s[b], s0[b]):
            mag = torch.maximum(torch.maximum(got.abs(), want.abs()),
                                old.abs())
            err = max(err, _fp32_ulp_excess(got, want, mag))
    cast_equal = torch.equal(grp.cast, grp.param.to(torch.bfloat16))
    del want_p, want_s, p0, g0, s0
    torch.cuda.empty_cache()

    def step():
        opt.step([grp], st, compute_norm=False)
    nbytes = OPT_BYTES[name] * n
    b_ms, b_by = bound(nbytes, 0, FP32_FLOPS_PER_S)
    lib, lib_name = None, None
    p, g = [grp.param], [grp.grad]
    bufs = [torch.zeros_like(grp.param) for _ in range(2)]
    steps = [torch.tensor(3.0, device=dev)]
    if name == "sgd_momentum":
        lib_name = "torch._fused_sgd_"
        lib = time_ms(lambda: torch._fused_sgd_(
            p, g, bufs[:1], weight_decay=0.0, momentum=0.9, lr=lr,
            dampening=0.0, nesterov=False, maximize=False,
            is_first_step=False))
    elif name == "adagrad":
        lib_name = "torch._fused_adagrad_"
        lib = time_ms(lambda: torch._fused_adagrad_(
            p, g, bufs[:1], steps, lr=lr, lr_decay=0.0, weight_decay=0.0,
            eps=1e-10, maximize=False))
    elif name == "adamw_unfused":
        lib_name = "torch._fused_adamw_"
        lib = time_ms(lambda: torch._fused_adamw_(
            p, g, bufs[:1], bufs[1:], [], steps, lr=lr, beta1=0.9,
            beta2=0.95, weight_decay=0.01, eps=1e-8, amsgrad=False,
            maximize=False))
    rec = {"name": name, "shape": [n], "max_ulp": err,
           "cast_copy_bit_equal": cast_equal,
           "ms": time_ms(step, iters=20, warmup=3),
           "device_ms": device_ms(step, n=5, reps=4),
           "bytes": nbytes, "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": lib,
           "library": None if lib is None else
           f"{lib_name} (no cast copy; a time yardstick)"}
    del grp, st, bufs, p, g
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return rec


def train_api(dev, smi):
    """The reference's training API at gpt2-small (full width and depth,
    bf16 with fp32 masters, dropout 0.1, the main path's Markov stream,
    gas 2 x 8 x 1024): ``train_api_trio`` (6 steps through forward/
    backward/step) against ``train_api_batch`` (6 through train_batch)
    from the same init, interleaved step by step (the order of each
    pair alternating): every step's params,
    cast copy, moments, count and loss-scale machine bit-equal, exact
    launches, the step p50 of each and its peak above what the step
    starts with (over steps 2-6, the trio's within ``API_PEAK_SHARE`` of
    train_batch's);
    then the optimizer matrix: each of ``MATRIX`` 10 steps from the same
    init (path ``train_api_<name>``: exact launches, K5 once a step and
    no K6; the loss at step 10 below step 1), its update against the
    leaf-by-leaf reference and its step's time (``check_optimizer_
    update``); then ``eval_batch`` at 8 x 1024 against the train path's
    loss at dropout 0, and its time. Returns the launch counts by path
    and the optimizer rows."""
    cfg = GPT2_CONFIGS["gpt2-small"]
    batches = token_stream(cfg, max(API_STEPS, MATRIX_STEPS))
    expect = per_train_step(cfg)
    counts = {}
    engines = {"batch": make_engine(cfg, "bf16"),
               "trio": make_engine(cfg, "bf16")}
    drive = {"batch": lambda e, b: e.train_batch(b), "trio": trio_step}
    runs = {k: {"losses": [], "ms": [], "host_ms": [],
                "peak_above_start": []} for k in engines}
    per_path = {k: {c: 0 for c in expect} for k in engines}
    equal_steps = 0
    for k, b in enumerate(batches[:API_STEPS]):
        bits = {}
        # (which goes first alternates, so neither always follows the
        # other)
        for kind in (("batch", "trio"), ("trio", "batch"))[k % 2]:
            eng = engines[kind]
            torch.cuda.synchronize()
            start = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            st, en = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            st.record()
            t0 = time.perf_counter()
            loss = drive[kind](eng, b)
            host = (time.perf_counter() - t0) * 1e3
            en.record()
            torch.cuda.synchronize()
            runs[kind]["host_ms"].append(host)
            for c, v in ops.launch_counts().items():
                per_path[kind][c] = per_path[kind].get(c, 0) + v
            runs[kind]["ms"].append(st.elapsed_time(en))
            runs[kind]["losses"].append(float(loss))
            runs[kind]["peak_above_start"].append(
                torch.cuda.max_memory_allocated() - start)
            bits[kind] = engine_state_bits(eng)
        equal_steps += all(torch.equal(x, y) for x, y in
                           zip(bits["batch"], bits["trio"]))
    for kind in engines:
        counts[f"train_api_{kind}"] = per_path[kind]
        runs[kind]["step_ms_p50"] = float(np.median(runs[kind]["ms"][1:]))
        # (the first step of the call also makes the card's one-time
        # allocations, the GEMM library's workspaces among them)
        runs[kind]["peak_above_start_steady"] = \
            max(runs[kind]["peak_above_start"][1:])
    del engines, bits
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    trio = {"model": "gpt2-small", "batch": [TRAIN_GAS, TRAIN_MICRO,
                                             TRAIN_SEQ],
            "steps": API_STEPS, "dropout": cfg.hidden_dropout,
            "steps_bit_equal": equal_steps, "runs": runs,
            "step_ms_of": "CUDA events around each step, the two "
            "interleaved step by step, the first of each pair "
            "alternating; p50 of steps 2-6",
            "host_ms_of": "the host's clock around the step's calls, "
            "before the end event and the sync",
            "card": smi}
    emit({"train_api_trio": trio})
    assert equal_steps == API_STEPS, trio
    assert runs["trio"]["losses"] == runs["batch"]["losses"], trio
    for kind in ("batch", "trio"):
        assert counts[f"train_api_{kind}"] == {
            c: API_STEPS * v for c, v in expect.items()}, \
            (kind, counts[f"train_api_{kind}"])
    pb, pt = (runs[k]["peak_above_start_steady"]
              for k in ("batch", "trio"))
    assert abs(pt - pb) <= API_PEAK_SHARE * pb, (pt, pb)

    # The optimizer matrix.
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = []
    no_k6 = dict(expect, fused_adam_apply=0)
    for name, section in MATRIX:
        lr = section["params"]["lr"]
        extra = {"optimizer": section, "scheduler": {
            "type": "WarmupLR", "params": {"warmup_num_steps": 10,
                                           "warmup_max_lr": lr,
                                           "warmup_type": "linear"}}}
        eng = make_engine(cfg, "bf16", extra=extra)
        assert type(eng.optimizer).__name__ != "FusedAdam", name
        path = f"train_api_{name}"
        losses, _, ms, counts[path] = run_path(eng,
                                               batches[:MATRIX_STEPS])
        del eng
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        assert counts[path] == {c: MATRIX_STEPS * v
                                for c, v in no_k6.items()}, \
            (name, counts[path])
        rec = check_optimizer_update(dev, gen, cfg, name, section)
        rec.update(route="plain PyTorch over the flat buffers (no TPU "
                   "kernel: optax in JAX)",
                   source="deepspeed_tpu_torch/ops/optimizers.py",
                   replaces="deepspeed_tpu/ops/optimizers.py: "
                   "build_optimizer's optax chain",
                   section=section, losses=losses,
                   step_ms_p50=float(np.median(ms[1:])),
                   k5_launches=counts[path]["sqnorm"],
                   k6_launches=counts[path]["fused_adam_apply"])
        emit({"train_api_optimizer": rec})
        rows.append(rec)
        assert all(math.isfinite(l) for l in losses), rec
        assert losses[-1] < losses[0], (name, losses)
        assert rec["max_ulp"] <= OPT_ULP and rec["cast_copy_bit_equal"], rec

    # eval_batch: the compute-dtype params, no graph, against the train
    # path's loss at dropout 0 (the first step's loss is taken before
    # its update, on the same params).
    cfg0 = dataclasses.replace(cfg, hidden_dropout=0.0, attn_dropout=0.0)
    eng = make_engine(cfg0, "bf16")
    b = batches[0].to(dev)
    evals = [eng.eval_batch(mb) for mb in b.chunk(TRAIN_GAS)]
    eval_loss = float(sum(e.float() for e in evals) / TRAIN_GAS)
    eval_ms = time_ms(lambda: eng.eval_batch(b[:TRAIN_MICRO]), iters=10,
                      warmup=2)
    train_loss = float(eng.train_batch(batches[0]))
    ev = {"shape": [TRAIN_MICRO, TRAIN_SEQ], "eval_loss": eval_loss,
          "train_loss": train_loss, "rel": abs(eval_loss - train_loss) /
          abs(train_loss), "eval_ms": eval_ms, "card": smi}
    emit({"train_api_eval": ev})
    assert ev["rel"] <= TRAIN_LOSS_RTOL, ev
    del eng
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return counts, rows


# --------------------------------------------------------------------- #
# Phase 5i: 1-bit Adam (the example config) and its flat step
# --------------------------------------------------------------------- #
ONEBIT_CONFIG = os.path.join("examples", "gpt2", "ds_config_onebit.json")
ONEBIT_STEPS, ONEBIT_FUSED_STEPS = 40, 10
ONEBIT_FP16_FREEZE, ONEBIT_FP16_STEPS = 3, 10
# Ideal bytes a parameter of one flat 1-bit step (fp32 masters and grads,
# the bf16 cast copy written, 2): warmup g read, p, m, v read and written
# (28); compressed g, v read, p, m, worker and server errors read and
# written (40).
ONEBIT_BYTES = {"warmup": 28 + 2, "compressed": 40 + 2}
# The flat step against onebit_reference_step: fp32 ulp of the larger
# operand (of the leaf's largest scale for the error buffers). Warmup 4;
# compressed 8: the reference sums a chunk in fp32 with torch.sum, the
# flat step as fp64 prefix sums, and wte's chunk is 38.6M elements, so
# the reference's scale carries the rounding of a long fp32 reduction
# (6.0 ulp on an H100 80GB HBM3). A server-side compensated value within
# ONEBIT_TIE_ULP ulp of the scale of 0 takes its sign at rounding level:
# such elements are counted and held within the flip bound (2 scales in
# m and the error, 2.5 lr * scale / (sqrt(v) + eps) in p).
ONEBIT_ULP, ONEBIT_TIE_ULP = {"warmup": 4.0, "compressed": 8.0}, 16.0


def per_onebit_step(cfg, gas):
    """Launches of one 1-bit train step at ``gas`` micro-batches: the
    model's kernels (the step itself is plain PyTorch: no K5/K6)."""
    c = per_train_step(cfg)
    return {k: 0 if k in ("sqnorm", "fused_adam_apply") else
            v // TRAIN_GAS * gas for k, v in c.items()}


def kernel_launches(fn):
    """CUDA kernels one call of ``fn`` launches (torch.profiler)."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    n = 0
    for evt in prof.key_averages():
        dev_t = getattr(evt, "device_type", "")
        if "cuda" in str(dev_t).lower():
            n += evt.count
    return n


def check_onebit_step(dev, gen, cfg, phase, lr):
    """The flat 1-bit step over gpt2-small's parameters (one fp32 group
    with a bf16 cast copy, dp 1) against ``onebit_reference_step`` on
    copies of the same seeded inputs, in ``phase`` (``ONEBIT_ULP``, the
    ties counted), the copy bit-equal to the masters' cast; then timed
    in place beside the fused Adam's step (K5 + K6) on the same group and
    ``torch._fused_adamw_``, with its launches and its bound."""
    compressed = phase == "compressed"
    freeze = 20
    opt = ob.OnebitAdam(lr, freeze_step=freeze, weight_decay=0.01)
    params = gpt2_init(cfg, torch.Generator(device=dev).manual_seed(SEED),
                       dev)
    leaves = [t.float() for t in tree_flatten(params)[0]]
    del params
    grp = fu.FlatGroup(leaves, torch.float32, dev, torch.bfloat16)
    del leaves
    n = grp.numel
    st = opt.init([grp], 1)

    def rnd(scale):
        return scale * torch.randn(n, device=dev, generator=gen)
    # (the grads' norm under the clip: the coefficient is 1 on both sides)
    grp.grad.copy_(rnd(1e-5))
    st.m[0].copy_(rnd(1e-4))
    st.v[0].copy_(rnd(1e-5) ** 2 + 1e-12)
    if compressed:
        st.worker_error[0].copy_(rnd(3e-5))
        st.server_error[0].copy_(rnd(3e-5))
    step = freeze if compressed else freeze - 1
    st = st._replace(step=torch.tensor(step, dtype=torch.int32, device=dev))
    lr_t = torch.tensor(lr, dtype=torch.float32, device=dev)

    def views(buf):
        return [v.clone() for v in grp.views(buf)]
    p0, g0 = views(grp.param), views(grp.grad)
    ref_state = ob.OnebitState(st.step.clone(), views(st.m[0]),
                               views(st.v[0]), views(st.worker_error[0]),
                               views(st.server_error[0]))
    want_p, want_s, _ = ob.onebit_reference_step(opt, p0, g0, ref_state,
                                                 lr_t, clip=1.0)
    st2, norm, overflow = opt.step([grp], st, lr=lr_t, compressed=compressed,
                                   clip=1.0)
    torch.cuda.synchronize()
    assert not bool(overflow) and int(st2.step) == step + 1
    err, ties = 0.0, 0
    got_p, got_m, got_v, got_w, got_s = (
        grp.views(b) for b in (grp.param, st2.m[0], st2.v[0],
                               st2.worker_error[0], st2.server_error[0]))
    for i in range(len(p0)):
        wm = want_s.m[i]
        scale = wm.abs().max().clamp_min(1e-30)
        if compressed:
            m_local = 0.9 * ref_state.m[i] + (1 - 0.9) * g0[i]
            sent_scale = (m_local + ref_state.worker_error[i] -
                          want_s.worker_error[i]).abs().max()
            comp2 = wm + want_s.server_error[i]
            ulp_s = torch.exp2(torch.floor(torch.log2(scale)) - 23)
            tie = comp2.abs() <= ONEBIT_TIE_ULP * ulp_s
        else:
            sent_scale = scale
            tie = torch.zeros_like(wm, dtype=torch.bool)
        ties += int(tie.sum())
        flip_p = 2.5 * lr * scale / (torch.sqrt(ref_state.v[i]) + 1e-8)
        for got, want, old, floor, flip in (
                (got_p[i], want_p[i], p0[i], None, flip_p),
                (got_m[i], wm, None, None, 2 * scale),
                (got_v[i], want_s.v[i], None, None, None),
                (got_w[i], want_s.worker_error[i], None, sent_scale, None),
                (got_s[i], want_s.server_error[i], None, scale, 2 * scale)):
            mag = torch.maximum(got.abs(), want.abs())
            if old is not None:
                mag = torch.maximum(mag, old.abs())
            if floor is not None:
                mag = torch.clamp_min(mag, float(floor))
            d = (got - want).abs()
            if flip is not None and bool(tie.any()):
                limit = flip[tie] if flip.dim() else flip
                assert bool((d[tie] <= limit).all()), (phase, i)
                d = torch.where(tie, torch.zeros_like(d), d)
            err = max(err, _fp32_ulp_excess(d, torch.zeros_like(d), mag))
    cast_equal = torch.equal(grp.cast, grp.param.to(torch.bfloat16))
    del want_p, want_s, p0, g0, ref_state
    torch.cuda.empty_cache()

    state = [st2]

    def onebit_step():
        state[0] = opt.step([grp], state[0], lr=lr_t, compressed=compressed,
                            clip=1.0)[0]
    launches = kernel_launches(onebit_step)
    rec = {"name": f"onebit_adam_{phase}", "shape": [n],
           "max_ulp": err, "rounding_level_signs": ties,
           "cast_copy_bit_equal": cast_equal,
           "ms": time_ms(onebit_step, iters=20, warmup=3),
           "device_ms": device_ms(onebit_step, n=5, reps=4),
           "launches_per_step": launches}
    nbytes = ONEBIT_BYTES[phase] * n
    rec["bytes"] = nbytes
    rec["bound_ms"], rec["bound_by"] = bound(nbytes, 0, FP32_FLOPS_PER_S)
    # the fused Adam (K5 + K6) on the same group, for the same clip
    fa = topt.FusedAdam(lr, weight_decay=0.01)
    fst = fa.init([grp])

    def fused_step():
        fa.step([grp], fst, clip=1.0, compute_norm=True)
    rec["fused_adam_ms"] = time_ms(fused_step, iters=20, warmup=3)
    rec["fused_adam_launches_per_step"] = kernel_launches(fused_step)
    if compressed:
        rec["library_ms"], rec["library"] = None, None
    else:
        p, g = [grp.param], [grp.grad]
        bufs = [torch.zeros_like(grp.param) for _ in range(2)]
        steps = [torch.tensor(3.0, device=dev)]
        rec["library_ms"] = time_ms(lambda: torch._fused_adamw_(
            p, g, bufs[:1], bufs[1:], [], steps, lr=lr, beta1=0.9,
            beta2=0.999, weight_decay=0.01, eps=1e-8, amsgrad=False,
            maximize=False))
        rec["library"] = ("torch._fused_adamw_ (no clip, no cast copy; a "
                          "time yardstick)")
        del p, g, bufs
    del grp, st, st2, state, fst
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return rec


def key_bias_norm(eng, cfg):
    """The norm of the key third of qkv_bias (its grad is zero in exact
    arithmetic)."""
    H = cfg.hidden_size
    return float(torch.linalg.vector_norm(
        eng.state.params["blocks"]["qkv_bias"][..., H:2 * H].float()))


def train_onebit(dev, smi):
    """1-bit Adam at gpt2-small (full width and depth) under
    ``examples/gpt2/ds_config_onebit.json`` read from its file (bf16,
    train_batch_size 8 at gas 1 x 1024, clip 1.0, OneBitAdam lr 0.002,
    freeze_step 20, dropout 0.1) on the main path's Markov stream: 40
    steps, the warmup (``train_onebit_warmup``) and the compressed phase
    (``train_onebit_compressed``) each its own path. Asserted: every loss
    finite, the loss falls over the warmup, the variance bit-unchanged
    across the compressed steps, the worker error nonzero, exact launches
    (the model's kernels, no K5/K6), no host sync in a compressed step.
    Then the fused Adam's engine on the same recipe (10 steps) for its
    step time, and an fp16 run (dynamic scale from 2^20, freeze_step 3,
    10 steps: the compressed phase reached). Then the flat step against
    ``onebit_reference_step`` at 124M parameters in both phases, timed
    beside the fused Adam's step. Returns the launch counts by path and
    the ``optimizers`` rows."""
    with open(ONEBIT_CONFIG) as f:
        ds = json.load(f)
    cfg = GPT2_CONFIGS["gpt2-small"]
    gas = ds.get("gradient_accumulation_steps", 1)
    micro = ds["train_batch_size"] // gas
    freeze = ds["optimizer"]["params"]["freeze_step"]
    lr = ds["optimizer"]["params"]["lr"]
    batches = token_stream(cfg, ONEBIT_STEPS + 1, seed=SEED + 7,
                           micro=micro // TRAIN_GAS)
    expect = per_onebit_step(cfg, gas)

    def engine(config):
        params = gpt2_init(cfg, torch.Generator(device=dev).manual_seed(SEED))
        eng, *_ = deepspeed_tpu_torch.initialize(
            model=gpt2_loss_fn(cfg), model_params=params, config=config,
            rng=SEED)
        return eng

    counts = {}
    eng = engine(ds)
    assert eng._onebit
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lw, _, msw, counts["train_onebit_warmup"] = run_path(eng, batches[:freeze])
    cb_warm = eng.onebit_comm_bytes
    kb_warm = key_bias_norm(eng, cfg)
    v_frozen = [t.clone() for t in eng.state.opt_state.v]
    lc, mc, msc, counts["train_onebit_compressed"] = run_path(
        eng, batches[freeze:ONEBIT_STEPS])
    cb_comp = eng.onebit_comm_bytes
    kb_comp = key_bias_norm(eng, cfg)
    v_equal = all(torch.equal(a, b) for a, b in
                  zip(eng.state.opt_state.v, v_frozen))
    werr_max = max(float(t.abs().max())
                   for t in eng.state.opt_state.worker_error)
    peak = torch.cuda.max_memory_allocated()
    syncs = count_host_syncs(eng, batches[ONEBIT_STEPS:])
    del eng, v_frozen
    torch.cuda.empty_cache()
    # the fused Adam's engine on the same recipe
    ds_adam = dict(ds, optimizer={"type": "AdamW", "params": {
        "lr": lr, "weight_decay": 0.0}})
    eng = engine(ds_adam)
    la, _, msa, counts["train_onebit_fused_adam_yardstick"] = run_path(
        eng, batches[:ONEBIT_FUSED_STEPS])
    del eng
    torch.cuda.empty_cache()
    # fp16 with the dynamic scale, past a smaller freeze_step
    ds16 = dict(ds, bf16={"enabled": False},
                fp16={"enabled": True, "initial_scale_power": 20},
                optimizer={"type": "OneBitAdam", "params": {
                    "lr": lr, "freeze_step": ONEBIT_FP16_FREEZE}})
    eng = engine(ds16)
    l16, m16, _, counts["train_onebit_fp16"] = run_path(
        eng, batches[:ONEBIT_FP16_STEPS])
    taken16 = int(eng.state.opt_state.step)
    skipped16 = int(eng.state.skipped_steps)
    scales16 = [float(m["loss_scale"]) for m in m16]
    del eng
    torch.cuda.empty_cache()

    rec = {"model": "gpt2-small", "config": ONEBIT_CONFIG,
           "batch": [gas, micro, TRAIN_SEQ], "freeze_step": freeze,
           "steps": ONEBIT_STEPS, "dropout": cfg.hidden_dropout,
           "losses_warmup": lw, "losses_compressed": lc,
           "warmup_first5_mean": float(np.mean(lw[:5])),
           "warmup_last5_mean": float(np.mean(lw[-5:])),
           "compressed_last5_mean": float(np.mean(lc[-5:])),
           "step_ms_p50_warmup": float(np.median(msw[1:])),
           "step_ms_p50_compressed": float(np.median(msc[1:])),
           "step_ms_p50_fused_adam": float(np.median(msa[1:])),
           "fused_adam_losses": la,
           "comm_bytes_per_step": {"warmup": cb_warm,
                                   "compressed": cb_comp},
           "launches_per_step": expect,
           "variance_bit_unchanged_compressed": v_equal,
           "worker_error_abs_max": werr_max,
           "key_bias_norm": {"after_warmup": kb_warm,
                             "after_compressed": kb_comp},
           "grad_norm_compressed": [float(m["grad_norm"]) for m in mc],
           "host_syncs_compressed_step": syncs,
           "peak_memory_gb": peak / 1e9,
           "fp16": {"freeze_step": ONEBIT_FP16_FREEZE,
                    "steps": ONEBIT_FP16_STEPS, "losses": l16,
                    "loss_scales": scales16, "taken": taken16,
                    "skipped": skipped16},
           "card": smi}
    emit({"train_onebit": rec})
    assert all(math.isfinite(x) for x in lw + lc), rec
    assert rec["warmup_last5_mean"] < rec["warmup_first5_mean"], rec
    assert v_equal and werr_max > 0, rec
    assert syncs["host_syncs"] == 0, syncs
    assert cb_comp < cb_warm / 16, (cb_warm, cb_comp)
    for path, steps in (("train_onebit_warmup", freeze),
                        ("train_onebit_compressed", ONEBIT_STEPS - freeze),
                        ("train_onebit_fp16", ONEBIT_FP16_STEPS)):
        assert counts[path] == {k: steps * v for k, v in expect.items()}, \
            (path, counts[path])
    # (the compressed phase reached; the warmup's losses finite)
    assert taken16 > ONEBIT_FP16_FREEZE, rec["fp16"]
    assert all(math.isfinite(x) for x in l16[:ONEBIT_FP16_FREEZE + 1]), \
        rec["fp16"]

    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    rows = []
    for phase in ("warmup", "compressed"):
        r = check_onebit_step(dev, gen, cfg, phase, lr)
        r.update(route="plain PyTorch over the flat buffers (no TPU "
                 "kernel: jnp in JAX)",
                 source="deepspeed_tpu_torch/ops/onebit.py",
                 replaces="deepspeed_tpu/ops/onebit.py: onebit_adam_update",
                 section=ds["optimizer"],
                 losses=lw if phase == "warmup" else lc,
                 step_ms_p50=rec[f"step_ms_p50_{phase}"],
                 k5_launches=0, k6_launches=0, card=smi)
        emit({"train_onebit_step": r})
        assert r["max_ulp"] <= ONEBIT_ULP[phase] and \
            r["cast_copy_bit_equal"], r
        rows.append(r)
    return counts, rows


# --------------------------------------------------------------------- #
# Phase 5j: BERT-large pretraining (post-LN, then pre-LN)
# --------------------------------------------------------------------- #
# examples/bert/train.py's recipe: bf16, ZeRO-1 (one card: the one-card
# path), Adam lr 3e-3 under WarmupLR (10 steps to its default peak,
# 1e-3), clipping 1.0, micro-batch 8 x 512.
BERT_MICRO, BERT_SEQ = 8, 512
BERT_STEPS, BERT_PRELN_STEPS = 30, 10
BERT_LR = 3e-3
BERT_CORPUS = os.path.join("examples", "data", "corpus.txt")
# Byte tokens (0-255) of the corpus; the [MASK] id sits past them.
BERT_MASK_TOKEN, BERT_MASK_PROB = 256, 0.15


def bert_ds_config():
    return {"train_batch_size": BERT_MICRO,
            "gradient_accumulation_steps": 1,
            "bf16": {"enabled": True}, "zero_optimization": {"stage": 1},
            "gradient_clipping": 1.0,
            "optimizer": {"type": "Adam", "params": {"lr": BERT_LR}},
            "scheduler": {"type": "WarmupLR",
                          "params": {"warmup_num_steps": 10}},
            "steps_per_print": 10 ** 9}


def corpus_mlm(steps, seed=SEED):
    """Seeded MLM batches over the corpus's bytes: 8 windows of 512 at
    random offsets a step, 15% of the positions masked (labels there,
    -100 elsewhere)."""
    with open(os.path.join(REPO, BERT_CORPUS), "rb") as f:
        data = np.frombuffer(f.read(), np.uint8)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        starts = rng.integers(0, len(data) - BERT_SEQ, BERT_MICRO)
        toks = np.stack([data[i:i + BERT_SEQ] for i in starts]).astype(
            np.int64)
        masked = rng.random(toks.shape) < BERT_MASK_PROB
        labels = np.where(masked, toks, -100)
        toks = np.where(masked, BERT_MASK_TOKEN, toks)
        out.append((torch.from_numpy(toks), torch.from_numpy(labels)))
    return out


def per_bert_step(cfg):
    """Launches of one BERT train step (one micro-batch): the embedding
    and MLM-head LayerNorms (plain mode), per layer pre-LN's LN1 or
    post-LN's second residual LN, the residual LN(s), the FFN's and the
    head's bias+GELU, the flash forward and its backward."""
    L = cfg.num_layers
    c = {name: 0 for name in ops.launch_counts()}
    pre = cfg.pre_layer_norm
    c.update({"fused_layer_norm": 2 + (L if pre else 0),
              "fused_residual_layer_norm": L if pre else 2 * L,
              "fused_bias_gelu": L + 1,
              "layer_norm_backward": 2 * L + 2,
              "bias_gelu_backward": L + 1,
              "flash_attention_fwd": L, "sqnorm": 1, "fused_adam_apply": 1})
    bwd = ("flash_attention_bwd_fused",) if fa.use_fused_bwd(
        BERT_SEQ, BERT_SEQ) else ("flash_attention_bwd_dq",
                                  "flash_attention_bwd_dkv")
    c.update({name: L for name in bwd})
    return c


def bert_engine(cfg, dev):
    params = bert_init(cfg, torch.Generator(device=dev).manual_seed(SEED),
                       dev)
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=bert_mlm_loss_fn(cfg), model_params=params,
        config=bert_ds_config(), rng=SEED, device=dev)
    return eng


def plain_bert_step(eng, cfg, batch):
    """The first step's loss and grad norm by plain autograd (plain
    LayerNorm/GELU, the flash forward's plain version drawing the same
    seeds) on the engine's bf16 params, batch and next generator."""
    gen = eng.step_generator()
    cast, spec = tree_flatten(eng.state.cast_params)
    leaves = [t.detach().clone().requires_grad_() for t in cast]
    loss_fn = bert_mlm_loss_fn(cfg, attention_fn=fa.flash_attention_plain,
                               ops=PLAIN_OPS)
    loss = loss_fn(tree_unflatten(spec, leaves),
                   tuple(t.to(eng.device) for t in batch), gen)
    # (the segment table gets no gradient: the MLM batches carry none)
    grads = torch.autograd.grad(loss.float(), leaves, allow_unused=True)
    norm = float(torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads
                                if g is not None)))
    return float(loss.detach()), norm


def check_ln_backward_no_gs(dev, gen, rows, H):
    """K3b as a post-LN block runs it (the residual LN's sum unused: no
    gs) at BERT-large's rows, against the zero-gs launch autograd made
    before the repair: bit-equal, and the time of each. Without gs this
    is a plain LN backward, so the library's is timed beside it."""
    dt = torch.bfloat16
    s = torch.randn(rows, H, device=dev, generator=gen).to(dt)
    sc = 1 + 0.1 * torch.randn(H, device=dev, generator=gen)
    dy = torch.randn(rows, H, device=dev, generator=gen).to(dt)
    zeros = torch.zeros_like(s)
    bi = torch.zeros(H, device=dev)
    mean, rstd = _native_ln_bwd_inputs(s, sc, bi)
    sc_t, bi_t = sc.to(dt), bi.to(dt)
    got = fe.layer_norm_backward(s, sc, dy, None)
    zero = fe.layer_norm_backward(s, sc, dy, zeros)
    want = fe.ln_backward_plain(s, sc, dy, None)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, zero))
    ulps = bf16_ulp_excess(got[0], want[0])
    c = costs.layer_norm_bwd(rows, H, s.element_size(), False)
    b_ms, b_by = bound(c.bytes, c.flops)
    rec = {"kernel": "layer_norm_backward", "case": "bert_postln_no_gs",
           "residual": "no_gs", "shape": [rows, H], "dtype": "bf16",
           **kernel_times(lambda: fe.layer_norm_backward(s, sc, dy, None)),
           "zero_gs_ms": time_ms(
               lambda: fe.layer_norm_backward(s, sc, dy, zeros)),
           "zero_gs_device_ms": device_ms(
               lambda: fe.layer_norm_backward(s, sc, dy, zeros)),
           "plain_ms": time_ms(
               lambda: fe.ln_backward_plain(s, sc, dy, None), iters=20),
           **library_times(
               lambda: torch.ops.aten.native_layer_norm_backward(
                   dy, s, [H], mean, rstd, sc_t, bi_t, [True, True, True])),
           "library": "torch.ops.aten.native_layer_norm_backward",
           "bound_ms": b_ms, "bound_by": b_by,
           "max_err": float((got[0].float() - want[0].float()).abs().max()),
           "max_err_in_2ulp": ulps, "bit_equal_to_zero_gs": same}
    emit(rec)
    assert same, rec
    assert ulps <= 1.0, rec
    return rec


def train_bert(dev, smi, gen):
    """BERT-large (post-LN) on the example's recipe over the corpus's MLM
    batches: a plain-autograd yardstick step, then 30 steps as the
    path (losses finite, the last 5 below the first 5, exact launches, 0
    host syncs a step); then bert-large-preln 10 steps. Returns the
    launch counts by path and K3b's no-gs record."""
    counts = {}
    free_card()
    ln_rec = check_ln_backward_no_gs(dev, gen, BERT_MICRO * BERT_SEQ, 1024)
    batches = corpus_mlm(BERT_STEPS + 3)
    cfg = BERT_CONFIGS["bert-large"]
    eng = bert_engine(cfg, dev)
    ref_loss, ref_norm = plain_bert_step(eng, cfg, batches[0])
    free_card()
    torch.cuda.reset_peak_memory_stats()
    losses, metrics, ms, counts["train_bert"] = run_path(
        eng, batches[:BERT_STEPS])
    k_norm = float(metrics[0]["grad_norm"])
    check = {"loss_kernel": losses[0], "loss_plain": ref_loss,
             "loss_rel": abs(losses[0] - ref_loss) / abs(ref_loss),
             "loss_rtol": TRAIN_LOSS_RTOL, "grad_norm_kernel": k_norm,
             "grad_norm_plain": ref_norm,
             "grad_norm_rel": abs(k_norm - ref_norm) / ref_norm,
             "grad_norm_rtol": TRAIN_GRAD_NORM_RTOL}
    expect = per_bert_step(cfg)
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    step_ms = float(np.median(ms[3:]))
    tokens = BERT_MICRO * BERT_SEQ
    rec = {"model": "bert-large", "post_ln": True,
           "params": bert_num_params(cfg),
           "precision": "bf16, fp32 masters", "zero_stage": 1,
           "batch": [1, BERT_MICRO, BERT_SEQ], "steps": BERT_STEPS,
           "lr": BERT_LR, "warmup_max_lr": 1e-3,
           "dropout": cfg.hidden_dropout, "losses": losses,
           "loss_first5_mean": first, "loss_last5_mean": last,
           "step_vs_plain_autograd": check,
           "grad_norm_last": float(metrics[-1]["grad_norm"]),
           "launches_per_step": nonzero(expect),
           "step_ms_p50": step_ms, "step_ms_all": ms,
           "tokens_per_s": tokens / (step_ms / 1e3),
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "card": smi}
    emit({"train_bert": rec})
    assert check["loss_rel"] <= TRAIN_LOSS_RTOL, check
    assert check["grad_norm_rel"] <= TRAIN_GRAD_NORM_RTOL, check
    assert all(math.isfinite(x) for x in losses), losses
    assert last < first, (first, last)
    assert counts["train_bert"] == {k: BERT_STEPS * v
                                    for k, v in expect.items()}, \
        counts["train_bert"]
    prof = profile_train_steps(eng, batches[BERT_STEPS:BERT_STEPS + 2])
    prof["card"] = smi
    emit({"train_bert_profile": prof})
    syncs = count_host_syncs(eng, batches[BERT_STEPS + 2:])
    emit({"train_bert_host_syncs": syncs})
    assert syncs["host_syncs"] == 0, syncs
    del eng
    free_card()

    cfg = BERT_CONFIGS["bert-large-preln"]
    eng = bert_engine(cfg, dev)
    losses, _, ms, counts["train_bert_preln"] = run_path(
        eng, batches[:BERT_PRELN_STEPS])
    expect = per_bert_step(cfg)
    rec = {"model": "bert-large-preln", "steps": BERT_PRELN_STEPS,
           "losses": losses, "launches_per_step": nonzero(expect),
           "step_ms_p50": float(np.median(ms[3:])), "card": smi}
    emit({"train_bert_preln": rec})
    assert all(math.isfinite(x) for x in losses), losses
    assert np.mean(losses[-3:]) < np.mean(losses[:3]), losses
    assert counts["train_bert_preln"] == {
        k: BERT_PRELN_STEPS * v for k, v in expect.items()}, \
        counts["train_bert_preln"]
    del eng
    free_card()
    return counts, ln_rec


# --------------------------------------------------------------------- #
# Phase 5k: module injection and the sparse-encoder swap
# --------------------------------------------------------------------- #
# A HF BertConfig's attributes at bert-large's widths (read by attribute:
# this machine has no transformers). "gelu" is HF's erf form.
HF_BERT_LARGE = dict(model_type="bert", hidden_size=1024,
                     num_attention_heads=16, num_hidden_layers=24,
                     intermediate_size=4096, max_position_embeddings=512,
                     vocab_size=30522, type_vocab_size=2, hidden_act="gelu",
                     hidden_dropout_prob=0.1,
                     attention_probs_dropout_prob=0.1, layer_norm_eps=1e-12)
HF_GPT2_SMALL = dict(model_type="gpt2", n_embd=768, n_head=12, n_layer=12,
                     n_positions=1024, vocab_size=50257, resid_pdrop=0.1,
                     attn_pdrop=0.1, layer_norm_epsilon=1e-5)
# The injected encoder on the kernels against the plain route (bf16, 8 x
# 512): each layer teacher-forced from the kernel route's input, and the
# whole encoder; relative errors of the Frobenius norm.
INJECT_LAYER_REL_TOL = 1e-2
INJECT_ENCODER_REL_TOL = 5e-2
# The sparse swap: positions 512 -> 2048, 2 sequences of 2000 tokens
# padded to the block, the Fixed bidirectional layout at 16 heads.
SWAP_POSITIONS, SWAP_B, SWAP_TOKENS = 2048, 2, 2000
SWAP_SPARSITY = dict(num_heads=16, block=128, num_local_blocks=4,
                     num_global_blocks=1, attention="bidirectional")
# The swap against the dense route with the layout as a mask, forward
# and backward through 24 layers: in fp32 (each kernel's fp32 tile
# against fp32 softmax) the sums' order alone; in bf16 (the counted
# path) the two routes round p and the LN/GELU outputs at other points
# in every layer. On an H100 80GB HBM3 at 700 W, fp32 read 1.7-3.9e-6;
# bf16 over 3 input draws 1.18e-2 on the output and 2.47-2.50e-2 on dx.
# bf16 cannot see a layout fault (one block dropped from the reference
# read 2.51e-2 on dx there), so fp32 holds the layout: that control
# read 3.2e-4 to 2.2e-3 in fp32, and must read above its limit.
SWAP_REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
SWAP_DRAWS = 3


def hf_bert_state_dict(c, gen, dev):
    """A HF ``BertModel`` state_dict's names and shapes (Linear weights
    ``[out, in]``), fp32 values from ``gen``."""
    H, F_, V = c.hidden_size, c.intermediate_size, c.vocab_size

    def w(*shape):
        return 0.02 * torch.randn(shape, device=dev, generator=gen)

    def ln(prefix):
        return {prefix + ".weight": 1 + 0.1 * torch.randn(
            H, device=dev, generator=gen), prefix + ".bias": w(H) * 5}
    sd = {"embeddings.word_embeddings.weight": w(V, H),
          "embeddings.position_embeddings.weight":
          w(c.max_position_embeddings, H),
          "embeddings.token_type_embeddings.weight": w(c.type_vocab_size, H),
          **ln("embeddings.LayerNorm")}
    for i in range(c.num_hidden_layers):
        p = f"encoder.layer.{i}."
        for n in ("query", "key", "value"):
            sd[f"{p}attention.self.{n}.weight"] = w(H, H)
            sd[f"{p}attention.self.{n}.bias"] = w(H)
        sd.update({f"{p}attention.output.dense.weight": w(H, H),
                   f"{p}attention.output.dense.bias": w(H),
                   **ln(f"{p}attention.output.LayerNorm"),
                   f"{p}intermediate.dense.weight": w(F_, H),
                   f"{p}intermediate.dense.bias": w(F_),
                   f"{p}output.dense.weight": w(H, F_),
                   f"{p}output.dense.bias": w(H),
                   **ln(f"{p}output.LayerNorm")})
    return sd


def hf_gpt2_state_dict(c, gen, dev):
    """A HF ``GPT2Model`` state_dict's names and shapes (``Conv1D``
    weights ``[in, out]``)."""
    H = c.n_embd

    def w(*shape):
        return 0.02 * torch.randn(shape, device=dev, generator=gen)
    sd = {"wte.weight": w(c.vocab_size, H), "wpe.weight": w(c.n_positions, H),
          "ln_f.weight": 1 + w(H), "ln_f.bias": w(H)}
    for i in range(c.n_layer):
        p = f"h.{i}."
        sd.update({p + "ln_1.weight": 1 + w(H), p + "ln_1.bias": w(H),
                   p + "attn.c_attn.weight": w(H, 3 * H),
                   p + "attn.c_attn.bias": w(3 * H),
                   p + "attn.c_proj.weight": w(H, H),
                   p + "attn.c_proj.bias": w(H),
                   p + "ln_2.weight": 1 + w(H), p + "ln_2.bias": w(H),
                   p + "mlp.c_fc.weight": w(H, 4 * H),
                   p + "mlp.c_fc.bias": w(4 * H),
                   p + "mlp.c_proj.weight": w(4 * H, H),
                   p + "mlp.c_proj.bias": w(H)})
    return sd


def _rel(a, b):
    return float(torch.linalg.vector_norm((a.float() - b.float()).ravel())
                 / torch.linalg.vector_norm(b.float().ravel()))


def hf_embed(sd, c, ids):
    """HF BERT's embeddings (token type 0), fp32, LN at the config's
    eps."""
    S = ids.shape[1]
    x = sd["embeddings.word_embeddings.weight"][ids] + \
        sd["embeddings.position_embeddings.weight"][None, :S] + \
        sd["embeddings.token_type_embeddings.weight"][0]
    return F.layer_norm(x, (c.hidden_size,),
                        sd["embeddings.LayerNorm.weight"],
                        sd["embeddings.LayerNorm.bias"], c.layer_norm_eps)


def bert_inject(dev, smi, gen):
    """``module_inject`` at bert-large's widths from a HF-named
    state_dict (erf GELU): restore ∘ extract bit-equal (and a gpt2-small
    Conv1D round trip); the injected encoder at 8 x 512 on the kernels
    (flash ``causal=False``, the residual LN, erf K4f) against the plain
    route; then ``SparseAttentionUtils``: positions 512 -> 2048, padding
    to the block, and the sparse encoder (the LUT kernels K7/K8b/K8c),
    forward and backward, against the dense route with the layout as a
    mask; K7/K8b/K8c at the swap's shape against their plain versions.
    Returns (launch counts by path, the sparse kernels' records)."""
    from types import SimpleNamespace
    counts = {}
    free_card()
    hf_cfg = SimpleNamespace(**HF_BERT_LARGE)
    sd = hf_bert_state_dict(hf_cfg, gen, dev)
    cfg, stacked, restore_fn = replace_module(hf_cfg, sd)
    assert get_policy("bert").detect(hf_cfg) and cfg.gelu_exact and \
        not cfg.pre_layer_norm and not cfg.causal, cfg
    back = restore_fn(stacked)
    bert_round_trip = list(back) == list(sd) and \
        all(torch.equal(back[k], sd[k]) for k in sd)
    g_cfg = SimpleNamespace(**HF_GPT2_SMALL)
    gsd = hf_gpt2_state_dict(g_cfg, gen, dev)
    gcfg, gstacked, grestore = replace_module(g_cfg, gsd)
    gback = grestore(gstacked)
    gpt2_round_trip = list(gback) == list(gsd) and \
        all(torch.equal(gback[k], gsd[k]) for k in gsd)
    H = g_cfg.n_embd
    assert gstacked["qkv_kernel"].shape == (g_cfg.n_layer, H, 3 * H) and \
        gcfg.causal and gcfg.pre_layer_norm
    del gsd, gstacked, gback, back

    # The encoder at 8 x 512 in bf16: kernels against the plain route.
    bf = {k: v.to(torch.bfloat16) for k, v in stacked.items()}
    ids = torch.randint(0, hf_cfg.vocab_size, (BERT_MICRO, BERT_SEQ),
                        device=dev, generator=gen)
    x = hf_embed(sd, hf_cfg, ids).to(torch.bfloat16)
    with torch.no_grad():
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        out_k = apply_blocks(bf, x, cfg)
        torch.cuda.synchronize()
        counts["bert_inject"] = ops.launch_counts()
        out_p = apply_blocks(bf, x, cfg, attention_fn=dense_attention,
                             ops=PLAIN_OPS)
        layer_rel, h = [], x
        for i in range(cfg.num_layers):
            one = dataclasses.replace(cfg, num_layers=1)
            p_i = {k: v[i:i + 1] for k, v in bf.items()}
            yk = apply_blocks(p_i, h, one)
            yp = apply_blocks(p_i, h, one, attention_fn=dense_attention,
                              ops=PLAIN_OPS)
            layer_rel.append(_rel(yk, yp))
            h = yk
    L = cfg.num_layers
    want = {name: 0 for name in ops.launch_counts()}
    want.update({"flash_attention_fwd": L, "fused_bias_gelu": L,
                 "fused_residual_layer_norm": 2 * L})
    enc_rel = _rel(out_k, out_p)
    del out_k, out_p, yk, yp, h

    # The sparse-encoder swap: extend, pad, run on the LUT kernels.
    sd2 = SparseAttentionUtils.extend_position_embedding(sd, SWAP_POSITIONS)
    sparsity = FixedSparsityConfig(**SWAP_SPARSITY)
    enc, stacked2, cfg2 = SparseAttentionUtils.\
        replace_model_self_attention_with_sparse_self_attention(
            hf_cfg, sd2, sparsity, max_position=SWAP_POSITIONS)

    def draw():
        ids = torch.randint(0, hf_cfg.vocab_size, (SWAP_B, SWAP_TOKENS),
                            device=dev, generator=gen)
        pad_len, ids, *_ = SparseAttentionUtils.pad_to_block_size(
            sparsity.block, ids, torch.ones_like(ids))
        w_out = torch.randn(SWAP_B, ids.shape[1], hf_cfg.hidden_size,
                            device=dev, generator=gen)
        return pad_len, hf_embed(sd2, hf_cfg, ids), w_out

    draws = [draw() for _ in range(SWAP_DRAWS)]
    pad_len, S = draws[0][0], draws[0][1].shape[1]
    assert S == SWAP_POSITIONS and pad_len == SWAP_POSITIONS - SWAP_TOKENS
    layout = enc.sparse_self_attention.get_layout(S)
    # The negative control: one kept off-diagonal block of head 0's
    # middle row taken out of the reference's mask.
    broken = np.array(layout, copy=True)
    r = broken.shape[1] // 2
    c = [j for j in np.flatnonzero(broken[0, r]) if j != r][0]
    broken[0, r, c] = 0

    def run(attention_fn, remat, dt, x2, w_out):
        params = {k: v.detach().to(dt).clone().requires_grad_()
                  for k, v in stacked2.items()}
        xin = x2.detach().to(dt).clone().requires_grad_()
        c2 = dataclasses.replace(cfg2, remat_policy=remat)
        if attention_fn is None:
            y = enc(params, xin)
        else:
            y = apply_blocks(params, xin, c2, attention_fn=attention_fn)
        (y.float() * w_out).sum().backward()
        torch.cuda.synchronize()
        return (SparseAttentionUtils.unpad_sequence_output(pad_len, y)
                .detach(), xin.grad, params["qkv_kernel"].grad,
                params["fc_kernel"].grad)

    def dense(mask_layout):
        return lambda q, k, v, **kw: sparse_attention_reference(
            q, k, v, mask_layout)

    # swap_rel[dt]: one [out, dx, dqkv, dfc] list a draw (fp32: the
    # first draw); broken_rel[dt]: the first draw against the control.
    swap_rel, broken_rel = {}, {}
    for dt in (torch.float32, torch.bfloat16):
        swap_rel[dt] = []
        for i, (_, x2, w_out) in enumerate(
                draws[:1] if dt == torch.float32 else draws):
            if dt == torch.bfloat16 and i == 0:
                # warm-up: the counted path's tile resolved (a search on
                # a fresh registry) outside its count
                run(None, "none", dt, x2, w_out)
                free_card()
            ops.reset_launch_counts()
            got = run(None, "none", dt, x2, w_out)
            if dt == torch.bfloat16 and i == 0:
                counts["bert_sparse_swap"] = ops.launch_counts()
            free_card()
            ref = run(dense(layout), "full", dt, x2, w_out)
            swap_rel[dt].append([_rel(a, b) for a, b in zip(got, ref)])
            assert got[0].shape == (SWAP_B, SWAP_TOKENS,
                                    hf_cfg.hidden_size)
            del ref
            if i == 0:
                free_card()
                bad = run(dense(broken), "full", dt, x2, w_out)
                broken_rel[dt] = [_rel(a, b) for a, b in zip(got, bad)]
                del bad
            del got
            free_card()
    want_swap = {name: 0 for name in ops.launch_counts()}
    want_swap.update({"sparse_flash_fwd": L, "sparse_flash_bwd_dq": L,
                      "sparse_flash_bwd_dkv": L, "fused_bias_gelu": L,
                      "fused_residual_layer_norm": 2 * L,
                      "layer_norm_backward": 2 * L,
                      "bias_gelu_backward": L})
    seed = torch.tensor(FLASH_SEED, dtype=torch.int32, device=dev)
    swap_tile = sparse_path_tile(layout, SWAP_B, S, cfg.num_heads, False,
                                 dev)
    sparse_recs = sparse_case(
        dev, gen, "sparse_bert_swap", layout, SWAP_B, S, False, 0.1,
        swap_tile, cfg.num_heads, seed, "fixed_bidirectional",
        with_fused=False)
    rec = {"model": "bert-large widths from a HF-named state_dict",
           "hidden_act": hf_cfg.hidden_act,
           "bert_restore_extract_bit_equal": bert_round_trip,
           "gpt2_conv1d_round_trip_bit_equal": gpt2_round_trip,
           "encoder_batch": [BERT_MICRO, BERT_SEQ],
           "encoder_rel_err_vs_plain": enc_rel,
           "encoder_rel_tol": INJECT_ENCODER_REL_TOL,
           "layer_rel_err_vs_plain_max": max(layer_rel),
           "layer_rel_err_vs_plain": layer_rel,
           "layer_rel_tol": INJECT_LAYER_REL_TOL,
           "launches_encoder": nonzero(counts["bert_inject"]),
           "swap": {"positions": SWAP_POSITIONS, "batch": SWAP_B,
                    "tokens": SWAP_TOKENS, "pad_len": pad_len,
                    "layout_kept_blocks": int(np.asarray(layout).sum()),
                    "layout_blocks": int(np.asarray(layout).size),
                    "tile": list(swap_tile),
                    "rel_err_out_dx_dqkv_dfc_vs_dense": {
                        str(dt).replace("torch.", ""): v
                        for dt, v in swap_rel.items()},
                    "rel_err_vs_one_block_dropped": {
                        "dropped": [0, int(r), int(c)],
                        **{str(dt).replace("torch.", ""): v
                           for dt, v in broken_rel.items()}},
                    "rel_tol": {str(dt).replace("torch.", ""): v
                                for dt, v in SWAP_REL_TOL.items()},
                    "launches": nonzero(counts["bert_sparse_swap"])},
           "card": smi}
    emit({"bert_inject": rec})
    assert bert_round_trip and gpt2_round_trip, rec
    assert counts["bert_inject"] == want, counts["bert_inject"]
    assert max(layer_rel) <= INJECT_LAYER_REL_TOL, rec
    assert enc_rel <= INJECT_ENCODER_REL_TOL, rec
    assert all(max(max(d) for d in v) <= SWAP_REL_TOL[dt]
               for dt, v in swap_rel.items()), rec
    assert min(broken_rel[torch.float32]) > SWAP_REL_TOL[torch.float32], \
        rec
    assert counts["bert_sparse_swap"] == want_swap, \
        counts["bert_sparse_swap"]
    del sd, sd2, stacked, stacked2, bf
    free_card()
    return counts, sparse_recs


# --------------------------------------------------------------------- #
# Phase 4c: serving telemetry (request traces, the serving step spine)
# --------------------------------------------------------------------- #
# Serves of the stream on each engine, in the order off, on, on, off,
# ... (each engine first in half the rounds: the second of two serves
# in a row can read slower whichever engine it is).
SERVE_TEL_ROUNDS = 4


def serve_tel_config(out_dir, job, replica=None):
    inf = dict(SERVE_BASE)
    if replica is not None:
        inf["replica"] = replica
    cfg = {"inference": inf}
    if job is not None:
        cfg["telemetry"] = {"enabled": True, "output_path": out_dir,
                            "job_name": job, "report_steps": 16,
                            "trace_path": os.path.join(out_dir,
                                                       job + ".trace.json"),
                            "fail_on_recompile": True}
    return cfg


def read_stream(out_dir, job):
    with open(os.path.join(out_dir, job + ".jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


def serve_telemetry(dev, smi, params, out_dir):
    """gpt2-small through the scheduler with telemetry on and off (the
    same stream, ``SERVE_TEL_ROUNDS`` interleaved rounds), then through a
    2-replica router on and off. Fails unless the greedy streams are
    bit-equal on and off, the launches equal, a decode step makes the
    same host syncs on and off, ``recompiles`` is 0, every completed
    request's timeline passes ``validate_timeline``, and
    ``tools/telemetry_report.py`` reads the stream (its serving section
    and a worst-request exemplar). Records the on/off decode-step p50
    ratio. Returns the launch counts by path (the telemetry-on serves)."""
    cfg = GPT2_CONFIGS["gpt2-small"]
    free_card()
    reqs = lambda: serve_requests(cfg)  # noqa: E731
    engines = {"off": InferenceEngine(cfg, params,
                                      serve_tel_config(out_dir, None)),
               "on": InferenceEngine(cfg, params,
                                     serve_tel_config(out_dir, "serve"))}
    for eng in engines.values():
        warm_serve(eng, cfg)
    p50, reports, by = {"on": [], "off": []}, {"on": [], "off": []}, \
        {"on": [], "off": []}
    for r in range(SERVE_TEL_ROUNDS):
        for name in (("off", "on") if r % 2 == 0 else ("on", "off")):
            engines[name].reset_serving_stats()
            rep, c, _ = serve_path(engines[name], reqs())
            p50[name].append(rep["decode_step_ms"]["p50"])
            reports[name].append(rep)
            by[name].append(c)
        assert [x["tokens"] for x in reports["on"][r]["requests"]] == \
            [x["tokens"] for x in reports["off"][r]["requests"]], r
    # telemetry launches nothing: each round's counts equal on and off
    assert by["on"] == by["off"], by
    counts = {"serve_telemetry": {k: sum(c[k] for c in by["on"])
                                  for k in by["on"][0]}}
    prompt = serve_prompt(cfg)
    syncs = {}
    for name, eng in engines.items():
        tok, _ = eng.prefill(prompt, slot=0, max_new_tokens=8)
        eng.activate_slot(0, len(prompt), tok)
        syncs[name] = step_host_syncs(eng.decode_once)
        eng.release_slot(0)
    on_reps = reports["on"]
    engines["on"].close()
    recs = read_stream(out_dir, "serve")
    traces = [x for x in recs if x.get("event") == "request_trace"]
    bad = {t["rid"]: validate_timeline(t) for t in traces
           if validate_timeline(t)}
    summary_path = os.path.join(out_dir, "SERVE_TELEMETRY.json")
    tool = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "telemetry_report.py"),
         os.path.join(out_dir, "serve.jsonl"), "-o", summary_path],
        capture_output=True, text=True, timeout=120)
    summary = {}
    if tool.returncode == 0:
        with open(summary_path) as f:
            summary = json.load(f)
    ss = summary.get("serving_slo", {})
    worst = (ss.get("traces") or {}).get("worst_ttft") or []
    kinds = [x["kind"] for x in recs]
    with open(os.path.join(out_dir, "serve.trace.json")) as f:
        text = f.read().rstrip().rstrip(",")
    trace_events = json.loads(text if text.endswith("]") else text + "]")
    rec = {"requests_per_round": 16, "rounds": SERVE_TEL_ROUNDS,
           "decode_step_ms_p50_on": p50["on"],
           "decode_step_ms_p50_off": p50["off"],
           "decode_step_p50_ratio_on_off":
           float(np.median(p50["on"]) / np.median(p50["off"])),
           "decode_step_host_syncs": syncs,
           "recompiles": [x["recompiles"] for x in on_reps],
           "trace": [x["trace"] for x in on_reps],
           "kinds": {k: kinds.count(k) for k in sorted(set(kinds))},
           "request_traces": len(traces), "timeline_problems": bad,
           "report_tool_rc": tool.returncode,
           "serving_section": sorted(summary.get("serving", {}))[:12],
           "worst_ttft_exemplar": worst[0] if worst else None,
           "perfetto_request_spans": sum(
               1 for e in trace_events if e["name"].startswith("req")
               and e["ph"] == "X"),
           "perfetto_flow_events": sum(
               1 for e in trace_events if e["ph"] in ("s", "t", "f")),
           "launches": nonzero(counts["serve_telemetry"]), "card": smi}
    emit({"serve_telemetry": rec})
    assert syncs["on"] == syncs["off"], syncs
    assert all(x == 0 for x in rec["recompiles"]), rec
    assert all(t["completed"] == 16 and t["records_dropped"] == 0
               for t in rec["trace"]), rec
    # (the warm-up's 2 requests drain into the same stream)
    assert len(traces) == 2 + 16 * SERVE_TEL_ROUNDS and not bad, rec
    assert kinds[0] == "meta" and kinds[-1] == "final", kinds[:3]
    assert tool.returncode == 0, tool.stderr[-2000:]
    assert summary.get("serving") and worst and worst[0].get("spans"), rec
    del engines, on_reps, reports
    free_card()

    # The router: two replicas sharing the card, on and off.
    rreqs = lambda: serve_requests(cfg, ROUTER_REQUESTS)  # noqa: E731
    fleets = {}
    for name in ("off", "on"):
        fleets[name] = [InferenceEngine(cfg, params, serve_tel_config(
            out_dir, None if name == "off" else f"router_r{i}", f"r{i}"))
            for i in range(2)]
        for eng in fleets[name]:
            warm_serve(eng, cfg)
    reps = {}
    for name in ("off", "on"):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        reps[name] = ReplicaRouter(fleets[name]).serve(rreqs())
        torch.cuda.synchronize()
        counts[f"serve_telemetry_router_{name}"] = ops.launch_counts()
    for eng in fleets["on"]:
        eng.close()
    tr = [x for i in range(2) for x in read_stream(out_dir, f"router_r{i}")
          if x.get("event") == "request_trace"]
    bad = [(t["rid"], validate_timeline(t)) for t in tr
           if validate_timeline(t)]
    on, off = reps["on"], reps["off"]
    rec = {"replicas": 2, "requests": ROUTER_REQUESTS,
           "streams_equal_on_off": [x["tokens"] for x in on["requests"]]
           == [x["tokens"] for x in off["requests"]],
           "routed_on": on["router"]["routed"],
           "routed_off": off["router"]["routed"],
           "recompiles": on["recompiles"], "trace": on["trace"],
           "request_traces": len(tr), "timeline_problems": bad,
           "tpot_ms_p50_on": on["tpot_ms"]["p50"],
           "tpot_ms_p50_off": off["tpot_ms"]["p50"], "card": smi}
    emit({"serve_telemetry_router": rec})
    counts.pop("serve_telemetry_router_off")
    counts["serve_telemetry_router"] = counts.pop(
        "serve_telemetry_router_on")
    assert rec["streams_equal_on_off"], rec
    assert on["recompiles"] == 0 and off["recompiles"] == 0, rec
    assert on["trace"]["completed"] == ROUTER_REQUESTS and not bad, rec
    assert "trace" not in off, sorted(off)
    del fleets, reps
    free_card()
    return counts



# --------------------------------------------------------------------- #
# Phase 7: the front door (bin/, the example trainer, ds_report, the
# crash-kill harness), each in its own processes
# --------------------------------------------------------------------- #
LAUNCH_STEPS = 20
# The two gloo ranks' depth (gpt2-small's widths): gloo stages every
# collective through host memory, so the full depth would cost seconds a
# step (PERF.md, PR 12).
LAUNCH_ZERO_LAYERS, LAUNCH_ZERO_STEPS = 2, 3
LAUNCH_KILL_S = 10.0

TWO_RANKS_SCRIPT = """\
import argparse, dataclasses, json, os
import numpy as np
import torch
import deepspeed_tpu_torch
from deepspeed_tpu_torch.models.gpt2 import (GPT2_CONFIGS, gpt2_init,
                                             gpt2_loss_fn)
from deepspeed_tpu_torch.ops.fused_update import tree_flatten

ap = argparse.ArgumentParser()
ap.add_argument("--local_rank", type=int)
ap.add_argument("--out")
ap.add_argument("--config")
ap.add_argument("--layers", type=int)
ap.add_argument("--steps", type=int)
a = ap.parse_args()
deepspeed_tpu_torch.init_distributed(dist_backend="gloo")
cfg = dataclasses.replace(GPT2_CONFIGS["gpt2-small"], num_layers=a.layers)
with open(a.config) as f:
    ds = json.load(f)
gen = torch.Generator(device="cuda").manual_seed(0)
eng, *_ = deepspeed_tpu_torch.initialize(
    model=gpt2_loss_fn(cfg), model_params=gpt2_init(cfg, gen, "cuda"),
    config=ds, device="cuda")
rng = np.random.default_rng(0)
losses = []
for _ in range(a.steps):
    tokens = rng.integers(0, 256, size=(ds["train_batch_size"],
                                        cfg.max_seq_length + 1))
    losses.append(float(eng.train_batch(tokens.astype(np.int32))))
flat = torch.cat([t.detach().float().reshape(-1)
                  for t in tree_flatten(eng.state.params)[0]]).cpu()
torch.save({"params": flat, "losses": losses, "dp": eng.dp,
            "rank": eng.dp_rank, "local_rank": a.local_rank,
            "device": str(eng.device),
            "current_device": torch.cuda.current_device(),
            "visible": os.environ.get("CUDA_VISIBLE_DEVICES")},
           f"{a.out}.rank{eng.dp_rank}.pt")
"""

FAILING_CHILD_SCRIPT = """\
import os, sys, time
if os.environ["LOCAL_RANK"] == "1":
    with open(sys.argv[-1], "w") as f:
        f.write(repr(time.time()))
    sys.exit(3)
time.sleep(300)   # only the launcher's kill ends it
"""


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_command(cmd, timeout):
    """``cmd`` from the checkout's root: (completed process, wall s)."""
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                         timeout=timeout)
    return res, time.perf_counter() - t0


def deepspeed_cmd(*args):
    return [sys.executable, os.path.join(REPO, "bin", "deepspeed_torch"),
            "--master_port", str(_free_port()), *args]


def launch_gpt2(smi):
    """``bin/deepspeed_torch --num_gpus 1`` on the gpt2 example at
    gpt2-small on ``ds_config_zero2.json`` over the corpus: the child
    trains on the card's kernels, its loss falls, and its launches are
    exactly the main path's a micro-batch (gas 1)."""
    res, wall = run_command(deepspeed_cmd(
        "--num_gpus", "1", "examples/gpt2/train_torch.py", "--config",
        "ds_config_zero2.json", "--model", "gpt2-small", "--data",
        "examples/data/corpus.txt", "--steps", str(LAUNCH_STEPS)), 900)
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-4000:]
    losses = [float(x) for x in re.search(
        r"^losses:\s*(.*)$", res.stdout, re.M).group(1).split()]
    final = float(re.search(r"^final loss:\s*(\S+)$", res.stdout,
                            re.M).group(1))
    rec = json.loads([ln for ln in res.stdout.splitlines()
                      if ln.startswith('{"example"')][-1])
    cfg = GPT2_CONFIGS["gpt2-small"]
    want = {k: LAUNCH_STEPS * v
            for k, v in per_train_step(cfg, gas=1).items()}
    k = max(1, len(losses) // 4)
    first, last = float(np.mean(losses[:k])), float(np.mean(losses[-k:]))
    out = {"command": "bin/deepspeed_torch --num_gpus 1 "
                      "examples/gpt2/train_torch.py --config "
                      "ds_config_zero2.json --model gpt2-small --data "
                      "examples/data/corpus.txt --steps 20",
           "device": rec["device"], "device_name": rec["device_name"],
           "losses": losses, "final_loss": final,
           "loss_first_quarter_mean": first, "loss_last_quarter_mean": last,
           "step_ms_p50": float(np.median(rec["step_ms"][3:])),
           "step_ms_all": rec["step_ms"], "launches": nonzero(
               rec["launches"]), "launch_wall_s": wall, "card": smi}
    emit({"launch_gpt2_small": out})
    assert rec["device"].startswith("cuda"), rec
    assert rec["device_name"] == torch.cuda.get_device_name(0), rec
    assert last < 0.97 * first, out
    assert rec["launches"] == want, (rec["launches"], want)
    return rec["launches"], out


def launch_two_ranks(smi, tmp):
    """Two ranks on the one card through the launcher (``--procs_per_node
    2``), gloo, ZeRO-2: both take ``cuda:0`` (LOCAL_RANK % 1) and end
    with bit-equal params."""
    script = os.path.join(tmp, "two_ranks.py")
    with open(script, "w") as f:
        f.write(TWO_RANKS_SCRIPT)
    base = os.path.join(tmp, "two_ranks")
    res, wall = run_command(deepspeed_cmd(
        "--num_gpus", "1", "--procs_per_node", "2", script, "--out", base,
        "--config", os.path.join(REPO, "examples", "gpt2",
                                 "ds_config_zero2.json"),
        "--layers", str(LAUNCH_ZERO_LAYERS), "--steps",
        str(LAUNCH_ZERO_STEPS)), 900)
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-4000:]
    ranks = [torch.load(f"{base}.rank{r}.pt") for r in (0, 1)]
    out = {"layers": LAUNCH_ZERO_LAYERS, "steps": LAUNCH_ZERO_STEPS,
           "ranks": [{k: r[k] for k in ("rank", "local_rank", "dp",
                                         "device", "current_device",
                                         "visible", "losses")}
                     for r in ranks],
           "params_bit_equal": torch.equal(ranks[0]["params"],
                                           ranks[1]["params"]),
           "launch_wall_s": wall, "card": smi}
    emit({"launch_two_ranks": out})
    assert out["params_bit_equal"], out
    assert [(r["rank"], r["local_rank"], r["dp"], r["current_device"],
             r["visible"]) for r in ranks] == [(0, 0, 2, 0, "0"),
                                               (1, 1, 2, 0, "0")], out
    return out


def launch_failing_child(smi, tmp):
    """A child that exits 3 takes its sibling (asleep for 300 s) down:
    the launch exits non-zero within ``LAUNCH_KILL_S`` of the failure."""
    script = os.path.join(tmp, "failing.py")
    with open(script, "w") as f:
        f.write(FAILING_CHILD_SCRIPT)
    stamp = os.path.join(tmp, "failed_at")
    res, wall = run_command(deepspeed_cmd(
        "--num_gpus", "1", "--procs_per_node", "2", script, stamp), 120)
    t_end = time.time()
    with open(stamp) as f:
        after = t_end - float(f.read())
    out = {"returncode": res.returncode, "s_from_failure_to_exit": after,
           "limit_s": LAUNCH_KILL_S, "launch_wall_s": wall, "card": smi}
    emit({"launch_failing_child": out})
    assert res.returncode != 0 and after <= LAUNCH_KILL_S, out
    return out


def launch_ds_report(smi):
    """``bin/ds_report_torch`` names the card and shows every kernel
    source's library built, loadable and current."""
    res, wall = run_command([sys.executable, os.path.join(
        REPO, "bin", "ds_report_torch")], 300)
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-4000:]
    text = re.sub(r"\x1b\[[0-9;]*m", "", res.stdout)
    rows = {p.name: ln.split()[1:] for p in [*op_builder.sources(),
                                              op_builder.CSRC_DIR /
                                              "cpu_adam.cpp"]
            for ln in text.splitlines() if ln.startswith(p.name + " ")}
    out = {"names_card": smi.split(",")[0] in text, "rows": rows,
           "report": text.splitlines(), "wall_s": wall, "card": smi}
    emit({"launch_ds_report": out})
    assert out["names_card"], out
    assert len(rows) == len(op_builder.sources()) + 1 and all(
        v == ["[OKAY]"] * 3 for v in rows.values()), out
    return out


def launch_crashkill(smi, tmp):
    """``tools/crashkill_torch.py run --quick`` on the card: SIGTERM and
    SIGKILL kills, a loadable latest after each, the resumed run
    bit-identical to an uninterrupted one."""
    res, wall = run_command([sys.executable, os.path.join(
        REPO, "tools", "crashkill_torch.py"), "run", "--quick",
        "--workdir", os.path.join(tmp, "crashkill")], 900)
    out = {"returncode": res.returncode, "log": res.stdout.splitlines(),
           "wall_s": wall, "card": smi}
    emit({"launch_crashkill": out})
    assert res.returncode == 0 and "BIT-IDENTICAL" in res.stdout, \
        res.stdout[-4000:] + res.stderr[-4000:]
    return out


def launch_phase(smi):
    """The port's front door, each part in its own processes from the
    checkout's root: the gpt2 trainer through ``bin/deepspeed_torch``,
    two gloo ranks through the launcher, a failing child, ``ds_report``
    and the crash-kill harness. Returns the trainer's launch counts (the
    path ``launch_gpt2_small``)."""
    free_card()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_launch_") as tmp:
        counts, gpt2 = launch_gpt2(smi)
        launch_two_ranks(smi, tmp)
        launch_failing_child(smi, tmp)
        launch_ds_report(smi)
        launch_crashkill(smi, tmp)
    emit({"launch_phase": {"wall_s": time.perf_counter() - t0,
                           "card": smi}})
    return {"launch_gpt2_small": counts}


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
    # The tile resolver's registry, fresh for this run (children too):
    # one left by an earlier run would change what this run times.
    reg_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_autotune_")
    os.environ["DS_AUTOTUNE_REGISTRY"] = os.path.join(reg_dir.name,
                                                      "autotune.json")

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
    sq_shard, adam_shard = check_fused_adam_sharded(
        dev, gen, gpt2_leaf_sizes(GPT2_CONFIGS["gpt2-small"]))
    flash = check_flash(dev, gen)
    autotune_phase(dev, smi)
    sparse = check_sparse(dev, gen)
    grouped = check_grouped_gemm(dev, gen)
    torch.cuda.synchronize()
    host_adam = check_cpu_adam(smi)

    serve_counts, serve_reports, serve_params = serve_gpt2_small(dev)
    torch.cuda.synchronize()
    counts = {"whole_prompt" if k == "whole" else f"spec_k={k}": c
              for k, c in serve_counts.items()}
    counts.update(serve_extras(dev, serve_params, serve_reports))
    with tempfile.TemporaryDirectory() as st_dir:
        counts.update(serve_telemetry(dev, smi, serve_params, st_dir))
    del serve_params, serve_reports
    counts.update(train_gpt2_small(dev, smi))
    with tempfile.TemporaryDirectory() as tel_dir:
        counts.update(train_telemetry(dev, smi, tel_dir))
    bert_counts, bert_ln_bwd = train_bert(dev, smi, gen)
    counts.update(bert_counts)
    inject_counts, swap_sparse = bert_inject(dev, smi, gen)
    counts.update(inject_counts)
    counts.update(train_sparse(dev, smi))
    counts.update(train_moe(dev, smi))
    counts.update(train_remat(dev, smi))
    api_counts, optimizer_rows = train_api(dev, smi)
    counts.update(api_counts)
    onebit_counts, onebit_rows = train_onebit(dev, smi)
    counts.update(onebit_counts)
    optimizer_rows += onebit_rows
    counts.update(train_checkpoint(dev, smi))
    counts.update(train_zero(dev, smi))
    offload_counts, host_counts = train_offload(dev, smi, host_adam)
    counts.update(offload_counts)
    counts.update(launch_phase(smi))
    reg_dir.cleanup()

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
                ("layer_norm_backward",), ln_bwd[0],
                ln_bwd + [bert_ln_bwd]),
        summary("bias_gelu_fwd", fe_src, ref + "fused_elementwise.py:392",
                ("fused_bias_gelu",), train_gelu[0], gelu),
        summary("bias_gelu_bwd", fe_src, ref + "fused_elementwise.py:398",
                ("bias_gelu_backward",), gelu_bwd[0], gelu_bwd),
        summary("sqnorm", fu_src, ref + "fused_update.py:257", ("sqnorm",),
                sq[0], sq + sq_shard),
        summary("fused_adam", fu_src, ref + "fused_update.py:267",
                ("fused_adam_apply",), [r for r in adam if r["flags"] ==
                                        "bf16_cast_cache"][0],
                adam + adam_shard),
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
    # Sparse rows: the path's record (its super-tile, dropout 0.1).
    for wrapper, line in (("sparse_flash_fwd", 114),
                          ("sparse_flash_bwd_dq", 171),
                          ("sparse_flash_bwd_dkv", 294),
                          ("sparse_flash_bwd_fused", 219)):
        recs = [r for r in sparse + swap_sparse if r["kernel"] == wrapper]
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
    # The shard-local mode's local launches (a rank's rows) by dp.
    for row, recs in ((kernels[4], sq_shard), (kernels[5], adam_shard)):
        row["shard_local"] = [
            {"dp": r["dp"], "flags": r.get("flags"), "shape": r["shape"],
             "ms": r["kernel_ms"], "bound_ms": r["bound_ms"],
             "bound_by": r["bound_by"], "max_abs_err": r["max_err"]}
            for r in recs]
    assert len(kernels) == 16, [k["name"] for k in kernels]
    host_adam["launches_by_path"] = {
        path: c.get("cpu_adam_step", 0) for path, c in host_counts.items()}
    host_adam["launches"] = sum(host_adam["launches_by_path"].values())
    emit({"smoke_wall_s": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"host_kernels": [{k: host_adam[k] for k in (
        "name", "route", "source", "replaces", "launches",
        "launches_by_path", "max_ulp", "ms", "plain_ms", "bound_ms",
        "bound_by", "bound_note", "bound_set_by", "library_ms", "library",
        "host")}]})
    emit({"optimizers": [{k: r[k] for k in (
        "name", "route", "source", "replaces", "section", "shape", "bytes",
        "ms", "device_ms", "bound_ms", "bound_by", "library_ms", "library",
        "max_ulp", "k5_launches", "k6_launches", "step_ms_p50", "losses")}
        for r in optimizer_rows]})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": device_name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--train-zero-rank":
        train_zero_rank(int(sys.argv[2]), sys.argv[3])
        sys.exit(0)
    sys.exit(main())
