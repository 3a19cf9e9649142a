#!/usr/bin/env python3
"""1-bit Adam's key bias on both engines, on the CPU.

Trains gpt2-tiny (bf16 compute, fp32 masters, dropout 0.1) under the
recipe of ``examples/gpt2/ds_config_onebit.json`` (8 rows of 128 tokens
a step, clip 1.0, OneBitAdam lr 0.002, freeze_step 20) for 40 steps of a
seeded Markov token stream, on the JAX engine (one CPU device, dense
attention) and on the port (``device="cpu"``) from the same parameters,
and prints a JSON line a step: each engine's loss and the norm of the
key third of ``qkv_bias``.

The key bias's gradient is zero in exact arithmetic (the softmax ignores
a score shift shared by every key), so its warmup variance is rounding
noise; in the compressed phase its update ``scale / (sqrt(v) + eps)`` is
set by the chunk's other elements and can be large on both engines.
Run from the root of a checkout (about 2 minutes)::

    JAX_PLATFORMS=cpu python tools/onebit_key_bias.py
"""
import dataclasses
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import deepspeed_tpu  # noqa: E402
import deepspeed_tpu_torch  # noqa: E402
from deepspeed_tpu.models import gpt2 as jgpt2  # noqa: E402
from deepspeed_tpu.models.transformer import dense_attention  # noqa: E402
from deepspeed_tpu.parallel.topology import build_mesh  # noqa: E402
from deepspeed_tpu_torch.models import convert  # noqa: E402
from deepspeed_tpu_torch.models import gpt2 as tgpt2  # noqa: E402

STEPS, ROWS, SEQ, SEED = 40, 8, 128, 0


def markov_batches(steps, rows, seq, seed, vocab_size=512, n=256):
    rng = np.random.default_rng(seed)
    vocab = rng.choice(vocab_size, n, replace=False)
    succ = rng.permutation(n)
    for _ in range(steps):
        toks = np.empty((rows, seq + 1), np.int64)
        cur = rng.integers(0, n, rows)
        for t in range(seq + 1):
            toks[:, t] = cur
            jump = rng.random(rows) < 0.1
            cur = np.where(jump, rng.integers(0, n, rows), succ[cur])
        yield vocab[toks].astype(np.int32)


def main():
    torch.set_num_threads(4)
    with open(os.path.join(REPO, "examples", "gpt2",
                           "ds_config_onebit.json")) as f:
        ds = json.load(f)
    ds["steps_per_print"] = 10 ** 9
    jcfg = dataclasses.replace(jgpt2.GPT2_CONFIGS["gpt2-tiny"],
                               dtype=jnp.bfloat16, fused_kernels=False)
    tcfg = dataclasses.replace(tgpt2.GPT2_CONFIGS["gpt2-tiny"],
                               dtype=torch.bfloat16)
    params = jax.tree_util.tree_map(np.asarray, jgpt2.gpt2_init(
        jax.random.PRNGKey(SEED), dataclasses.replace(jcfg,
                                                      dtype=jnp.float32)))
    jeng, *_ = deepspeed_tpu.initialize(
        model=jgpt2.gpt2_loss_fn(jcfg, attention_fn=dense_attention),
        model_params=jax.tree_util.tree_map(jnp.asarray, params), config=ds,
        mesh=build_mesh(devices=jax.devices()[:1]))
    teng, *_ = deepspeed_tpu_torch.initialize(
        model=tgpt2.gpt2_loss_fn(tcfg),
        model_params=convert.from_jax_params(params), config=ds,
        device="cpu")
    H = tcfg.hidden_size
    for step, b in enumerate(markov_batches(STEPS, ROWS, SEQ, SEED), 1):
        jl, tl = float(jeng.train_batch(b)), float(teng.train_batch(b))
        jk = float(jnp.linalg.norm(jeng.state.params["blocks"]["qkv_bias"]
                                   [..., H:2 * H].astype(jnp.float32)))
        tk = float(torch.linalg.vector_norm(
            teng.state.params["blocks"]["qkv_bias"][..., H:2 * H].float()))
        print(json.dumps({"step": step, "jax_loss": jl, "port_loss": tl,
                          "jax_key_bias_norm": jk,
                          "port_key_bias_norm": tk}), flush=True)


if __name__ == "__main__":
    main()
