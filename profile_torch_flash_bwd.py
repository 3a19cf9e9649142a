#!/usr/bin/env python3
"""The flash backward on one card: K2c (the fused backward) and the
K2a + K2b pair at the training paths' shapes, beside the library's
backward, in one process.

    python3 profile_torch_flash_bwd.py

At gpt2-small's attention (12 heads of 64, bf16, causal, q/k/v the
strided split of one QKV projection as the model hands them over):
8 x 1024 (the main training path, where the JAX rule takes K2c),
8 x 768 (the split path) and 2 x 4096 (the dense causal step of the
sparse phase), dropout 0 and 0.1. Each kernel runs at every shape (K2c
takes any sequence), so the two designs stand side by side. Readings of
each: CUDA events over 20 warm calls (``ms``), graph replay
(``device_ms``, the card alone) and one call after a 64 MB write
(``cold_ms``); the library's backward alone
(``F.scaled_dot_product_attention``, ``torch.autograd.grad`` over a
built graph), event-timed, as ``library_ms``. First, the ptxas report of
the backward kernels (registers, spills) when the library builds in
this process.

It reads only the wrappers' Python interface, so a copy of it also runs
from a checkout of an earlier commit, for a comparison on one card in
one call. One JSON line per reading, the card's name and power limit
first. Needs a CUDA device.

    python3 profile_torch_flash_bwd.py --variants

instead rebuilds ``csrc/flash_attention.cu`` with other register
budgets of the backward tiles at head dim 64 (``bwd_chunk``, the rows a
step works on at once, and ``bwd_min_blocks``, the blocks per SM the
kernels are compiled for; ``VARIANTS``) into ``build/variants/``, and
reads K2c and the pair at 8 x 1024 and 2 x 4096, dropout 0.1, with each
build in turn, the sources as they are first and last.
"""
import contextlib
import ctypes
import io
import re
import shutil
import subprocess
import sys

import torch
import torch.nn.functional as F

import chip_smoke as cs
from deepspeed_tpu_torch.ops import flash_attention as fa
from deepspeed_tpu_torch.ops import op_builder

CASES = ((8, 1024), (8, 768), (2, 4096))
DROPOUTS = (0.0, 0.1)
BWD_KERNELS = ("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel",
               "flash_bwd_fused_kernel", "sparse_dq_kernel",
               "sparse_dkv_kernel", "sparse_fused_bwd_kernel")
NH, D = 12, 64
# (bwd_chunk, bwd_min_blocks) at head dim 64; None: the sources as they are.
VARIANTS = (None, (32, 2), (32, 3), None)


def variant_library(chunk, blocks):
    """The kernel library built from csrc/ with bwd_chunk and
    bwd_min_blocks at DP 64 set to ``chunk`` and ``blocks``: (ctypes
    library with the flash entry points bound, ptxas report)."""
    root = op_builder.BUILD_DIR.parent / "variants" / f"c{chunk}_b{blocks}"
    csrc = root / "csrc"
    csrc.mkdir(parents=True, exist_ok=True)
    for p in op_builder.CSRC_DIR.glob("*.cuh"):
        shutil.copy(p, csrc)
    for name in ("flash_attention.cu", "runtime.cu"):
        shutil.copy(op_builder.CSRC_DIR / name, csrc)
    tiles = (csrc / "flash_tiles.cuh").read_text()
    for fn, value in (("bwd_chunk", chunk), ("bwd_min_blocks", blocks)):
        tiles, n = re.subn(
            rf"(constexpr int {fn}\(int DP\) {{\s*return )([^;]*);",
            rf"\g<1>DP == 64 ? {value} : (\g<2>);", tiles)
        assert n == 1, fn
    (csrc / "flash_tiles.cuh").write_text(tiles)
    saved = op_builder.CSRC_DIR, op_builder.BUILD_DIR
    op_builder.CSRC_DIR, op_builder.BUILD_DIR = csrc, root / "build"
    log = io.StringIO()
    try:
        with contextlib.redirect_stdout(log):
            path = op_builder.build(verbose=True)
    finally:
        op_builder.CSRC_DIR, op_builder.BUILD_DIR = saved
    lib = ctypes.CDLL(str(path))
    for name, (argtypes, restype) in op_builder._SIGNATURES.items():
        if name.startswith("dstt_flash") or name == "dstt_error_string":
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = restype
    return lib, cs.ptxas_summary(log.getvalue())


def bwd_inputs(dev, gen, B, S, drop, seed):
    """args of the backward wrappers at (B, S): q/k/v the strided split
    of one projection, o and lse from the forward kernel."""
    qkv = torch.randn(B, S, 3 * NH * D, device=dev,
                      generator=gen).to(torch.bfloat16)
    q, k, v = (t.reshape(B, S, NH, D) for t in qkv.split(NH * D, -1))
    do = torch.randn(B, S, NH, D, device=dev,
                     generator=gen).to(torch.bfloat16)
    o, lse = fa.flash_attention_fwd(q, k, v, True, D ** -0.5, drop, seed)
    delta = fa.flash_delta(do, o)
    return (q, k, v, do, lse, delta, True, D ** -0.5, drop, seed)


def variants(dev, gen, seed):
    cases = [(B, S, bwd_inputs(dev, gen, B, S, 0.1, seed))
             for B, S in ((8, 1024), (2, 4096))]
    default = op_builder.load()
    for var in VARIANTS:
        lib, ptx = (default, {}) if var is None else variant_library(*var)
        op_builder._lib = lib
        rec = {"variant": "as built" if var is None else
               {"bwd_chunk": var[0], "bwd_min_blocks": var[1]},
               "ptxas": {k: v for k, v in ptx.items()
                         if k.startswith("flash_bwd") and "Li64" in k}}
        for B, S, args in cases:
            rec[f"{B}x{S}"] = {
                "fused": readings(lambda: fa.flash_attention_bwd_fused(
                    *args)),
                "pair": readings(lambda: (fa.flash_attention_bwd_dq(*args),
                                          fa.flash_attention_bwd_dkv(
                                              *args)))}
        cs.emit(rec)
    op_builder._lib = default


def readings(fn):
    return {"ms": cs.time_ms(fn, iters=20, warmup=3),
            "device_ms": cs.device_ms(fn), "cold_ms": cs.cold_ms(fn)}


def main():
    if not torch.cuda.is_available():
        print("profile_torch_flash_bwd: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        op_builder.load(verbose=True)
    ptx = {k: v for k, v in cs.ptxas_summary(log.getvalue()).items()
           if k.startswith(BWD_KERNELS)}
    cs.emit({"card": smi, "torch": torch.__version__, "ptxas": ptx})
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    seed = torch.tensor(cs.FLASH_SEED, dtype=torch.int32, device=dev)
    if "--variants" in sys.argv[1:]:
        variants(dev, gen, seed)
        print(smi, flush=True)
        return 0
    for B, S in CASES:
        for drop in DROPOUTS:
            args = bwd_inputs(dev, gen, B, S, drop, seed)
            q, k, v, do = args[:4]
            sq, sk, sv = (t.transpose(1, 2).contiguous().requires_grad_()
                          for t in (q, k, v))
            sdo = do.transpose(1, 2).contiguous()
            lib_out = F.scaled_dot_product_attention(
                sq, sk, sv, is_causal=True, dropout_p=drop)
            rec = {"batch": B, "seq": S, "heads": NH, "head_dim": D,
                   "dropout": drop, "causal": True,
                   "jax_rule": "fused" if fa.use_fused_bwd(S, S)
                   else "pair"}
            kernels = (
                ("fused", lambda: fa.flash_attention_bwd_fused(*args)),
                ("pair", lambda: (fa.flash_attention_bwd_dq(*args),
                                  fa.flash_attention_bwd_dkv(*args))),
                ("dq", lambda: fa.flash_attention_bwd_dq(*args)),
                ("dkv", lambda: fa.flash_attention_bwd_dkv(*args)))
            for name, fn in kernels:
                rec[name] = readings(fn)
            rec["library_ms"] = cs.time_ms(
                lambda: torch.autograd.grad(lib_out, (sq, sk, sv), sdo,
                                            retain_graph=True),
                iters=20, warmup=3)
            cs.emit(rec)
            del q, k, v, do, args, lib_out, sq, sk, sv
            torch.cuda.empty_cache()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
