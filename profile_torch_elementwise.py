#!/usr/bin/env python3
"""Build variants of the fused elementwise kernels (LayerNorm forward
K3f and backward K3b, bias+GELU forward K4f and backward K4b) and read
them side by side on one card, in one process.

    python3 profile_torch_elementwise.py [--kernels K3f,K4b]

Each variant compiles ``deepspeed_tpu_torch/csrc/fused_elementwise.cu``
(with ``runtime.cu``) with other ``-D`` settings into its own library
under ``build/variants/`` (all built in parallel, with the ptxas report),
and is called through the same C entry points as the port's wrappers:

- K3f: ``DSTT_LN_FWD_STAGES`` (rows a warp keeps in flight: the depth of
  its shared-memory ring of rows, filled by cp.async; 1: the next row in
  registers instead), ``DSTT_LN_FWD_WARPS`` (warps a block) and
  ``DSTT_LN_FWD_BLOCKS_PER_SM`` (the grid, 132 times it, and the register
  cap of the launch bounds);
- K3b: ``DSTT_LN_BWD_STAGES``, ``DSTT_LN_BWD_WARPS`` and
  ``DSTT_LN_BWD_BLOCKS_PER_SM``, the same three for the backward;
- K4f: ``DSTT_GELU_ROWS`` (rows a thread walks) and ``DSTT_GELU_UNROLL``
  (rows in flight);
- K4b: ``DSTT_GELU_BWD_ROWS`` (rows a thread walks),
  ``DSTT_GELU_BWD_SPLIT`` (threads a block on one column vector's
  adjacent runs, whose sums the block adds: a dbias partial row covers
  ROWS x SPLIT rows) and ``DSTT_GELU_BWD_UNROLL`` (rows a batch; the
  next batch loads while one computes).

At the training shapes (8192 rows of 768 or 3072, bf16), and K3f also at
a serving step's 8 rows: K3f with and without the residual, K3b with and
without the residual cotangent (each including its second launch, the
sum of the per-block partials), K4f and K4b in both forms, each against
its plain version (2 bf16 ulp) and read as ``device_ms`` (CUDA-graph
replay) and ``cold_ms`` (one call after a 64 MB write), in the order of
the variant list and then reversed. ``--kernels`` keeps the variants
that vary those kernels (and the default build) and reads only their
cases. Prints one JSON line per variant and reading, with the registers
and spills of the main path's instances, then a summary. Needs a CUDA
device.
"""
import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs
from deepspeed_tpu_torch.ops import fused_elementwise as fe
from deepspeed_tpu_torch.ops import op_builder

OUT = Path(__file__).resolve().parent / "build" / "variants" / "elementwise"
# name: (build settings, the kernel they vary); the first is the default
# build, read on every case.
VARIANTS = {
    "default": ({}, None),
    "lnf_ring2": ({"DSTT_LN_FWD_STAGES": 2}, "K3f"),
    "lnf_ring4": ({"DSTT_LN_FWD_STAGES": 4}, "K3f"),
    "lnf_regs_prefetch": ({"DSTT_LN_FWD_STAGES": 1}, "K3f"),
    "lnf_w8_b1": ({"DSTT_LN_FWD_BLOCKS_PER_SM": 1}, "K3f"),
    "lnf_w4_b4": ({"DSTT_LN_FWD_WARPS": 4, "DSTT_LN_FWD_BLOCKS_PER_SM": 4},
                  "K3f"),
    "lnf_w16_b1": ({"DSTT_LN_FWD_WARPS": 16,
                    "DSTT_LN_FWD_BLOCKS_PER_SM": 1}, "K3f"),
    "lnb_w4_b2": ({"DSTT_LN_BWD_WARPS": 4, "DSTT_LN_BWD_BLOCKS_PER_SM": 2},
                  "K3b"),
    "lnb_regs_prefetch": ({"DSTT_LN_BWD_STAGES": 1}, "K3b"),
    "gelu_rows8": ({"DSTT_GELU_ROWS": 8}, "K4f"),
    "gbw_r16_s4_u2": ({"DSTT_GELU_BWD_ROWS": 16, "DSTT_GELU_BWD_SPLIT": 4,
                       "DSTT_GELU_BWD_UNROLL": 2}, "K4b"),
    "gbw_r16_s2_u2": ({"DSTT_GELU_BWD_ROWS": 16,
                       "DSTT_GELU_BWD_UNROLL": 2}, "K4b"),
    "gbw_r32_s2_u2": ({"DSTT_GELU_BWD_UNROLL": 2}, "K4b"),
    "gbw_r32_s4_u2": ({"DSTT_GELU_BWD_SPLIT": 4, "DSTT_GELU_BWD_UNROLL": 2},
                      "K4b"),
    "gbw_r32_s1_u2": ({"DSTT_GELU_BWD_SPLIT": 1, "DSTT_GELU_BWD_UNROLL": 2},
                      "K4b"),
    "gbw_r64_s2_u2": ({"DSTT_GELU_BWD_ROWS": 64,
                       "DSTT_GELU_BWD_UNROLL": 2}, "K4b"),
}
ENTRIES = ("dstt_layer_norm", "dstt_layer_norm_bwd",
           "dstt_layer_norm_bwd_blocks", "dstt_bias_gelu",
           "dstt_bias_gelu_bwd", "dstt_bias_gelu_bwd_splits",
           "dstt_error_string")


def build_all(variants):
    """{variant: (library, {kernel instance: ptxas line})}."""
    nvcc = op_builder.find_nvcc()
    srcs = [op_builder.CSRC_DIR / "fused_elementwise.cu",
            op_builder.CSRC_DIR / "runtime.cu"]
    procs = {}
    for name, (defs, _) in variants.items():
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        flags = [f"-D{k}={v}" for k, v in defs.items()]
        procs[name] = subprocess.Popen(
            [nvcc, *op_builder.NVCC_FLAGS, "-Xptxas", "-v", *flags,
             "-shared", "-o", str(d / "lib.so"), *map(str, srcs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    out = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc {name}:\n{log}")
        out[name] = (OUT / name / "lib.so", ptxas(log))
    return out


def ptxas(log):
    """Registers and spills of the main path's instances: K3f and K3b
    bf16 at three vectors a lane (H 768), K4f and K4b bf16 16-byte
    vectors."""
    want = {"ln_fwd_bf16_resid": r"ln_fwd_kernelI13__nv_bfloat16Lb1ELi3ELi8E",
            "ln_fwd_bf16": r"ln_fwd_kernelI13__nv_bfloat16Lb0ELi3ELi8E",
            "ln_bwd_bf16_gs": r"ln_bwd_kernelI13__nv_bfloat16Lb1ELi3ELi8E",
            "ln_bwd_bf16": r"ln_bwd_kernelI13__nv_bfloat16Lb0ELi3ELi8E",
            "gelu_bf16_tanh": r"bias_gelu_kernelI13__nv_bfloat16Li8ELb0E",
            "gelu_bf16_erf": r"bias_gelu_kernelI13__nv_bfloat16Li8ELb1E",
            "gelu_bwd_bf16_tanh":
                r"bias_gelu_bwd_kernelI13__nv_bfloat16Li8ELb0E",
            "gelu_bwd_bf16_erf":
                r"bias_gelu_bwd_kernelI13__nv_bfloat16Li8ELb1E"}
    got, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = next((k for k, pat in want.items()
                        if re.search(pat, m.group(1))), None)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            got.setdefault(cur, {})["spill_stores"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            got.setdefault(cur, {})["registers"] = int(m.group(1))
            cur = None
    return got


def load(path):
    lib = ctypes.CDLL(str(path))
    for name in ENTRIES:
        argtypes, restype = op_builder._SIGNATURES[name]
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = restype
    return lib


def ln_bwd_call(lib, s, sc, dy, gs):
    """The port's ``layer_norm_backward`` on ``lib``: the rows' kernel and
    the sum of its partials (two launches)."""
    rows, H = s.shape
    blocks = lib.dstt_layer_norm_bwd_blocks(rows)
    dx = torch.empty_like(s)
    parts = torch.empty((2, blocks, H), dtype=torch.float64,
                        device=s.device)
    out = torch.empty((2, H), dtype=torch.float32, device=s.device)
    rc = lib.dstt_layer_norm_bwd(
        s.data_ptr(), sc.data_ptr(), dy.data_ptr(),
        None if gs is None else gs.data_ptr(), dx.data_ptr(),
        parts.data_ptr(), out.data_ptr(), rows, H, 1e-5, 1,
        op_builder.stream_ptr(s.device))
    assert rc == 0, rc
    return dx, out


def ln_fwd_call(lib, x, d, sc, bi):
    """The port's ``fused_(residual_)layer_norm`` forward on ``lib``."""
    rows, H = x.shape
    y = torch.empty_like(x)
    s = None if d is None else torch.empty_like(x)
    rc = lib.dstt_layer_norm(
        x.data_ptr(), None if d is None else d.data_ptr(), sc.data_ptr(),
        bi.data_ptr(), None if s is None else s.data_ptr(), y.data_ptr(),
        rows, H, 1e-5, 1, op_builder.stream_ptr(x.device))
    assert rc == 0, rc
    return y if s is None else (s, y)


def gelu_bwd_call(lib, y, b, g, exact):
    """The port's ``bias_gelu_backward`` on ``lib``: the rows' kernel and
    the sum of its partials (two launches)."""
    rows, F = y.shape
    splits = lib.dstt_bias_gelu_bwd_splits(rows)
    dz = torch.empty_like(y)
    part = torch.empty((splits, F), dtype=torch.float32, device=y.device)
    db = torch.empty(F, dtype=torch.float32, device=y.device)
    rc = lib.dstt_bias_gelu_bwd(
        y.data_ptr(), b.data_ptr(), g.data_ptr(), dz.data_ptr(),
        part.data_ptr(), db.data_ptr(), rows, F, int(exact), 1,
        op_builder.stream_ptr(y.device))
    assert rc == 0, rc
    return dz, db


def gelu_call(lib, y, b, exact):
    out = torch.empty_like(y)
    rc = lib.dstt_bias_gelu(y.data_ptr(), b.data_ptr(), out.data_ptr(),
                            y.numel(), y.shape[-1], int(exact), 1,
                            op_builder.stream_ptr(y.device))
    assert rc == 0, rc
    return out


def main():
    if not torch.cuda.is_available():
        print("profile_torch_elementwise: no CUDA device is available",
              file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernels", default="K3f,K3b,K4f,K4b")
    kinds = set(ap.parse_args().kernels.split(","))
    variants = {k: v for k, v in VARIANTS.items()
                if v[1] is None or v[1] in kinds}
    built = build_all(variants)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    R, H, Fw, dt = cs.TRAIN_ROWS, 768, 3072, torch.bfloat16
    s = (2 * torch.randn(R, H, device=dev, generator=gen) + 0.5).to(dt)
    dy, gs = (torch.randn(R, H, device=dev, generator=gen).to(dt)
              for _ in range(2))
    sc = 1 + 0.1 * torch.randn(H, device=dev, generator=gen)
    bi = 0.1 * torch.randn(H, device=dev, generator=gen)
    y = (3 * torch.randn(R, Fw, device=dev, generator=gen)).to(dt)
    b = torch.randn(Fw, device=dev, generator=gen)
    g = torch.randn(R, Fw, device=dev, generator=gen).to(dt)
    s8, dy8 = s[:8].clone(), dy[:8].clone()
    # case: (kernel, call on a library, plain version's output)
    cases = {
        "lnf": ("K3f", lambda lib: ln_fwd_call(lib, s, None, sc, bi),
                lambda: fe.layer_norm_plain(s, None, sc, bi)[1]),
        "lnf_resid": ("K3f", lambda lib: ln_fwd_call(lib, s, dy, sc, bi),
                      lambda: fe.layer_norm_plain(s, dy, sc, bi)),
        "lnf_8rows": ("K3f", lambda lib: ln_fwd_call(lib, s8, None, sc, bi),
                      lambda: fe.layer_norm_plain(s8, None, sc, bi)[1]),
        "lnf_8rows_resid": (
            "K3f", lambda lib: ln_fwd_call(lib, s8, dy8, sc, bi),
            lambda: fe.layer_norm_plain(s8, dy8, sc, bi)),
        "ln": ("K3b", lambda lib: ln_bwd_call(lib, s, sc, dy, None),
               lambda: fe.ln_backward_plain(s, sc, dy, None)[:1]),
        "ln_gs": ("K3b", lambda lib: ln_bwd_call(lib, s, sc, dy, gs),
                  lambda: fe.ln_backward_plain(s, sc, dy, gs)[:1]),
        "gelu": ("K4f", lambda lib: gelu_call(lib, y, b, False),
                 lambda: fe.bias_gelu_plain(y, b, False)),
        "gelu_exact": ("K4f", lambda lib: gelu_call(lib, y, b, True),
                       lambda: fe.bias_gelu_plain(y, b, True)),
        "gelu_bwd": ("K4b", lambda lib: gelu_bwd_call(lib, y, b, g, False),
                     lambda: fe.bias_gelu_backward_plain(y, b, g, False)),
        "gelu_bwd_exact": (
            "K4b", lambda lib: gelu_bwd_call(lib, y, b, g, True),
            lambda: fe.bias_gelu_backward_plain(y, b, g, True)),
    }
    cases = {k: v for k, v in cases.items() if v[0] in kinds}
    ref = {k: v[2]() for k, v in cases.items()}
    libs = {name: load(path) for name, (path, _) in built.items()}
    readings = {}
    order = list(variants) + list(reversed(variants))
    for turn, name in enumerate(order):
        lib = libs[name]
        rec = {"variant": name, "turn": turn, "defs": variants[name][0],
               "ptxas": built[name][1], "card": smi}
        for case, (kind, fn, _) in cases.items():
            if variants[name][1] not in (None, kind):
                continue
            got, got2 = fn(lib), fn(lib)
            torch.cuda.synchronize()
            as_tuple = (lambda v: v if isinstance(v, tuple) else (v,))
            got, got2, want = map(as_tuple, (got, got2, ref[case]))
            # The first output (y, dx, the GELU output or dz) in 2 ulp;
            # every output bit-equal across the two calls.
            ulps = cs.bf16_ulp_excess(got[-1] if case.startswith("lnf")
                                      else got[0],
                                      want[-1] if case.startswith("lnf")
                                      else want[0])
            same = all(torch.equal(a, c) for a, c in zip(got, got2))
            rec[case] = {"device_ms": cs.device_ms(lambda: fn(lib)),
                         "cold_ms": cs.cold_ms(lambda: fn(lib)),
                         "max_err_in_2ulp": ulps, "bit_equal": same}
            readings.setdefault(name, {}).setdefault(case, []).append(
                (rec[case]["device_ms"], rec[case]["cold_ms"]))
        cs.emit({"variant_reading": rec})
    cs.emit({"summary": readings, "card": smi,
             "shapes": {"rows": R, "H": H, "F": Fw, "dtype": "bf16"}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
