#!/usr/bin/env python3
"""Build variants of the LayerNorm backward (K3b) and bias+GELU forward
(K4f) kernels and read them side by side on one card, in one process.

    python3 profile_torch_elementwise.py

Each variant compiles ``deepspeed_tpu_torch/csrc/fused_elementwise.cu``
(with ``runtime.cu``) with other ``-D`` settings into its own library
under ``build/variants/`` (all built in parallel, with the ptxas report),
and is called through the same C entry points as the port's wrappers:

- K3b: ``DSTT_LN_BWD_STAGES`` (the depth of each warp's shared-memory
  ring of rows, filled by cp.async; 1: the next row in registers
  instead), ``DSTT_LN_BWD_WARPS`` (warps a block) and
  ``DSTT_LN_BWD_BLOCKS_PER_SM`` (the grid, 132 times it, and the
  register cap of the launch bounds);
- K4f: ``DSTT_GELU_ROWS`` (rows a thread walks) and
  ``DSTT_GELU_UNROLL`` (rows in flight).

At the training shapes (8192 rows of 768 or 3072, bf16): K3b with and
without the residual cotangent, including the sum of the
per-block partials (the entry point's second launch), and K4f in both
forms, each against its plain
version (2 bf16 ulp) and read as ``device_ms`` (CUDA-graph replay) and
``cold_ms`` (one call after a 64 MB write), in the order of the variant
list and then reversed. Prints one JSON line per variant and reading,
with its registers and spills, then a summary. Needs a CUDA device.
"""
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
VARIANTS = {
    "ring3_w8_b1": {},
    "ring3_w4_b2": {"DSTT_LN_BWD_WARPS": 4, "DSTT_LN_BWD_BLOCKS_PER_SM": 2},
    "ring4_w8_b1": {"DSTT_LN_BWD_STAGES": 4},
    "ring3_w16_b1": {"DSTT_LN_BWD_WARPS": 16},
    "regs_prefetch_w8_b1": {"DSTT_LN_BWD_STAGES": 1},
    "gelu_rows8": {"DSTT_GELU_ROWS": 8},
}
ENTRIES = ("dstt_layer_norm_bwd", "dstt_layer_norm_bwd_blocks",
           "dstt_bias_gelu", "dstt_error_string")


def build_all():
    """{variant: (library, {kernel instance: ptxas line})}."""
    nvcc = op_builder.find_nvcc()
    srcs = [op_builder.CSRC_DIR / "fused_elementwise.cu",
            op_builder.CSRC_DIR / "runtime.cu"]
    procs = {}
    for name, defs in VARIANTS.items():
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
    """Registers and spills of the main path's instances: K3b bf16 at
    three vectors a lane (H 768), K4f bf16 16-byte vectors."""
    want = {"ln_bwd_bf16_gs": r"ln_bwd_kernelI13__nv_bfloat16Lb1ELi3ELi8E",
            "ln_bwd_bf16": r"ln_bwd_kernelI13__nv_bfloat16Lb0ELi3ELi8E",
            "gelu_bf16_tanh": r"bias_gelu_kernelI13__nv_bfloat16Li8ELb0E",
            "gelu_bf16_erf": r"bias_gelu_kernelI13__nv_bfloat16Li8ELb1E"}
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
    built = build_all()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    R, H, Fw, dt = cs.TRAIN_ROWS, 768, 3072, torch.bfloat16
    s = (2 * torch.randn(R, H, device=dev, generator=gen) + 0.5).to(dt)
    dy, gs = (torch.randn(R, H, device=dev, generator=gen).to(dt)
              for _ in range(2))
    sc = 1 + 0.1 * torch.randn(H, device=dev, generator=gen)
    y = (3 * torch.randn(R, Fw, device=dev, generator=gen)).to(dt)
    b = torch.randn(Fw, device=dev, generator=gen)
    ref = {"ln": fe.ln_backward_plain(s, sc, dy, None),
           "ln_gs": fe.ln_backward_plain(s, sc, dy, gs),
           "gelu": fe.bias_gelu_plain(y, b, False),
           "gelu_exact": fe.bias_gelu_plain(y, b, True)}
    libs = {name: load(path) for name, (path, _) in built.items()}
    cases = {
        "ln": lambda lib: ln_bwd_call(lib, s, sc, dy, None),
        "ln_gs": lambda lib: ln_bwd_call(lib, s, sc, dy, gs),
        "gelu": lambda lib: gelu_call(lib, y, b, False),
        "gelu_exact": lambda lib: gelu_call(lib, y, b, True),
    }
    readings = {}
    order = list(VARIANTS) + list(reversed(VARIANTS))
    for turn, name in enumerate(order):
        lib = libs[name]
        rec = {"variant": name, "turn": turn, "defs": VARIANTS[name],
               "ptxas": built[name][1], "card": smi}
        for case, fn in cases.items():
            got = fn(lib)
            got2 = fn(lib)
            torch.cuda.synchronize()
            want = ref[case]
            if case.startswith("ln"):
                ulps = cs.bf16_ulp_excess(got[0], want[0])
                same = all(torch.equal(a, c) for a, c in zip(got, got2))
            else:
                ulps = cs.bf16_ulp_excess(got, want)
                same = torch.equal(got, got2)
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
