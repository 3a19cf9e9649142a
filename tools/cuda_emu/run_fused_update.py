#!/usr/bin/env python3
"""Run the fused-update kernels (the grad sum of squares K5 and the
fused Adam pass K6) on the CPU, in a warp emulation, in their whole-
buffer and their shard-local mode.

    python3 tools/cuda_emu/run_fused_update.py [--quick]

As ``run_elementwise.py`` does, this compiles
``deepspeed_tpu_torch/csrc/fused_update.cu`` with ``g++`` (no FMA
contraction) against the stand-in headers beside this script, each
``<<<...>>>`` launch rewritten as ``emu_launch`` and the kernel's static
shared scratch mapped onto the emulated block's, into
``build/cuda_emu/libemu_fused_update.so``, and calls the C entry points
with ``ctypes`` on CPU tensors. On a V-layout group buffer (8 x 8192
elements) it holds, for every flag set the engine runs (fp32 AdamW,
coupled Adam, the fp16 cast copy with the unscale and a forced skip,
the bf16 cast copy, master-free stochastic rounding):

- K6 over the whole buffer within 1 ulp of ``fused_adam_plain`` (the
  kernel rounds op by op, as the plain version does; the emulation's
  ``std::sqrt`` is correctly rounded, torch's vectorized CPU ``sqrt``
  is within 0.5001 ulp and rounds the other way at about one element
  in 65536 — on the card the two are bit-equal) and bit-equal across
  two launches;
- for dp 2, 4 and 8, the launches over each rank's rows with the rank's
  base in the seed row, joined, bit-equal to the whole-buffer launch —
  and with a base row near 2^32, where the noise index wraps as uint32;
- K5: the partials' sum within 1e-6 relative of ``sqnorm_plain``, each
  rank's and their sum over the ranks too, and an inf making it
  non-finite.

It checks the kernels' indexing and the base offset before a card
call; it says nothing of speed. About 5 s to build and 1-2 min for all
cases (``--quick``: one flag set at dp 2).
"""
import ctypes
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
REPO = HERE.parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(HERE))

from deepspeed_tpu_torch.ops import fused_update as fu  # noqa: E402
from deepspeed_tpu_torch.ops import op_builder  # noqa: E402
from run_elementwise import rewrite_launches  # noqa: E402

OUT = REPO / "build" / "cuda_emu"
ENTRIES = ("dstt_sqnorm_blocks", "dstt_sqnorm", "dstt_fused_adam")
CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
PRELUDE = """#include <cmath>
using std::isfinite;
struct float4 { float x, y, z, w; };
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fsqrt_rn(float a) { return std::sqrt(a); }
inline uint32_t __float_as_uint(float f) {
  uint32_t u; std::memcpy(&u, &f, 4); return u; }
inline float __uint_as_float(uint32_t u) {
  float f; std::memcpy(&f, &u, 4); return f; }
"""
# The kernel's static shared scratch → the emulated block's (its 128
# bytes of slack hold the 32 floats).
SMEM = {"__shared__ float red[32];":
        "float* red = reinterpret_cast<float*>(emu_smem());"}
V, LPAD = 8, 8192
# (name, param dtype, cast dtype, flags, [neg_lr, bc1, bc2, coeff, inv,
# skip]): the flag sets of chip_smoke.ADAM_FLAG_SETS.
FLAG_SETS = (
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


def build() -> ctypes.CDLL:
    src = OUT / "src_fused_update"
    src.mkdir(parents=True, exist_ok=True)
    csrc = op_builder.CSRC_DIR
    (src / "common.cuh").write_text((csrc / "common.cuh").read_text())
    text = (csrc / "fused_update.cu").read_text()
    for a, b in SMEM.items():
        assert a in text, a
        text = text.replace(a, b)
    # (a launch whose <<< opens a line of its own joins its kernel name)
    text = rewrite_launches(re.sub(r"\s+<<<", "<<<", text))
    (src / "fused_update.cpp").write_text(
        text.replace('#include "common.cuh"',
                     '#include "common.cuh"\n' + PRELUDE, 1))
    lib = OUT / "libemu_fused_update.so"
    subprocess.run(["g++", "-std=c++20", "-O2", "-ffp-contract=off",
                    "-shared", "-fPIC", "-pthread", "-w", f"-I{HERE}",
                    f"-I{src}", str(src / "fused_update.cpp"), "-o",
                    str(lib)], check=True)
    dll = ctypes.CDLL(str(lib))
    for name in ENTRIES:
        argtypes, restype = op_builder._SIGNATURES[name]
        getattr(dll, name).argtypes = argtypes
        getattr(dll, name).restype = restype
    return dll


def sqnorm(lib, g):
    part = torch.empty(lib.dstt_sqnorm_blocks(g.numel()))
    assert lib.dstt_sqnorm(g.data_ptr(), g.numel(), part.data_ptr(),
                           None) == 0
    return float(part.double().sum())


def adam(lib, g, p, m, v, cast, scalars, seed, flags):
    bits = (1 * flags["coupled"]) | (2 * flags["use_inv"]) | \
        (4 * flags["use_coeff"]) | 8 | (16 * bool(flags["wd"]))
    rc = lib.dstt_fused_adam(
        g.data_ptr(), p.data_ptr(), m.data_ptr(), v.data_ptr(),
        None if cast is None else cast.data_ptr(), scalars.data_ptr(),
        seed.data_ptr(), p.numel(), CODES[p.dtype],
        -1 if cast is None else CODES[cast.dtype], int(flags["sr"]), bits,
        0.9, 1 - 0.9, 0.999, 1 - 0.999, 1e-8, flags["wd"], None)
    assert rc == 0, rc


def sqnorm_case(lib, dp):
    gen = torch.Generator().manual_seed(dp)
    g = 1e-3 * torch.randn(V * LPAD, generator=gen)
    want = float(fu.sqnorm_plain(g))
    whole = sqnorm(lib, g)
    n = g.numel() // dp
    parts = [sqnorm(lib, g[d * n:(d + 1) * n]) for d in range(dp)]
    ok = abs(whole - want) <= 1e-6 * want and \
        abs(sum(parts) - want) <= 1e-6 * want and \
        all(abs(pt - float(fu.sqnorm_plain(g[d * n:(d + 1) * n]))) <=
            1e-6 * pt for d, pt in enumerate(parts))
    g[777] = float("inf")
    ok = ok and not torch.isfinite(torch.tensor(sqnorm(lib, g)))
    print(("ok  " if ok else "FAIL"), f"sqnorm dp={dp}", flush=True)
    return ok


def within_ulp(a, b):
    """|a - b| within 1 ulp (of a's dtype) of the larger magnitude."""
    bits = {torch.float32: 23, torch.bfloat16: 7, torch.float16: 10}
    a64, b64 = a.double(), b.double()
    mag = torch.maximum(a64.abs(), b64.abs()).clamp_min(1e-38)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - bits[a.dtype])
    return bool(((a64 - b64).abs() <= ulp).all())


def adam_case(lib, flag_set, dps, base0=0):
    name, p_dt, c_dt, flags, sc = flag_set
    N = V * LPAD
    gen = torch.Generator().manual_seed(len(name))
    g = 0.05 * torch.randn(N, generator=gen)
    if flags["use_inv"]:
        g = g * 2.0 ** 16
    p = (0.2 * torch.randn(N, generator=gen)).to(p_dt)
    m = 0.01 * torch.randn(N, generator=gen)
    v = 1e-4 * torch.rand(N, generator=gen)
    scalars = torch.tensor(sc + [0.0, 0.0])

    def seed(base):
        return torch.tensor([123456789, fu._int32(base)], dtype=torch.int32)

    def state():
        return [p.clone(), m.clone(), v.clone(),
                None if c_dt is None else torch.empty(N, dtype=c_dt)]
    W = state()
    adam(lib, g, W[0], W[1], W[2], W[3], scalars, seed(base0), flags)
    W2 = state()
    adam(lib, g, W2[0], W2[1], W2[2], W2[3], scalars, seed(base0), flags)
    ref = fu.fused_adam_plain(g, p, m, v, scalars, seed(base0), b1=0.9,
                              b2=0.999, eps=1e-8, one_pass=True,
                              cast_dtype=c_dt, **flags)
    ok = all(within_ulp(a, b) for a, b in zip(W, ref) if a is not None)
    ok = ok and all(torch.equal(a, b) for a, b in zip(W, W2)
                    if a is not None)
    for dp in dps:
        n = N // dp
        S = state()
        for d in range(dp):
            sl = slice(d * n, (d + 1) * n)
            adam(lib, g[sl], S[0][sl], S[1][sl], S[2][sl],
                 None if S[3] is None else S[3][sl], scalars,
                 seed(base0 + d * n), flags)
        ok = ok and all(torch.equal(a, b) for a, b in zip(S, W)
                        if a is not None)
    print(("ok  " if ok else "FAIL"), f"fused_adam {name} dp={dps} "
          f"base={base0}", flush=True)
    return ok


def main():
    t0 = time.perf_counter()
    lib = build()
    print(f"built in {time.perf_counter() - t0:.0f} s", flush=True)
    oks = []
    if "--quick" in sys.argv[1:]:
        oks.append(sqnorm_case(lib, 2))
        oks.append(adam_case(lib, FLAG_SETS[-1], (2,)))
    else:
        for dp in (2, 4, 8):
            oks.append(sqnorm_case(lib, dp))
        for fs in FLAG_SETS:
            oks.append(adam_case(lib, fs, (2, 4, 8)))
        # The noise index wraps as uint32 past 2^32.
        oks.append(adam_case(lib, FLAG_SETS[-1], (2, 4, 8),
                             base0=2 ** 32 - V * LPAD // 2))
    print(f"{sum(oks)} of {len(oks)} cases ok in "
          f"{time.perf_counter() - t0:.0f} s")
    return 0 if all(oks) else 1


if __name__ == "__main__":
    sys.exit(main())
