#!/usr/bin/env python3
"""Run the flash kernels and the block-sparse backward kernels on the
CPU, in a warp emulation, against their plain PyTorch versions.

    python3 tools/cuda_emu/run_flash.py [--quick]

The CUDA sources compile only where there is ``nvcc``. This compiles
``deepspeed_tpu_torch/csrc/flash_attention.cu`` and ``sparse_flash.cu``
with ``g++`` instead, against the stand-in headers beside this script
(``cuda_runtime.h``: a thread per CUDA thread and barriers; ``mma.cuh``:
``ldmatrix`` and ``mma.sync`` exchanged through per-warp slots), with
each ``<<<...>>>`` launch rewritten as ``emu_launch``, into
``build/cuda_emu/libemu.so``. It then calls the C entry points with
``ctypes`` on CPU tensors (the signatures of ``ops/op_builder.py``) and
holds K1 (o; lse within 1e-4), K2c, the K2a + K2b pair (ungated and
gated), K8b + K8c and K8a against ``flash_fwd_plain`` /
``flash_bwd_plain`` / ``sparse_bwd_plain``: bf16 and fp16 at
head dims 32, 48, 64, 128, fp32 at 32, causal or not, dropout 0 and
0.1, within the card tests' tolerances (2**-7 bf16, 2**-9 fp16, 1e-5
fp32 of each output's largest magnitude) and bit-equal across two
launches. It checks fragment layouts, tile walks and numerics before a
card call; it says nothing of speed, and the product sums run in
another order than the tensor cores'. About 15 s to build and 5 s a
case (``--quick``: one case).
"""
import ctypes
import random
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
REPO = HERE.parent.parent
sys.path.insert(0, str(REPO))

from deepspeed_tpu_torch.ops import flash_attention as fa  # noqa: E402
from deepspeed_tpu_torch.ops import op_builder  # noqa: E402
from deepspeed_tpu_torch.ops import sparse_attention as sa  # noqa: E402
from deepspeed_tpu_torch.ops import sparse_flash as sf  # noqa: E402

OUT = REPO / "build" / "cuda_emu"
DTYPES = {"bf16": torch.bfloat16, "fp16": torch.float16,
          "fp32": torch.float32}
CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
REL = {"fp32": 1e-5, "bf16": 2.0 ** -7, "fp16": 2.0 ** -9}
LAUNCH = re.compile(r"(\S+)<<<([^,]+),\s*([^,]+),\s*([^,]+),\s*([^>]+)>>>"
                    r"\(([^)]*)\);")


def build() -> ctypes.CDLL:
    src = OUT / "src"
    src.mkdir(parents=True, exist_ok=True)
    csrc = op_builder.CSRC_DIR
    for name in ("common.cuh", "flash_tiles.cuh"):
        (src / name).write_text((csrc / name).read_text())
    cpps = []
    for name in ("flash_attention", "sparse_flash"):
        text = (csrc / f"{name}.cu").read_text().replace(
            "extern __shared__ __align__(128) unsigned char smem[];",
            "unsigned char* smem = emu_smem();")
        text = LAUNCH.sub(r"emu_launch(\2, \3, \4, [=] { \1(\6); });", text)
        (src / f"{name}.cpp").write_text(text)
        cpps.append(str(src / f"{name}.cpp"))
    lib = OUT / "libemu.so"
    # The stand-ins come first on the include path: mma.cuh replaces the
    # real one, which flash_tiles.cuh includes by name.
    subprocess.run(["g++", "-std=c++20", "-O2", "-shared", "-fPIC",
                    "-pthread", "-w", f"-I{HERE}", f"-I{src}", *cpps, "-o",
                    str(lib)], check=True)
    dll = ctypes.CDLL(str(lib))
    for name, (argtypes, restype) in op_builder._SIGNATURES.items():
        if name.startswith(("dstt_flash", "dstt_sparse_flash")):
            getattr(dll, name).argtypes = argtypes
            getattr(dll, name).restype = restype
    return dll


def inputs(dt, B, S, nH, D, seed):
    """q, k, v the strided split of one projection, dO contiguous."""
    g = torch.Generator().manual_seed(seed)
    qkv = torch.randn(B, S, 3 * nH * D, generator=g).to(dt)
    q, k, v = (t.reshape(B, S, nH, D) for t in qkv.split(nH * D, -1))
    return q, k, v, torch.randn(B, S, nH, D, generator=g).to(dt)


def tail(q, drop, causal, scale):
    B, S, nH, D = q.shape
    return (B, nH, S, D, float(scale), float(drop),
            fa._inv_keep(drop) if drop > 0 else 1.0, int(causal),
            CODES[q.dtype], None)


def rel(a, b):
    return float((a.float() - b.float()).abs().max() /
                 b.float().abs().max().clamp_min(1e-30))


def forward(lib, q, k, v, causal, scale, drop, seed, lay=None):
    B, S, nH, D = q.shape
    o = torch.empty((B, S, nH, D), dtype=q.dtype)
    lse = torch.empty((B * nH, S))
    gate = (None, 0, 0) if lay is None else \
        (lay.data_ptr(), lay.shape[-1], S // lay.shape[-1])
    rc = lib.dstt_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), *q.stride()[:3],
        o.data_ptr(), lse.data_ptr(), seed.data_ptr() if drop > 0 else None,
        *gate, *tail(q, drop, causal, scale))
    assert rc == 0, rc
    return o, lse


def dense(lib, kind, q, k, v, do, lse, delta, causal, scale, drop, seed,
          lay=None):
    st, e = q.stride()[:3], lambda: torch.empty(q.shape, dtype=q.dtype)
    sp = seed.data_ptr() if drop > 0 else None
    ptrs = [t.data_ptr() for t in (q, k, v)]
    bwd = [t.data_ptr() for t in (do, lse, delta)]
    gate = (None, 0, 0) if lay is None else \
        (lay.data_ptr(), lay.shape[-1], q.shape[1] // lay.shape[-1])
    dq, dk, dv = e(), e(), e()
    t = tail(q, drop, causal, scale)
    if kind == "fused":
        rcs = [lib.dstt_flash_bwd_fused(*ptrs, *st, *bwd, dq.data_ptr(),
                                        dk.data_ptr(), dv.data_ptr(), sp,
                                        *t)]
    else:
        rcs = [lib.dstt_flash_bwd_dq(*ptrs, *st, *bwd, dq.data_ptr(), sp,
                                     *gate, *t),
               lib.dstt_flash_bwd_dkv(*ptrs, *st, *bwd, dk.data_ptr(),
                                      dv.data_ptr(), sp, *gate, *t)]
    assert rcs == [0] * len(rcs), rcs
    return dq, dk, dv


def sparse(lib, kind, q, k, v, do, lse, delta, lay, causal, scale, drop,
           seed, widen, qwiden):
    plan = sf.sparse_plan(lay, q.shape[1], q.dtype, causal, q.device, widen,
                          qwiden)
    B, S, nH, D = q.shape
    dq, dk, dv = (torch.empty(q.shape, dtype=q.dtype) for _ in range(3))
    ws = torch.empty(B * nH * plan.slots_per_head * plan.tile * D) \
        if kind == 3 else None
    P = (lambda t: None if t is None else t.data_ptr())  # noqa: E731
    rc = lib.dstt_sparse_flash(
        kind, q.data_ptr(), k.data_ptr(), v.data_ptr(), *q.stride()[:3],
        P(do), P(lse), P(delta), None, P(dq), P(dk), P(dv), P(ws),
        seed.data_ptr() if drop > 0 else None, P(plan.row_ptr), P(plan.kid),
        P(plan.kmask), plan.kid.shape[1], P(plan.col_ptr), P(plan.qidT),
        P(plan.kmaskT), plan.qidT.shape[1], P(plan.slot_base),
        P(plan.rslot_ptr), P(plan.rslots), plan.rslots.shape[1],
        plan.slots_per_head, plan.block, plan.widen, plan.qwiden,
        *tail(q, drop, causal, scale))
    assert rc == 0, rc
    return dq, dk, dv


def judge(name, runs, want, tol):
    """{run: (max relative error, bit-equal across launches)}; True when
    every run is within tol and repeats."""
    out, ok = {}, True
    for kind, fn in runs.items():
        got, again = fn(), fn()
        errs = max(rel(a, b) for a, b in zip(got, want))
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        out[kind] = (round(errs, 6), same)
        ok &= errs <= tol and same
    print(("ok  " if ok else "FAIL"), name, out, flush=True)
    return ok


def dense_case(lib, dtn, S, D, causal, drop, gated=False, nH=2):
    dt = DTYPES[dtn]
    q, k, v, do = inputs(dt, 1, S, nH, D, S + D + causal)
    seed = torch.tensor(-123456789, dtype=torch.int32)
    scale, lay = D ** -0.5, None
    if gated:  # 64-blocks, the diagonal kept, one k-column closed
        nb = S // 64
        keep = np.random.default_rng(S + D).random((nH, nb, nb)) < 0.6
        keep[:, np.arange(nb), np.arange(nb)] = True
        keep[:, 1:, 1] = False
        lay = torch.from_numpy(keep.astype(np.int32))
    o, lse = fa.flash_fwd_plain(q, k, v, causal, scale, drop, seed, lay)
    got = forward(lib, q, k, v, causal, scale, drop, seed, lay)
    lse_ok = float((got[1] - lse).abs().max()) <= 1e-4
    fwd_ok = judge("  forward", {"fwd": lambda: forward(
        lib, q, k, v, causal, scale, drop, seed, lay)[:1]}, (o,), REL[dtn])
    args = (q, k, v, do, lse, fa.flash_delta(do, o), causal, scale, drop,
            seed)
    want = fa.flash_bwd_plain(*args, layout=lay)
    runs = {"pair": lambda: dense(lib, "pair", *args, lay=lay)}
    if not gated:
        runs["fused"] = lambda: dense(lib, "fused", *args)
    return lse_ok and fwd_ok and judge(
        f"{dtn} S={S} D={D} causal={causal} dropout={drop}"
        f"{' gated' if gated else ''}", runs, want, REL[dtn])


def sparse_case(lib, dtn, D, kind, causal, tile, drop, S=512, nH=2):
    dt = DTYPES[dtn]
    q, k, v, do = inputs(dt, 1, S, nH, D, D + causal)
    random.seed(0)
    lay = (sa.FixedSparsityConfig(num_heads=nH, block=128,
                                  num_local_blocks=2,
                                  attention="unidirectional")
           if kind == "fixed" else
           sa.BigBirdSparsityConfig(num_heads=nH, block=128,
                                    num_random_blocks=1,
                                    different_layout_per_head=True)
           ).make_layout(S)
    seed = torch.tensor(-123456789, dtype=torch.int32)
    scale = D ** -0.5
    o, lse = sf.sparse_fwd_plain(q, k, v, lay, causal, scale, drop, seed)
    args = (q, k, v, do, lse, fa.flash_delta(do, o), lay, causal, scale,
            drop, seed, tile[1], tile[0])
    want = sf.sparse_bwd_plain(*args[:11])
    runs = {"pair": lambda: (sparse(lib, 1, *args)[0],
                             *sparse(lib, 2, *args)[1:]),
            "fused": lambda: sparse(lib, 3, *args)}
    return judge(f"sparse {dtn} D={D} {kind} causal={causal} tile={tile} "
                 f"dropout={drop}", runs, want, REL[dtn])


def main():
    t0 = time.perf_counter()
    lib = build()
    print(f"built {OUT / 'libemu.so'} in {time.perf_counter() - t0:.0f} s",
          flush=True)
    if "--quick" in sys.argv[1:]:
        oks = [dense_case(lib, "bf16", 128, 64, True, 0.1)]
    else:
        oks = []
        for dtn, S, dims in (("bf16", 192, (32, 48, 64, 128)),
                             ("fp16", 192, (32, 48, 64, 128)),
                             ("fp32", 96, (32,))):
            for D in dims:
                for causal in (True, False):
                    for drop in (0.0, 0.1):
                        oks.append(dense_case(lib, dtn, S, D, causal, drop))
            oks.append(dense_case(lib, dtn, 2 * S, dims[-1], True, 0.1,
                                  gated=True))
        for args in (("bf16", 64, "fixed", True, (1, 1), 0.1),
                     ("bf16", 64, "bigbird", False, (1, 2), 0.0),
                     ("fp16", 128, "bigbird", True, (2, 1), 0.1),
                     ("fp16", 32, "fixed", True, (2, 2), 0.0),
                     ("fp32", 32, "fixed", True, (1, 1), 0.1)):
            oks.append(sparse_case(lib, *args))
    print(f"{sum(oks)} of {len(oks)} cases ok in "
          f"{time.perf_counter() - t0:.0f} s")
    return 0 if all(oks) else 1


if __name__ == "__main__":
    sys.exit(main())
