#!/usr/bin/env python3
"""Run the fused elementwise kernels (LayerNorm forward K3f and backward
K3b, bias+GELU forward K4f and backward K4b) on the CPU, in a warp
emulation, against their plain PyTorch versions.

    python3 tools/cuda_emu/run_elementwise.py [--quick] [-DNAME=VALUE ...]

As ``run_flash.py`` does for the flash sources, this compiles
``deepspeed_tpu_torch/csrc/fused_elementwise.cu`` with ``g++`` against the
stand-in headers beside this script (a thread per CUDA thread; barriers
for ``__syncthreads`` and the warp shuffles), each ``<<<...>>>`` launch
rewritten as ``emu_launch``, into ``build/cuda_emu/libemu_elementwise.so``,
and calls the C entry points with ``ctypes`` on CPU tensors. Each case is
held against ``layer_norm_plain`` / ``ln_backward_plain`` /
``bias_gelu_plain`` / ``bias_gelu_backward_plain`` within the card tests'
tolerances (fp32 1e-5; bf16 and fp16 2 ulp floored at 1e-5; dscale/dbias
and dbias within 1e-5 plus 2**-20 of the column's sum of magnitudes),
the residual sum ``s`` bit-equal to ``x + delta``, and every output must
be bit-equal across two launches: every dtype, H from 72 to 2048 (the
vector instances, the wide ones above H 1024, and the width-1 instance
for H 197 and for rows that start off a 16-byte boundary; the forward
also at H 4096 and 12256), rows 1, 7, 37 and 2113 (more rows than the
grid has warps), with and without the residual (cotangent), both GELU
forms (F 72 to 3072, the backward's runs of rows at rows 2113).
``-D`` arguments reach the compiler (the build settings of
``profile_torch_elementwise.py``'s variants, e.g.
``-DDSTT_LN_FWD_STAGES=1``). It checks the kernels' layouts, edges and
the row-to-warp walk before a card call; it says nothing of speed.
About 20 s to build and 6-10 min for all cases.
"""
import ctypes
import subprocess
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
REPO = HERE.parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

from deepspeed_tpu_torch.ops import fused_elementwise as fe  # noqa: E402
from deepspeed_tpu_torch.ops import op_builder  # noqa: E402
from torch_cases import FRACTION_BITS, ln_sum_magnitudes  # noqa: E402

OUT = REPO / "build" / "cuda_emu"
DTYPES = {"bf16": torch.bfloat16, "fp16": torch.float16,
          "fp32": torch.float32}
CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
ENTRIES = ("dstt_layer_norm", "dstt_layer_norm_bwd",
           "dstt_layer_norm_bwd_blocks",
           "dstt_bias_gelu", "dstt_bias_gelu_bwd",
           "dstt_bias_gelu_bwd_splits")
SMEM = {"extern __shared__ float4 smem4[];":
        "float4* smem4 = reinterpret_cast<float4*>(emu_smem());",
        "extern __shared__ float smem[];":
        "float* smem = reinterpret_cast<float*>(emu_smem());",
        "extern __shared__ double colsum_red[];":
        "double* colsum_red = reinterpret_cast<double*>(emu_smem());"}
PRELUDE = ("#include <algorithm>\nusing std::min;\n"
           "struct float4 { float x, y, z, w; };\n")


def _callee_start(text, at):
    """Start of the kernel expression that ends just before ``at`` (the
    ``<<<``): back over template brackets to whitespace at depth 0."""
    depth, i = 0, at - 1
    while i >= 0:
        c = text[i]
        if c == ">":
            depth += 1
        elif c == "<":
            depth -= 1
        elif c.isspace() and depth == 0:
            return i + 1
        i -= 1
    return 0


def _split_top(s):
    parts, depth, cur = [], 0, ""
    for c in s:
        if c in "(<[":
            depth += 1
        elif c in ")>]":
            depth -= 1
        if c == "," and depth == 0:
            parts.append(cur)
            cur = ""
        else:
            cur += c
    return parts + [cur]


def rewrite_launches(text):
    """``kern<<<grid, threads, smem, stream>>>(args);`` becomes
    ``emu_launch(grid, threads, smem, [=] { kern(args); });``."""
    while "<<<" in text:
        at = text.index("<<<")
        start = _callee_start(text, at)
        end_cfg = text.index(">>>", at)
        grid, threads, smem, _ = _split_top(text[at + 3:end_cfg])
        i, depth = end_cfg + 3, 0
        assert text[i] == "("
        while True:
            depth += {"(": 1, ")": -1}.get(text[i], 0)
            i += 1
            if depth == 0:
                break
        args = text[end_cfg + 4:i - 1]
        assert text[i] == ";"
        call = (f"emu_launch({grid.strip()}, {threads.strip()}, "
                f"{smem.strip()}, [=] {{ {text[start:at]}({args}); }});")
        text = text[:start] + call + text[i + 1:]
    return text


def build(defines=()) -> ctypes.CDLL:
    src = OUT / "src_elementwise"
    src.mkdir(parents=True, exist_ok=True)
    csrc = op_builder.CSRC_DIR
    (src / "common.cuh").write_text((csrc / "common.cuh").read_text())
    text = (csrc / "fused_elementwise.cu").read_text()
    for a, b in SMEM.items():
        text = text.replace(a, b)
    text = rewrite_launches(text)
    (src / "fused_elementwise.cpp").write_text(
        text.replace('#include "common.cuh"',
                     '#include "common.cuh"\n' + PRELUDE, 1))
    lib = OUT / "libemu_elementwise.so"
    subprocess.run(["g++", "-std=c++20", "-O2", "-shared", "-fPIC",
                    "-pthread", "-w", *defines, f"-I{HERE}", f"-I{src}",
                    str(src / "fused_elementwise.cpp"), "-o", str(lib)],
                   check=True)
    dll = ctypes.CDLL(str(lib))
    for name in ENTRIES:
        argtypes, restype = op_builder._SIGNATURES[name]
        getattr(dll, name).argtypes = argtypes
        getattr(dll, name).restype = restype
    return dll


def close(a, b, dtn):
    """The card tests' tolerance (tests/torch_cases.assert_close)."""
    a, b = a.float(), b.float()
    if dtn == "fp32":
        return bool(((a - b).abs() <= 1e-5 + 1e-5 * b.abs()).all())
    mag = torch.maximum(a.abs(), b.abs()).clamp_min(1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - FRACTION_BITS[dtn])
    return bool(((a - b).abs() <= torch.clamp_min(2 * ulp, 1e-5)).all())


def sums_close(a, b, mag):
    """Column sums in two fp32 orders: within 1e-5 plus 2**-20 of the
    column's sum of |term| (tests/torch_cases.assert_column_sums_close)."""
    return bool(((a - b).abs() <= 1e-5 + 2.0 ** -20 * mag).all())


def offset(t, shift):
    """``t``'s values in a contiguous view that starts ``shift`` elements
    into a larger buffer (not 16-byte aligned for shift 1)."""
    if not shift:
        return t
    buf = torch.empty(t.numel() + shift, dtype=t.dtype)
    v = buf[shift:].view(t.shape)
    v.copy_(t)
    return v


def ln_fwd(lib, x, d, sc, bi, shift):
    rows, H = x.shape
    y = offset(torch.empty_like(x), shift)
    s = offset(torch.empty_like(x), shift) if d is not None else None
    rc = lib.dstt_layer_norm(
        x.data_ptr(), None if d is None else d.data_ptr(), sc.data_ptr(),
        bi.data_ptr(), None if s is None else s.data_ptr(), y.data_ptr(),
        rows, H, 1e-5, CODES[x.dtype], None)
    assert rc == 0, rc
    return None if s is None else s.clone(), y.clone()


def ln_fwd_case(lib, dtn, H, rows, resid, shift=0):
    dt = DTYPES[dtn]
    g = torch.Generator().manual_seed(H * 17 + rows + resid)
    x = offset((2 * torch.randn(rows, H, generator=g) + 0.5).to(dt), shift)
    d = offset(torch.randn(rows, H, generator=g).to(dt), shift) \
        if resid else None
    sc = 1 + 0.1 * torch.randn(H, generator=g)
    bi = 0.1 * torch.randn(H, generator=g)
    rs, ry = fe.layer_norm_plain(x, d, sc, bi)
    s, y = ln_fwd(lib, x, d, sc, bi, shift)
    s2, y2 = ln_fwd(lib, x, d, sc, bi, shift)
    ok = close(y, ry, dtn) and torch.equal(y, y2)
    if resid:
        ok = ok and torch.equal(s, rs) and torch.equal(s, s2)
    print(("ok  " if ok else "FAIL"), f"ln_fwd {dtn} H={H} rows={rows} "
          f"resid={resid} shift={shift}", flush=True)
    return ok


def ln_bwd(lib, s, sc, dy, gs, shift):
    rows, H = s.shape
    blocks = lib.dstt_layer_norm_bwd_blocks(rows)
    dx = offset(torch.empty_like(s), shift)
    parts = torch.empty((2, blocks, H), dtype=torch.float64)
    out = torch.empty((2, H))
    rc = lib.dstt_layer_norm_bwd(
        s.data_ptr(), sc.data_ptr(), dy.data_ptr(),
        None if gs is None else gs.data_ptr(), dx.data_ptr(),
        parts.data_ptr(), out.data_ptr(), rows, H, 1e-5, CODES[s.dtype],
        None)
    assert rc == 0, rc
    return dx.clone(), out


def ln_case(lib, dtn, H, rows, with_gs, shift=0):
    dt = DTYPES[dtn]
    g = torch.Generator().manual_seed(H * 31 + rows + with_gs)
    s = offset((2 * torch.randn(rows, H, generator=g) + 0.5).to(dt), shift)
    dy = offset(torch.randn(rows, H, generator=g).to(dt), shift)
    gs = offset(torch.randn(rows, H, generator=g).to(dt), shift) \
        if with_gs else None
    sc = 1 + 0.1 * torch.randn(H, generator=g)
    rdx, rdsc, rdbi = fe.ln_backward_plain(s, sc, dy, gs)
    dx, part = ln_bwd(lib, s, sc, dy, gs, shift)
    dx2, part2 = ln_bwd(lib, s, sc, dy, gs, shift)
    mag = [torch.from_numpy(m).float()
           for m in ln_sum_magnitudes(s.float(), dy.float())]
    ok = (close(dx, rdx, dtn) and sums_close(part[0], rdsc, mag[0]) and
          sums_close(part[1], rdbi, mag[1]) and torch.equal(dx, dx2) and
          torch.equal(part, part2))
    print(("ok  " if ok else "FAIL"), f"ln_bwd {dtn} H={H} rows={rows} "
          f"gs={with_gs} shift={shift}", flush=True)
    return ok


def gelu_case(lib, dtn, F, rows, exact, shift=0):
    dt = DTYPES[dtn]
    g = torch.Generator().manual_seed(F * 7 + rows + exact)
    y = offset((3 * torch.randn(rows, F, generator=g)).to(dt), shift)
    b = torch.randn(F, generator=g)
    gr = offset(torch.randn(rows, F, generator=g).to(dt), shift)

    def fwd():
        out = offset(torch.empty_like(y), shift)
        rc = lib.dstt_bias_gelu(y.data_ptr(), b.data_ptr(), out.data_ptr(),
                                y.numel(), F, int(exact), CODES[dt], None)
        assert rc == 0, rc
        return out.clone()

    def bwd():
        splits = lib.dstt_bias_gelu_bwd_splits(rows)
        dz = offset(torch.empty_like(y), shift)
        part = torch.empty((splits, F))
        db = torch.empty(F)
        rc = lib.dstt_bias_gelu_bwd(y.data_ptr(), b.data_ptr(), gr.data_ptr(),
                                    dz.data_ptr(), part.data_ptr(),
                                    db.data_ptr(), rows, F, int(exact),
                                    CODES[dt], None)
        assert rc == 0, rc
        return dz.clone(), db

    out, out2 = fwd(), fwd()
    (dz, db), (dz2, db2) = bwd(), bwd()
    rdz, rdb = fe.bias_gelu_backward_plain(y, b, gr, exact)
    ok = (close(out, fe.bias_gelu_plain(y, b, exact), dtn) and
          torch.equal(out, out2) and close(dz, rdz, dtn) and
          sums_close(db, rdb, rdz.float().abs().sum(0)) and
          torch.equal(dz, dz2) and
          torch.equal(db, db2))
    print(("ok  " if ok else "FAIL"), f"bias_gelu {dtn} F={F} rows={rows} "
          f"exact={exact} shift={shift}", flush=True)
    return ok


def main():
    t0 = time.perf_counter()
    lib = build([a for a in sys.argv[1:] if a.startswith("-D")])
    print(f"built in {time.perf_counter() - t0:.0f} s", flush=True)
    oks = []
    if "--quick" in sys.argv[1:]:
        oks.append(ln_fwd_case(lib, "bf16", 768, 37, True))
        oks.append(ln_case(lib, "bf16", 768, 37, True))
        oks.append(gelu_case(lib, "bf16", 3072, 7, True))
    else:
        for dtn in ("bf16", "fp16", "fp32"):
            for H in (72, 128, 197, 200, 768, 1024, 1600, 2048):
                for rows, resid in ((1, False), (7, True), (37, False),
                                    (37, True)):
                    oks.append(ln_fwd_case(lib, dtn, H, rows, resid))
            for H in (4096, 12256):
                oks.append(ln_fwd_case(lib, dtn, H, 7, True))
            oks.append(ln_fwd_case(lib, dtn, 768, 37, True, shift=1))
            oks.append(ln_fwd_case(lib, dtn, 1600, 7, False, shift=1))
            # More rows than warps: each warp walks several rows, through
            # its ring and past its end.
            oks.append(ln_fwd_case(lib, dtn, 768, 2113, True))
            oks.append(ln_fwd_case(lib, dtn, 768, 2113, False))
            oks.append(ln_fwd_case(lib, dtn, 200, 2113, True))
        for dtn in ("bf16", "fp16", "fp32"):
            for H in (72, 128, 197, 200, 768, 1024, 1600, 2048):
                for rows, with_gs in ((1, False), (7, True), (37, False),
                                      (37, True)):
                    oks.append(ln_case(lib, dtn, H, rows, with_gs))
            oks.append(ln_case(lib, dtn, 768, 37, True, shift=1))
            # More rows than warps: each warp walks 2-3 rows.
            oks.append(ln_case(lib, dtn, 768, 2113, True))
            oks.append(ln_case(lib, dtn, 1600, 2113, False))
            oks.append(ln_case(lib, dtn, 1600, 7, True, shift=1))
            for F in (72, 197, 200, 3072):
                for rows in (1, 7, 37):
                    for exact in (False, True):
                        oks.append(gelu_case(lib, dtn, F, rows, exact))
            oks.append(gelu_case(lib, dtn, 3072, 37, True, shift=1))
            # Several runs of rows a thread, the last one short.
            oks.append(gelu_case(lib, dtn, 200, 2113, False))
            oks.append(gelu_case(lib, dtn, 197, 2113, True))
    print(f"{sum(oks)} of {len(oks)} cases ok in "
          f"{time.perf_counter() - t0:.0f} s")
    return 0 if all(oks) else 1


if __name__ == "__main__":
    sys.exit(main())
