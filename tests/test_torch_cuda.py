"""The PyTorch port's CUDA kernels against their plain PyTorch versions,
on the card (marker ``cuda``; every test skips where there is no CUDA
device). The file imports no JAX, so it runs on a GPU machine without
it, apart from the JAX tests' conftest:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerances: LayerNorm/GELU forward and backward fp32 1e-5, bf16/fp16 2
ulp floored at 1e-5 (tests/torch_cases.py), dscale/dbias 1e-5, both GELU
forms, the residual sum bit-equal to ``x + d``, and K3f, K3b, K4f and
K4b bit-equal across two launches (where the
sums run over thousands of rows, dscale/dbias within 1e-5 plus 2**-20
of the column's sum of magnitudes: fp32 sums in two orders); the grad
sum of squares relative 1e-5 (two fp32 summation orders); the fused
Adam step bit-equal to its plain version (both round op by op), and
the stochastic rounding equal element for element; paged attention
atol/rtol 2e-5 (fp32 queries, fp32 or bf16 pools); the flash kernels
(ungated and layout-gated; the forward and backward tiles at every head
dim and the training sequences) and the sparse LUT kernels within 1e-5
(fp32), 2**-7 (bf16) or 2**-9 (fp16) of each output's largest magnitude
and bit-equal across two launches; the serving engine's
kernel path against its CPU plain path on gpt2-tiny in fp32: logits atol
1e-4 and equal greedy streams; two gpt2-tiny fp32 training steps on the
card against the CPU: losses and grad norms within 1e-4 relative; the
grouped GEMM (K9): its pre-activation within the LayerNorm tolerances of
the plain version, a GELU output within them of the plain epilogue of
the kernel's own pre-activation, bit-equal across two launches and
across strided, unaligned and contiguous views of the same operands;
the grouped FFN forward and backward on the card against the CPU within
1e-5 (fp32) or 2**-7 (bf16) of each leaf's largest magnitude; two
gpt2-tiny fp32 MoE steps as the dense ones, with equal expert token
counts and drop fractions.
"""
import dataclasses

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch import ops
from deepspeed_tpu_torch.inference import InferenceEngine, \
    shared_prefix_requests
from deepspeed_tpu_torch.models.gpt2 import GPT2_CONFIGS, gpt2_init, \
    gpt2_loss_fn
from deepspeed_tpu_torch.ops import fused_elementwise as fe
from deepspeed_tpu_torch.ops import fused_update as fu
from deepspeed_tpu_torch.ops import grouped_gemm as gg
from deepspeed_tpu_torch.ops import paged_attention as pa
from torch_cases import (ADAM_CASES, PAGED_CASES, PAGED_SPLIT_CASES,
                         adam_case, assert_close, assert_column_sums_close,
                         ln_sum_magnitudes, paged_case, paged_split_case,
                         ulps)

pytestmark = pytest.mark.cuda
SPARSE_ZERO = {"sparse_flash_fwd": 0, "sparse_flash_bwd_dq": 0,
               "sparse_flash_bwd_dkv": 0, "sparse_flash_bwd_fused": 0}
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16,
          "fp16": torch.float16}
CFG32 = dataclasses.replace(GPT2_CONFIGS["gpt2-tiny"], dtype=torch.float32)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _np(t):
    return t.float().cpu().numpy()


@pytest.mark.parametrize("H", [128, 197, 768, 1600, 4096, 12256])
@pytest.mark.parametrize("dtype_name", ["fp32", "bf16", "fp16"])
def test_layer_norm_kernels_match_plain(dev, H, dtype_name):
    """K3f without and with the residual at 33 rows: the 16-byte
    instances (H 128, 768), the width-1 one (H 197), the wide rows (H
    1600 up to 12256; fp32 from H 768): within the plain version's
    tolerances, ``s`` bit-equal to ``x + d``, each bit-equal across two
    launches, one launch counted a call."""
    dt = DTYPES[dtype_name]
    g = torch.Generator(device=dev).manual_seed(H)
    x = (2 * torch.randn(33, H, device=dev, generator=g) + 0.5).to(dt)
    d = torch.randn(33, H, device=dev, generator=g).to(dt)
    sc = 1 + 0.1 * torch.randn(H, device=dev, generator=g)
    bi = 0.1 * torch.randn(H, device=dev, generator=g)
    before = (fe.fused_layer_norm.launches,
              fe.fused_residual_layer_norm.launches)
    y = fe.fused_layer_norm(x, sc, bi)
    s, yr = fe.fused_residual_layer_norm(x, d, sc, bi)
    y2 = fe.fused_layer_norm(x, sc, bi)
    s2, yr2 = fe.fused_residual_layer_norm(x, d, sc, bi)
    s_ref, yr_ref = fe.layer_norm_plain(x, d, sc, bi)
    torch.cuda.synchronize()
    assert (fe.fused_layer_norm.launches,
            fe.fused_residual_layer_norm.launches) == \
        (before[0] + 2, before[1] + 2)
    assert torch.equal(s, s_ref)                  # residual sum bit-equal
    assert torch.equal(s, x + d)
    assert_close(_np(y), _np(fe.layer_norm_plain(x, None, sc, bi)[1]),
                 dtype_name)
    assert_close(_np(yr), _np(yr_ref), dtype_name)
    assert torch.equal(y, y2) and torch.equal(s, s2) and \
        torch.equal(yr, yr2)


@pytest.mark.parametrize("F", [512, 3072])
@pytest.mark.parametrize("dtype_name", ["fp32", "bf16"])
def test_bias_gelu_kernel_matches_plain(dev, F, dtype_name):
    dt = DTYPES[dtype_name]
    g = torch.Generator(device=dev).manual_seed(F)
    y = (3 * torch.randn(33, F, device=dev, generator=g)).to(dt)
    b = torch.randn(F, device=dev, generator=g)
    out = fe.fused_bias_gelu(y, b)
    torch.cuda.synchronize()
    assert out.dtype == dt
    assert_close(_np(out), _np(fe.bias_gelu_plain(y, b)), dtype_name)


@pytest.mark.parametrize("D", pa.HEAD_DIMS)
@pytest.mark.parametrize("kv", ["fp32", "bf16"])
@pytest.mark.parametrize("name", sorted(PAGED_CASES))
def test_paged_attention_kernel_matches_plain(dev, name, kv, D):
    c = paged_case(sum(map(ord, name)) + D, D=D, **PAGED_CASES[name])
    q = torch.from_numpy(c["q"]).to(dev)
    args = [torch.from_numpy(c[k]).to(dev, DTYPES[kv]) for k in "kv"] + \
        [torch.from_numpy(c[k]).to(dev) for k in ("bt", "pos")]
    before = pa.paged_attention.launches
    out = pa.paged_attention(q, *args, c["scale"])
    torch.cuda.synchronize()
    assert pa.paged_attention.launches == before + 1
    ref = pa.paged_attention_plain(q, *args, c["scale"])
    # q and the output are fp32 and a bf16 pool widens exactly, so both
    # sides compute the same fp32 function whatever the pool's dtype.
    np.testing.assert_allclose(_np(out), _np(ref), atol=2e-5, rtol=2e-5)
    dead = c["bt"][..., 0] < 0
    assert (_np(out)[dead] == 0).all()


def test_paged_attention_ignores_unnamed_and_masked_garbage(dev):
    c = paged_case(6, [[10, 3]], K=2, D=64)
    t = {k: torch.from_numpy(c[k]).to(dev) for k in ("q", "k", "v", "bt",
                                                     "pos")}
    ref = pa.paged_attention(t["q"], t["k"], t["v"], t["bt"], t["pos"],
                             c["scale"])
    used = set(c["bt"][c["bt"] >= 0].tolist())
    for b in range(c["k"].shape[1]):
        if b not in used:
            t["k"][:, b] = float("nan")
            t["v"][:, b] = float("nan")
    blk, last = int(c["bt"][0, 0, 1]), int(c["pos"][0, 0].max())
    t["k"][0, blk, :, last % 8 + 1:] = float("inf")
    out = pa.paged_attention(t["q"], t["k"], t["v"], t["bt"], t["pos"],
                             c["scale"])
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert torch.equal(out, ref)


@pytest.mark.parametrize("D", pa.HEAD_DIMS)
@pytest.mark.parametrize("q_dt, kv_dt", [("fp32", "fp32"), ("bf16", "bf16"),
                                         ("fp32", "bf16")])
@pytest.mark.parametrize("name", sorted(PAGED_SPLIT_CASES))
def test_paged_attention_splits_match_plain_and_repeat_bit_equal(
        dev, name, q_dt, kv_dt, D):
    """The split kernel (several blocks per stream and head, merged in
    split order) against the plain version: fp32 queries atol/rtol 2e-5,
    bf16 queries 2 bf16 ulp; dead streams and rows that attend nothing
    exactly 0; two launches bit-equal."""
    spec = PAGED_SPLIT_CASES[name]
    c = paged_split_case(sum(map(ord, name)) + D, D=D, **spec)
    q = torch.from_numpy(c["q"]).to(dev, DTYPES[q_dt])
    kv = [torch.from_numpy(c[k]).to(dev, DTYPES[kv_dt]) for k in "kv"]
    bt, pos = (torch.from_numpy(c[k]).to(dev) for k in ("bt", "pos"))
    G, Q, K, nH, _ = q.shape
    assert pa.paged_splits(G * Q, nH, bt.shape[-1], K) > 1
    before = pa.paged_attention.launches
    out = pa.paged_attention(q, *kv, bt, pos, c["scale"])
    again = pa.paged_attention(q, *kv, bt, pos, c["scale"])
    ref = pa.paged_attention_plain(q, *kv, bt, pos, c["scale"])
    torch.cuda.synchronize()
    assert pa.paged_attention.launches == before + 2
    assert torch.equal(out, again)
    if q_dt == "fp32":
        np.testing.assert_allclose(_np(out), _np(ref), atol=2e-5, rtol=2e-5)
    else:
        assert_close(_np(out), _np(ref), "bf16")
    assert (_np(out)[c["bt"][..., 0] < 0] == 0).all()
    assert (_np(out)[c["pos"] < 0] == 0).all()
    for s, rows in spec.get("rows", {}).items():
        # The row at position 2 alone: every split past the first adds an
        # exact 0, so it equals the same row run as a one-row stream.
        g, sq = divmod(s, Q)
        k = rows.index(2)
        one = pa.paged_attention(q[g:g + 1, sq:sq + 1, k:k + 1].contiguous(),
                                 *[t[g:g + 1].contiguous() for t in kv],
                                 bt[g:g + 1, sq:sq + 1].contiguous(),
                                 pos[g:g + 1, sq:sq + 1, k:k + 1].contiguous(),
                                 c["scale"])
        torch.cuda.synchronize()
        assert torch.equal(one[0, 0, 0], out[g, sq, k])


def test_kernel_wrappers_reject_what_the_kernels_do_not_take(dev):
    c = paged_case(1, [[5, 9]], D=64)
    t = {k: torch.from_numpy(c[k]).to(dev) for k in ("q", "k", "v", "bt",
                                                     "pos")}
    with pytest.raises(TypeError, match="int32"):
        pa.paged_attention(t["q"], t["k"], t["v"], t["bt"].long(), t["pos"],
                           c["scale"])
    with pytest.raises(ValueError, match="head_dim"):
        pa.paged_attention(t["q"][..., :48].contiguous(),
                           t["k"][..., :48].contiguous(),
                           t["v"][..., :48].contiguous(), t["bt"], t["pos"],
                           c["scale"])
    with pytest.raises(TypeError, match="not supported"):
        pa.paged_attention(t["q"].bfloat16(), t["k"], t["v"], t["bt"],
                           t["pos"], c["scale"])
    with pytest.raises(ValueError, match="on cpu"):
        pa.paged_attention(t["q"], t["k"], t["v"], t["bt"].cpu(), t["pos"],
                           c["scale"])
    x = torch.randn(8, 256, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        fe.fused_layer_norm(x[:, ::2], torch.ones(128, device=dev),
                            torch.zeros(128, device=dev))
    with pytest.raises(TypeError, match="float16"):
        fe.fused_bias_gelu(x.double(), torch.zeros(256, device=dev))
    wide = torch.randn(4, 2049, device=dev)
    with pytest.raises(ValueError, match="H <= 2048"):
        fe.layer_norm_backward(wide, torch.ones(2049, device=dev), wide,
                               None)


def _engine(params, device, **inf):
    return InferenceEngine(CFG32, params, config={"inference": dict(
        {"max_slots": 4, "max_seq_len": 64, "prefill_chunk": 8,
         "block_size": 8}, **inf)}, device=device)


def _drive(eng):
    prompt = np.random.default_rng(0).integers(0, 512, 19).astype(np.int32)
    tok, lg = eng.prefill(prompt, slot=1, return_logits=True)
    eng.activate_slot(1, len(prompt), tok)
    logits, toks = [lg], [tok]
    for _ in range(5):
        s, lg = eng.decode_once(return_logits=True)
        logits.append(lg[1])
        toks.append(int(s[1]))
    return logits, toks


def test_engine_kernel_path_matches_cpu_plain_path(dev):
    torch.backends.cuda.matmul.allow_tf32 = False
    params = gpt2_init(CFG32, torch.Generator().manual_seed(0), "cpu")
    (cl, ct), (gl, gt) = _drive(_engine(params, "cpu")), \
        _drive(_engine(params, dev))
    assert gt == ct
    for a, b in zip(gl, cl):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)


@pytest.mark.parametrize("spec_k", [0, 3])
def test_engine_serve_streams_match_cpu(dev, spec_k):
    torch.backends.cuda.matmul.allow_tf32 = False
    params = gpt2_init(CFG32, torch.Generator().manual_seed(1), "cpu")
    reqs = lambda: shared_prefix_requests(  # noqa: E731
        6, prefix_len=16, tail_len=(0, 6), max_new_tokens=5, seed=0)
    streams = []
    for device in ("cpu", dev):
        rep = _engine(params, device, spec_k=spec_k).serve(reqs())
        assert rep["completed"] == 6
        streams.append([r["tokens"] for r in rep["requests"]])
    assert streams[0] == streams[1]


def test_decode_step_launch_counts(dev):
    params = gpt2_init(CFG32, torch.Generator().manual_seed(0), "cpu")
    eng = _engine(params, dev)
    tok, _ = eng.prefill(np.arange(12, dtype=np.int32), slot=0)
    eng.activate_slot(0, 12, tok)
    ops.reset_launch_counts()
    eng.decode_once()
    L = CFG32.num_layers
    assert ops.launch_counts() == {
        "fused_layer_norm": 2 * L + 1, "fused_residual_layer_norm": 0,
        "fused_bias_gelu": L, "layer_norm_backward": 0,
        "bias_gelu_backward": 0, "sqnorm": 0, "fused_adam_apply": 0,
        "paged_attention": L, "flash_attention_fwd": 0,
        "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0,
        "flash_attention_bwd_fused": 0, "grouped_matmul": 0,
        **SPARSE_ZERO}


# --------------------------------------------------------------------- #
# Training kernels: LayerNorm / GELU backward, grad norm, fused Adam
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("gs", [False, True])
@pytest.mark.parametrize("H", [128, 200, 768, 1600])
@pytest.mark.parametrize("dtype_name", ["fp32", "bf16", "fp16"])
def test_layer_norm_backward_kernel_matches_plain(dev, H, dtype_name, gs):
    dt = DTYPES[dtype_name]
    g = torch.Generator(device=dev).manual_seed(H + gs)
    s = (2 * torch.randn(600, H, device=dev, generator=g) + 0.5).to(dt)
    dy = torch.randn(600, H, device=dev, generator=g).to(dt)
    res = torch.randn(600, H, device=dev, generator=g).to(dt) if gs \
        else None
    sc = 1 + 0.1 * torch.randn(H, device=dev, generator=g)
    before = fe.layer_norm_backward.launches
    dx, dsc, dbi = fe.layer_norm_backward(s, sc, dy, res)
    torch.cuda.synchronize()
    assert fe.layer_norm_backward.launches == before + 1
    rdx, rdsc, rdbi = fe.ln_backward_plain(s, sc, dy, res)
    assert dx.dtype == dt and dsc.dtype == torch.float32
    assert_close(_np(dx), _np(rdx), dtype_name)
    for a, b in ((dsc, rdsc), (dbi, rdbi)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("F", [197, 200, 512, 3072])
@pytest.mark.parametrize("dtype_name", ["fp32", "bf16", "fp16"])
def test_bias_gelu_backward_kernel_matches_plain(dev, F, dtype_name):
    """K4b in the tanh and the erf form at 300 rows (five runs of rows,
    the last one short): the 16-byte instance, and the width-1 one for F
    197; dz within the plain version's tolerances, dbias within 1e-5,
    both bit-equal across two launches, one launch counted a call."""
    dt = DTYPES[dtype_name]
    g = torch.Generator(device=dev).manual_seed(F)
    y = (3 * torch.randn(300, F, device=dev, generator=g)).to(dt)
    b = torch.randn(F, device=dev, generator=g)
    gr = torch.randn(300, F, device=dev, generator=g).to(dt)
    for exact in (False, True):
        before = fe.bias_gelu_backward.launches
        dz, db = fe.bias_gelu_backward(y, b, gr, exact)
        dz2, db2 = fe.bias_gelu_backward(y, b, gr, exact)
        torch.cuda.synchronize()
        assert fe.bias_gelu_backward.launches == before + 2
        rdz, rdb = fe.bias_gelu_backward_plain(y, b, gr, exact)
        assert_close(_np(dz), _np(rdz), dtype_name)
        np.testing.assert_allclose(_np(db), _np(rdb), rtol=1e-5, atol=1e-5)
        assert torch.equal(dz, dz2) and torch.equal(db, db2)


def _shifted(t, shift):
    """``t``'s values in a contiguous view ``shift`` elements into a larger
    buffer: for shift 1 the rows start off a 16-byte boundary, which the
    kernels take through their width-1 instances."""
    if not shift:
        return t
    buf = torch.empty(t.numel() + shift, dtype=t.dtype, device=t.device)
    v = buf[shift:].view(t.shape)
    v.copy_(t)
    return v


@pytest.mark.parametrize("shift", [0, 1])
@pytest.mark.parametrize("gs", [False, True])
@pytest.mark.parametrize("rows", [1, 7, 8191])
@pytest.mark.parametrize("H", [72, 128, 197, 200, 768, 1600, 2048])
@pytest.mark.parametrize("dtype_name", ["fp32", "bf16", "fp16"])
def test_layer_norm_backward_kernel_edges_repeat_bit_equal(
        dev, dtype_name, H, rows, gs, shift):
    """K3b at every instance (16-byte vectors, the wide rows above H 1024,
    the width-1 instance for H 197 and for unaligned rows), rows fewer
    than a block's warps and more than the grid's: within the plain
    version's tolerances, and bit-equal across two launches (the
    row-to-warp map is fixed by the shape)."""
    dt = DTYPES[dtype_name]
    g = torch.Generator(device=dev).manual_seed(H * 7 + rows + gs)
    mk = lambda: torch.randn(rows, H, device=dev, generator=g)  # noqa: E731
    s = _shifted((2 * mk() + 0.5).to(dt), shift)
    dy = _shifted(mk().to(dt), shift)
    res = _shifted(mk().to(dt), shift) if gs else None
    sc = 1 + 0.1 * torch.randn(H, device=dev, generator=g)
    first = fe.layer_norm_backward(s, sc, dy, res)
    again = fe.layer_norm_backward(s, sc, dy, res)
    torch.cuda.synchronize()
    rdx, rdsc, rdbi = fe.ln_backward_plain(s, sc, dy, res)
    assert_close(_np(first[0]), _np(rdx), dtype_name)
    for a, b, m in zip(first[1:], (rdsc, rdbi),
                       ln_sum_magnitudes(_np(s), _np(dy))):
        assert_column_sums_close(_np(a), _np(b), m)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("shift", [0, 1])
@pytest.mark.parametrize("resid", [False, True])
@pytest.mark.parametrize("rows", [1, 8, 33, 2113])
@pytest.mark.parametrize("H", [72, 128, 197, 768, 1024, 1600, 4096, 12256])
@pytest.mark.parametrize("dtype_name", ["fp32", "bf16", "fp16"])
def test_layer_norm_kernel_edges_repeat_bit_equal(dev, dtype_name, H, rows,
                                                  resid, shift):
    """K3f at every instance (16-byte vectors up to H 1024, 512 in fp32;
    the wide rows above; the width-1 instance for H 197 and for rows that
    start off a 16-byte boundary), rows fewer than a block's warps and
    more than the grid's (each warp walks its ring past its last row):
    within the plain version's tolerances, ``s`` bit-equal to ``x + d``,
    bit-equal across two launches."""
    dt = DTYPES[dtype_name]
    g = torch.Generator(device=dev).manual_seed(H * 5 + rows + resid)
    x = _shifted((2 * torch.randn(rows, H, device=dev, generator=g)
                  + 0.5).to(dt), shift)
    d = _shifted(torch.randn(rows, H, device=dev, generator=g).to(dt),
                 shift) if resid else None
    sc = 1 + 0.1 * torch.randn(H, device=dev, generator=g)
    bi = 0.1 * torch.randn(H, device=dev, generator=g)
    if resid:
        first = fe.fused_residual_layer_norm(x, d, sc, bi)
        again = fe.fused_residual_layer_norm(x, d, sc, bi)
    else:
        first = (x, fe.fused_layer_norm(x, sc, bi))
        again = (x, fe.fused_layer_norm(x, sc, bi))
    torch.cuda.synchronize()
    s_ref, y_ref = fe.layer_norm_plain(x, d, sc, bi)
    assert torch.equal(first[0], s_ref)
    assert_close(_np(first[1]), _np(y_ref), dtype_name)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("shift", [0, 1])
@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("rows", [1, 7, 2113, 8191])
@pytest.mark.parametrize("F", [72, 197, 200, 512, 3072])
@pytest.mark.parametrize("dtype_name", ["fp32", "bf16", "fp16"])
def test_bias_gelu_kernels_both_forms_edges_repeat_bit_equal(
        dev, dtype_name, F, rows, exact, shift):
    """K4f and K4b (16-byte vectors, and the width-1 instances for F 197
    and for unaligned rows; K4b's runs of rows and their partial sums
    from one run to 129) in the tanh and the erf form: within the plain
    versions' tolerances, bit-equal across two launches."""
    dt = DTYPES[dtype_name]
    g = torch.Generator(device=dev).manual_seed(F * 3 + rows + exact)
    y = _shifted((3 * torch.randn(rows, F, device=dev, generator=g)).to(dt),
                 shift)
    b = torch.randn(F, device=dev, generator=g)
    gr = _shifted(torch.randn(rows, F, device=dev, generator=g).to(dt),
                  shift)
    before = (fe.fused_bias_gelu.launches, fe.bias_gelu_backward.launches)
    out = fe.fused_bias_gelu(y, b, exact)
    out2 = fe.fused_bias_gelu(y, b, exact)
    dz, db = fe.bias_gelu_backward(y, b, gr, exact)
    dz2, db2 = fe.bias_gelu_backward(y, b, gr, exact)
    torch.cuda.synchronize()
    assert (fe.fused_bias_gelu.launches, fe.bias_gelu_backward.launches) \
        == (before[0] + 2, before[1] + 2)
    assert_close(_np(out), _np(fe.bias_gelu_plain(y, b, exact)), dtype_name)
    rdz, rdb = fe.bias_gelu_backward_plain(y, b, gr, exact)
    assert_close(_np(dz), _np(rdz), dtype_name)
    assert_column_sums_close(_np(db), _np(rdb), np.abs(_np(rdz)).sum(0))
    assert torch.equal(out, out2) and torch.equal(dz, dz2) and \
        torch.equal(db, db2)


def test_autograd_functions_run_the_backward_kernels(dev):
    """Gradients through the kernel-backed autograd Functions equal
    plain autograd through the reference ops (fp32, rtol 1e-4)."""
    from deepspeed_tpu_torch.models.transformer import KERNEL_OPS, PLAIN_OPS
    g = torch.Generator(device=dev).manual_seed(3)
    mk = lambda *shape: torch.randn(*shape, device=dev, generator=g)  # noqa: E731
    x, d, w1 = mk(4, 9, 256), mk(4, 9, 256), mk(4, 9, 256)
    sc, bi, w2 = 1 + 0.1 * mk(256), 0.1 * mk(256), mk(4, 9, 512)
    kern, fb = mk(256, 512) * 0.05, mk(512)
    grads = []
    for ops_ in (KERNEL_OPS, PLAIN_OPS):
        leaves = [t.clone().requires_grad_() for t in (x, d, sc, bi, fb)]
        s, y = ops_.res_ln(*leaves[:4], 1e-5)
        y = ops_.ln(y, leaves[2], leaves[3], 1e-5)
        z = ops_.gelu_up(y, kern, leaves[4])
        ((s * w1).sum() + (z * w2).sum()).backward()
        grads.append([t.grad for t in leaves])
        if ops_ is KERNEL_OPS:
            torch.cuda.synchronize()
            counts = (fe.layer_norm_backward.launches,
                      fe.bias_gelu_backward.launches)
    assert counts[0] >= 2 and counts[1] >= 1
    for a, b in zip(*grads):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n", [1, 7, 4099, (1 << 20) + 3])
def test_sqnorm_kernel_matches_plain(dev, n):
    g = torch.randn(n, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(n))
    before = fu.sqnorm.launches
    got = fu.sqnorm(g)
    torch.cuda.synchronize()
    assert fu.sqnorm.launches == before + 1
    np.testing.assert_allclose(float(got), float(fu.sqnorm_plain(g)),
                               rtol=1e-5)
    g[n // 2] = float("inf")
    assert not torch.isfinite(fu.sqnorm(g))


@pytest.mark.parametrize("name", sorted(ADAM_CASES))
def test_fused_adam_kernel_matches_plain(dev, name):
    p_dt, c_dt, kw, _ = ADAM_CASES[name]
    g, p, m, v, scalars, seed = (torch.from_numpy(a).to(dev)
                                 for a in adam_case(name, 100003))
    p = p.to(getattr(torch, p_dt))
    cast = None if c_dt is None else torch.empty(
        p.shape, dtype=getattr(torch, c_dt), device=dev)
    ref = fu.fused_adam_plain(g, p, m, v, scalars, seed, b1=0.9, b2=0.999,
                              eps=1e-8, cast_dtype=None if cast is None
                              else cast.dtype, **kw)
    p0, m0, v0 = p.clone(), m.clone(), v.clone()
    before = fu.fused_adam_apply.launches
    fu.fused_adam_apply(g, p, m, v, scalars, seed, b1=0.9, b2=0.999,
                        eps=1e-8, cast_out=cast, **kw)
    torch.cuda.synchronize()
    assert fu.fused_adam_apply.launches == before + 1
    if scalars[5] > 0:                       # forced skip: nothing moves
        assert torch.equal(p, p0) and torch.equal(m, m0) and \
            torch.equal(v, v0)
    for got, want in ((p, ref[0]), (m, ref[1]), (v, ref[2])):
        assert torch.equal(got, want), (name, float(
            ulps(_np(got), _np(want), "fp32").max()))
    if cast is not None:
        assert torch.equal(cast, ref[3])


def test_train_batch_on_the_card_matches_the_cpu(dev):
    """Two gpt2-tiny fp32 steps (gas 2, AdamW, clip) on the card and on
    the CPU from the same params and batches; each step launches exactly
    its kernels."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(CFG32, hidden_dropout=0.0, attn_dropout=0.0)
    params = gpt2_init(cfg, torch.Generator().manual_seed(0), "cpu")
    ds = {"train_batch_size": 4, "gradient_accumulation_steps": 2,
          "gradient_clipping": 1.0, "steps_per_print": 10 ** 9,
          "optimizer": {"type": "AdamW",
                        "params": {"lr": 1e-3, "weight_decay": 0.01}}}
    batches = np.random.default_rng(0).integers(0, 512, (2, 4, 33))
    out = {}
    for device in ("cpu", dev):
        eng, *_ = deepspeed_tpu_torch.initialize(
            model=gpt2_loss_fn(cfg), model_params=params, config=ds,
            device=device)
        hist = []
        for b in batches:
            ops.reset_launch_counts()
            loss = eng.train_batch(b)
            hist.append((float(loss), float(eng.last_metrics["grad_norm"]),
                         ops.launch_counts()))
        out[str(device)] = hist
    L = cfg.num_layers
    for (lc, nc, cc), (lg, ng, cg) in zip(out["cpu"], out["cuda"]):
        np.testing.assert_allclose(lg, lc, rtol=1e-4)
        np.testing.assert_allclose(ng, nc, rtol=1e-4)
        assert sum(cc.values()) == 0
        assert cg == {"fused_layer_norm": 2 * (L + 1),
                      "fused_residual_layer_norm": 2 * L,
                      "fused_bias_gelu": 2 * L,
                      "layer_norm_backward": 2 * (2 * L + 1),
                      "bias_gelu_backward": 2 * L, "sqnorm": 1,
                      "fused_adam_apply": 1, "paged_attention": 0,
                      # S = 32 is not a multiple of 128: dense attention
                      "flash_attention_fwd": 0, "flash_attention_bwd_dq": 0,
                      "flash_attention_bwd_dkv": 0,
                      "flash_attention_bwd_fused": 0, "grouped_matmul": 0,
                      **SPARSE_ZERO}


# --------------------------------------------------------------------- #
# Flash attention: K1, K2a, K2b, K2c
# --------------------------------------------------------------------- #
# Kernel against plain: both round p and ds to the input type at the
# same points but at different running maxima (the kernel's online
# softmax over 64-column tiles, the plain whole-row formula) and sum in
# other orders; outputs within this fraction of their largest magnitude.
FLASH_REL = {"fp32": 1e-5, "bf16": 2.0 ** -7, "fp16": 2.0 ** -9}


def _flash_inputs(dev, dt, B, S, nH, D, seed):
    """q, k, v as the strided split of one [B, S, 3*nH*D] projection, as
    the model hands them over; dO contiguous."""
    g = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn(B, S, 3 * nH * D, device=dev, generator=g).to(dt)
    q, k, v = (t.reshape(B, S, nH, D) for t in qkv.split(nH * D, dim=-1))
    do = torch.randn(B, S, nH, D, device=dev, generator=g).to(dt)
    return q, k, v, do


def _rel(a, b):
    return float((a.float() - b.float()).abs().max() /
                 b.float().abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("drop", [0.0, 0.1])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype_name, D", [("fp32", 32), ("bf16", 64),
                                           ("bf16", 48), ("fp16", 128)])
def test_flash_kernels_match_plain_and_repeat_bit_equal(dev, dtype_name, D,
                                                        causal, drop):
    from deepspeed_tpu_torch.ops import flash_attention as fa
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = DTYPES[dtype_name]
    q, k, v, do = _flash_inputs(dev, dt, 2, 256, 3, D, D + causal)
    seed = torch.tensor(-123456789, dtype=torch.int32, device=dev)
    scale = D ** -0.5
    tol = FLASH_REL[dtype_name]
    o, lse = fa.flash_attention_fwd(q, k, v, causal, scale, drop, seed)
    ro, rlse = fa.flash_fwd_plain(q, k, v, causal, scale, drop, seed)
    assert _rel(o, ro) <= tol
    torch.testing.assert_close(lse, rlse, rtol=0, atol=1e-4)
    delta = fa.flash_delta(do, o)
    args = (q, k, v, do, lse, delta, causal, scale, drop, seed)
    want = fa.flash_bwd_plain(*args)
    got = {"fused": fa.flash_attention_bwd_fused(*args),
           "split": (fa.flash_attention_bwd_dq(*args),
                     *fa.flash_attention_bwd_dkv(*args))}
    for name, grads in got.items():
        for gk, gw in zip(grads, want):
            assert gk.dtype == dt and gk.is_contiguous()
            assert _rel(gk, gw) <= tol, name
    again = (fa.flash_attention_fwd(q, k, v, causal, scale, drop, seed)[0],
             *fa.flash_attention_bwd_fused(*args),
             fa.flash_attention_bwd_dq(*args),
             *fa.flash_attention_bwd_dkv(*args))
    first = (o, *got["fused"], *got["split"])
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("drop", [0.0, 0.1])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype_name", ["bf16", "fp16"])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("S", [128, 384, 768, 1024])
def test_flash_forward_tile_matches_plain_and_repeats(dev, S, D, dtype_name,
                                                      causal, drop, gated):
    """The register-resident forward tile (K1) over the sequence lengths
    of the training, split-backward and prefill paths, every head-dim
    width, causal or not, with and without dropout, ungated or gated by a
    layout of 128-blocks: o within 2**-7 (bf16) or 2**-9 (fp16) of its
    largest magnitude, lse within 1e-4, two launches bit-equal."""
    from deepspeed_tpu_torch.ops import flash_attention as fa
    dt = DTYPES[dtype_name]
    q, k, v, _ = _flash_inputs(dev, dt, 2, S, 2, D, S + D + causal)
    seed = torch.tensor(24681357, dtype=torch.int32, device=dev)
    lay = None
    if gated:
        # A random layout of 128-blocks, its diagonal kept, one k-column
        # closed where there are three or more.
        nb = S // 128
        keep = np.random.default_rng(S + D).random((2, nb, nb)) < 0.6
        keep[:, np.arange(nb), np.arange(nb)] = True
        if nb >= 3:
            keep[:, 1:, 1] = False
        lay = torch.from_numpy(keep.astype(np.int32)).to(dev)
    before = fa.flash_attention_fwd.launches
    o, lse = fa.flash_attention_fwd(q, k, v, causal, D ** -0.5, drop, seed,
                                    lay)
    o2, lse2 = fa.flash_attention_fwd(q, k, v, causal, D ** -0.5, drop, seed,
                                      lay)
    ro, rlse = fa.flash_fwd_plain(q, k, v, causal, D ** -0.5, drop, seed, lay)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.launches == before + 2
    assert _rel(o, ro) <= FLASH_REL[dtype_name]
    torch.testing.assert_close(lse, rlse, rtol=0, atol=1e-4)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("drop", [0.0, 0.1])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype_name", ["bf16", "fp16"])
@pytest.mark.parametrize("D", [32, 48, 64, 128])
@pytest.mark.parametrize("S", [128, 384, 768, 1024])
def test_flash_backward_tiles_match_plain_and_repeat(dev, S, D, dtype_name,
                                                     causal, drop, gated):
    """The register-resident backward tiles: K2c (ungated cases) and the
    K2a + K2b pair (ungated, or gated by a layout of 128-blocks) over the
    sequence lengths of the training and split-backward paths, every
    head-dim width (48 padded to 64), causal or not, with and without
    dropout: dq, dk, dv within 2**-7 (bf16) or 2**-9 (fp16) of their
    largest magnitude of flash_bwd_plain's, two launches bit-equal."""
    from deepspeed_tpu_torch.ops import flash_attention as fa
    dt = DTYPES[dtype_name]
    q, k, v, do = _flash_inputs(dev, dt, 2, S, 2, D, S + D + causal + 1)
    seed = torch.tensor(13579, dtype=torch.int32, device=dev)
    scale = D ** -0.5
    lay = None
    if gated:
        nb = S // 128
        keep = np.random.default_rng(S + D + 1).random((2, nb, nb)) < 0.6
        keep[:, np.arange(nb), np.arange(nb)] = True
        if nb >= 3:
            keep[:, 1:, 1] = False
        lay = torch.from_numpy(keep.astype(np.int32)).to(dev)
    o, lse = fa.flash_fwd_plain(q, k, v, causal, scale, drop, seed, lay)
    delta = fa.flash_delta(do, o)
    args = (q, k, v, do, lse, delta, causal, scale, drop, seed)
    want = fa.flash_bwd_plain(*args, layout=lay)
    ops.reset_launch_counts()

    def pair():
        return (fa.flash_attention_bwd_dq(*args, lay),
                *fa.flash_attention_bwd_dkv(*args, lay))
    runs = {"pair": pair} if gated else \
        {"pair": pair, "fused": lambda: fa.flash_attention_bwd_fused(*args)}
    for name, fn in runs.items():
        got, again = fn(), fn()
        torch.cuda.synchronize()
        for gk, gw in zip(got, want):
            assert gk.dtype == dt and gk.is_contiguous()
            assert _rel(gk, gw) <= FLASH_REL[dtype_name], name
        assert all(torch.equal(a, b) for a, b in zip(got, again)), name
    counts = {n: c for n, c in ops.launch_counts().items() if c}
    assert counts == dict({"flash_attention_bwd_dq": 2,
                           "flash_attention_bwd_dkv": 2},
                          **({} if gated else
                             {"flash_attention_bwd_fused": 2}))


@pytest.mark.parametrize("S, kernels", [
    (128, {"flash_attention_fwd": 1, "flash_attention_bwd_fused": 1}),
    (384, {"flash_attention_fwd": 1, "flash_attention_bwd_dq": 1,
           "flash_attention_bwd_dkv": 1})])
def test_flash_attention_autograd_on_the_card_matches_the_cpu(dev, S,
                                                              kernels):
    """fp32 causal flash attention with dropout through autograd: the
    card's kernels against the CPU's plain versions, same int32 seed; the
    fused rule picks the kernels."""
    from deepspeed_tpu_torch.ops import flash_attention as fa
    torch.backends.cuda.matmul.allow_tf32 = False
    x = np.random.default_rng(S).standard_normal((4, 2, S, 2, 32)) \
        .astype(np.float32)
    out = {}
    for device in ("cpu", dev):
        leaves = [torch.from_numpy(a).to(device).requires_grad_()
                  for a in x[:3]]
        seed = torch.tensor(987654, dtype=torch.int32, device=device)
        ops.reset_launch_counts()
        o = fa.flash(*leaves, seed, 32 ** -0.5, True, 0.1)
        o.backward(torch.from_numpy(x[3]).to(device))
        torch.cuda.synchronize()
        out[str(device)] = ([_np(o.detach())] + [_np(t.grad) for t in leaves],
                            {n: c for n, c in ops.launch_counts().items()
                             if c})
    assert out["cpu"][1] == {} and out["cuda"][1] == kernels
    for a, b in zip(out["cuda"][0], out["cpu"][0]):
        np.testing.assert_allclose(a, b, atol=1e-5 * np.abs(b).max(),
                                   rtol=0)


def test_whole_prompt_serve_on_the_card_matches_the_cpu(dev):
    """prefill_chunk: 0 at max_seq_len 128: the card prefills through the
    flash forward (one launch per layer and admission), the CPU through
    dense attention; greedy streams equal."""
    torch.backends.cuda.matmul.allow_tf32 = False
    params = gpt2_init(CFG32, torch.Generator().manual_seed(1), "cpu")
    streams = []
    for device in ("cpu", dev):
        eng = _engine(params, device, prefill_chunk=0, max_seq_len=128)
        ops.reset_launch_counts()
        rep = eng.serve(shared_prefix_requests(6, prefix_len=16,
                                               tail_len=(0, 6),
                                               max_new_tokens=5, seed=0))
        assert rep["completed"] == 6
        streams.append([r["tokens"] for r in rep["requests"]])
        if device != "cpu":
            c = ops.launch_counts()
            assert c["flash_attention_fwd"] == 6 * CFG32.num_layers
            assert c["paged_attention"] > 0
    assert streams[0] == streams[1]


# --------------------------------------------------------------------- #
# Block-sparse attention: K7, K8a, K8b, K8c and the gated K1/K2a/K2b
# --------------------------------------------------------------------- #
def _layouts(nH, S, kind, seed=0):
    import random
    from deepspeed_tpu_torch.ops import sparse_attention as sa
    random.seed(seed)
    if kind == "fixed":
        return sa.FixedSparsityConfig(num_heads=nH, block=128,
                                      num_local_blocks=2,
                                      attention="unidirectional"
                                      ).make_layout(S)
    return sa.BigBirdSparsityConfig(num_heads=nH, block=128,
                                    num_random_blocks=1,
                                    different_layout_per_head=True
                                    ).make_layout(S)


@pytest.mark.parametrize("drop", [0.0, 0.1])
@pytest.mark.parametrize("kind, causal, tile", [
    ("fixed", True, (1, 1)), ("fixed", True, (2, 2)),
    ("bigbird", False, (1, 2)), ("bigbird", True, (2, 1))])
@pytest.mark.parametrize("dtype_name, D", [("fp32", 32), ("bf16", 64),
                                           ("fp16", 128)])
def test_sparse_kernels_match_plain_and_repeat_bit_equal(
        dev, dtype_name, D, kind, causal, tile, drop):
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import sparse_flash as sf
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = DTYPES[dtype_name]
    S, nH = 512, 3
    q, k, v, do = _flash_inputs(dev, dt, 2, S, nH, D, D + causal)
    lay = _layouts(nH, S, kind)
    seed = torch.tensor(-123456789, dtype=torch.int32, device=dev)
    scale = D ** -0.5
    tol = FLASH_REL[dtype_name]
    qw, w = tile
    o, lse = sf.sparse_flash_fwd(q, k, v, lay, causal, scale, drop, seed, w,
                                 qw)
    ro, rlse = sf.sparse_fwd_plain(q, k, v, lay, causal, scale, drop, seed)
    assert _rel(o, ro) <= tol
    torch.testing.assert_close(lse, rlse, rtol=0, atol=1e-4)
    delta = fa.flash_delta(do, o)
    args = (q, k, v, do, lse, delta, lay, causal, scale, drop, seed, w, qw)
    want = sf.sparse_bwd_plain(*args[:11])
    got = {"fused": sf.sparse_flash_bwd_fused(*args),
           "split": (sf.sparse_flash_bwd_dq(*args),
                     *sf.sparse_flash_bwd_dkv(*args))}
    for name, grads in got.items():
        for gk, gw in zip(grads, want):
            assert gk.dtype == dt and gk.is_contiguous()
            assert _rel(gk, gw) <= tol, name
    again = (sf.sparse_flash_fwd(q, k, v, lay, causal, scale, drop, seed, w,
                                 qw)[0],
             *sf.sparse_flash_bwd_fused(*args), sf.sparse_flash_bwd_dq(*args),
             *sf.sparse_flash_bwd_dkv(*args))
    first = (o, *got["fused"], *got["split"])
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("causal, drop", [(True, 0.1), (False, 0.0)])
@pytest.mark.parametrize("dtype_name, D", [("fp32", 32), ("bf16", 64)])
def test_gated_flash_kernels_match_plain_and_repeat_bit_equal(
        dev, dtype_name, D, causal, drop):
    """K1, K2a, K2b with a layout on the card (an empty k-column too)."""
    from deepspeed_tpu_torch.ops import flash_attention as fa
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = DTYPES[dtype_name]
    S, nH = 512, 3
    q, k, v, do = _flash_inputs(dev, dt, 2, S, nH, D, D + 7)
    lay = torch.from_numpy(_layouts(nH, S, "bigbird", 1)).to(
        dev, torch.int32)
    lay[:, :, 2] = 0
    seed = torch.tensor(97531, dtype=torch.int32, device=dev)
    scale = D ** -0.5
    tol = FLASH_REL[dtype_name]
    o, lse = fa.flash_attention_fwd(q, k, v, causal, scale, drop, seed, lay)
    ro, rlse = fa.flash_fwd_plain(q, k, v, causal, scale, drop, seed, lay)
    assert _rel(o, ro) <= tol
    torch.testing.assert_close(lse, rlse, rtol=0, atol=1e-4)
    delta = fa.flash_delta(do, o)
    args = (q, k, v, do, lse, delta, causal, scale, drop, seed, lay)
    want = fa.flash_bwd_plain(*args)
    got = (fa.flash_attention_bwd_dq(*args),
           *fa.flash_attention_bwd_dkv(*args))
    for gk, gw in zip(got, want):
        assert _rel(gk, gw) <= tol
    assert not got[1][:, 256:384].any() and not got[2][:, 256:384].any()
    again = (fa.flash_attention_fwd(q, k, v, causal, scale, drop, seed,
                                    lay)[0],
             fa.flash_attention_bwd_dq(*args),
             *fa.flash_attention_bwd_dkv(*args))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip((o, *got), again))
    with pytest.raises(ValueError, match="multiples"):
        fa.flash_attention_fwd(q, k, v, causal, scale, drop, seed,
                               torch.ones(nH, 32, 32, dtype=torch.int32,
                                          device=dev))


@pytest.mark.parametrize("route, env, kernels", [
    ("lut", "0", {"sparse_flash_fwd": 1, "sparse_flash_bwd_dq": 1,
                  "sparse_flash_bwd_dkv": 1}),
    ("lut", "1", {"sparse_flash_fwd": 1, "sparse_flash_bwd_fused": 1}),
    ("gated", "0", {"flash_attention_fwd": 1, "flash_attention_bwd_dq": 1,
                    "flash_attention_bwd_dkv": 1})])
def test_sparse_attention_autograd_on_the_card_matches_the_cpu(
        dev, monkeypatch, route, env, kernels):
    """fp32 causal sparse attention with dropout through autograd: the
    LUT kernels (the split pair, or the fused backward with
    DS_SPARSE_FUSED_BWD=1) or the gated ones on the card against the
    CPU's plain versions, same int32 seed; ``flash_attention`` routes a
    host layout to the LUT kernels and a CUDA one to the gated mode."""
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import sparse_flash as sf
    torch.backends.cuda.matmul.allow_tf32 = False
    monkeypatch.setenv("DS_SPARSE_FUSED_BWD", env)
    S = 512
    x = np.random.default_rng(5).standard_normal((4, 2, S, 2, 32)) \
        .astype(np.float32)
    lay = _layouts(2, S, "fixed")
    out = {}
    for device in ("cpu", dev):
        leaves = [torch.from_numpy(a).to(device).requires_grad_()
                  for a in x[:3]]
        seed = torch.tensor(987654, dtype=torch.int32, device=device)
        ops.reset_launch_counts()
        if route == "lut":
            o = sf.sparse_flash_attention(*leaves, lay, causal=True,
                                          scale=32 ** -0.5, seed=seed,
                                          dropout=0.1)
        else:
            o = fa.flash_sparse(*leaves, torch.from_numpy(lay).to(
                device, torch.int32), seed, 32 ** -0.5, True, 0.1)
        o.backward(torch.from_numpy(x[3]).to(device))
        torch.cuda.synchronize()
        out[str(device)] = ([_np(o.detach())] + [_np(t.grad) for t in leaves],
                            {n: c for n, c in ops.launch_counts().items()
                             if c})
    assert out["cpu"][1] == {} and out["cuda"][1] == kernels
    for a, b in zip(out["cuda"][0], out["cpu"][0]):
        np.testing.assert_allclose(a, b, atol=1e-5 * np.abs(b).max(),
                                   rtol=0)
    q = torch.from_numpy(x[0]).to(dev)
    ops.reset_launch_counts()
    fa.flash_attention(q, q, q, causal=True, layout=torch.from_numpy(lay)
                       .to(dev) if route == "gated" else lay)
    torch.cuda.synchronize()
    first = "flash_attention_fwd" if route == "gated" else "sparse_flash_fwd"
    assert {n: c for n, c in ops.launch_counts().items() if c} == {first: 1}


# --------------------------------------------------------------------- #
# The grouped GEMM (K9) and the MoE path
# --------------------------------------------------------------------- #
# (E, M, K, N): a capacity of 40 and odd widths; several 128-tiles each
# way with ragged edges; K not a multiple of the 64-deep K step; several
# K steps with a K tail and N past two 256-wide tiles.
GG_SHAPES = [(3, 40, 200, 136), (2, 260, 96, 300), (2, 300, 264, 520)]


def _gg_inputs(dev, dt, E, M, K, N, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    a = torch.randn(E, M, K, device=dev, generator=g).to(dt)
    b = (torch.randn(E, K, N, device=dev, generator=g) * K ** -0.5).to(dt)
    bias = torch.randn(E, N, device=dev, generator=g)
    return a, b, bias


@pytest.mark.parametrize("shape", GG_SHAPES)
@pytest.mark.parametrize("act", [None, "gelu_tanh", "gelu_exact"])
@pytest.mark.parametrize("dtype_name", ["fp32", "bf16", "fp16"])
def test_grouped_gemm_kernel_matches_plain_and_repeats(dev, dtype_name, act,
                                                       shape):
    """Against the plain version: the pre-activation z within the
    tolerance; with an activation, the output against the plain epilogue
    of the kernel's own z (a z one rounding step apart moves a GELU
    output by its slope, many ulp of a small output). Two launches give
    the same bits; transposed, unaligned and non-unit-stride views of
    the same values give the same bits as contiguous operands, and so do
    both wgmma tiles (BN 128 and 256), on every layout."""
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = DTYPES[dtype_name]
    a, b, bias = _gg_inputs(dev, dt, *shape, seed=len(str(act)))
    got = gg.grouped_matmul(a, b, bias, act)
    again = gg.grouped_matmul(a, b, bias, act)
    z = gg.grouped_matmul(a, b, bias)
    z_ref = gg.grouped_matmul_plain(a, b, bias)
    torch.cuda.synchronize()
    assert got.dtype == dt and got.shape == (shape[0], shape[1], shape[3])
    assert torch.equal(got, again)
    assert_close(_np(z), _np(z_ref), dtype_name)
    if act is None:
        assert torch.equal(got, z)
    else:
        epi = fe.gelu_f32(z.float(), act == "gelu_exact").to(dt)
        assert_close(_np(got), _np(epi), dtype_name)
        if dtype_name == "fp32":
            assert_close(_np(got), _np(gg.grouped_matmul_plain(
                a, b, bias, act)), "fp32")
    # the same values through other strides
    at = a.transpose(1, 2).contiguous().transpose(1, 2)       # M stride 1
    bt = b.transpose(1, 2).contiguous().transpose(1, 2)       # K stride 1
    wide = torch.zeros(a.shape[:2] + (2 * a.shape[2],), dtype=dt, device=dev)
    wide[..., ::2] = a                                       # K stride 2
    off = torch.zeros(a.shape[:2] + (a.shape[2] + 1,), dtype=dt, device=dev)
    off[..., 1:] = a                                         # unaligned
    for a2, b2 in ((at, b), (a, bt), (at, bt), (wide[..., ::2], b),
                   (off[..., 1:], b)):
        assert torch.equal(gg.grouped_matmul(a2, b2, bias, act), got)
        for tile in gg.GG_TILES if dtype_name != "fp32" else ():
            assert torch.equal(gg.grouped_matmul(a2, b2, bias, act, tile),
                               got), (tile, a2.stride(), b2.stride())
    # a bias 4 bytes off 16-byte alignment reads the same values
    bias_off = torch.empty(bias.numel() + 1, device=dev)[1:].view(
        bias.shape).copy_(bias)
    assert torch.equal(gg.grouped_matmul(a, b, bias_off, act), got)
    assert torch.equal(gg.grouped_matmul(a, b, None, act),
                       gg.grouped_matmul(a, b, torch.zeros_like(bias), act))


@pytest.mark.parametrize("dtype_name", ["bf16", "fp16"])
def test_grouped_gemm_stages_only_what_tma_cannot_read(dev, dtype_name):
    """Contiguous operands with 16-byte aligned rows, and the transposed
    views of such, run with no copy; an unaligned view of a, a K stride
    of 2 and b's 600-byte rows (N = 300) each stage their operand once,
    and every form gives the same bits."""
    dt = DTYPES[dtype_name]
    E, M, K, N = 2, 72, 200, 136
    a, b, bias = _gg_inputs(dev, dt, E, M, K, N, seed=5)
    ops.reset_launch_counts()
    got = gg.grouped_matmul(a, b, bias, "gelu_tanh")
    at = a.transpose(1, 2).contiguous().transpose(1, 2)
    bt = b.transpose(1, 2).contiguous().transpose(1, 2)
    assert torch.equal(gg.grouped_matmul(at, bt, bias, "gelu_tanh"), got)
    assert gg.grouped_matmul.staged == 0
    off = torch.zeros(E, M, K + 1, dtype=dt, device=dev)
    off[..., 1:] = a
    wide = torch.zeros(E, M, 2 * K, dtype=dt, device=dev)
    wide[..., ::2] = a
    for a2 in (off[..., 1:], wide[..., ::2]):
        ops.reset_launch_counts()
        assert torch.equal(gg.grouped_matmul(a2, b, bias, "gelu_tanh"), got)
        assert gg.grouped_matmul.staged == 1
    a3, b3, _ = _gg_inputs(dev, dt, E, M, K, 300, seed=6)
    ops.reset_launch_counts()
    want = gg.grouped_matmul_plain(a3, b3)
    z = gg.grouped_matmul(a3, b3)
    assert gg.grouped_matmul.staged == 1
    assert_close(_np(z), _np(want), dtype_name)
    assert ops.launch_counts()["grouped_matmul"] == 1


def test_grouped_gemm_wrapper_rejects_what_the_kernel_does_not_take(dev):
    a = torch.randn(2, 8, 16, device=dev)
    b = torch.randn(2, 16, 4, device=dev)
    with pytest.raises(TypeError, match="one dtype"):
        gg.grouped_matmul(a, b.bfloat16())
    with pytest.raises(ValueError, match="different devices"):
        gg.grouped_matmul(a, b.cpu())
    with pytest.raises(TypeError, match="one dtype"):
        gg.grouped_matmul(a.double(), b.double())
    with pytest.raises(ValueError, match="tile"):
        gg.grouped_matmul(a.bfloat16(), b.bfloat16(), _tile=64)


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("dtype_name", ["fp32", "bf16"])
def test_grouped_ffn_on_the_card_matches_the_cpu(dev, dtype_name, exact):
    """Forward and backward on the card (seven K9 launches) against the
    plain versions on the CPU: fp32 within 1e-5, bf16 within 2^-7 of each
    leaf's largest magnitude."""
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = DTYPES[dtype_name]
    rng = np.random.default_rng(7)
    E, C, H, F = 4, 40, 64, 200
    arrs = [rng.standard_normal(s).astype(np.float32) * sc for s, sc in (
        ((E, C, H), 1.0), ((E, H, F), H ** -0.5), ((E, F), 0.1),
        ((E, F, H), F ** -0.5), ((E, H), 0.1), ((E, C, H), 1.0))]
    out = {}
    for device in ("cpu", dev):
        leaves = [torch.from_numpy(x).to(device, dt).requires_grad_()
                  for x in arrs[:5]]
        ops.reset_launch_counts()
        y = gg.grouped_ffn(*leaves, exact)
        grads = torch.autograd.grad(y, leaves,
                                    torch.from_numpy(arrs[5]).to(device, dt))
        torch.cuda.synchronize()
        out[str(device)] = ([_np(y.detach())] + [_np(t) for t in grads],
                            ops.launch_counts()["grouped_matmul"])
    assert out["cpu"][1] == 0 and out["cuda"][1] == 7
    tol = 1e-5 if dtype_name == "fp32" else 2.0 ** -7
    for a, b in zip(out["cuda"][0], out["cpu"][0]):
        np.testing.assert_allclose(a, b, atol=tol * np.abs(b).max(), rtol=0)


def test_moe_train_batch_on_the_card_matches_the_cpu(dev):
    """Two gpt2-tiny fp32 MoE steps (8 experts, top-2, gas 2) on the card
    and on the CPU (grouped_gemm True there: the plain versions) from the
    same params and batches: losses, grad norms and the moe metrics; the
    card launches 7 K9 a MoE layer and micro-batch, and no bias+GELU."""
    from deepspeed_tpu_torch.moe import MoEConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    moe = {"num_experts": 8, "top_k": 2, "capacity_factor": 1.25}
    ds = {"train_batch_size": 4, "gradient_accumulation_steps": 2,
          "gradient_clipping": 1.0, "steps_per_print": 10 ** 9,
          "optimizer": {"type": "AdamW",
                        "params": {"lr": 1e-3, "weight_decay": 0.01}},
          "moe": moe}
    batches = np.random.default_rng(0).integers(0, 512, (2, 4, 33))
    out = {}
    for device, grouped in (("cpu", True), (dev, "auto")):
        cfg = dataclasses.replace(
            CFG32, hidden_dropout=0.0, attn_dropout=0.0,
            moe=MoEConfig(grouped_gemm=grouped, **moe))
        params = gpt2_init(cfg, torch.Generator().manual_seed(0), "cpu")
        eng, *_ = deepspeed_tpu_torch.initialize(
            model=gpt2_loss_fn(cfg), model_params=params,
            config=dict(ds, moe=dict(moe, grouped_gemm=grouped)),
            device=device)
        hist = []
        for b in batches:
            ops.reset_launch_counts()
            loss = eng.train_batch(b)
            m = eng.last_metrics
            hist.append((float(loss), float(m["grad_norm"]),
                         m["moe_expert_tokens"].cpu().numpy(),
                         float(m["moe_drop_fraction"]),
                         ops.launch_counts()))
        out[str(device)] = hist
    L = CFG32.num_layers
    for c, g in zip(out["cpu"], out["cuda"]):
        np.testing.assert_allclose(g[0], c[0], rtol=1e-4)
        np.testing.assert_allclose(g[1], c[1], rtol=1e-4)
        np.testing.assert_array_equal(g[2], c[2])
        assert g[3] == c[3]
        assert sum(c[4].values()) == 0
        assert g[4]["grouped_matmul"] == 7 * L * 2
        assert g[4]["fused_bias_gelu"] == g[4]["bias_gelu_backward"] == 0
