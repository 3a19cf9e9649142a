"""The port's host Adam (``ops/cpu_adam.py`` over its copy of
``csrc/cpu_adam.cpp``) against the JAX package's ``DeepSpeedCPUAdam``
and against its own plain version, on the CPU.

- Native against JAX's native, on the same numpy inputs from a seed:
  bit-equal masters, moments and bf16 copies after 1 and after 100 steps,
  for each of the four Adam entry points (fp32 or bf16 gradients, with
  or without the bf16 copy), AdamW and coupled Adam. Both libraries
  come from the same source and flags on this host.
- The squared norms from both norm entry points bit-equal to the JAX
  module's numpy path (``DeepSpeedCPUAdam.grad_norm_sq`` with no
  library, called directly): the port sums in numpy's order, while the
  JAX library's vectorized sum depends on the host's SIMD width (its
  bits differ between -march targets) and, above one thread, on the
  order its threads finish.
- The port's norm on any team: the same bits on every call and every
  team, within 1e-12 relative of the plain sum; the same bits from
  libraries built for two CPU targets, and from processes started
  under two ``OMP_NUM_THREADS``.
- Native against the plain step (``adam_ulp_gaps``: the moments' half
  and, from the native moments, the parameters' half of
  ``cpu_adam_plain``) step by step over 20 steps: masters and moments
  within 4 fp32 ulp of the largest term of their last add (g++ may fuse
  either product of ``a*b + c*d`` into an FMA), the bf16 copy bit-equal
  to ``masters.to(torch.bfloat16)``; the norm within 1e-12 relative (the
  same fp64 sum in another order).
- The build: keyed by source, flags and host CPU and reused; a missing
  compiler or a failed compile raises; the ctypes signatures match the
  ``extern "C"`` parameter counts; a call leaves torch's OpenMP team as
  it found it; a call refused by its input checks counts no launch.
- The memory-rate probes the card smoke bounds the step with move what
  they say (the Adam step's traffic with an add; a sum of one span).
"""
import ctypes
import json
import os
import re
import subprocess
import sys
import types
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import cpu_adam as jca
from deepspeed_tpu_torch.ops import cpu_adam as tca
from deepspeed_tpu_torch.ops import op_builder
from torch_jax_native import jax_native  # noqa: F401 (autouse)

SHAPES = [(64, 32), (1001,), (3, 5, 7)]
# The JAX module's norm without its library: numpy's float64 sum.
NUMPY_NORM = types.SimpleNamespace(_lib=None)


def numpy_norm_sq(leaves, scale=1.0):
    return jca.DeepSpeedCPUAdam.grad_norm_sq(NUMPY_NORM, leaves, scale)
HP = dict(lr=1e-2, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01)


@pytest.fixture(autouse=True)
def team_of_one():
    """The main thread's OpenMP team is one thread: the norms' sums are
    deterministic on both sides (see the docstring), and the JAX
    library's calls on these small leaves wake no team under parallel
    test workers. ``test_adam_bits_do_not_depend_on_the_team`` runs
    teams."""
    lib = tca.native_lib()
    prev = int(lib.ds_omp_max_threads())
    lib.ds_omp_set_threads(1)
    yield
    lib.ds_omp_set_threads(prev)


def _bf16_np(x):
    return np.asarray(x, np.float32).astype(ml_dtypes.bfloat16)


def _bf16_t(x_bf16):
    return torch.from_numpy(x_bf16.view(np.uint16).copy()).view(
        torch.bfloat16)


def _bits(t):
    return t.view(torch.int16).numpy().view(np.uint16)


def _pair(adamw, seed=0):
    rng = np.random.default_rng(seed)
    init = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    jm = [a.copy() for a in init]
    tm = [torch.from_numpy(a.copy()) for a in init]
    jo = jca.DeepSpeedCPUAdam({str(i): a for i, a in enumerate(jm)},
                              adamw_mode=adamw, **HP)
    to = tca.DeepSpeedCPUAdam(tm, adamw_mode=adamw, **HP)
    assert jo.native
    return rng, jm, tm, jo, to


def test_jax_native_under_racing_workers_f11(tmp_path):
    """F11: processes that start at once on an empty build cache each
    get JAX's native host Adam (``tests/torch_jax_native.py`` builds it
    under the cache's lock; without it, a worker whose build or rename
    lost the race ran the numpy path for its whole process)."""
    env = dict(os.environ, DS_BUILD_CACHE=str(tmp_path / "cache"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    here = Path(__file__).resolve().parent
    procs = [subprocess.Popen([sys.executable,
                               str(here / "torch_jax_native.py")],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, env=env, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=240)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0 and "NATIVE_OK" in out, out[-2000:]
    assert len(list((tmp_path / "cache").glob("cpu_adam_*.so"))) == 1


@pytest.mark.parametrize("steps", [1, 100])
@pytest.mark.parametrize("adamw", [True, False], ids=["adamw", "coupled"])
@pytest.mark.parametrize("entry", ["step", "plus_copy", "plus_copy_bf16g",
                                   "bf16g"])
def test_adam_entry_bit_equal_to_jax(entry, adamw, steps):
    rng, jm, tm, jo, to = _pair(adamw)
    copy = entry.startswith("plus_copy")
    bf16 = entry.endswith("bf16g")
    jb = [np.empty(s, np.uint16) for s in SHAPES] if copy else None
    tb = [torch.empty(s, dtype=torch.bfloat16) for s in SHAPES] \
        if copy else None
    for k in range(steps):
        gs = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
        scale = 0.5 if k % 2 else 1.0
        if bf16:
            jg = [_bf16_np(g) for g in gs]
            tg = [_bf16_t(g) for g in jg]
        else:
            jg, tg = gs, [torch.from_numpy(g.copy()) for g in gs]
        jo.step(jm, jg, grad_scale=scale, bf16_out=jb)
        to.step(tm, tg, grad_scale=scale, bf16_out=tb)
    for a, b in zip(jm + jo.exp_avg + jo.exp_avg_sq,
                    tm + to.exp_avg + to.exp_avg_sq):
        np.testing.assert_array_equal(b.numpy(), a)
    if copy:
        for a, b in zip(jb, tb):
            np.testing.assert_array_equal(_bits(b), a)
    assert to.step_count == jo.step_count == steps


@pytest.mark.parametrize("wire", ["fp32", "bf16"])
def test_norm_entry_bit_equal_to_jax(wire):
    rng = np.random.default_rng(3)
    gs = [rng.standard_normal(s).astype(np.float32) * 3 for s in SHAPES]
    if wire == "bf16":
        jg = [_bf16_np(g) for g in gs]
        tg = [_bf16_t(g) for g in jg]
    else:
        jg, tg = gs, [torch.from_numpy(g) for g in gs]
    to = tca.DeepSpeedCPUAdam([torch.from_numpy(gs[0])])
    for scale in (1.0, 0.25, 1.0 / 3):
        assert to.grad_norm_sq(tg, scale, threads=1) == \
            numpy_norm_sq(jg, scale)
    assert to.grad_norm(tg, threads=1) == \
        float(np.sqrt(numpy_norm_sq(jg)))


@pytest.mark.parametrize("adamw", [True, False], ids=["adamw", "coupled"])
@pytest.mark.parametrize("entry", ["step", "plus_copy", "plus_copy_bf16g",
                                   "bf16g"])
def test_native_within_4ulp_of_plain(entry, adamw):
    """Each of 20 steps from the native state: p, m, v within 4 ulp of
    the largest term of their last add (``adam_ulp_gaps``), and the bf16
    copy bit-equal to the masters' cast."""
    rng = np.random.default_rng(5)
    init = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    tm = [torch.from_numpy(a.copy()) for a in init]
    to = tca.DeepSpeedCPUAdam(tm, adamw_mode=adamw, **HP)
    copy = entry.startswith("plus_copy")
    tb = [torch.empty(s, dtype=torch.bfloat16) for s in SHAPES]
    for k in range(20):
        gs = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
              for s in SHAPES]
        if entry.endswith("bf16g"):
            gs = [g.to(torch.bfloat16) for g in gs]
        before = [(p.clone(), m.clone(), v.clone()) for p, m, v in
                  zip(tm, to.exp_avg, to.exp_avg_sq)]
        to.step(tm, gs, grad_scale=0.5, bf16_out=tb if copy else None)
        for (p0, m0, v0), p, m, v, g, out in zip(
                before, tm, to.exp_avg, to.exp_avg_sq, gs, tb):
            gaps = tca.adam_ulp_gaps(p0, g, m0, v0, p, m, v, step=k + 1,
                                     adamw_mode=adamw, grad_scale=0.5,
                                     **HP)
            assert max(gaps.values()) <= 4, (entry, k, gaps)
            if copy:
                assert torch.equal(out.view(torch.int16),
                                   p.to(torch.bfloat16).view(torch.int16))


@pytest.mark.parametrize("entry", ["plus_copy_bf16g", "step"])
def test_adam_bits_do_not_depend_on_the_team(entry):
    """One leaf large enough to share (4 * MIN_PER_THREAD elements), one
    step on teams of 1, 3 and 4 threads and by JAX's library on 4:
    bit-equal (Adam is elementwise)."""
    rng = np.random.default_rng(9)
    n = 4 * tca.MIN_PER_THREAD
    p0 = rng.standard_normal(n).astype(np.float32)
    g = rng.standard_normal(n).astype(np.float32)
    copy = entry == "plus_copy_bf16g"
    if copy:
        g = _bf16_np(g)
    outs = []
    for threads in (1, 3, 4):
        p = torch.from_numpy(p0.copy())
        out = [torch.empty(n, dtype=torch.bfloat16)] if copy else None
        to = tca.DeepSpeedCPUAdam([p], **HP)
        to.step([p], [_bf16_t(g) if copy else torch.from_numpy(g)],
                grad_scale=0.5, bf16_out=out, threads=threads)
        outs.append([p, to.exp_avg[0], to.exp_avg_sq[0]] +
                    ([out[0].view(torch.int16)] if copy else []))
    lib = tca.native_lib()
    lib.ds_omp_set_threads(4)
    jm = [p0.copy()]
    jo = jca.DeepSpeedCPUAdam({"a": jm[0]}, **HP)
    jb = [np.empty(n, np.uint16)] if copy else None
    jo.step(jm, [g], grad_scale=0.5, bf16_out=jb)
    lib.ds_omp_set_threads(1)
    for got in outs[1:]:
        for a, b in zip(outs[0], got):
            assert torch.equal(a, b)
    for a, b in zip(outs[0], [jm[0], jo.exp_avg[0], jo.exp_avg_sq[0]] +
                    ([jb[0]] if copy else [])):
        np.testing.assert_array_equal(a.numpy().view(b.dtype), b)


@pytest.mark.parametrize("wire", ["fp32", "bf16"])
def test_native_norm_matches_plain(wire):
    rng = np.random.default_rng(7)
    g = torch.from_numpy(rng.standard_normal(100003).astype(np.float32))
    if wire == "bf16":
        g = g.to(torch.bfloat16)
    to = tca.DeepSpeedCPUAdam([torch.zeros(3)])
    got = to.grad_norm_sq([g], 0.125)
    want = tca.grad_norm_sq_plain(g, 0.125)
    assert abs(got - want) <= 1e-12 * want


@pytest.mark.parametrize("wire", ["fp32", "bf16"])
def test_norm_bits_depend_only_on_the_team(wire):
    rng = np.random.default_rng(13)
    n = 4 * tca.MIN_PER_THREAD + 3        # wide enough for a team of 4
    g = rng.standard_normal(n).astype(np.float32)
    jg = _bf16_np(g) if wire == "bf16" else g
    tg = _bf16_t(jg) if wire == "bf16" else torch.from_numpy(g)
    to = tca.DeepSpeedCPUAdam([torch.zeros(3)])
    want = tca.grad_norm_sq_plain(tg, 0.5)
    got = {}
    for team in (1, 3, 4):
        vals = {to.grad_norm_sq([tg], 0.5, threads=team) for _ in range(8)}
        assert len(vals) == 1, (team, vals)
        got[team] = vals.pop()
        assert abs(got[team] - want) <= 1e-12 * want
    # (and not even on the team: numpy's order on every team)
    assert got[1] == got[3] == got[4] == numpy_norm_sq([jg], 0.5)


_NORM_PROBE = """
import json, sys
import numpy as np, torch
from deepspeed_tpu_torch.ops import cpu_adam as tca
rng = np.random.default_rng(29)
g = torch.from_numpy(rng.standard_normal(300007).astype(np.float32) * 30)
to = tca.DeepSpeedCPUAdam([torch.zeros(3)])
print(json.dumps([tca.default_threads(), to.grad_norm_sq([g], 0.5).hex(),
                  to.grad_norm_sq([g.to(torch.bfloat16)], 0.5).hex()]))
"""


def test_norm_bits_do_not_depend_on_the_process_team():
    """Two processes whose default OpenMP teams differ (1 and 4 threads)
    give the same bits for an fp32 and a bf16 norm, numpy's."""
    root = Path(__file__).resolve().parent.parent
    out = []
    for threads in (1, 4):
        env = dict(os.environ, OMP_NUM_THREADS=str(threads),
                   PYTHONPATH=str(root))
        r = subprocess.run([sys.executable, "-c", _NORM_PROBE], env=env,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode == 0, r.stderr[-2000:]
        out.append(json.loads(r.stdout.strip().splitlines()[-1]))
    assert [o[0] for o in out] == [1, 4]
    assert out[0][1:] == out[1][1:]
    rng = np.random.default_rng(29)
    g = rng.standard_normal(300007).astype(np.float32) * 30
    assert float.fromhex(out[0][1]) == numpy_norm_sq([g], 0.5)
    assert float.fromhex(out[0][2]) == numpy_norm_sq(
        [g.astype(ml_dtypes.bfloat16)], 0.5)


def test_norm_bits_do_not_depend_on_the_cpu_target(tmp_path):
    """The host source built for two CPU targets (the host's own, and
    the baseline x86-64 or the compiler's default elsewhere): the same
    norm bits, numpy's, where the SIMD widths differ."""
    flags = [f for f in op_builder.HOST_FLAGS if f != "-march=native"]
    src = str(op_builder.CSRC_DIR / "cpu_adam.cpp")
    other = ["-march=x86-64"] if op_builder.platform.machine() in \
        ("x86_64", "AMD64") else []
    rng = np.random.default_rng(31)
    g = rng.standard_normal(100003).astype(np.float32)
    gb = g.astype(ml_dtypes.bfloat16)
    want = (numpy_norm_sq([g], 0.25), numpy_norm_sq([gb], 0.25))
    for i, march in enumerate((["-march=native"], other)):
        so = str(tmp_path / f"norm{i}.so")
        subprocess.run([op_builder.find_cxx()] + flags + march +
                       [src, "-o", so], check=True, capture_output=True)
        lib = ctypes.CDLL(so)
        for name in ("ds_grad_norm_sq", "ds_grad_norm_sq_bf16"):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = tca.HOST_SIGNATURES[name]
        got = (lib.ds_grad_norm_sq(g.ctypes.data, g.size, 0.25),
               lib.ds_grad_norm_sq_bf16(gb.view(np.uint16).ctypes.data,
                                        gb.size, 0.25))
        assert got == want, (march, got, want)


def test_stream_probes():
    lib = tca.native_lib()
    rng = np.random.default_rng(17)
    n = 1000
    p, m, v = (torch.from_numpy(rng.standard_normal(n).astype(np.float32))
               for _ in range(3))
    g = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(
        torch.bfloat16)
    want = [x + g.float() for x in (p, m, v)]
    copy = torch.empty(n, dtype=torch.bfloat16)
    lib.ds_stream_adam_traffic(p.data_ptr(), g.data_ptr(), m.data_ptr(),
                               v.data_ptr(), copy.data_ptr(), n)
    for a, b in zip((p, m, v), want):
        assert torch.equal(a, b)
    assert torch.equal(copy, p.to(torch.bfloat16))
    # (fp32 partial sums)
    assert abs(lib.ds_stream_read(p.data_ptr(), n) -
               float(p.double().sum())) <= 1e-6 * float(p.abs().sum())


def test_a_call_restores_the_callers_team():
    lib = tca.native_lib()
    lib.ds_omp_set_threads(3)
    to = tca.DeepSpeedCPUAdam([torch.zeros(8)])
    to.grad_norm_sq([torch.ones(8)], threads=1)
    to.step([torch.zeros(8)], [torch.ones(8)], threads=2)
    assert int(lib.ds_omp_max_threads()) == 3
    lib.ds_omp_set_threads(1)


def test_inputs_are_checked():
    to = tca.DeepSpeedCPUAdam([torch.zeros(4, 4)])
    before = tca.host_launch_counts()
    with pytest.raises(ValueError, match="contiguous CPU"):
        to.step([torch.zeros(4, 4).t()], [torch.ones(4, 4)])
    with pytest.raises(ValueError, match="float32"):
        to.step([torch.zeros(4, 4, dtype=torch.float64)],
                [torch.ones(4, 4)])
    with pytest.raises(ValueError, match="elements"):
        to.step([torch.zeros(4, 4)], [torch.ones(5)])
    with pytest.raises(ValueError, match="bfloat16"):
        to.step([torch.zeros(4, 4)], [torch.ones(4, 4)],
                bf16_out=[torch.zeros(4, 4)])
    assert tca.host_launch_counts() == before


def test_host_build_is_keyed_and_reused(tmp_path, monkeypatch):
    monkeypatch.setattr(op_builder, "BUILD_DIR", tmp_path)
    first = op_builder.build_host()
    mtime = first.stat().st_mtime_ns
    assert op_builder.build_host() == first
    assert first.stat().st_mtime_ns == mtime
    assert first.parent == tmp_path and first.name.startswith(
        "libdstt_host_")
    monkeypatch.setattr(op_builder, "HOST_FLAGS",
                        op_builder.HOST_FLAGS + ["-DDSTT_VARIANT=1"])
    assert op_builder.build_host() != first


def test_missing_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(op_builder, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="no C.. compiler"):
        op_builder.build_host()
    assert not list(tmp_path.glob("*.so"))


def test_failed_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(op_builder, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(op_builder, "HOST_FLAGS",
                        op_builder.HOST_FLAGS + ["--no-such-flag"])
    with pytest.raises(RuntimeError, match="host build failed"):
        op_builder.build_host()
    assert not list(tmp_path.glob("*.so")) and \
        not list(tmp_path.glob("*.tmp"))


def _extern_c_params(src):
    text = Path(src).read_text()
    body = text[text.index('extern "C" {'):]
    out = {}
    for m in re.finditer(r"^\w[\w ]*?\b(ds_\w+)\(([^)]*)\)", body,
                         flags=re.M):
        args = m.group(2).strip()
        out[m.group(1)] = 0 if args in ("", "void") else \
            len(args.split(","))
    return out


def test_signatures_match_extern_c():
    got = _extern_c_params(op_builder.CSRC_DIR / "cpu_adam.cpp")
    assert {k: len(v[0]) for k, v in tca.HOST_SIGNATURES.items()} == got
    # The six entry points of the JAX package's source, with its counts.
    jax_src = Path(op_builder.CSRC_DIR).parent.parent / "csrc" / \
        "cpu_adam.cpp"
    want = _extern_c_params(jax_src)
    assert len(want) == 6
    assert {k: got[k] for k in want} == want
