"""Build and load the port's CUDA kernels (``deepspeed_tpu_torch/csrc``).

Every ``csrc/*.cu`` file is compiled by hand with ``nvcc`` for Hopper
(``sm_90a``), one ``nvcc -c`` per source, all started together, then
linked into ONE shared library with a plain C interface that ``ctypes``
loads. The build runs at first use (the first kernel launch, or
``load()``), lands in ``build/deepspeed_tpu_torch/`` under the checkout,
and is keyed by a hash of the sources and flags, so an edited source
rebuilds and an unchanged one loads the existing library.

No ``nvcc``, or a failed build, raises: nothing falls back to another
implementation. Every C entry point returns ``cudaGetLastError()`` after
its launch and ``check`` turns a non-zero code into an exception.

The host kernel of ZeRO-Offload, ``csrc/cpu_adam.cpp``, is a second,
separate library (``build_host`` / ``load_host``), built with the host's
C++ compiler (``g++``, else ``clang++``) and the JAX package's flags, in
the same directory, keyed by the sources, the flags and the host CPU
(``-march=native``). It needs no ``nvcc``, so the CPU tests build and
run it. No compiler, or a failed build, raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
from pathlib import Path
from typing import List, Optional

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / \
    "deepspeed_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]
DEFAULT_CUDA_HOME = Path("/usr/local/cuda")
HOST_SOURCES = ("cpu_adam.cpp",)
# The JAX package's host flags (deepspeed_tpu/ops/op_builder.py): without
# -fno-math-errno / -fno-trapping-math g++ keeps sqrtf a libm call and
# the Adam loop scalar. -march=native is dropped on a retry where the
# host's compiler refuses it.
HOST_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-fopenmp",
              "-march=native", "-funroll-loops", "-fno-math-errno",
              "-fno-trapping-math"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong

# C signatures (argtypes, restype) of the entry points; see the
# extern "C" blocks in csrc/.
_SIGNATURES = {
    "dstt_layer_norm": ([_P, _P, _P, _P, _P, _P, _I, _I, _F, _I, _P], _I),
    "dstt_layer_norm_bwd_blocks": ([_I], _I),
    "dstt_layer_norm_bwd": ([_P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _I,
                             _P], _I),
    "dstt_bias_gelu": ([_P, _P, _P, _L, _I, _I, _I, _P], _I),
    "dstt_bias_gelu_bwd_splits": ([_I], _I),
    "dstt_bias_gelu_bwd": ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
                           _I),
    "dstt_sqnorm_blocks": ([_L], _I),
    "dstt_sqnorm": ([_P, _L, _P, _P], _I),
    "dstt_fused_adam": ([_P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I,
                         _F, _F, _F, _F, _F, _F, _P], _I),
    "dstt_paged_attention": ([_P] * 7 + [_I] * 8 + [_F, _I, _I, _I, _P],
                             _I),
    "dstt_flash_fwd": ([_P] * 3 + [_L] * 3 + [_P] * 3 + [_P, _I, _I] +
                       [_I] * 4 + [_F] * 3 + [_I] * 4 + [_P], _I),
    "dstt_flash_bwd_dq": ([_P] * 3 + [_L] * 3 + [_P] * 5 + [_P, _I, _I] +
                          [_I] * 4 + [_F] * 3 + [_I] * 4 + [_P], _I),
    "dstt_flash_bwd_dkv": ([_P] * 3 + [_L] * 3 + [_P] * 6 + [_P, _I, _I] +
                           [_I] * 4 + [_F] * 3 + [_I] * 4 + [_P], _I),
    "dstt_flash_bwd_fused": ([_P] * 3 + [_L] * 3 + [_P] * 7 + [_I] * 4 +
                             [_F] * 3 + [_I] * 4 + [_P], _I),
    "dstt_sparse_flash": ([_I] + [_P] * 3 + [_L] * 3 + [_P] * 12 + [_I] +
                          [_P] * 3 + [_I] + [_P] * 3 + [_I] * 9 + [_F] * 3 +
                          [_I, _I, _P], _I),
    "dstt_grouped_gemm": ([_P, _L, _L, _I, _P, _L, _L, _I, _P, _P] +
                          [_I] * 7 + [_P], _I),
    "dstt_grouped_gemm_f32": ([_P, _L, _L, _L, _P, _L, _L, _L, _P, _P] +
                              [_I] * 5 + [_P], _I),
    "dstt_error_string": ([_I], ctypes.c_char_p),
}

_lib: Optional[ctypes.CDLL] = None
_host_lib: Optional[ctypes.CDLL] = None


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin``, or
    the PATH. Raises when there is none."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    cands.append(DEFAULT_CUDA_HOME / "bin" / "nvcc")
    for c in cands:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the port's CUDA kernels cannot be built")
    return found


def sources() -> List[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libdstt_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile every source in parallel and link one shared library.
    Returns its path; raises with nvcc's output on any failure."""
    nvcc = find_nvcc()
    out = _library_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    extra = ["-Xptxas", "-v"] if verbose else []
    procs = []
    for src in sources():
        obj = BUILD_DIR / f"{src.stem}.{os.getpid()}.o"
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for src, obj, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{log}")
        elif verbose and log:
            print(f"[nvcc {src.name}]\n{log}", flush=True)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
         *[str(obj) for _, obj, _ in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for _, obj, _ in procs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, out)
    return out


def load(verbose: bool = False) -> ctypes.CDLL:
    """The kernel library, built on first use and cached per process."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build(verbose)))
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _lib = lib
    return _lib


def check(rc: int, kernel: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if rc != 0:
        msg = load().dstt_error_string(rc).decode()
        raise RuntimeError(f"{kernel}: CUDA error {rc} ({msg})")


def find_cxx() -> str:
    """The host C++ compiler: ``g++``, else ``clang++``, on the PATH (the
    JAX package's choice). Raises when there is none."""
    for name in ("g++", "clang++"):
        found = shutil.which(name)
        if found is not None:
            return found
    raise RuntimeError("no C++ compiler (g++ or clang++ on the PATH): the "
                       "port's host kernels cannot be built")


def _host_cpu() -> str:
    """The host CPU's model and feature flags (what -march=native
    compiles for), so a library built on another host is never
    loaded."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = f.read().splitlines()
    except OSError:
        return platform.machine()
    keep = [ln for ln in lines
            if ln.startswith(("model name", "flags", "Features"))]
    return platform.machine() + "\n" + "\n".join(sorted(set(keep)))


def _host_library_path(flags: List[str]) -> Path:
    h = hashlib.sha256(" ".join(flags).encode())
    h.update(_host_cpu().encode())
    for name in HOST_SOURCES:
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    return BUILD_DIR / f"libdstt_host_{h.hexdigest()[:16]}.so"


def build_host() -> Path:
    """Compile ``HOST_SOURCES`` into the host library (once per hash of
    the sources and flags) and return its path; raises with the
    compiler's output on failure."""
    cxx = find_cxx()
    out = _host_library_path(HOST_FLAGS)
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    srcs = [str(CSRC_DIR / name) for name in HOST_SOURCES]
    flags = list(HOST_FLAGS)
    proc = subprocess.run([cxx, *flags, *srcs, "-o", str(tmp)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0 and "-march=native" in flags:
        flags.remove("-march=native")
        proc = subprocess.run([cxx, *flags, *srcs, "-o", str(tmp)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"host build failed ({cxx}):\n{proc.stdout}")
    os.replace(tmp, out)
    return out


def load_host() -> ctypes.CDLL:
    """The host kernel library, built on first use and cached per
    process (its ctypes signatures are set by ``ops/cpu_adam.py``)."""
    global _host_lib
    if _host_lib is None:
        _host_lib = ctypes.CDLL(str(build_host()))
    return _host_lib


def stream_ptr(device) -> int:
    """PyTorch's current stream on ``device`` as a raw handle."""
    import torch
    return torch.cuda.current_stream(device).cuda_stream


__all__ = ["find_nvcc", "sources", "build", "load", "check", "stream_ptr",
           "find_cxx", "build_host", "load_host", "BUILD_DIR", "CSRC_DIR"]
