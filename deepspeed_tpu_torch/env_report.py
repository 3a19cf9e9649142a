"""Environment report, ``ds_report`` for the port (port of
``deepspeed_tpu/env_report.py``; reference env_report.py:23).

Prints the software stack (torch and its CUDA, ``nvcc``, ``g++``), the
cards this process sees (with ``nvidia-smi``'s name and power limit), and
for each kernel source whether ``ops/op_builder.py``'s library of it is
built, loadable and current. It builds nothing: a missing library is
reported, not made (the first kernel launch, or ``op_builder.load()``,
builds it).
"""
from __future__ import annotations

import ctypes
import importlib
import re
import subprocess
import sys
from pathlib import Path
from typing import List, Optional

GREEN_OK = "\033[92m[OKAY]\033[0m"
RED_NO = "\033[91m[NO]\033[0m"


def _mark(ok: bool) -> str:
    return GREEN_OK if ok else RED_NO


def _version(mod_name: str) -> str:
    try:
        mod = importlib.import_module(mod_name)
        return getattr(mod, "__version__", "unknown")
    except ImportError:
        return "not installed"


def _tool_version(cmd: List[str], want: str = "") -> str:
    """The first line of ``cmd``'s output that holds ``want``."""
    try:
        out = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=60).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"unavailable ({e})"
    lines = [ln.strip() for ln in out.splitlines() if want in ln]
    return lines[0] if lines else "unknown"


def software_report(lines=None) -> list:
    import torch
    from . import __version__
    from .ops import op_builder
    out = lines if lines is not None else []
    out.append("-" * 64)
    out.append("software stack")
    out.append("-" * 64)
    out.append(f"python ................. {sys.version.split()[0]}")
    out.append(f"torch .................. {torch.__version__}")
    out.append(f"torch cuda ............. {torch.version.cuda}")
    out.append(f"numpy .................. {_version('numpy')}")
    for label, find, want in (("nvcc", op_builder.find_nvcc, "release"),
                              ("g++", op_builder.find_cxx, "")):
        try:
            tool = find()
        except RuntimeError as e:
            out.append(f"{label + ' ':.<24} not found ({e})")
            continue
        out.append(f"{label + ' ':.<24} {tool}: "
                   f"{_tool_version([tool, '--version'], want)}")
    out.append(f"deepspeed_tpu_torch .... {__version__}")
    return out


def nvidia_smi() -> Optional[str]:
    """``name, power.limit`` of the first card as ``nvidia-smi`` gives
    them, or None without one."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def device_report(lines=None) -> list:
    import torch
    from .monitor.peaks import peaks_for_kind
    out = lines if lines is not None else []
    out.append("-" * 64)
    out.append("cards")
    out.append("-" * 64)
    smi = nvidia_smi()
    out.append(f"nvidia-smi ............. {smi or 'not available'}")
    if not torch.cuda.is_available():
        out.append("cuda ................... no CUDA device is available")
        return out
    out.append(f"cards (this process) ... {torch.cuda.device_count()}")
    for i in range(torch.cuda.device_count()):
        name = torch.cuda.get_device_name(i)
        props = torch.cuda.get_device_properties(i)
        pk = peaks_for_kind(name)
        peak = (f"no peak-table row; rooflines assume {pk.name}"
                if pk.assumed else
                f"peak {pk.bf16_tflops:.0f} bf16 TFLOP/s, "
                f"{pk.hbm_gbs:.0f} GB/s HBM")
        out.append(f"  card {i}: {name}, {props.total_memory / 2**30:.1f} "
                   f"GiB, {props.multi_processor_count} SMs, sm_"
                   f"{props.major}{props.minor} ({peak})")
    return out


def _entry_points(source: Path, names) -> List[str]:
    text = source.read_text()
    return [n for n in names if re.search(rf"\b{n}\s*\(", text)]


def _loads(path: Path, names) -> bool:
    try:
        lib = ctypes.CDLL(str(path))
        for n in names:
            getattr(lib, n)
    except (OSError, AttributeError):
        return False
    return True


def op_report(lines=None) -> list:
    """A row a kernel source: its library (``op_builder``'s name for the
    current sources and flags), whether a library of it is built (this
    one or one of older sources), whether the current one loads with the
    source's entry points, and whether the built one is current."""
    from .ops import op_builder
    from .ops.cpu_adam import HOST_SIGNATURES
    out = lines if lines is not None else []
    out.append("-" * 64)
    out.append(f"{'kernel source':<24}{'built':>12}{'loadable':>12}"
               f"{'current':>12}")
    out.append("-" * 64)
    cuda_lib = op_builder._library_path()
    host_lib = op_builder._host_library_path(op_builder.HOST_FLAGS)
    rows = [(src, cuda_lib, "libdstt_kernels_*.so",
             _entry_points(src, op_builder._SIGNATURES))
            for src in op_builder.sources()]
    rows += [(op_builder.CSRC_DIR / name, host_lib, "libdstt_host_*.so",
              list(HOST_SIGNATURES)) for name in op_builder.HOST_SOURCES]
    for src, lib, pattern, names in rows:
        current = lib.is_file()
        built = current or any(lib.parent.glob(pattern))
        loads = current and _loads(lib, names)
        out.append(f"{src.name:<24}{_mark(built):>21}{_mark(loads):>21}"
                   f"{_mark(current):>21}")
    out.append(f"kernel library ......... {cuda_lib}")
    out.append(f"host library ........... {host_lib}")
    return out


def main() -> int:
    lines: list = []
    lines.append("=" * 64)
    lines.append("deepspeed_tpu_torch environment report (ds_report)")
    lines.append("=" * 64)
    software_report(lines)
    device_report(lines)
    op_report(lines)
    print("\n".join(lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
