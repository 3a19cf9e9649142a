"""Flops profiler: per-module FLOPs, MACs, bytes and params of one call
(port of ``deepspeed_tpu/profiling/flops_profiler/profiler.py``).

JAX walks a jaxpr; the port walks the aten ops one call runs, under a
``TorchDispatchMode`` (``OpWalk``): each op is counted with the JAX
profiler's per-primitive formulas (a matmul 2·M·N·K flops and M·N·K
MACs, an elementwise op one flop an output element, a transcendental
four, a reduction one an input element, a layout op none) and its bytes
are its tensor operands' and outputs' (what XLA's "bytes accessed"
sums; a view or an allocation moves none). A kernel wrapper declares
its own count (``ops/costs.py``): the walk counts that and not the aten
ops of its plain version, so the CPU and the card count the same.

Each op is attributed to a "module path", the chain of the package's
(and the caller's) Python functions on the stack below the profiler's
entry — e.g. ``gpt2_apply / apply_blocks / transformer_block`` — as JAX
reads the source traceback. A backward op takes its forward op's path:
the walk runs the call under anomaly mode (``check_nan=False``, no
device read), which keeps each autograd node's forward stack.

The walk runs the call (``profile_fn`` executes ``fn`` once; the
engine's hook profiles a real training step), adds no device read, and
leaves the numerics as they are: every op runs as it would.
"""
from __future__ import annotations

import os
import re
import sys
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ...ops import costs

# --------------------------------------------------------------------- #
# Per-op formulas (the JAX profiler's per-primitive ones)
# --------------------------------------------------------------------- #
_ELEMENTWISE_1 = {
    "add", "sub", "rsub", "mul", "div", "maximum", "minimum", "pow", "remainder",
    "fmod", "neg", "abs", "sign", "floor", "ceil", "round", "sqrt", "rsqrt",
    "exp", "exp2", "expm1", "log", "log1p", "log2", "sin", "cos", "tan",
    "atan2", "square", "where", "clamp", "clamp_min", "clamp_max",
    "reciprocal", "lerp", "addcmul", "addcdiv", "masked_fill", "relu",
    "threshold_backward", "nextafter", "bitwise_and", "bitwise_or",
    "bitwise_xor", "logical_and", "logical_or",
}
_ELEMENTWISE_HEAVY = {"tanh", "sigmoid", "erf", "erfc", "erfinv", "sinh",
                      "cosh", "asinh", "acosh", "atanh", "asin", "acos",
                      "atan", "digamma", "lgamma", "tanh_backward",
                      "sigmoid_backward"}
_HEAVY_FACTOR = 4
# Ops the JAX counting decomposes into several primitives, at their
# per-element count: GELU (tanh form ~11, erf form ~8), softmax and
# log-softmax (max, sub, exp, sum, div/log) and their backward passes.
_PER_ELEMENT = {"gelu": 11, "gelu_backward": 14, "_softmax": 5,
                "_log_softmax": 5, "_softmax_backward_data": 3,
                "_log_softmax_backward_data": 3, "silu": 6,
                "native_dropout": 2, "native_dropout_backward": 1}
_REDUCE = {"sum", "mean", "amax", "amin", "max", "min", "prod", "cumsum",
           "cumprod", "logsumexp", "norm", "linalg_vector_norm", "var",
           "std", "any", "all", "nll_loss_forward", "nll_loss_backward"}
# Views and allocations: no flops, no bytes.
_NO_BYTES = {
    "view", "_unsafe_view", "reshape", "_reshape_alias", "expand", "t",
    "transpose", "permute", "unsqueeze", "squeeze", "slice", "select",
    "as_strided", "alias", "detach", "split", "split_with_sizes", "chunk",
    "unbind", "narrow", "diagonal", "unfold", "view_as", "expand_as",
    "lift_fresh", "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "_to_copy_meta", "is_same_size", "_local_scalar_dense",
    "set_", "resize_", "sym_size", "sym_stride", "sym_numel", "item",
}
_HEAVY_MM = {"mm", "addmm", "bmm", "baddbmm", "addbmm", "dot", "mv", "addmv",
             "_scaled_mm"}


def _op_name(func) -> str:
    name = func.__name__.split(".")[0]
    if name.endswith("_") and not name.startswith("_"):
        name = name[:-1]                      # in-place variants
    return name


def _numel(t) -> int:
    return int(t.numel()) if isinstance(t, torch.Tensor) else 0


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def _nbytes(x) -> int:
    return sum(int(t.numel()) * t.element_size() for t in _tensors(x))


def _mm_macs(name: str, args) -> Tuple[int, int]:
    """(macs, elementwise flops of a fused bias add) of a matmul op."""
    if name in ("addmm", "baddbmm", "addbmm", "addmv"):
        bias, a, b = args[0], args[1], args[2]
    else:
        a, b = args[0], args[1]
        bias = None
    if name in ("mm", "addmm", "_scaled_mm"):
        m, k = a.shape
        n = b.shape[1]
        macs = m * k * n
        out = m * n
    elif name in ("bmm", "baddbmm"):
        bt, m, k = a.shape
        n = b.shape[2]
        macs = bt * m * k * n
        out = bt * m * n
    elif name == "addbmm":
        bt, m, k = a.shape
        n = b.shape[2]
        macs = bt * m * k * n
        out = m * n
    else:                                   # dot, mv, addmv
        macs = int(a.numel()) if name == "dot" else \
            int(a.shape[0]) * int(a.shape[1])
        out = 1 if name == "dot" else int(a.shape[0])
    return int(macs), (out if bias is not None else 0)


def _sdpa_macs(name: str, args) -> int:
    q, k = args[0], args[1]
    B, H, Sq, D = q.shape
    Sk = k.shape[-2]
    m = int(B * H * Sq * Sk * D) * 2           # QK^T and PV
    return m * 2 if "backward" in name else m


def op_cost(func, args, kwargs, out) -> Tuple[int, int, int]:
    """(flops, macs, bytes) of one aten op."""
    name = _op_name(func)
    if name in _NO_BYTES:
        return 0, 0, 0
    nbytes = _nbytes(args) + _nbytes(kwargs) + _nbytes(out)
    if name in _HEAVY_MM:
        macs, extra = _mm_macs(name, args)
        return 2 * macs + extra, macs, nbytes
    if name.startswith("_scaled_dot_product") or \
            name.startswith("_efficient_attention") or \
            name.startswith("_flash_attention"):
        macs = _sdpa_macs(name, args)
        return 2 * macs, macs, nbytes
    first = next(iter(_tensors(out)), None)
    n_out = _numel(first)
    if name in _PER_ELEMENT:
        return _PER_ELEMENT[name] * n_out, 0, nbytes
    if name in _ELEMENTWISE_HEAVY:
        return _HEAVY_FACTOR * n_out, 0, nbytes
    if name in _ELEMENTWISE_1:
        return n_out, 0, nbytes
    if name in _REDUCE:
        return sum(_numel(t) for t in _tensors(args)), 0, nbytes
    return 0, 0, nbytes


# --------------------------------------------------------------------- #
# Module attribution from the Python stack
# --------------------------------------------------------------------- #
_SKIP_FUNCS = {"<module>", "<lambda>", "tree_map", "wrapper", "inner",
               "fun", "profile_fn", "profile", "get_model_profile",
               "__call__", "_call_impl", "_wrapped_call_impl", "apply",
               "decorate_context", "forward", "backward", "with_pending",
               "wrapped"}
_THIS = os.path.abspath(__file__)
_EXCLUDE = tuple(os.path.dirname(os.path.abspath(m.__file__)) + os.sep
                 for m in (torch, os))
_ENTRY = {"walk_call"}
_TB_LINE = re.compile(r'File "([^"]+)", line \d+, in (\S+)')


def _chain(frames: List[Tuple[str, str]], max_depth: int = 12
           ) -> Tuple[str, ...]:
    """Outermost-first (file, function) frames -> the module path: the
    frames below the walk's entry, without torch's, the standard
    library's, the profiler's and the harness names."""
    start = 0
    for i in range(len(frames) - 1, -1, -1):
        if frames[i][0] == _THIS and frames[i][1] in _ENTRY:
            start = i + 1
            break
    names = []
    for path, fn in frames[start:]:
        if path == _THIS or path.startswith(_EXCLUDE) or \
                fn in _SKIP_FUNCS or path.startswith("<"):
            continue
        names.append(fn)
    return tuple(names[:max_depth])


def _stack_path() -> Tuple[str, ...]:
    frames = []
    f = sys._getframe(1)
    while f is not None:
        frames.append((os.path.abspath(f.f_code.co_filename),
                       f.f_code.co_name))
        f = f.f_back
    return _chain(frames[::-1])


def _current_path() -> Tuple[str, ...]:
    """The forward stack of the autograd node running (a backward op),
    else the Python stack."""
    node = torch._C._current_autograd_node()
    if node is not None:
        tb = node.metadata.get("traceback_") if hasattr(node, "metadata") \
            else None
        if tb:
            frames = [(os.path.abspath(m.group(1)), m.group(2))
                      for m in (_TB_LINE.search(line) for line in tb) if m]
            return _chain(frames) + ("backward",)
    return _stack_path()


@dataclass
class ModuleNode:
    """One node of the per-module aggregation tree."""
    name: str
    flops: int = 0
    macs: int = 0
    bytes: int = 0
    children: Dict[str, "ModuleNode"] = field(default_factory=dict)

    def child(self, name: str) -> "ModuleNode":
        if name not in self.children:
            self.children[name] = ModuleNode(name)
        return self.children[name]

    def total_flops(self) -> int:
        return self.flops + sum(c.total_flops()
                                for c in self.children.values())

    def total_macs(self) -> int:
        return self.macs + sum(c.total_macs() for c in self.children.values())

    def total_bytes(self) -> int:
        return self.bytes + sum(c.total_bytes()
                                for c in self.children.values())


class OpWalk(TorchDispatchMode):
    """Count the aten ops run inside (and the kernels they declare) into
    a module tree. ``declared`` counts for the kernels live in
    ``kernels`` ({kernel id: [calls, flops, bytes]})."""

    def __init__(self):
        super().__init__()
        self.root = ModuleNode("model")
        self.kernels: Dict[str, List[float]] = {}
        self._hidden = 0
        self._anomaly = None
        self._prev_walk = None

    def add(self, path: Tuple[str, ...], flops, macs, nbytes) -> None:
        node = self.root
        for name in path:
            node = node.child(name)
        node.flops += int(flops)
        node.macs += int(macs)
        node.bytes += int(nbytes)

    @contextmanager
    def declared(self, kernel_id: str, cost: "costs.Cost"):
        if self._hidden == 0:
            self.add(_current_path(), cost.flops, cost.macs, cost.bytes)
            k = self.kernels.setdefault(kernel_id, [0, 0.0, 0.0])
            k[0] += 1
            k[1] += float(cost.flops)
            k[2] += float(cost.bytes)
        self._hidden += 1
        try:
            yield
        finally:
            self._hidden -= 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._hidden == 0:
            fl, mc, nb = op_cost(func, args, kwargs, out)
            if fl or mc or nb:
                self.add(_current_path(), fl, mc, nb)
        return out

    def __enter__(self):
        self._prev_walk, costs.WALK.active = costs.WALK.active, self
        self._anomaly = torch.autograd.set_detect_anomaly(True,
                                                          check_nan=False)
        self._anomaly.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._anomaly.__exit__(*exc)
            costs.WALK.active = self._prev_walk

    def walk_call(self, fn: Callable, *args, **kwargs):
        """``fn(*args, **kwargs)`` under the walk (the attribution's
        entry frame)."""
        with self:
            return fn(*args, **kwargs)


# --------------------------------------------------------------------- #
# Public API (the JAX module's)
# --------------------------------------------------------------------- #
def num_to_string(num: float, precision: int = 2) -> str:
    if num >= 1e12:
        return f"{num / 1e12:.{precision}f} T"
    if num >= 1e9:
        return f"{num / 1e9:.{precision}f} G"
    if num >= 1e6:
        return f"{num / 1e6:.{precision}f} M"
    if num >= 1e3:
        return f"{num / 1e3:.{precision}f} K"
    return f"{num:.{precision}f} "


def params_to_string(n, units=None, precision=2):
    return num_to_string(float(n), precision)


def flops_to_string(f, units=None, precision=2):
    return num_to_string(float(f), precision) + "FLOPs"


def macs_to_string(m, units=None, precision=2):
    return num_to_string(float(m), precision) + "MACs"


def duration_to_string(d, units=None, precision=2):
    if d >= 1:
        return f"{d:.{precision}f} s"
    if d >= 1e-3:
        return f"{d * 1e3:.{precision}f} ms"
    return f"{d * 1e6:.{precision}f} us"


@dataclass
class ProfileResult:
    total_flops: int
    total_macs: int
    total_params: int
    duration: float              # measured seconds for one call (0: none)
    tree: ModuleNode
    total_bytes: int = 0
    kernels: Dict[str, List[float]] = field(default_factory=dict)

    def get_total_flops(self, as_string: bool = False):
        return flops_to_string(self.total_flops) if as_string \
            else self.total_flops

    def get_total_macs(self, as_string: bool = False):
        return macs_to_string(self.total_macs) if as_string \
            else self.total_macs

    def get_total_params(self, as_string: bool = False):
        return params_to_string(self.total_params) if as_string \
            else self.total_params

    def get_total_duration(self, as_string: bool = False):
        return duration_to_string(self.duration) if as_string \
            else self.duration

    def _rows(self, node: ModuleNode, depth: int, path: str,
              max_depth: int, out: List[Tuple[str, int, int, int]]):
        for name, c in node.children.items():
            p = f"{path}/{name}" if path else name
            out.append((p, depth, c.total_flops(), c.total_macs()))
            if max_depth < 0 or depth + 1 < max_depth:
                self._rows(c, depth + 1, p, max_depth, out)

    def aggregate_by_depth(self, depth: int = -1
                           ) -> List[Tuple[str, int, int]]:
        rows: List[Tuple[str, int, int, int]] = []
        self._rows(self.tree, 0, "", -1, rows)
        if depth < 0:
            return [(p, f, m) for (p, d, f, m) in rows]
        agg: Dict[str, Tuple[int, int]] = {}
        for (p, d, f, m) in rows:
            if d == depth:
                agg[p] = (f, m)
        return [(p, f, m) for p, (f, m) in agg.items()]

    def top_modules(self, k: int = 1, depth: int = 1
                    ) -> List[Tuple[str, int, int]]:
        rows = self.aggregate_by_depth(depth - 1 if depth > 0 else 0)
        return sorted(rows, key=lambda r: -r[1])[:k]

    def format_profile(self, module_depth: int = -1, top_modules: int = 1,
                       detailed: bool = True) -> str:
        lines = [
            "-------------------------- DeepSpeed-TPU Flops Profiler "
            "--------------------------",
            f"params:   {params_to_string(self.total_params)}",
            f"fwd+step flops: {flops_to_string(self.total_flops)}",
            f"fwd+step MACs:  {macs_to_string(self.total_macs)}",
            f"fwd+step bytes: {num_to_string(float(self.total_bytes))}B",
        ]
        if self.duration:
            lines.append(f"measured step time: "
                         f"{duration_to_string(self.duration)}  "
                         f"({self.total_flops / self.duration / 1e12:.2f} "
                         f"TFLOPS achieved)")
        lines.append("")
        lines.append(f"Top {top_modules} modules by FLOPs:")
        for (p, f, m) in self.top_modules(top_modules, depth=1):
            lines.append(f"  {p}: {flops_to_string(f)}")
        if detailed:
            lines.append("")
            lines.append("Per-module profile "
                         "(module, flops, MACs, est. duration share):")
            rows: List[Tuple[str, int, int, int]] = []
            self._rows(self.tree, 0, "", module_depth, rows)
            tot = max(self.total_flops, 1)
            for (p, d, f, m) in rows:
                indent = "  " * (d + 1)
                dur = ""
                if self.duration:
                    dur = f", ~{duration_to_string(self.duration * f / tot)}"
                lines.append(f"{indent}{p.rsplit('/', 1)[-1]}: "
                             f"{flops_to_string(f)}, {macs_to_string(m)}"
                             f"{dur}  [{100.0 * f / tot:.1f}%]")
        lines.append("-" * 82)
        return "\n".join(lines)

    def print_model_profile(self, module_depth: int = -1,
                            top_modules: int = 1,
                            detailed: bool = True) -> None:
        print(self.format_profile(module_depth, top_modules, detailed))


def _count_params(tree) -> int:
    from ...ops.fused_update import tree_flatten
    return sum(int(np.prod(tuple(x.shape), dtype=np.int64))
               for x in tree_flatten(tree)[0] if hasattr(x, "shape"))


def _sync(out) -> None:
    if any(t.device.type == "cuda" for t in _tensors(out)):
        torch.cuda.synchronize()


def walk(fn: Callable, *args, **kwargs) -> Tuple[Any, ProfileResult]:
    """``(fn(*args, **kwargs), its ProfileResult)``: one call under the
    walk (no params column, no timing)."""
    w = OpWalk()
    out = w.walk_call(fn, *args, **kwargs)
    root = w.root
    return out, ProfileResult(
        total_flops=root.total_flops(), total_macs=root.total_macs(),
        total_params=0, duration=0.0, tree=root,
        total_bytes=root.total_bytes(), kernels=w.kernels)


def profile_fn(fn: Callable, *args, params=None, run: bool = True,
               static_argnums=()) -> ProfileResult:
    """Profile ``fn(*args)``: its op walk (one call), and with ``run`` one
    more call timed on the host clock (fenced on the card).

    ``params``: tree counted for the params column (default: args[0]).
    ``static_argnums`` is accepted for the JAX signature."""
    _, res = walk(fn, *args)
    if run:
        t0 = time.perf_counter()
        _sync(fn(*args))
        res.duration = time.perf_counter() - t0
    p = params if params is not None else (args[0] if args else None)
    res.total_params = _count_params(p) if p is not None else 0
    return res


def get_model_profile(model_fn: Callable, args=(), kwargs=None,
                      print_profile: bool = True, detailed: bool = True,
                      module_depth: int = -1, top_modules: int = 1,
                      warm_up: int = 1, as_string: bool = True,
                      ignore_modules=None):
    """(flops, macs, params) of one call of ``model_fn``."""
    if ignore_modules:
        import warnings
        warnings.warn("ignore_modules is not supported by the op-walking "
                      "profiler; counts include all modules")
    kwargs = kwargs or {}
    res = profile_fn(lambda *a: model_fn(*a, **kwargs), *args,
                     run=warm_up > 0)
    if print_profile:
        res.print_model_profile(module_depth=module_depth,
                                top_modules=top_modules, detailed=detailed)
    if as_string:
        return (res.get_total_flops(True), res.get_total_macs(True),
                res.get_total_params(True))
    return res.total_flops, res.total_macs, res.total_params


class FlopsProfiler:
    """Engine-facing profiler object: the engine calls ``profile`` on one
    training step at ``flops_profiler.profile_step`` and prints the
    table."""

    def __init__(self, fn: Optional[Callable] = None, config=None):
        self.fn = fn
        self.config = config
        self.result: Optional[ProfileResult] = None
        self.started = False

    def start_profile(self, ignore_list=None) -> None:
        self.started = True

    def stop_profile(self) -> None:
        self.started = False

    def reset_profile(self) -> None:
        self.result = None

    def end_profile(self) -> None:
        self.stop_profile()
        self.reset_profile()

    def profile(self, fn: Callable, *args, params=None) -> ProfileResult:
        self.result = profile_fn(fn, *args, params=params)
        return self.result

    def print_model_profile(self, profile_step=None, module_depth=-1,
                            top_modules=1, detailed=True, output_file=None):
        if self.result is None:
            return
        text = self.result.format_profile(module_depth, top_modules,
                                          detailed)
        if output_file:
            with open(output_file, "w") as f:
                f.write(text)
        else:
            print(text)


__all__ = ["FlopsProfiler", "OpWalk", "ProfileResult", "get_model_profile",
           "profile_fn", "walk", "op_cost", "flops_to_string",
           "macs_to_string", "params_to_string", "duration_to_string"]
