"""Recompile sentinel: flag a step path called with a new argument
signature after its warmup (port of ``deepspeed_tpu/monitor/
recompile.py``).

The port has no jit cache, so the sentinel takes the JAX module's own
fallback: signature-set membership. Every call computes the ABSTRACT
SIGNATURE of its arguments (the tree of containers + each tensor's
dtype and shape, a Python value's type) — host metadata only, no device
read. A signature not seen before is a miss: the first
``warmup_calls`` calls of a path may miss (its cold start); a later
miss is an event naming the path and the signature delta against the
last miss, and under ``telemetry.fail_on_recompile`` a
``RecompileError`` that ``raise_pending`` raises once the caller has
stored the step's state. What a miss costs on the card is new kernel
builds, allocator growth and, for a shape-polymorphic caller, a
different program: the event is the signal that a batch's shapes
drifted.

A sentinel built with ``walk_fn`` also walks each path's first call
through the flops profiler (``walk_fn(fn, args, kwargs) -> (out,
walk)``) and keeps the walk: ``registered_paths`` hands the walks to the
roofline cost model (monitor/cost_model.py).
"""
from __future__ import annotations

import functools
import time
from typing import Any, Callable, Dict, List, Optional, Tuple


class RecompileError(RuntimeError):
    """Raised on a post-warmup signature miss under fail_on_recompile."""


def _leaf_desc(x: Any) -> str:
    shape = getattr(x, "shape", None)
    dtype = getattr(x, "dtype", None)
    if shape is not None and dtype is not None:
        name = str(dtype).replace("torch.", "")
        return f"{name}[{','.join(str(int(d)) for d in shape)}]"
    return f"py:{type(x).__name__}"


def _flatten(tree: Any, path: str, out: List[Tuple[str, str]],
             struct: List[Any]) -> None:
    if isinstance(tree, (list, tuple)):
        struct.append((type(tree).__name__, len(tree)))
        for i, x in enumerate(tree):
            _flatten(x, f"{path}[{i}]", out, struct)
    elif isinstance(tree, dict):
        keys = sorted(tree, key=str)
        struct.append(("dict", tuple(keys)))
        for k in keys:
            _flatten(tree[k], f"{path}[{k!r}]", out, struct)
    else:
        out.append((path, _leaf_desc(tree)))


def abstract_signature(tree: Any) -> Tuple[Any, Tuple[Tuple[str, str], ...]]:
    """(hashable key, [(path, desc)]) for an argument tree (lists, tuples
    and dicts of tensors and Python values) — host metadata only."""
    descs: List[Tuple[str, str]] = []
    struct: List[Any] = []
    _flatten(tree, "", descs, struct)
    descs_t = tuple(descs)
    return (tuple(struct), tuple(d for _, d in descs_t)), descs_t


def signature_delta(old: Tuple[Tuple[str, str], ...],
                    new: Tuple[Tuple[str, str], ...]) -> List[str]:
    """Human-readable per-path differences between two signatures."""
    if tuple(old) == tuple(new):
        return ["no abstract-signature change"]
    o, n = dict(old), dict(new)
    out = []
    for path in n:
        if path not in o:
            out.append(f"{path}: added {n[path]}")
        elif o[path] != n[path]:
            out.append(f"{path}: {o[path]} -> {n[path]}")
    for path in o:
        if path not in n:
            out.append(f"{path}: removed {o[path]}")
    if not out:
        out.append("tree structure changed (same leaf signatures)")
    return out


class RecompileSentinel:
    """Per-engine registry of instrumented step paths."""

    def __init__(self, warmup_calls: int = 1, fail_on_recompile: bool = False,
                 on_event: Optional[Callable[[Dict[str, Any]], None]] = None,
                 walk_fn: Optional[Callable] = None):
        self.warmup_calls = max(0, int(warmup_calls))
        self.fail_on_recompile = bool(fail_on_recompile)
        self.on_event = on_event
        self.walk_fn = walk_fn
        self.events: List[Dict[str, Any]] = []
        self.pending_error: Optional[RecompileError] = None
        self._fns: Dict[str, Dict[str, Any]] = {}
        # Cumulative wall of missing calls (warmup ones too: the goodput
        # ledger attributes all of it).
        self.compile_wall_s = 0.0

    def raise_pending(self) -> None:
        """Raise (once) a fail_on_recompile violation recorded by the
        last call, after the caller stored the step's state."""
        if self.pending_error is not None:
            err, self.pending_error = self.pending_error, None
            raise err

    @property
    def recompile_count(self) -> int:
        """Post-warmup misses across every instrumented path."""
        return len(self.events)

    def compile_counts(self) -> Dict[str, int]:
        return {name: st["compiles"] for name, st in self._fns.items()}

    def registered_paths(self) -> Dict[str, Any]:
        """{path name: its walk} for every instrumented path walked so
        far (``walk_fn``'s result of its first call)."""
        return {name: st["walk"] for name, st in self._fns.items()
                if st.get("walk") is not None}

    def instrument(self, name: str, fn: Callable) -> Callable:
        """Wrap ``fn``; the raw function stays reachable via
        ``__wrapped__``."""
        st = self._fns.setdefault(
            name, {"calls": 0, "compiles": 0, "seen": set(), "descs": None,
                   "compile_wall_s": 0.0, "walk": None})

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            t_call0 = time.perf_counter()
            key, descs = abstract_signature((args, kwargs))
            if self.walk_fn is not None and st["walk"] is None:
                out, st["walk"] = self.walk_fn(fn, args, kwargs)
            else:
                out = fn(*args, **kwargs)
            miss = key not in st["seen"]
            st["seen"].add(key)
            prior_calls = st["calls"]
            st["calls"] += 1
            if miss:
                dt = time.perf_counter() - t_call0
                st["compile_wall_s"] += dt
                self.compile_wall_s += dt
                prev_descs, st["descs"] = st["descs"], descs
                st["compiles"] += 1
                if prior_calls >= self.warmup_calls:
                    self._violation(name, st, prev_descs, descs)
            return out

        wrapped.__wrapped__ = fn
        return wrapped

    def _violation(self, name: str, st: Dict[str, Any], prev_descs,
                   descs) -> None:
        delta = signature_delta(prev_descs or (), descs)
        event = {
            "fn": name,
            "call_index": st["calls"] - 1,
            "total_compiles": st["compiles"],
            "signature_delta": delta,
        }
        self.events.append(event)
        if self.on_event is not None:
            self.on_event(dict(event))
        if self.fail_on_recompile:
            self.pending_error = RecompileError(
                f"telemetry.fail_on_recompile: new argument signature on "
                f"'{name}' after warmup (miss #{st['compiles']} at call "
                f"{st['calls'] - 1}); signature delta: " + "; ".join(delta))


__all__ = ["RecompileSentinel", "RecompileError", "abstract_signature",
           "signature_delta"]
