"""Training-health monitor: anomaly detection with provenance and the
hang watchdog (port of ``deepspeed_tpu/monitor/health.py``).

- **The grad tap.** The engine's step computes ``leaf_sq_taps``: one
  ``[num_leaves]`` fp32 device tensor of per-leaf gradient sums of
  squares (unscaled), which rides the telemetry ring and is read in the
  drain's one batched copy (no added host sync). At drain time
  ``HealthMonitor`` names the FIRST non-finite leaf (tree flatten
  order) and its top-level layer, for a non-finite loss and for the
  fp16 overflow vote; per-layer grad norms come from the same tensor
  (``TapSpec`` groups leaves by top-level key).
- **Spikes.** ``EwmaDetector`` keeps an exponentially weighted mean and
  variance per metric (loss, grad_norm) and flags ``|z| > z_threshold``
  after a warmup count, on the drained host scalars.
- **Hangs.** ``HangWatchdog`` is a daemon thread fed ``pending(name)``
  at a step's launch and ``beat(wall_s)`` at its end; no beat within
  ``max(min_timeout_s, factor * p95(recent walls))`` fires once: an
  all-thread stack dump, a device-memory sample (``memory_sampler``)
  and the pending step's name. The checkpoint writer
  (runtime/async_ckpt.py) arms one around each background write.

Events flow through ``Telemetry.event`` into the JSONL stream and the
flight recorder (monitor/flight.py).
"""
from __future__ import annotations

import faulthandler
import math
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ..utils.logging import logger


# --------------------------------------------------------------------- #
# Grad taps + provenance spec
# --------------------------------------------------------------------- #
class TapSpec:
    """Host-side decoder for the grad tap: leaf paths in tree
    flatten order, each mapped to its top-level "layer" (first path
    component). Built ONCE from the params tree (host metadata only)."""

    def __init__(self, leaf_paths: List[str], layer_names: List[str],
                 leaf_layer_idx: List[int]):
        self.leaf_paths = list(leaf_paths)
        self.layer_names = list(layer_names)
        self.leaf_layer_idx = list(leaf_layer_idx)

    @classmethod
    def from_tree(cls, tree: Any) -> "TapSpec":
        """From a params tree (nested dicts/lists of tensors), its leaves
        in the port's flatten order (JAX's: dict keys sorted) under
        ``jax.tree_util.keystr`` names, so both packages name a leaf
        alike."""
        return cls.from_paths(keystr_paths(tree))

    @classmethod
    def from_paths(cls, leaf_paths: List[str]) -> "TapSpec":
        layers: List[str] = []
        idx: List[int] = []
        for path in leaf_paths:
            top = path[:path.index("]") + 1] if path.startswith("[") \
                else "<root>"
            # keystr-style component without the container syntax noise.
            top = top.strip("[]'\".")
            if top not in layers:
                layers.append(top)
            idx.append(layers.index(top))
        return cls(leaf_paths, layers, idx)

    @property
    def num_leaves(self) -> int:
        return len(self.leaf_paths)

    def layer_of(self, leaf_index: int) -> str:
        return self.layer_names[self.leaf_layer_idx[leaf_index]]

    def layer_norms(self, leaf_sq: np.ndarray) -> Dict[str, Any]:
        """Per-layer grad norms from the per-leaf sum-of-squares (host
        aggregation — the device tap stays per-leaf). Non-finite
        values stringify so the JSONL stays parseable everywhere."""
        sums = np.zeros(len(self.layer_names), np.float64)
        bad = np.zeros(len(self.layer_names), bool)
        for i, s in enumerate(np.asarray(leaf_sq, np.float64)):
            j = self.leaf_layer_idx[i]
            if math.isfinite(float(s)):
                sums[j] += float(s)
            else:
                bad[j] = True
        out: Dict[str, Any] = {}
        for j, name in enumerate(self.layer_names):
            out[name] = "non-finite" if bad[j] \
                else round(float(np.sqrt(sums[j])), 6)
        return out


def leaf_sq_taps(leaves: List[Any], scale: Any = None):
    """The tap: per-leaf sum of squares, fp32, stacked into one
    ``[num_leaves]`` device tensor (the leaves in tree flatten order —
    TapSpec decodes it), times ``scale`` (a tensor or float: the squared
    unscale) when given. ``leaves`` are views of the flat grad buffers,
    so the tap is one multi-tensor norm over them, on the device, with
    no host read. A non-finite value in a leaf makes its entry
    non-finite: the fp16 overflow vote's information with provenance."""
    import torch
    if not leaves:
        return None
    norms = torch._foreach_norm([x.float() for x in leaves])
    tap = torch.stack(norms).square()
    return tap if scale is None else tap * scale


def keystr_paths(tree: Any, prefix: str = "") -> List[str]:
    """The leaves' key paths in ``jax.tree_util.keystr`` form
    (``"['blocks']['qkv_kernel']"``, a sequence index as ``[0]``), in
    ``tree_flatten`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in keystr_paths(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [p for i, t in enumerate(tree)
                for p in keystr_paths(t, f"{prefix}[{i}]")]
    return [prefix]


# --------------------------------------------------------------------- #
# EWMA z-score spike detection
# --------------------------------------------------------------------- #
class EwmaDetector:
    """Exponentially-weighted mean/variance with z-score spike flagging.

    ``update(x)`` returns the z-score when ``|z| > z_threshold`` after
    ``warmup`` finite samples, else None. The baseline updates on every
    sample INCLUDING flagged ones (a level shift fires once and is then
    absorbed, instead of firing forever against a frozen baseline)."""

    def __init__(self, alpha: float = 0.1, z_threshold: float = 6.0,
                 warmup: int = 20):
        self.alpha = float(alpha)
        self.z_threshold = float(z_threshold)
        self.warmup = int(warmup)
        self.mean: Optional[float] = None
        self.var = 0.0
        self.n = 0

    @property
    def std(self) -> float:
        return math.sqrt(max(0.0, self.var))

    def update(self, x: float) -> Optional[float]:
        x = float(x)
        if not math.isfinite(x):
            return None   # non-finite is its own (provenance) event
        z: Optional[float] = None
        if self.mean is not None and self.n >= self.warmup:
            # Relative std floor: a dead-constant series (var == 0) must
            # not divide by zero, but a genuine jump off a flat baseline
            # SHOULD fire — with a huge z, which is the honest answer.
            denom = max(self.std, 1e-6 * max(1.0, abs(self.mean)))
            z0 = (x - self.mean) / denom
            if abs(z0) > self.z_threshold:
                z = z0
        if self.mean is None:
            self.mean = x
        else:
            d = x - self.mean
            self.mean += self.alpha * d
            self.var = (1.0 - self.alpha) * (self.var + self.alpha * d * d)
        self.n += 1
        return z


# --------------------------------------------------------------------- #
# Drain-time health monitor
# --------------------------------------------------------------------- #
class HealthMonitor:
    """Consumes drained (host-native) step records; emits anomaly event
    payloads. Owned by Telemetry; runs only at report boundaries."""

    def __init__(self, spec: Optional[TapSpec] = None,
                 z_threshold: float = 6.0, ewma_alpha: float = 0.1,
                 warmup_steps: int = 20, max_events: int = 256):
        self.spec = spec
        self.detectors = {
            "loss": EwmaDetector(ewma_alpha, z_threshold, warmup_steps),
            "grad_norm": EwmaDetector(ewma_alpha, z_threshold,
                                      warmup_steps),
        }
        self.counts: Dict[str, int] = {}
        self.anomalies: deque = deque(maxlen=int(max_events))

    def check_step(self, step: int, rec: Dict[str, Any],
                   leaf_sq: Optional[np.ndarray] = None
                   ) -> List[Dict[str, Any]]:
        events: List[Dict[str, Any]] = []
        loss = rec.get("loss")
        if isinstance(loss, (int, float)) and not isinstance(loss, bool):
            if not math.isfinite(float(loss)):
                # `overflow` rides along: a non-finite value on an
                # overflow-SKIPPED step is routine fp16 loss-scale
                # mechanics (the update was discarded); unskipped is the
                # defect class the bench gate fails on.
                ev = {"anomaly": "nonfinite_loss", "anomaly_step": step,
                      "value": str(float(loss)),
                      "overflow": bool(rec.get("overflow", False))}
                ev.update(self._provenance(leaf_sq))
                events.append(ev)
            else:
                z = self.detectors["loss"].update(float(loss))
                if z is not None:
                    events.append(self._spike("loss", step, float(loss), z))
        gn = rec.get("grad_norm")
        overflow = bool(rec.get("overflow", False))
        gn_val = float(gn) if isinstance(gn, (int, float)) \
            and not isinstance(gn, bool) else None
        # The tap is a first-class detector, not just provenance: on the
        # fp32 no-clip path grad_norm is the -1 "not computed" sentinel
        # and there is no overflow vote, so a NaN gradient silently
        # poisons the params — only the per-leaf tap sees it.
        tap_bad = leaf_sq is not None and \
            not bool(np.isfinite(np.asarray(leaf_sq,
                                            np.float64)).all())
        if overflow or tap_bad or \
                (gn_val is not None and not math.isfinite(gn_val)):
            ev = {"anomaly": "nonfinite_grad", "anomaly_step": step,
                  "overflow": overflow}
            if gn_val is not None:
                ev["grad_norm"] = gn_val if math.isfinite(gn_val) \
                    else str(gn_val)
            ev.update(self._provenance(leaf_sq))
            events.append(ev)
        elif gn_val is not None and gn_val >= 0.0:
            # -1.0 is the engine's "norm not computed" sentinel.
            z = self.detectors["grad_norm"].update(gn_val)
            if z is not None:
                events.append(self._spike("grad_norm", step, gn_val, z))
        for ev in events:
            kind = ev["anomaly"]
            self.counts[kind] = self.counts.get(kind, 0) + 1
            self.anomalies.append(ev)
        return events

    def _spike(self, metric: str, step: int, value: float,
               z: float) -> Dict[str, Any]:
        det = self.detectors[metric]
        return {"anomaly": f"{metric}_spike", "anomaly_step": step,
                "metric": metric, "value": round(value, 6),
                "z": round(float(z), 3),
                "ewma_mean": round(float(det.mean), 6),
                "ewma_std": round(det.std, 6)}

    def _provenance(self, leaf_sq: Optional[np.ndarray]) -> Dict[str, Any]:
        """First-non-finite-leaf attribution from the grad tap."""
        if leaf_sq is None or self.spec is None:
            return {}
        arr = np.asarray(leaf_sq, np.float64).reshape(-1)
        if arr.shape[0] != self.spec.num_leaves:
            return {"tap_mismatch": [int(arr.shape[0]),
                                     self.spec.num_leaves]}
        bad = np.flatnonzero(~np.isfinite(arr))
        if bad.size == 0:
            # Overflow vote without a non-finite tap (e.g. a host-voted
            # sparse overflow): still report the layer norms for context.
            return {"layer_grad_norms": self.spec.layer_norms(arr)}
        i = int(bad[0])
        return {"first_nonfinite_leaf": self.spec.leaf_paths[i],
                "first_nonfinite_layer": self.spec.layer_of(i),
                "nonfinite_leaves": int(bad.size),
                "num_leaves": int(arr.shape[0]),
                "layer_grad_norms": self.spec.layer_norms(arr)}

    def summary(self) -> Dict[str, Any]:
        return {"counts": dict(self.counts),
                "total": int(sum(self.counts.values()))}


# --------------------------------------------------------------------- #
# Hang watchdog
# --------------------------------------------------------------------- #


class HangWatchdog:
    """Daemon thread that fires when no step completes within
    ``max(min_timeout_s, factor * p95(recent step walls))``.

    Hot-path cost: ``pending()`` is one attribute store at dispatch,
    ``beat()`` is a deque append + two stores at completion. The thread
    samples device memory and dumps stacks only when it FIRES."""

    def __init__(self, factor: float = 10.0, min_timeout_s: float = 120.0,
                 poll_s: Optional[float] = None,
                 on_fire: Optional[Callable[[Dict[str, Any]], None]] = None,
                 dump_dir: Optional[str] = None, window: int = 64,
                 memory_sampler: Optional[Callable] = None):
        self.factor = float(factor)
        self.min_timeout_s = float(min_timeout_s)
        self.poll_s = float(poll_s) if poll_s is not None \
            else max(0.05, self.min_timeout_s / 4.0)
        self.on_fire = on_fire
        self.dump_dir = dump_dir or "."
        self._walls: deque = deque(maxlen=int(window))
        self._last_beat = time.perf_counter()
        self._pending: Optional[str] = None
        self._armed = True
        self.fires = 0
        self.events: List[Dict[str, Any]] = []
        self._memory_sampler = memory_sampler
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -------------------------- hot path ----------------------------- #
    def pending(self, name: str) -> None:
        """A step function is dispatching — remember its signature so a
        fire can name what the run was stuck on."""
        self._pending = name

    def beat(self, wall_s: Optional[float] = None) -> None:
        """A step completed: record its wall, reset the clock, re-arm."""
        if wall_s is not None and wall_s > 0.0:
            self._walls.append(float(wall_s))
        self._last_beat = time.perf_counter()
        self._armed = True

    def disarm(self) -> None:
        """Stand down until the next beat(). For bounded-duration guards
        (the async checkpoint writer arms at write start and disarms at
        completion) where silence between work items is legitimate, not
        a hang."""
        self._armed = False

    # -------------------------- thread ------------------------------- #
    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="ds-hang-watchdog")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=2 * self.poll_s + 1.0)

    def _p95_wall(self) -> Optional[float]:
        """Nearest-rank p95 of the recent step walls (the ONE percentile
        rule the timeout and the fired event both report)."""
        if not self._walls:
            return None
        walls = sorted(self._walls)
        return walls[min(len(walls) - 1,
                         int(round(0.95 * (len(walls) - 1))))]

    def timeout_s(self) -> float:
        p95 = self._p95_wall()
        if p95 is None:
            return self.min_timeout_s
        return max(self.min_timeout_s, self.factor * p95)

    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            elapsed = time.perf_counter() - self._last_beat
            timeout = self.timeout_s()
            if self._armed and elapsed > timeout:
                self._armed = False   # once per stall; next beat re-arms
                self.fires += 1
                try:
                    event = self._fire(elapsed, timeout)
                except Exception as e:  # the watchdog must never kill
                    event = {"error": f"{type(e).__name__}: {e}"[:200],
                             "elapsed_s": round(elapsed, 3)}
                self.events.append(event)
                if self.on_fire is not None:
                    try:
                        self.on_fire(dict(event))
                    except Exception:
                        pass

    def _fire(self, elapsed: float, timeout: float) -> Dict[str, Any]:
        dump_path = os.path.join(self.dump_dir, "watchdog_stacks.txt")
        try:
            os.makedirs(self.dump_dir, exist_ok=True)
            with open(dump_path, "w") as f:
                f.write(f"# hang watchdog fire #{self.fires}: no step in "
                        f"{elapsed:.1f}s (timeout {timeout:.1f}s), "
                        f"pending={self._pending}\n")
                faulthandler.dump_traceback(file=f, all_threads=True)
        except Exception as e:
            dump_path = f"<dump failed: {type(e).__name__}: {e}>"
        mem = None
        if self._memory_sampler is not None:
            try:
                mem = self._memory_sampler()
            except Exception:
                pass
        p95 = self._p95_wall()
        event = {
            "fire": self.fires,
            # No completed step yet => the run never got past warmup
            # (stuck compiling / first dispatch), a different diagnosis
            # than a steady-state hang.
            "phase": "steady" if self._walls else "startup",
            "pending_fn": self._pending,
            "elapsed_s": round(elapsed, 3),
            "timeout_s": round(timeout, 3),
            "p95_step_wall_s": round(p95, 4) if p95 is not None else None,
            "steps_observed": len(self._walls),
            "threads": threading.active_count(),
            "stack_dump_path": dump_path,
        }
        if isinstance(mem, dict):
            event["memory"] = {k: mem[k] for k in
                               ("bytes_in_use_max", "peak_bytes_in_use_max",
                                "num_devices") if k in mem}
        logger.warning(
            f"telemetry: hang watchdog fired — no step completed in "
            f"{elapsed:.1f}s (timeout {timeout:.1f}s, pending "
            f"{self._pending}); stacks dumped to {dump_path}")
        return event


__all__ = ["TapSpec", "keystr_paths", "leaf_sq_taps", "EwmaDetector", "HealthMonitor",
           "HangWatchdog"]
