"""The tile resolver: one call for every run-time tile decision
(port of ``deepspeed_tpu/ops/autotune.py``).

    tile = autotune.resolve(kernel, shape, dtype, heuristic,
                            candidates, measure)

The contract, in priority order:

1. ``DS_AUTOTUNE=0``: ``resolve`` returns ``heuristic``, today's fixed
   rule, with no registry read and no search.
2. Off CUDA nothing is searched (``search_allowed()`` is False unless
   ``DS_AUTOTUNE_FORCE=1``, the tests' and tools' override): the CPU tests
   stay deterministic whatever a card run recorded.
3. On CUDA the first resolve of a new ``kernel|dtype[dims]|card`` key
   times the candidates once (``measure``) and records the winner; every
   later resolve of that key, in this process or the next, hits the
   registry with no search.

The registry is a JSON file (``DS_AUTOTUNE_REGISTRY``, default
``~/.cache/deepspeed_tpu_torch/autotune.json``) written by rank 0 only,
through a temporary file and ``os.replace``, so a killed writer never
leaves a torn file. A corrupt file degrades to empty with a warning; an
entry outside today's candidates is ignored; a candidate that raises is
discarded. The card part of the key is ``torch.cuda.get_device_name()``
with spaces replaced (``cpu`` without a card): a tile timed on one card is
no evidence about another.

A decision goes behind ``resolve`` only where every candidate computes
the same bits (the tiles move the schedule, not the arithmetic), which is
what makes a registry shared across runs safe. The call sites: K9's BN
(``ops/grouped_gemm.py``), K7/K8's super-tile (``ops/sparse_flash.py``).
"""
from __future__ import annotations

import functools
import json
import math
import os
import tempfile
import time
import warnings
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

_ENV_KNOB = "DS_AUTOTUNE"
_ENV_PATH = "DS_AUTOTUNE_REGISTRY"
_ENV_FORCE = "DS_AUTOTUNE_FORCE"

# How many resolves searched, hit the registry or fell back to the
# heuristic since import (or ``reset()``).
counters: Dict[str, int] = {"search": 0, "hit": 0, "heuristic": 0}

# The registries read so far: path -> {key: entry}. ``reset()`` drops them
# (tests point DS_AUTOTUNE_REGISTRY at temporary files).
_CACHE: Dict[str, Dict[str, Any]] = {}

# The decisions this process has made: (registry, kernel, dims, dtype,
# card, candidates, heuristic) -> tile. A kernel's wrapper resolves at
# every launch (the JAX package's once a compile), so a launch after the
# first one of its key takes the decision from here, a hit as well.
_DECIDED: Dict[Tuple, Any] = {}


def enabled() -> bool:
    """``DS_AUTOTUNE=0`` turns the resolver off: the heuristics only."""
    return os.environ.get(_ENV_KNOB, "1") != "0"


def search_allowed() -> bool:
    """Whether this process may time candidates: with a card only (a CPU
    timing measures PyTorch's CPU kernels, and the tests must be
    deterministic); ``DS_AUTOTUNE_FORCE=1`` overrides."""
    if not enabled():
        return False
    if os.environ.get(_ENV_FORCE) == "1":
        return True
    return torch.cuda.is_available()


def card_kind() -> str:
    """The key's card part: the current device's name with spaces
    replaced, or ``cpu`` without a card."""
    if torch.cuda.is_available():
        return _card_name(torch.cuda.current_device())
    return "cpu"


@functools.lru_cache(maxsize=None)
def _card_name(index: int) -> str:
    # read once a device: a resolve runs at every K9 launch
    return torch.cuda.get_device_name(index).replace(" ", "_")


def registry_path() -> str:
    env = os.environ.get(_ENV_PATH)
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache",
                        "deepspeed_tpu_torch", "autotune.json")


def reset() -> None:
    """Drop the registries read and the decisions made, and zero the
    counters."""
    _CACHE.clear()
    _DECIDED.clear()
    for k in counters:
        counters[k] = 0


def dtype_name(dtype: Any) -> str:
    """``torch.bfloat16`` -> ``bfloat16`` (the JAX package's spelling)."""
    return str(dtype).replace("torch.", "")


def _key(kernel: str, shape: Sequence[int], dtype: Any) -> str:
    dims = ",".join(str(int(d)) for d in shape)
    return f"{kernel}|{dtype_name(dtype)}[{dims}]|{card_kind()}"


def _load(path: str) -> Dict[str, Any]:
    if path in _CACHE:
        return _CACHE[path]
    reg: Dict[str, Any] = {}
    try:
        with open(path) as f:
            loaded = json.load(f)
        if not isinstance(loaded, dict):
            raise ValueError(f"registry root is {type(loaded).__name__}")
        reg = loaded
    except FileNotFoundError:
        pass
    except (OSError, ValueError) as e:  # corrupt: start empty
        warnings.warn(f"autotune registry {path} unreadable ({e}); "
                      f"starting empty — heuristics still apply")
    _CACHE[path] = reg
    return reg


def _rank() -> int:
    if torch.distributed.is_available() and \
            torch.distributed.is_initialized():
        return torch.distributed.get_rank()
    return int(os.environ.get("RANK", "0"))


def _write(path: str, reg: Dict[str, Any]) -> None:
    """Rank 0 only: a temporary file in the same directory, then
    ``os.replace``."""
    if _rank() != 0:
        return
    directory = os.path.dirname(path) or "."
    try:
        os.makedirs(directory, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=directory, prefix=".autotune_",
                                   suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(reg, f, indent=1, sort_keys=True)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
    except OSError as e:  # read-only file system: keep it in memory
        warnings.warn(f"autotune registry {path} not writable ({e}); "
                      f"keeping the winner in memory only")


def _encode(tile: Any) -> Any:
    if isinstance(tile, tuple):
        return [int(t) for t in tile]
    return int(tile)


def _decode(raw: Any, like: Any) -> Any:
    """A registry value as the call site's tile type (int or int tuple),
    None when it is not one."""
    if isinstance(like, tuple):
        if not isinstance(raw, (list, tuple)) or len(raw) != len(like):
            return None
        try:
            return tuple(int(v) for v in raw)
        except (TypeError, ValueError):
            return None
    if isinstance(raw, (list, tuple)):
        return None
    try:
        return int(raw)
    except (TypeError, ValueError):
        return None


def resolve(kernel: str, shape: Sequence[int], dtype: Any, heuristic,
            candidates: Optional[Sequence] = None,
            measure: Optional[Callable[[Any], float]] = None):
    """Resolve one tile decision.

    ``heuristic`` is today's fixed choice and the answer when the
    resolver is off, may not search here, or has no usable registry
    entry and no ``measure``. ``candidates`` are the legal tiles (the
    heuristic joins them if missing); ``measure(tile) -> seconds`` times
    one, and a candidate that raises is discarded. The winner is recorded
    in the registry under ``kernel|dtype[dims]|card``."""
    if not search_allowed():
        counters["heuristic"] += 1
        return heuristic
    cands = tuple(candidates or ())
    if heuristic not in cands:
        cands += (heuristic,)
    path = registry_path()
    decided = (path, kernel, tuple(shape), dtype_name(dtype), card_kind(),
               cands, heuristic)
    if decided in _DECIDED:
        counters["hit"] += 1
        return _DECIDED[decided]
    key = _key(kernel, shape, dtype)
    reg = _load(path)
    ent = reg.get(key)
    if isinstance(ent, dict):
        tile = _decode(ent.get("tile"), heuristic)
        if tile is not None and tile in cands:
            counters["hit"] += 1
            _DECIDED[decided] = tile
            return tile
        # recorded outside today's candidates: ignored
    if measure is None or len(cands) < 2:
        counters["heuristic"] += 1
        return heuristic
    counters["search"] += 1
    timings: Dict[Any, float] = {}
    for c in cands:
        try:
            t = float(measure(c))
        except Exception:  # a candidate that fails is no winner
            continue
        if math.isfinite(t):
            timings[c] = t
    if not timings:
        return heuristic
    best = min(timings, key=lambda c: timings[c])
    t_h = timings.get(heuristic)
    reg[key] = {
        "tile": _encode(best),
        "heuristic": _encode(heuristic),
        "timings_s": {str(c): round(timings[c], 9) for c in timings},
        "speedup_vs_heuristic":
            round(t_h / timings[best], 4) if t_h else None,
        "recorded_unix": int(time.time()),
    }
    _write(path, reg)
    _DECIDED[decided] = best
    return best


def measure_from_runner(runner: Callable[[Any], Any],
                        repeats: int = 3) -> Callable[[Any], float]:
    """``runner(tile)`` as a measure: one warm call, then the best of
    ``repeats`` calls, each between CUDA events on the current stream
    (with a card; else the host clock)."""
    def measure(tile) -> float:
        runner(tile)
        best = float("inf")
        for _ in range(repeats):
            if torch.cuda.is_available():
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                runner(tile)
                end.record()
                end.synchronize()
                best = min(best, start.elapsed_time(end) / 1e3)
            else:
                t0 = time.perf_counter()
                runner(tile)
                best = min(best, time.perf_counter() - t0)
        return best
    return measure


def pow2_candidates(lo: int, hi: int,
                    fits: Optional[Callable[[int], bool]] = None
                    ) -> Tuple[int, ...]:
    """Powers of two in ``[lo, hi]`` that pass the call site's ``fits``."""
    out = []
    c = 1 << max(0, (lo - 1).bit_length())
    while c <= hi:
        if c >= lo and (fits is None or fits(c)):
            out.append(c)
        c *= 2
    return tuple(out)


__all__ = ["resolve", "measure_from_runner", "pow2_candidates",
           "enabled", "search_allowed", "card_kind", "registry_path",
           "reset", "counters", "dtype_name"]
