"""The module-level activation checkpointing API (port of
``deepspeed_tpu/runtime/activation_checkpointing/checkpointing.py``,
under its names): ``configure()`` once, then ``checkpoint(fn, *args)``
at each call site, or ``checkpoint_wrapper(fn)`` for a reusable
wrapper; ``is_configured()`` and ``reset()``.

A checkpointed call is a ``models/remat.Recompute`` region of one step:
its saved residuals are the floating-point tensor inputs of ``fn``, and
everything else ``fn`` would save for the backward pass is recomputed
there by running ``fn`` again, on the same inputs and the same random
draws: the global CPU and CUDA generators and any ``torch.Generator``
passed among the arguments are restored to their state at the call (the
JAX package gets this from its explicit keys). The gradients are the
plain call's bit for bit.

- ``cpu_checkpointing`` (``checkpoint_in_cpu``) holds the residuals in
  host memory between the passes (pinned, and copied without a host
  sync, for CUDA tensors) and copies them back when the backward pass
  needs them.
- ``partition_activations`` shards the residuals over the model-parallel
  ranks; at a model-parallel size of 1 (the port's only one) it is the
  identity. A model-parallel size above 1 raises here (an ``mpu`` saying
  so) and in the engine (the ds_config ``mesh``): it waits for tensor
  parallelism (ROADMAP queue 1 item 7, parallel axes and comm extras).
- ``contiguous_checkpointing``, ``synchronize`` and ``profile`` are
  accepted for call-site parity: the caching allocator packs the
  residuals, and nothing runs on a stream of its own.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Iterator, List, Optional

import torch

from ...models.remat import Op, Recompute
from ...utils.logging import logger

# module state set by configure()
_config = {
    "partition_activations": False,
    "cpu_checkpointing": False,
    "configured": False,
}


def configure(mpu=None, deepspeed_config=None,
              partition_activations: Optional[bool] = None,
              contiguous_checkpointing: Optional[bool] = None,
              checkpoint_in_cpu: Optional[bool] = None,
              synchronize: Optional[bool] = None,
              profile: Optional[bool] = None) -> None:
    """Reads the ``activation_checkpointing`` section of a
    ``DeepSpeedConfig`` and/or explicit flags (the flags win)."""
    if mpu is not None and \
            int(mpu.get_model_parallel_world_size()) > 1:
        raise NotImplementedError(
            "partition_activations over a model-parallel size above 1 is "
            "not ported yet (ROADMAP queue 1 item 7, parallel axes and "
            "comm extras: tensor parallelism)")
    ac = getattr(deepspeed_config, "activation_checkpointing_config", None)
    if ac is not None:
        _config["partition_activations"] = bool(ac.partition_activations)
        _config["cpu_checkpointing"] = bool(ac.cpu_checkpointing)
    if partition_activations is not None:
        _config["partition_activations"] = bool(partition_activations)
    if checkpoint_in_cpu is not None:
        _config["cpu_checkpointing"] = bool(checkpoint_in_cpu)
    _config["configured"] = True


def is_configured() -> bool:
    return bool(_config["configured"])


class _RngReplay:
    """The random state a checkpointed call may draw from: torch's CPU
    generator, the CUDA generators of its inputs' devices, and the
    ``torch.Generator`` arguments (``models/remat.GeneratorReplay``'s
    protocol)."""

    def __init__(self, generators: List[torch.Generator],
                 devices: List[int]):
        self.generators, self.devices = generators, devices

    def live(self) -> List[torch.Generator]:
        return self.generators

    def snapshot(self):
        return (torch.get_rng_state(),
                [torch.cuda.get_rng_state(d) for d in self.devices],
                [g.get_state() for g in self.generators])

    @contextlib.contextmanager
    def replay(self, state) -> Iterator[List[torch.Generator]]:
        cpu, cuda, gens = state
        with torch.random.fork_rng(devices=self.devices):
            torch.set_rng_state(cpu)
            for d, st in zip(self.devices, cuda):
                torch.cuda.set_rng_state(st, d)
            out = []
            for g, st in zip(self.generators, gens):
                r = torch.Generator(device=g.device)
                r.set_state(st)
                out.append(r)
            yield out


def checkpoint_wrapper(fn: Callable,
                       partition_activations: Optional[bool] = None,
                       cpu_checkpointing: Optional[bool] = None) -> Callable:
    """``fn(*args)`` as a checkpointed call; per-call flags override
    ``configure()``. The wrapper's ``last_saved`` lists what its last
    call held between the passes: ``(argument index, device, shape,
    pinned)`` a residual."""
    cpu = _config["cpu_checkpointing"] if cpu_checkpointing is None \
        else bool(cpu_checkpointing)
    # (partition_activations: the identity at a model-parallel size of 1)

    def wrapped(*args):
        floats = [i for i, a in enumerate(args)
                  if isinstance(a, torch.Tensor) and a.is_floating_point()]
        gens = [i for i, a in enumerate(args)
                if isinstance(a, torch.Generator)]
        names = tuple(f"arg{i}" for i in floats)
        # (the step re-runs from the held inputs: it must not keep the
        # float arguments alive itself)
        rest = [None if i in floats else a for i, a in enumerate(args)]

        def call(params, generators, *tensors):
            a = list(rest)
            for i, t in zip(floats, tensors):
                a[i] = t
            for i, g in zip(gens, generators):
                a[i] = g
            return (fn(*a),)

        devices = sorted({args[i].device.index or 0 for i in floats
                          if args[i].is_cuda})
        region = Recompute([Op("fn", names, ("out",), call, draws=True)],
                           frozenset(), _RngReplay(
                               [args[i] for i in gens], devices),
                           offload=cpu)
        out = region.forward({}, {n: args[i] for n, i in zip(names,
                                                             floats)})["out"]
        wrapped.last_saved = [(int(n[3:]),) + _describe(v)
                              for n, v in region._held.items()
                              if n in names]
        return out

    wrapped.last_saved = []
    return wrapped


def _describe(v: Any):
    """``(device, shape, pinned)`` of a held residual (a host span's
    device is the host's)."""
    t, shape = (v, v.shape) if isinstance(v, torch.Tensor) else \
        (v.span, v.size)
    pinned = t.device.type == "cpu" and torch.cuda.is_available() and \
        t.is_pinned()
    return str(t.device), tuple(shape), bool(pinned)


def checkpoint(function: Callable, *args) -> Any:
    """``function(*args)`` as a checkpointed call (the JAX package's and
    DeepSpeed's ``checkpoint(fn, *inputs)``)."""
    if not is_configured():
        logger.warning("activation checkpointing used before configure(); "
                       "using defaults")
    return checkpoint_wrapper(function)(*args)


def reset() -> None:
    """Restore the defaults (a test hook)."""
    _config.update(partition_activations=False, cpu_checkpointing=False,
                   configured=False)


__all__ = ["configure", "is_configured", "checkpoint_wrapper", "checkpoint",
           "reset"]
