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
  ranks of the ``mpu`` given to ``configure`` (a ``parallel/topology.
  PipelineParallelGrid``, e.g. ``build_mesh(mp=2)``): each rank holds
  its 1/mp slice of each residual along JAX's ``_default_spec`` dim
  (dim 1 of a ``[B, S, ...]`` activation, dim 0 of a 1-D or 2-D tensor)
  and the whole is all-gathered over the model group before the re-run;
  a residual that dim does not split evenly (or that is not contiguous)
  is held whole. At a model-parallel size of 1 it is the identity.
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
    "mp": None,          # (group, size, rank) of the model-parallel ranks
}


def configure(mpu=None, deepspeed_config=None,
              partition_activations: Optional[bool] = None,
              contiguous_checkpointing: Optional[bool] = None,
              checkpoint_in_cpu: Optional[bool] = None,
              synchronize: Optional[bool] = None,
              profile: Optional[bool] = None) -> None:
    """Reads the ``activation_checkpointing`` section of a
    ``DeepSpeedConfig`` and/or explicit flags (the flags win); ``mpu``
    names the model-parallel ranks ``partition_activations`` splits
    over."""
    if mpu is not None:
        size = int(mpu.get_model_parallel_world_size())
        _config["mp"] = None if size <= 1 else (
            mpu.get_model_parallel_group(), size,
            int(mpu.get_model_parallel_rank()))
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


def _default_dim(ndim: int) -> int:
    """JAX ``_default_spec``'s split dim: the sequence dim of a ``[B, S,
    ...]`` activation, else dim 0."""
    return 1 if ndim >= 3 else 0


class _MpSlice:
    """A residual held as this rank's slice along ``_default_dim``;
    ``restore()`` all-gathers the whole over the model group (a
    collective: every rank's backward pass makes it, in the same
    order). ``inner``: how the slice itself is held (host memory under
    ``cpu_checkpointing``)."""
    __slots__ = ("part", "dim", "mp")

    def __init__(self, v: torch.Tensor, mp, inner=None):
        group, size, rank = mp
        self.dim, self.mp = _default_dim(v.dim()), mp
        c = v.shape[self.dim] // size
        part = v.narrow(self.dim, rank * c, c).contiguous()
        self.part = part if inner is None else inner(part)

    @property
    def span(self) -> torch.Tensor:
        p = self.part
        return p if isinstance(p, torch.Tensor) else p.span

    def restore(self) -> torch.Tensor:
        from ...parallel import comm
        p = self.part if isinstance(self.part, torch.Tensor) else \
            self.part.restore()
        return comm.all_gather_dim(p, self.dim, self.mp[0])


def _holder(part: bool, cpu: bool):
    """How a checkpointed call holds its residuals: whole (None: the
    region's default, in host memory under ``cpu``), or as this rank's
    slice where ``part`` and a model-parallel size above 1."""
    mp = _config["mp"]
    if not part or mp is None:
        return None
    from ...models.remat import _HostSpan
    inner = _HostSpan if cpu else None

    def hold(v: torch.Tensor):
        d = _default_dim(v.dim())
        if v.dim() == 0 or not v.is_contiguous() or v.shape[d] % mp[1]:
            return v if inner is None else inner(v)
        return _MpSlice(v, mp, inner)
    return hold


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
    part = _config["partition_activations"] if partition_activations is \
        None else bool(partition_activations)
    hold = _holder(part, cpu)

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
                           offload=cpu, hold=hold)
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
    device is the host's; a slice's shape is the slice's)."""
    if isinstance(v, _MpSlice):
        t = v.span
        shape = t.shape if isinstance(v.part, torch.Tensor) else \
            v.part.size
    else:
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
                   configured=False, mp=None)


__all__ = ["configure", "is_configured", "checkpoint_wrapper", "checkpoint",
           "reset"]
