"""Activation recomputation: the port's counterpart of ``jax.checkpoint``
under the ``remat_policy`` policies of the JAX package
(``deepspeed_tpu/models/transformer.py`` ``_remat_policy``), and the
engine behind ``runtime/activation_checkpointing/checkpointing.py``.

A recomputed region is a *program*: a list of ``Op``s, each a function
of named values that returns named values, tagged with the kind of what
it computes (``"dot"``: a product with no batch dims; ``"dot_batch"``: a
product with batch dims; ``"flash"``: the flash forward, whose ``(o,
lse)`` the JAX package names ``flash_out``/``flash_lse``).
``run_program`` runs it plainly. ``Recompute.forward`` runs the same ops
with grad under saved-tensor hooks, so the backward pass is autograd's
graph of that very forward, node for node: the gradients are the plain
run's bit for bit. Only what is held between the passes differs:

- a saved tensor that is (a view of) a region input, or of a value the
  policy can save, is held;
- a weight (a tensor of the region's params) is held, or, inside the
  engine's ZeRO stage-3 ``regather_saved``, handed to its hooks and
  saved as a re-gather, never as the gathered tensor;
- every other saved tensor is dropped. The first time the backward pass
  unpacks one, the ops that produced the dropped tensors run again from
  the held values (with grad, so each saves what it saved the first
  time), and each dropped tensor is taken from that run: by its value's
  name and its view geometry, or by its op and its place in the order
  that op saved tensors in. Each is freed when its last unpacking is
  done.

Which ops run again follows JAX's partial evaluation: an op runs again
when the backward needs a tensor it saved, or a value it produced, that
was dropped; each of its inputs is held if the policy can save it, else
its producer runs again in turn. For the GPT-2 block
(``models/transformer.block_program``) the policies hold:

- ``full``: the block's input only (JAX ``nothing_saveable``). The
  backward reruns both LayerNorms (K3f), the QKV, proj and FC products,
  the attention (K1 on the flash route), the dropout masks and the GELU
  (K4f); the FC-out product is not needed (its output feeds only the
  residual add) and does not run again, as XLA would drop it too.
- ``dots``: the input and the outputs of the products (JAX
  ``checkpoint_dots``): on the flash route the QKV, proj and FC products
  (the FC-out product is never needed), on the dense route also QKᵀ and
  PV. The LayerNorms, the attention (K1), the masks and the GELU run
  again.
- ``attn``: the input and the products without batch dims (JAX
  ``dots_with_no_batch_dims_saveable``): on the flash route the same as
  ``dots``; on the dense route QKᵀ and PV are recomputed.
- ``dots_flash``: ``dots`` plus the flash forward's saved tensors and
  output (``o``, ``lse``, the int32 seed): K1 does not run again.

Random draws: an op that draws records its generator's state (a host
copy: no sync with the card) before it runs, and runs again from a
generator set to that state, so the recompute draws the forward's masks
and seeds whatever was drawn since.

Not supported: a double backward through a recomputed region (the
recomputed tensors are detached).
"""
from __future__ import annotations

import collections
import contextlib
from typing import (Any, Callable, Dict, FrozenSet, Iterator, List,
                    NamedTuple, Optional, Sequence, Tuple)

import torch

from ..runtime.zero.stage3 import active_regather


class Op(NamedTuple):
    """One step of a program: ``fn(params, generator, *inputs)`` returns
    the tuple of ``outputs``. ``generator`` is the region's generator
    when ``draws`` (None otherwise)."""
    name: str
    inputs: Tuple[str, ...]
    outputs: Tuple[str, ...]
    fn: Callable
    kind: Optional[str] = None
    draws: bool = False


# The kinds of values each policy can save (the region's inputs always).
SAVEABLE: Dict[str, FrozenSet[str]] = {
    "full": frozenset(),
    "dots": frozenset({"dot", "dot_batch"}),
    "dots_flash": frozenset({"dot", "dot_batch", "flash"}),
    "attn": frozenset({"dot"}),
}


def remat_policy(name: str) -> Optional[FrozenSet[str]]:
    """The saveable kinds of policy ``name``; None for ``"none"`` (no
    recomputation). An unknown name raises ``ValueError``, as in JAX."""
    if name == "none":
        return None
    kinds = SAVEABLE.get(name)
    if kinds is None:
        raise ValueError(f"unknown remat policy '{name}'")
    return kinds


def run_program(program: Sequence[Op], params: Dict[str, Any],
                inputs: Dict[str, Any], generator: Any = None
                ) -> Dict[str, Any]:
    """Run ``program`` plainly; returns every value by name."""
    env = dict(inputs)
    for op in program:
        outs = op.fn(params, generator if op.draws else None,
                     *[env[n] for n in op.inputs])
        env.update(zip(op.outputs, outs))
    return env


class GeneratorReplay:
    """Replays a ``torch.Generator``'s draws: ``snapshot()`` before an op
    draws, ``replay(state)`` a generator set to that state."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def live(self) -> torch.Generator:
        return self.generator

    def snapshot(self) -> torch.Tensor:
        return self.generator.get_state()

    @contextlib.contextmanager
    def replay(self, state: torch.Tensor) -> Iterator[torch.Generator]:
        g = torch.Generator(device=self.generator.device)
        g.set_state(state)
        yield g


def _storage(t: torch.Tensor) -> Optional[int]:
    """The address of ``t``'s storage (None for an empty or non-strided
    tensor, which is held as it is)."""
    if t.layout != torch.strided or t.numel() == 0:
        return None
    return t.data_ptr() - t.storage_offset() * t.element_size()


class _Slot:
    """A dropped (or host-held) saved tensor: its region and its key."""
    __slots__ = ("region", "key")

    def __init__(self, region: "Recompute", key: tuple):
        self.region, self.key = region, key


class _Outer:
    """A weight handed to the enclosing ``regather_saved``."""
    __slots__ = ("packed", "unpack")

    def __init__(self, packed: Any, unpack: Callable):
        self.packed, self.unpack = packed, unpack


def _unpack(p: Any) -> Any:
    if isinstance(p, _Slot):
        return p.region._take(p.key)
    if isinstance(p, _Outer):
        return p.unpack(p.packed)
    return p


class _Values:
    """Named values by storage: a saved tensor that shares a value's
    storage (and dtype) is that value, or a view of it."""

    def __init__(self):
        self.by_storage: Dict[int, str] = {}
        self.meta: Dict[str, Tuple[torch.dtype, int, tuple, tuple]] = {}

    def add(self, name: str, v: Any) -> None:
        if not isinstance(v, torch.Tensor):
            return
        ptr = _storage(v)
        if ptr is None:
            return
        if ptr not in self.by_storage:
            self.by_storage[ptr] = name
        if name not in self.meta:
            self.meta[name] = (v.dtype, v.storage_offset(), v.size(),
                               v.stride())

    def find(self, t: torch.Tensor, ptr: int) -> Optional[str]:
        name = self.by_storage.get(ptr)
        if name is None or self.meta[name][0] != t.dtype:
            return None
        return name


class Recompute:
    """One recomputed region: ``forward`` runs ``program`` and returns
    every value by name; the backward pass re-runs what it needs (see
    the module docstring). ``kinds``: the policy's saveable kinds.
    ``rng``: a replay (``GeneratorReplay``) for the ops that draw, or
    None. ``offload``: hold the saved inputs in host memory (pinned for
    CUDA tensors), copied back to the device when the backward pass
    needs them; or, given ``hold`` (a function of a tensor returning an
    object whose ``restore()`` gives it back), hold them through
    ``hold``."""

    def __init__(self, program: Sequence[Op], kinds: FrozenSet[str],
                 rng: Any = None, offload: bool = False,
                 hold: Optional[Callable[[torch.Tensor], Any]] = None):
        self.program = list(program)
        self.kinds = kinds
        self.rng = rng
        self.offload = offload or hold is not None
        self._hold = hold or _HostSpan
        self._ops = {op.name: op for op in self.program}
        self._producer = {n: op for op in self.program for n in op.outputs}

    # ------------------------------------------------------------------ #
    # forward
    # ------------------------------------------------------------------ #
    def _holds(self, name: str) -> bool:
        """Whether value ``name`` is held between the passes: a region
        input, or the output of an op whose kind the policy saves."""
        op = self._producer.get(name)
        return op is None or op.kind in self.kinds

    def forward(self, params: Dict[str, Any], inputs: Dict[str, Any]
                ) -> Dict[str, Any]:
        outer = active_regather()
        self._param_ptrs = {_storage(t) for t in params.values()
                            if isinstance(t, torch.Tensor)} - {None}
        self._params = {k: _Outer(outer[0](t), outer[1])
                        if outer is not None and isinstance(t, torch.Tensor)
                        else t for k, t in params.items()}
        self._values = _Values()
        self._counts: collections.Counter = collections.Counter()
        self._states: Dict[str, Any] = {}
        self._ready: Dict[tuple, torch.Tensor] = {}
        self._left: Dict[tuple, int] = {}
        env = dict(inputs)
        for n, v in inputs.items():
            self._values.add(n, v)
        self._op: Optional[Op] = None
        self._ord = 0
        with torch.autograd.graph.saved_tensors_hooks(self._pack, _unpack):
            for op in self.program:
                self._op, self._ord = op, 0
                g = None
                if op.draws and self.rng is not None:
                    self._states[op.name] = self.rng.snapshot()
                    g = self.rng.live()
                outs = op.fn(params, g, *[env[n] for n in op.inputs])
                for n, v in zip(op.outputs, outs):
                    env[n] = v
                    self._values.add(n, v)
        self._op = None
        self._plan(env, inputs)
        return env

    def _pack(self, t: torch.Tensor) -> Any:
        # A held tensor is packed detached: a node that saves its own
        # output would otherwise hold itself through the packed tensor's
        # grad_fn, a cycle that only its backward pass breaks.
        ptr = _storage(t)
        if ptr is None:
            return t.detach()
        if ptr in self._param_ptrs:
            outer = active_regather()
            return t.detach() if outer is None else \
                _Outer(outer[0](t), outer[1])
        name = self._values.find(t, ptr)
        if name is not None:
            if self._holds(name) and not self.offload:
                return t.detach()
            _, base, _, _ = self._values.meta[name]
            key = ("val", name, t.size(), t.stride(),
                   t.storage_offset() - base)
        else:
            key = ("op", self._op.name, self._ord)
            self._ord += 1
            if self._op.kind in self.kinds:
                return t.detach()
        self._counts[key] += 1
        return _Slot(self, key)

    def _plan(self, env: Dict[str, Any], inputs: Dict[str, Any]) -> None:
        """The ops to run again and the values to hold for them."""
        held = set(inputs)
        for key in self._counts:
            if key[0] == "val" and self._holds(key[1]):
                held.add(key[1])           # offloaded inputs
        todo = [self._producer[k[1]].name for k in self._counts
                if k[0] == "val" and k[1] not in held]
        todo += [k[1] for k in self._counts if k[0] == "op"]
        rerun = set()
        while todo:
            name = todo.pop()
            if name in rerun:
                continue
            rerun.add(name)
            for u in self._ops[name].inputs:
                if u in held:
                    continue
                if self._holds(u) or not isinstance(env[u], torch.Tensor):
                    held.add(u)
                else:
                    todo.append(self._producer[u].name)
        self._rerun = rerun
        self._held = {}
        for n in held:
            v = env[n]
            if isinstance(v, torch.Tensor):
                v = self._hold(v.detach()) if self.offload and n in inputs \
                    else v.detach()
            self._held[n] = v

    # ------------------------------------------------------------------ #
    # backward
    # ------------------------------------------------------------------ #
    def _take(self, key: tuple) -> torch.Tensor:
        if key not in self._ready:
            if key[0] == "val" and key[1] in self._held:
                self._put(key, _view(self._value(key[1]), key))
            else:
                self._recompute()
        t = self._ready[key]
        self._left[key] -= 1
        if self._left[key] == 0:
            del self._ready[key]
        return t

    def _put(self, key: tuple, t: torch.Tensor) -> None:
        self._ready[key] = t
        self._left[key] = self._counts[key]

    def _value(self, name: str) -> Any:
        """Held value ``name`` on its device (an offloaded input copied
        back from its host span)."""
        v = self._held[name]
        if not isinstance(v, torch.Tensor) and hasattr(v, "restore"):
            v = v.restore()
        return v

    def _recompute(self) -> None:
        params = {k: _unpack(h) for k, h in sorted(self._params.items())}
        params = {k: t.detach().requires_grad_(t.is_floating_point())
                  if isinstance(t, torch.Tensor) else t
                  for k, t in params.items()}
        param_ptrs = {_storage(t) for t in params.values()
                      if isinstance(t, torch.Tensor)}
        env: Dict[str, Any] = {}
        values = _Values()
        for n in self._held:
            v = self._value(n)
            if isinstance(v, torch.Tensor):
                v = v.detach().requires_grad_(v.is_floating_point())
            env[n] = v
            values.add(n, v)
        got: Dict[tuple, torch.Tensor] = {}
        cur: List[Any] = [None, 0]

        def pack(t: torch.Tensor) -> None:
            # (the re-run's own graph is never differentiated: it keeps
            # nothing)
            ptr = _storage(t)
            if ptr is None or ptr in param_ptrs or \
                    values.find(t, ptr) is not None:
                return None
            key = ("op", cur[0], cur[1])
            cur[1] += 1
            if key in self._counts:
                got[key] = t.detach()
            return None

        with torch.enable_grad(), \
                torch.autograd.graph.saved_tensors_hooks(pack, _unpack):
            for op in self.program:
                if op.name not in self._rerun:
                    continue
                cur[0], cur[1] = op.name, 0
                state = self._states.get(op.name)
                replay = self.rng.replay(state) if state is not None \
                    else contextlib.nullcontext(None)
                with replay as g:
                    outs = op.fn(params, g, *[env[n] for n in op.inputs])
                for n, v in zip(op.outputs, outs):
                    if n not in env:
                        env[n] = v
                        values.add(n, v)
        for key in self._counts:
            if key in self._ready or (key[0] == "val" and
                                      key[1] in self._held):
                continue
            if key[0] == "op":
                if key not in got:
                    raise RuntimeError(
                        f"the recompute of op {key[1]!r} saved fewer "
                        "tensors than its forward did: the region's ops "
                        "must be deterministic in what they save")
                self._put(key, got[key])
            else:
                v = env[key[1]]
                meta = self._values.meta[key[1]]
                if (v.dtype, v.size(), v.stride()) != meta[0:1] + meta[2:]:
                    raise RuntimeError(
                        f"the recomputed value {key[1]!r} has another "
                        "layout than its forward's")
                self._put(key, _view(v.detach(), key))


def _view(v: torch.Tensor, key: tuple) -> torch.Tensor:
    """The saved view ``key`` (size, stride, offset from the value's
    own) of value ``v``."""
    _, _, size, stride, rel = key
    return v.as_strided(size, stride, v.storage_offset() + rel)


class _HostSpan:
    """An offloaded value: the span of its storage that it covers, in
    host memory (pinned, copied without a host sync, for a CUDA tensor),
    and its geometry; ``restore()`` is the value on its device again."""
    __slots__ = ("span", "size", "stride", "device")

    def __init__(self, v: torch.Tensor):
        n = 1 + sum((d - 1) * st for d, st in zip(v.size(), v.stride()))
        flat = v.as_strided((n,), (1,), v.storage_offset())
        self.size, self.stride, self.device = v.size(), v.stride(), v.device
        if v.device.type == "cpu":
            self.span = flat.clone()
        else:
            self.span = torch.empty(n, dtype=v.dtype, pin_memory=True)
            self.span.copy_(flat, non_blocking=True)

    def restore(self) -> torch.Tensor:
        flat = self.span.to(self.device, non_blocking=True) \
            if self.device.type != "cpu" else self.span
        return flat.as_strided(self.size, self.stride, 0)


__all__ = ["Op", "SAVEABLE", "remat_policy", "run_program",
           "GeneratorReplay", "Recompute"]
