"""ZeRO stage 3: parameters partitioned over dp, gathered just in time
(port of ``deepspeed_tpu/runtime/zero/stage3.py``: its explicit gather,
``Zero3Scan`` and ``zero3_block_scan``).

Layouts. Each rank holds only its part of the fp32 masters (bf16
master-free):

- by default, its rows of the fused optimizer's V-interleaved layout
  (``ops/fused_update.ShardGroup``): a leaf's part is one range of its
  padded flattened values, a ``[V/dp, r]`` block (``RowPart``); at a
  dp that does not divide V, its range of each group's flat buffer
  (``FlatPart``), gathered a group at a time;
- with a bound ``Zero3Scan``, the per-layer form of that layout: each
  stacked ``[L, ...]`` leaf the scan covers enters the group as its L
  layer slices, each padded to V and laid ``[V, r]`` like a leaf of its
  own, so the rank's part of a covered leaf is ``[L, V/dp, r]`` and its
  part of layer l, ``[l]``, is 1/dp of that layer. Layer l's gather is
  then an equal-size all-gather of every covered leaf's ``[V/dp, r]``
  block of that layer. Param, grad and both moments stay element-aligned
  (the same rows), so K5 and K6 run over them unchanged; an element's
  stochastic-rounding index is its place in this layout (ROADMAP §3);
- under ZeRO-Offload, the card's compute-dtype copy of the host
  partition: each leaf split along its first dim that dp divides (JAX's
  ``stage3_param_specs`` rule, ``partition.stage3_dims``; past the layer
  axis for a covered leaf), or whole where none does (``DimPart``).

The generic gather, for every leaf the scan does not cover
(``gather_cast``, ``gather_parts``): each micro-step rebuilds the leaf

- forward: cast the rank's part to the compute dtype, then
  ``all_gather`` (the wire moves compute-dtype bytes) and cut the
  padded leaf back to its shape;
- backward: widen the cotangent to fp32 BEFORE the ``reduce_scatter``
  (sum), so the owner receives its part of the fp32-reduced gradient —
  the same widen-then-scatter the stage-2 path runs on its packed
  buffer, which is what makes one stage-3 step bit-identical to the
  stage-2 step from the same state. A whole leaf is all-reduced.

``regather_saved`` is the port's counterpart of the JAX engine's
``jax.checkpoint(gather_params)``: under it, autograd saves a gathered
weight (or any view of it) as its leaf id and its view geometry, and
unpacks it by a fresh gather in the backward pass, so stage 3 never
holds the gathered tree from forward to backward. Per step each
parameter crosses the wire three times: forward gather, backward
re-gather, gradient reduce-scatter.

``zero3_block_scan`` is the layer loop of a stacked-layer model under a
bound ``Zero3Scan`` (``models/transformer.apply_blocks``). Forward: the
gather of layer i+depth is started (``async_op``) before layer i runs,
and each layer's gathered leaves are dropped after its use. Each layer
runs as a ``models/remat.Recompute`` region under the ``full`` policy
(it holds its input only; the dropout draws are replayed), inside a
``regather_saved`` whose re-gather is the backward's window. Backward
(autograd walks the layers in reverse): the first unpack of layer i
re-gathers it once, after starting the gather of layer i-depth and
dropping the layers already walked; the region re-runs its forward, and
the layer's grads are widened to fp32 and reduce-scattered to the
owners in one collective as soon as they are complete. A gathered
weight is never saved, so the live gathered set is ``prefetch_depth +
1`` layers (``gather_working_set_bytes``). A prefetch moves values,
never arithmetic: every depth gives the same bits.
"""
from __future__ import annotations

import contextlib
import functools
import math
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ...ops.fused_update import tree_flatten
from ...parallel import comm
from .partition import covered_leaves, stage3_dims

__all__ = ["gather_cast", "gather_parts", "regather_saved",
           "active_regather", "RowPart", "DimPart", "FlatPart", "Zero3Scan",
           "zero3_block_scan", "gather_working_set_bytes"]


# --------------------------------------------------------------------- #
# Parts: how a rank's part of a leaf travels
# --------------------------------------------------------------------- #
class RowPart:
    """A rank's ``[V/dp, r]`` rows of a leaf of ``shape`` padded to
    ``V * r`` (the V-layout): the ranks' rows in rank order are the
    padded flat leaf."""
    whole = False

    def __init__(self, shape: Tuple[int, ...]):
        self.shape = tuple(shape)
        self.n = math.prod(self.shape)

    def put(self, part: torch.Tensor, dst: torch.Tensor) -> None:
        dst.view(part.shape).copy_(part)

    def leaf(self, rows: torch.Tensor) -> torch.Tensor:
        """``[world, k]``: every rank's part → the leaf."""
        return rows.reshape(-1)[:self.n].view(self.shape)

    def rows(self, g: torch.Tensor, world: int, k: int) -> torch.Tensor:
        """The leaf's fp32 grad as ``[world, k]``: rank d's part at d."""
        flat = g.reshape(-1).float()
        if world * k != self.n:
            flat = torch.nn.functional.pad(flat, (0, world * k - self.n))
        return flat.view(world, k)

    def part(self, flat: torch.Tensor, shape: Tuple[int, ...]
             ) -> torch.Tensor:
        return flat.view(shape)


class FlatPart:
    """A ranged group's part (``ShardGroup.ranged``: dp does not divide
    V): its range of the group's flat ``[n]`` buffer, the ranks' ranges
    equal and in rank order; ``whole`` when the group is replicated
    (gathered by a cast, its grad all-reduced)."""

    def __init__(self, n: int, whole: bool):
        self.shape = (int(n),)
        self.n = int(n)
        self.whole = bool(whole)

    def put(self, part: torch.Tensor, dst: torch.Tensor) -> None:
        dst.copy_(part.reshape(-1))

    def leaf(self, rows: torch.Tensor) -> torch.Tensor:
        return rows.reshape(-1)

    def rows(self, g: torch.Tensor, world: int, k: int) -> torch.Tensor:
        return g.reshape(-1).float().view(world, k)

    def part(self, flat: torch.Tensor, shape: Tuple[int, ...]
             ) -> torch.Tensor:
        return flat.view(shape)


class DimPart:
    """A rank's slice of a leaf of ``shape`` along ``dim`` (its
    ``shape[dim] / dp`` consecutive entries, rank order), or the whole
    leaf on every rank (``dim`` None: gathered by a cast, its grad
    all-reduced)."""

    def __init__(self, shape: Tuple[int, ...], dim: Optional[int]):
        self.shape = tuple(shape)
        self.dim = dim
        self.whole = dim is None

    def put(self, part: torch.Tensor, dst: torch.Tensor) -> None:
        moved = part.movedim(self.dim, 0)
        dst.view(moved.shape).copy_(moved)

    def leaf(self, rows: torch.Tensor) -> torch.Tensor:
        d = self.dim
        rest = self.shape[:d] + self.shape[d + 1:]
        out = rows.reshape((self.shape[d],) + rest)
        return out if d == 0 else out.movedim(0, d).contiguous()

    def rows(self, g: torch.Tensor, world: int, k: int) -> torch.Tensor:
        return g.float().movedim(self.dim, 0).reshape(world, k)

    def part(self, flat: torch.Tensor, shape: Tuple[int, ...]
             ) -> torch.Tensor:
        d = self.dim
        moved = (shape[d],) + tuple(shape[:d]) + tuple(shape[d + 1:])
        return flat.view(moved).movedim(0, d)


class _Gathering:
    """One all-gather of several parts in ``dtype`` (a whole part is
    cast, not gathered), started at construction; ``wait()`` gives the
    leaves. Holds nothing of the parts once started."""

    def __init__(self, parts: List[torch.Tensor], codecs: List[Any],
                 dtype: torch.dtype, group=None):
        self.codecs, self.group = codecs, group
        self.whole = [p.detach().to(dtype).clone() if c.whole else None
                      for p, c in zip(parts, codecs)]
        self.sizes = [0 if c.whole else p.numel()
                      for p, c in zip(parts, codecs)]
        K = sum(self.sizes)
        self.work = self.out = self.send = None
        if K:
            dev = parts[0].device
            self.send = torch.empty(K, dtype=dtype, device=dev)
            off = 0
            for p, c, k in zip(parts, codecs, self.sizes):
                if k:
                    c.put(p.detach(), self.send[off:off + k])
                    off += k
            self.out = torch.empty(comm.get_world_size(group) * K,
                                   dtype=dtype, device=dev)
            self.work = comm.all_gather_start(self.send, self.out,
                                              group=group)

    def wait(self) -> List[torch.Tensor]:
        if self.work is not None:
            self.work.wait()
            self.work = None
        leaves: List[torch.Tensor] = []
        rows = None if self.out is None else \
            self.out.view(comm.get_world_size(self.group), -1)
        one = sum(1 for k in self.sizes if k) == 1
        off = 0
        for c, k, w in zip(self.codecs, self.sizes, self.whole):
            if w is not None:
                leaves.append(w)
                continue
            leaves.append(c.leaf(rows if one else rows[:, off:off + k]))
            off += k
        self.send = self.out = None
        self.whole = []
        return leaves


def _scatter_grads(grads: Tuple[Optional[torch.Tensor], ...],
                   codecs: List[Any], shapes: List[Tuple[int, ...]],
                   device: torch.device, group=None) -> List[torch.Tensor]:
    """The parts' grads of the leaves' grads (None: zero): each widened
    to fp32, one reduce-scatter for the split leaves, an all-reduce for
    each whole one (over ``group``, the dp ranks)."""
    world = comm.get_world_size(group)
    out: List[Any] = [None] * len(codecs)
    blocks, order = [], []
    for i, (g, c, shape) in enumerate(zip(grads, codecs, shapes)):
        if g is None:
            g = torch.zeros(c.shape, dtype=torch.float32, device=device)
        if c.whole:
            out[i] = comm.all_reduce(g.float().clone(), group=group)
            continue
        k = math.prod(shape)
        blocks.append(c.rows(g, world, k))
        order.append((i, k))
    if blocks:
        full = torch.cat(blocks, dim=1) if len(blocks) > 1 \
            else blocks[0].contiguous()
        red = comm.reduce_scatter(full.view(-1), group=group)
        off = 0
        for i, k in order:
            out[i] = codecs[i].part(red[off:off + k], shapes[i])
            off += k
    return out


class _Gathered(torch.autograd.Function):
    """The leaves of a started ``_Gathering`` as a function of the parts
    it gathers: the backward reduce-scatters their fp32 grads to the
    parts, in the parts' dtype (as JAX's transpose casts to the
    shard's)."""

    @staticmethod
    def forward(ctx, gathering, *parts):
        ctx.codecs, ctx.group = gathering.codecs, gathering.group
        ctx.parts = [(tuple(p.shape), p.dtype) for p in parts]
        ctx.device = parts[0].device
        return tuple(gathering.wait())

    @staticmethod
    def backward(ctx, *grads):
        out = _scatter_grads(grads, ctx.codecs, [s for s, _ in ctx.parts],
                             ctx.device, ctx.group)
        return (None,) + tuple(g.to(dt) for g, (_, dt) in
                               zip(out, ctx.parts))


def gather_parts(parts: List[torch.Tensor], codecs: List[Any],
                 dtype: torch.dtype, group=None) -> List[torch.Tensor]:
    """The leaves, in ``dtype``, of every rank's ``parts`` (``codecs``
    say how each is laid), in one collective over ``group`` (the dp
    ranks; None: the default group); their gradient with respect to the
    parts is the fp32 reduce-scatter of the leaves'."""
    return list(_Gathered.apply(_Gathering(parts, codecs, dtype, group),
                                *parts))


def gather_cast(x: torch.Tensor, shape: Tuple[int, ...],
                dtype: torch.dtype) -> torch.Tensor:
    """The leaf of ``shape`` in ``dtype`` from every rank's
    ``[V/dp, r]`` part ``x`` (``RowPart``); its gradient with respect to
    ``x`` is the fp32 reduce-scatter of the leaf's gradient."""
    return gather_parts([x], [RowPart(shape)], dtype)[0]


def _gather(x: torch.Tensor, shape: Tuple[int, ...],
            dtype: torch.dtype) -> torch.Tensor:
    """``gather_cast`` without autograd (a re-gather): the leaf views the
    gathered buffer at storage offset 0."""
    return _Gathering([x], [RowPart(shape)], dtype).wait()[0]


# --------------------------------------------------------------------- #
# Saved weights as re-gathers
# --------------------------------------------------------------------- #
@contextlib.contextmanager
def regather_saved(gathered: Dict[Any, Tuple[Callable[[], torch.Tensor],
                                             torch.Tensor]]):
    """Save gathered weights as a re-gather, not as tensors.

    ``gathered`` maps a leaf id to ``(regather, leaf)``: ``leaf`` the
    tensor ``gather_cast`` returned, ``regather()`` a fresh gather of
    the same values (no autograd). A tensor autograd saves that shares
    a gathered leaf's storage is packed as ``(leaf id, size, stride,
    offset)`` and unpacked as the same view of ``regather()``; other
    tensors are saved as they are."""
    by_storage = {leaf.untyped_storage().data_ptr(): (lid, fn, leaf)
                  for lid, (fn, leaf) in gathered.items()}

    def pack(t: torch.Tensor):
        try:
            key = t.untyped_storage().data_ptr()
        except RuntimeError:
            return t
        hit = by_storage.get(key)
        if hit is None or t.dtype != hit[2].dtype:
            return t
        lid, fn, _ = hit
        return ("zero3", lid, fn, tuple(t.size()), tuple(t.stride()),
                t.storage_offset())

    def unpack(p):
        if not (isinstance(p, tuple) and p and p[0] == "zero3"):
            return p
        _, _, fn, size, stride, offset = p
        leaf = fn()
        base = leaf.view(-1)
        # The leaf views its gathered buffer at storage offset 0.
        return base.as_strided(size, stride, offset)

    _ACTIVE.hooks.append((pack, unpack))
    try:
        with torch.autograd.graph.saved_tensors_hooks(pack, unpack):
            yield
    finally:
        _ACTIVE.hooks.pop()
        # Autograd keeps a saved tensor's pack hook with it until the
        # backward pass: the closure must not hold the gathered leaves.
        by_storage.clear()


class _Active(threading.local):
    def __init__(self):
        self.hooks: List[Tuple[Callable, Callable]] = []


_ACTIVE = _Active()


def active_regather() -> Optional[Tuple[Callable, Callable]]:
    """The ``(pack, unpack)`` of the innermost ``regather_saved`` open on
    this thread, or None. Saved-tensor hooks do not chain (the innermost
    pack wins), so a recompute region opened inside one
    (``models/remat.py``) hands its weights to these: a gathered weight
    is saved as a re-gather there too."""
    return _ACTIVE.hooks[-1] if _ACTIVE.hooks else None


# --------------------------------------------------------------------- #
# The engine <-> model contract for the per-layer prefetched scan
# --------------------------------------------------------------------- #
class Zero3Scan:
    """Binds the model's stacked-layer loop to the engine's stage-3
    layout. Build one, hand it to BOTH the model's loss
    (``gpt2_loss_fn(cfg, zero3=spec)``) and the engine
    (``deepspeed_tpu_torch.initialize(..., zero3_scan=spec)``); a
    stage-3 engine at dp > 1 binds it at construction (the compute
    dtype, the prefetch depth, each covered leaf's layer part), and the
    model reads it at each forward. Unbound (any other engine), the
    model runs its normal layer loop.

    ``scope``: the key of the param-tree subtree the model gathers
    ITSELF per layer (default ``"blocks"``, the transformer's stacked
    subtree), matched as a whole key segment: a leaf named
    ``blocks_ln_scale`` is not covered. The engine's generic gather
    skips covered leaves. ``prefetch_depth``: layers gathered ahead of
    use (None: the engine's ``zero_optimization.prefetch_depth``); the
    engine clamps it to L - 1 and adopts the effective depth.
    ``layer_info`` maps each covered leaf's name to its layer part
    (``RowPart`` of the layer's slice shape, or ``DimPart`` under
    offload)."""

    def __init__(self, prefetch_depth: Optional[int] = None,
                 scope: str = "blocks"):
        self.prefetch_depth = prefetch_depth   # None -> engine config
        self.scope = scope
        self.mode = "unbound"                  # explicit | unbound
        self.compute_dtype: Optional[torch.dtype] = None
        self.layer_info: Dict[str, Any] = {}

    def covers(self, path_str: str) -> bool:
        # Exact key-segment match, not substring: a leaf named
        # "blocks_ln_scale" must NOT join the scan scope (a covered-but-
        # unscanned leaf would skip the engine's gather AND the model's
        # per-layer scatter — its grads would never reduce across dp).
        return f"['{self.scope}']" in path_str

    def bind(self, *, compute_dtype: torch.dtype, prefetch_depth: int,
             layer_info: Dict[str, Any], mode: str = "explicit") -> None:
        if mode != "explicit":
            raise ValueError(f"the port's scan lowers its gathers "
                             f"explicitly, got mode {mode!r}")
        self.mode = mode
        self.compute_dtype = compute_dtype
        if self.prefetch_depth is None:
            self.prefetch_depth = int(prefetch_depth)
        self.layer_info = dict(layer_info)

    @property
    def bound(self) -> bool:
        return self.mode == "explicit"

    def gather_layer(self, p_layer: Dict[str, Any]) -> Dict[str, Any]:
        """One layer's param dict (each covered leaf's part of the layer)
        gathered to whole leaves in the compute dtype, in one collective;
        the backward reduce-scatters their fp32 grads to the parts."""
        names = sorted(n for n, t in p_layer.items()
                       if isinstance(t, torch.Tensor) and
                       t.is_floating_point())
        out = dict(p_layer)
        out.update(zip(names, gather_parts(
            [p_layer[n] for n in names], [self.layer_info[n] for n in names],
            self.compute_dtype)))
        return out


class _Window:
    """Layer gathers in a walk order (``order``), started ``depth``
    layers ahead of use. The forward ``take``s each layer's gathering
    once; the backward's ``leaf`` gathers a layer once, at its first
    unpack, and drops the layers the walk has passed."""

    def __init__(self, start: Callable[[int], _Gathering], order,
                 depth: int):
        self.start = start
        self.order = list(order)
        self.pos = {layer: k for k, layer in enumerate(self.order)}
        self.depth = depth
        self.flight: Dict[int, _Gathering] = {}
        self.next = 0
        self.held: Dict[int, List[torch.Tensor]] = {}

    def _advance(self, i: int) -> None:
        last = min(self.pos[i] + self.depth, len(self.order) - 1)
        while self.next <= last:
            layer = self.order[self.next]
            self.flight[layer] = self.start(layer)
            self.next += 1

    def take(self, i: int) -> _Gathering:
        self._advance(i)
        return self.flight.pop(i)

    def leaf(self, i: int, k: int) -> torch.Tensor:
        if i not in self.held:
            here = self.pos[i]
            for layer in [x for x in self.held if self.pos[x] < here]:
                del self.held[layer]
            self._advance(i)
            g = self.flight.pop(i, None)
            # (a layer asked for again after the walk passed it: every
            # rank walks alike, so its gather pairs up)
            self.held[i] = (g if g is not None else self.start(i)).wait()
        return self.held[i][k]


def zero3_block_scan(program: List[Any], stacked: Dict[str, torch.Tensor],
                     x: torch.Tensor, spec: Zero3Scan,
                     rng: Optional[torch.Generator] = None
                     ) -> torch.Tensor:
    """Run L stacked layers with per-layer gathers (module docstring).

    ``program``: one block as ``models/remat.Op``s (``models/
    transformer.block_program``), from ``{"x": h}`` to ``"y"``.
    ``stacked``: each covered leaf's part, ``[L, ...]`` (the layer part
    at ``[l]``, as ``spec.layer_info`` lays it). ``rng``: the dropout
    generator (its draws are replayed in the backward)."""
    if not spec.bound:
        raise ValueError(
            "zero3_block_scan needs a bound Zero3Scan (a stage-3 engine "
            "at dp > 1 binds it at construction: build the engine before "
            "the first forward)")
    from ...models.remat import SAVEABLE, GeneratorReplay, Recompute
    names = sorted(stacked)
    missing = [n for n in names if n not in spec.layer_info]
    if missing:
        raise ValueError(f"the bound Zero3Scan has no layer part for "
                         f"{missing}: the engine's covered leaves and the "
                         "model's stacked subtree differ")
    L = int(stacked[names[0]].shape[0])
    depth = max(0, min(int(spec.prefetch_depth or 0), L - 1))
    codecs = [spec.layer_info[n] for n in names]
    dtype = spec.compute_dtype
    parts = [stacked[n].unbind(0) for n in names]
    local = [stacked[n].detach().unbind(0) for n in names]

    def start(i: int) -> _Gathering:
        return _Gathering([ps[i] for ps in local], codecs, dtype)
    fwd = _Window(start, range(L), depth)
    bwd = _Window(start, range(L - 1, -1, -1), depth)
    replay = GeneratorReplay(rng) if rng is not None else None
    for i in range(L):
        leaves = _Gathered.apply(fwd.take(i), *[ps[i] for ps in parts])
        saved = {(i, k): (functools.partial(bwd.leaf, i, k), leaf)
                 for k, leaf in enumerate(leaves)}
        with regather_saved(saved):
            x = Recompute(program, SAVEABLE["full"], replay).forward(
                dict(zip(names, leaves)), {"x": x})["y"]
        del leaves, saved
    return x


# --------------------------------------------------------------------- #
# Analytic memory: the bounded gather working set
# --------------------------------------------------------------------- #
def gather_working_set_bytes(params: Any, dp: int, compute_itemsize: int,
                             prefetch_depth: int = 0,
                             scan_paths: Optional[Callable[[str], bool]]
                             = None) -> int:
    """Per-rank bytes of gathered (compute-dtype) parameters live at once
    under stage 3, counted as the JAX function counts them: the leaves
    its stage-3 rule splits over dp (``partition.stage3_dims``; a leaf
    no dim of which dp divides is not counted), the ones the model
    gathers per layer (``scan_paths``) ``prefetch_depth + 1`` layer
    slices each, every other one whole. This is the term the engine
    adds to the analytic state footprint."""
    leaves = tree_flatten(params)[0]
    shapes = [tuple(getattr(t, "shape", ())) for t in leaves]
    covered = covered_leaves(params, scan_paths)
    scanned = generic = 0
    for shape, cov, dim in zip(shapes, covered,
                               stage3_dims(shapes, dp, covered)):
        if dim is None:
            continue
        n = int(compute_itemsize) * math.prod(shape)
        if cov:
            scanned += n // max(1, int(shape[0]))
        else:
            generic += n
    return generic + (int(prefetch_depth) + 1) * scanned
