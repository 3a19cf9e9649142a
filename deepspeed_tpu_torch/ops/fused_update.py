"""The fused one-pass Adam step over flat parameter groups.

Port of ``deepspeed_tpu/ops/fused_update.py``. Two kernels, CUDA C++ in
``csrc/fused_update.cu`` (the note at its top gives their bound and
design):

- ``sqnorm`` (K5, replaces ``_sqnorm_kernel``): per-block sum-of-squares
  partials of a flat fp32 grad buffer, summed with one ``torch.sum``.
  It gives the global norm and, through ``isfinite(norm)``, the fp16
  overflow vote.
- ``fused_adam_apply`` (K6, replaces ``_fused_adam_kernel``): one pass
  over g, p, m, v — unscale × clip coefficient, coupled or decoupled
  weight decay, Adam with bias correction, fp32 moments, the overflow
  skip as a select, the compute-dtype cast copy, and in-kernel bf16
  stochastic rounding — in place on p, m, v.

Each wrapper launches its kernel for CUDA tensors, runs its plain
PyTorch version (``sqnorm_plain``, ``fused_adam_plain``: the same
arithmetic) for CPU tensors, and counts its launches in ``.launches``.

Their front end, ``ops/optimizers.FusedAdam`` (``fused_adam``/
``fused_step`` of the JAX module), computes the scalar carry (bias
correction in optax's association order) and shares the one-pass
region — norm → overflow vote → clip coefficient → skip select — with
every optimizer of the port (``ops/optimizers.FlatOptimizer``). All of
it stays on the device: a step costs no host sync.

Layouts. Groups follow ``_float_groups``: leaves grouped by dtype,
groups sorted by dtype name, leaves in the order ``tree_flatten`` gives
(dict keys sorted, as in JAX).

- On one card (and at ZeRO stage 0) the port keeps one contiguous flat
  buffer per dtype group (``FlatGroup``), with each parameter a view
  into it, so no step copies parameters into or out of the buffer.
  ``models/convert.py`` carries moments between this layout and JAX's.
- Across dp ranks at ZeRO stage 1-3 the optimizer works in the JAX
  module's V-interleaved layout (``virtual_shards``, ``_group_row_len``,
  ``_flatten_group``, ``_unflatten_group``): each leaf padded to a
  multiple of V = 8 and reshaped ``[V, r_leaf]``, the leaves side by
  side in a ``[V, Lpad]`` buffer. Rank d of dp (dp dividing V) owns rows
  ``[d*V/dp, (d+1)*V/dp)``, a contiguous 1/dp of the buffer, and in a
  leaf's own flattened order its part of that leaf is also one range,
  ``[d*(V/dp)*r_leaf, (d+1)*(V/dp)*r_leaf)`` of the padded leaf. A
  ``ShardGroup`` holds a rank's rows; ``FusedAdam.step`` runs K5 and K6
  on them (the shard-local mode): the sum of squares is all-reduced
  over the ranks, and K6's stochastic-rounding index starts at the
  rank's first element in the V-layout, so every element draws the
  noise the JAX kernel draws for it. Where dp does not divide V (dp 3,
  5, 6, 7) a rank holds a range of the flat buffer instead: the d-th of
  dp equal parts, or the whole buffer where dp does not divide its
  length (JAX's placement of it, ``runtime/zero/partition.RowPlan``);
  K5 and K6 run over the range the same way (``ranged``,
  ``replicated``).
- A stage-3 engine with a bound ``Zero3Scan`` holds its groups in the
  per-layer form of that layout (``ShardGroup(..., layers=)``): each
  stacked ``[L, ...]`` leaf the scan covers enters as its L layer
  slices, each padded to V and laid ``[V, r]`` like a leaf of its own,
  the covered leaves' slices of one layer side by side in a block of
  ``R`` columns and the L blocks one after another, ahead of the other
  leaves. A rank's rows then hold ``1/dp`` of every layer, so one
  layer's gather is an equal-size all-gather of a ``[V/dp, R]`` block.
  K5 and K6 run over the rows as they do over any group; an element's
  stochastic-rounding index is its place in this layout, not in the
  JAX one (ROADMAP §3). Checkpoints carry the moments in the JAX layout
  (``to_jax_rows``, ``local_rows_from_jax``).
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import op_builder
from . import costs

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_U32 = 0xFFFFFFFF

# The JAX module's V-layout constants (deepspeed_tpu/ops/fused_update.py:
# _V virtual shards, rows padded to whole (8, _W) fp32 tiles).
_V = 8
_W = 1024
_ROW_QUANTUM = 8 * _W


# --------------------------------------------------------------------- #
# Trees and flat groups
# --------------------------------------------------------------------- #
def tree_flatten(tree: Any) -> Tuple[List[Any], Any]:
    """Leaves of a nested dict/list/tuple tree in JAX's order (dict keys
    sorted) and a spec to rebuild it."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        leaves, specs = [], []
        for k in keys:
            lv, sp = tree_flatten(tree[k])
            leaves += lv
            specs.append(sp)
        return leaves, ("dict", keys, specs)
    if isinstance(tree, (list, tuple)):
        leaves, specs = [], []
        for t in tree:
            lv, sp = tree_flatten(t)
            leaves += lv
            specs.append(sp)
        return leaves, (type(tree).__name__, None, specs)
    return [tree], None


def tree_unflatten(spec: Any, leaves: List[Any]) -> Any:
    it = iter(leaves)

    def build(sp):
        if sp is None:
            return next(it)
        kind, keys, subs = sp
        if kind == "dict":
            return {k: build(s) for k, s in zip(keys, subs)}
        out = [build(s) for s in subs]
        return tuple(out) if kind == "tuple" else out
    return build(spec)


def _int32(x: int) -> int:
    x &= _U32
    return x - (1 << 32) if x >= 1 << 31 else x


def dtype_name(dt: torch.dtype) -> str:
    return str(dt).replace("torch.", "")


def float_groups(leaves: List[Any]) -> List[Tuple[torch.dtype, List[int]]]:
    """``[(dtype, [leaf index])]`` of the floating leaves, sorted by dtype
    name (the JAX ``_float_groups``)."""
    groups: Dict[torch.dtype, List[int]] = {}
    for i, leaf in enumerate(leaves):
        if isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
            groups.setdefault(leaf.dtype, []).append(i)
    return sorted(groups.items(), key=lambda kv: dtype_name(kv[0]))


class FlatGroup:
    """One dtype group of parameters as one contiguous flat buffer.

    ``param`` holds the parameters (``views()`` gives each leaf as a view
    into it), ``grad`` the fp32 gradients (same offsets; None when
    ``grad=False``: the ZeRO-2 engine keeps only its reduce-scattered
    rows, in a ShardGroup), and ``cast``,
    when the engine keeps one, the compute-dtype copy of the parameters
    that the fused step rewrites in the same pass. ``base`` is K6's
    stochastic-rounding index of the first element (the group is
    whole)."""

    base = 0

    def __init__(self, leaves: List[torch.Tensor], dtype: torch.dtype,
                 device: torch.device, cast_dtype: Optional[torch.dtype],
                 grad: bool = True):
        self.dtype = dtype
        self.shapes = [tuple(t.shape) for t in leaves]
        self.sizes = [t.numel() for t in leaves]
        self.offsets = [sum(self.sizes[:i]) for i in range(len(leaves))]
        self.numel = sum(self.sizes)
        self.param = torch.empty(self.numel, dtype=dtype, device=device)
        with torch.no_grad():
            for t, v in zip(leaves, self.views(self.param)):
                v.copy_(t.detach())
        self.grad = torch.zeros(self.numel, dtype=torch.float32,
                                device=device) if grad else None
        self.cast = None
        if cast_dtype is not None and cast_dtype != dtype:
            self.cast = self.param.to(cast_dtype)

    def views(self, buf: torch.Tensor) -> List[torch.Tensor]:
        return [buf.narrow(0, o, n).view(s)
                for o, n, s in zip(self.offsets, self.sizes, self.shapes)]


# --------------------------------------------------------------------- #
# The V-interleaved layout (ZeRO shard-local)
# --------------------------------------------------------------------- #
def virtual_shards(dp: int = 1) -> int:
    return max(_V, int(dp))


def _leaf_rows(n: int, shards: int) -> int:
    """Per-virtual-shard row length of a leaf (leaf padded to V | n)."""
    return -(-int(n) // shards)


def _group_row_len(sizes: List[int], shards: int) -> int:
    """Padded row length Lpad of a group buffer: the sum of the leaves'
    rows, padded to a multiple of 8 * 1024."""
    L = sum(_leaf_rows(n, shards) for n in sizes)
    return max(_ROW_QUANTUM, -(-L // _ROW_QUANTUM) * _ROW_QUANTUM)


def group_nbytes(sizes: List[int], shards: int = _V,
                 itemsize: int = 4) -> int:
    """Padded group-buffer bytes (one moment buffer)."""
    return virtual_shards(shards) * _group_row_len(sizes, shards) * itemsize


def _leaf_columns(sizes: List[int], shards: int) -> List[Tuple[int, int]]:
    """``(column offset, r_leaf)`` of each leaf in the ``[V, Lpad]``
    buffer."""
    out, off = [], 0
    for n in sizes:
        r = _leaf_rows(n, shards)
        out.append((off, r))
        off += r
    return out


def _flatten_group(leaves: List[torch.Tensor], shards: int, Lpad: int,
                   dtype: torch.dtype, rows: Optional[Tuple[int, int]] = None,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Leaves → rows ``[r0, r1)`` (default all) of the ``[shards, Lpad]``
    V-interleaved buffer, as a ``[r1 - r0, Lpad]`` tensor (``out`` when
    given, written in place)."""
    r0, r1 = (0, shards) if rows is None else rows
    if out is None:
        out = torch.empty((r1 - r0, Lpad), dtype=dtype,
                          device=leaves[0].device if leaves else "cpu")
    return _pack_rows(leaves, _leaf_columns([t.numel() for t in leaves],
                                            shards), r0,
                      out.view(r1 - r0, Lpad))


def _pack_rows(leaves: List[Optional[torch.Tensor]],
               columns: List[Tuple[int, int]], r0: int,
               out: torch.Tensor) -> torch.Tensor:
    """Leaves (None: zeros) → their rows ``[r0, r0 + R)`` in the
    ``[R, Lpad]`` ``out``. A leaf's part of those rows is one range of
    its flattened values, copied by at most two strided copies; the zero
    padding is written where it falls, so ``out`` may be reused."""
    end = 0
    for leaf, (off, r) in zip(leaves, columns):
        _pack_leaf(leaf, out[:, off:off + r], r0, r)
        end = off + r
    out[:, end:].zero_()
    return out


def _pack_leaf(leaf: Optional[torch.Tensor], blk: torch.Tensor, r0: int,
               r: int) -> None:
    """Write a leaf's rows ``[r0, r0 + R)`` into ``blk`` (``[R, r]``,
    a strided view); None writes zeros."""
    R = blk.shape[0]
    if leaf is None:
        blk.zero_()
        return
    flat = leaf.reshape(-1)
    n = flat.numel()
    lo, hi = min(r0 * r, n), min((r0 + R) * r, n)
    k = hi - lo
    full, rem = divmod(k, r)
    if full:
        blk[:full].copy_(flat[lo:lo + full * r].view(full, r))
    if rem:
        blk[full, :rem].copy_(flat[lo + full * r:hi])
        blk[full, rem:].zero_()
        full += 1
    if full < R:
        blk[full:].zero_()


def _unflatten_group(buf: torch.Tensor, outs: List[torch.Tensor],
                     shards: int, rows: Optional[Tuple[int, int]] = None
                     ) -> List[torch.Tensor]:
    """Rows ``[r0, r1)`` of a V-interleaved group buffer (``buf``,
    ``[r1 - r0, Lpad]`` or flat) → each leaf's part of them, written
    into ``outs`` (leaf-shaped, contiguous; cast to their dtype) in
    place. With all rows this is the JAX ``_unflatten_group``."""
    r0, r1 = (0, shards) if rows is None else rows
    R = r1 - r0
    buf = buf.view(R, -1)
    for dst, (off, r) in zip(outs, _leaf_columns(
            [t.numel() for t in outs], shards)):
        flat = dst.view(-1)
        n = flat.numel()
        lo, hi = min(r0 * r, n), min(r1 * r, n)
        full, rem = divmod(hi - lo, r)
        blk = buf[:, off:off + r]
        if full:
            flat[lo:lo + full * r].view(full, r).copy_(blk[:full])
        if rem:
            flat[lo + full * r:hi].copy_(blk[full, :rem])
    return outs


def leaf_moment_views(state: "FusedAdamState", params: Any,
                      shards: int = _V) -> Tuple[Any, Any]:
    """Per-leaf copies of V-interleaved moment buffers (tests and
    debugging): ``(m_tree, v_tree)`` shaped like ``params``' float
    leaves (None at the other positions)."""
    leaves, spec = tree_flatten(params)
    shards = virtual_shards(shards)
    m_out: List[Any] = [None] * len(leaves)
    v_out: List[Any] = [None] * len(leaves)
    for gi, (_, idxs) in enumerate(float_groups(leaves)):
        sizes = [leaves[i].numel() for i in idxs]
        Lpad = _group_row_len(sizes, shards)
        for buf, dst in ((state.m[gi], m_out), (state.v[gi], v_out)):
            outs = [torch.empty(leaves[i].shape, dtype=buf.dtype,
                                device=buf.device) for i in idxs]
            _unflatten_group(buf.view(shards, Lpad), outs, shards)
            for i, t in zip(idxs, outs):
                dst[i] = t
    return tree_unflatten(spec, m_out), tree_unflatten(spec, v_out)


class ShardGroup:
    """One dtype group in the V-interleaved layout, as one rank holds it:
    the rows ``plan`` names (``runtime/zero/partition.row_plan``: rank d
    of dp owns ``[d*V/dp, (d+1)*V/dp)``) of the parameters (``param``,
    the dtype of the group: fp32 masters or bf16 master-free) and of the
    fp32 gradients (``grad``), each ``[V/dp * Lpad]`` flat. ``base`` is
    the rank's first element in the whole ``[V * Lpad]`` buffer: K6's
    stochastic-rounding index starts there.

    ``layers``: per leaf, 0 (the leaf is one column range) or its number
    of layer slices L (a stacked ``[L, ...]`` leaf in the per-layer form
    of the layout, the module docstring's last item; every such leaf of
    the group has the same L). ``columns`` gives each leaf's
    ``(column offset, r)`` (of its layer 0 for a layered leaf) and
    ``strides`` the column distance between a layered leaf's slices
    (0 for the others)."""

    cast = None

    def __init__(self, shapes: List[Tuple[int, ...]], dtype: torch.dtype,
                 device: torch.device, plan: Any,
                 layers: Optional[List[int]] = None):
        self.dtype = dtype
        self.shapes = [tuple(s) for s in shapes]
        self.sizes = [int(np.prod(s, dtype=np.int64)) for s in shapes]
        self.shards = plan.shards
        self.plan = plan
        self.layers = [int(n) for n in (layers or [0] * len(shapes))]
        self.layered = any(self.layers)
        if self.layered:
            self.columns, self.strides, end = _layered_columns(
                self.sizes, self.layers, self.shards)
            self.Lpad = max(_ROW_QUANTUM, -(-end // _ROW_QUANTUM)
                            * _ROW_QUANTUM)
        else:
            self.columns = _leaf_columns(self.sizes, self.shards)
            self.strides = [0] * len(self.sizes)
            self.Lpad = _group_row_len(self.sizes, self.shards)
        self.rows_per_rank = plan.rows_per_rank
        self.rows = (plan.row0, plan.row1)
        # dp not dividing V: a range of the flat buffer (``ranged``),
        # the whole buffer on every rank when dp does not divide it
        # (``replicated``).
        self.ranged = not plan.rows
        self.elements = plan.elements(self.Lpad)
        self.replicated = self.ranged and \
            self.elements == (0, self.shards * self.Lpad) and plan.dp > 1
        if self.ranged and self.layered:
            raise NotImplementedError(
                "the per-layer form of the V-layout (a bound Zero3Scan) at "
                f"a dp of {plan.dp}, which does not divide V = "
                f"{self.shards}: run stage 3 without zero3_scan there")
        self.numel = self.elements[1] - self.elements[0]
        self.base = self.elements[0]
        self.param = torch.zeros(self.numel, dtype=dtype, device=device)
        self.grad = torch.zeros(self.numel, dtype=torch.float32,
                                device=device)

    @property
    def full_numel(self) -> int:
        return self.shards * self.Lpad

    def _slices(self, buf2: torch.Tensor, j: int) -> torch.Tensor:
        """Layered leaf ``j``'s ``[L, rows, r]`` view of a 2-D buffer of
        this layout's rows (``buf2``: ``[rows, Lpad]``, contiguous)."""
        off, r = self.columns[j]
        return buf2.as_strided((self.layers[j], buf2.shape[0], r),
                               (self.strides[j], self.Lpad, 1),
                               buf2.storage_offset() + off)

    def local_views(self, buf: torch.Tensor) -> List[torch.Tensor]:
        """Each leaf's block of a local-rows buffer (strided views):
        ``[V/dp, r_leaf]``, or ``[L, V/dp, r]`` for a layered leaf (layer
        l's part at ``[l]``). A ranged group's part is no block of each
        leaf: its one view is the whole local buffer."""
        if self.ranged:
            return [buf.view(-1)]
        b2 = buf.view(self.rows_per_rank, self.Lpad)
        return [self._slices(b2, j) if n else b2[:, off:off + r]
                for j, (n, (off, r)) in enumerate(zip(self.layers,
                                                      self.columns))]

    def leaf_slices(self, full: torch.Tensor) -> List[torch.Tensor]:
        """Each leaf of a whole buffer of this (unlayered) layout, by
        differentiable slicing (a stage-3 gather of a ranged group)."""
        b2 = full.view(self.shards, self.Lpad)
        return [b2[:, off:off + r].reshape(-1)[:n].view(shape)
                for (off, r), n, shape in zip(self.columns, self.sizes,
                                              self.shapes)]

    def segments(self) -> List[List[Tuple[int, int]]]:
        """Each leaf's column ranges ``[(offset, length)]``: one, or one
        a layer slice."""
        return [[(off + k * st, r) for k in range(max(n, 1))]
                for n, st, (off, r) in zip(self.layers, self.strides,
                                           self.columns)]

    def pack(self, leaves: List[Optional[torch.Tensor]],
             out: torch.Tensor, rows: Optional[Tuple[int, int]] = None
             ) -> torch.Tensor:
        """Leaves (None: zeros) → ``out``, rows ``rows`` (default this
        rank's) of the layout; ``out`` is flat or 2-D."""
        if rows is None and self.ranged:
            full = torch.empty(self.full_numel, dtype=out.dtype,
                               device=out.device)
            self.pack(leaves, full, rows=(0, self.shards))
            out.view(-1).copy_(full[self.elements[0]:self.elements[1]])
            return out
        r0, r1 = self.rows if rows is None else rows
        out2 = out.view(r1 - r0, self.Lpad)
        if not self.layered:
            _pack_rows(leaves, self.columns, r0, out2)
            return out
        out2.zero_()
        V = self.shards
        for j, (leaf, n, (off, r)) in enumerate(zip(leaves, self.layers,
                                                    self.columns)):
            if leaf is None:
                continue
            if not n:
                _pack_leaf(leaf, out2[:, off:off + r], r0, r)
                continue
            m = self.sizes[j] // n
            src = leaf.reshape(n, m)
            if V * r != m:
                src = torch.nn.functional.pad(src, (0, V * r - m))
            self._slices(out2, j).copy_(src.view(n, V, r)[:, r0:r1])
        return out

    def unpack(self, buf: torch.Tensor, outs: List[torch.Tensor]) -> None:
        """The whole layout's buffer → each leaf, in place into the
        leaf-shaped ``outs``."""
        if not self.layered:
            _unflatten_group(buf, outs, self.shards)
            return
        V = self.shards
        b2 = buf.view(V, self.Lpad)
        for j, (dst, n, (off, r)) in enumerate(zip(outs, self.layers,
                                                   self.columns)):
            if not n:
                _unflatten_group(b2[:, off:off + r].contiguous(), [dst], V)
                continue
            m = self.sizes[j] // n
            dst.view(n, m).copy_(self._slices(b2, j).reshape(n, V * r)
                                 [:, :m])

    def _jax_twin(self) -> "ShardGroup":
        return ShardGroup(self.shapes, self.dtype, torch.device("meta"),
                          self.plan)

    def to_jax_rows(self, full: torch.Tensor) -> torch.Tensor:
        """A whole buffer of this layout (host) → the same values in the
        JAX V-layout of whole leaves."""
        leaves = [torch.empty(s, dtype=full.dtype) for s in self.shapes]
        self.unpack(full, leaves)
        twin = self._jax_twin()
        out = torch.empty(twin.full_numel, dtype=full.dtype)
        twin.pack(leaves, out, rows=(0, self.shards))
        return out

    def local_rows_from_jax(self, full: Any) -> Any:
        """A whole JAX V-layout buffer of this group's leaves (numpy or
        a host tensor) → this rank's rows of this layout."""
        full = torch.as_tensor(np.asarray(full)).reshape(-1)
        if self.ranged:
            return full[self.elements[0]:self.elements[1]].clone()
        twin = self._jax_twin()
        leaves = [torch.empty(s, dtype=full.dtype) for s in self.shapes]
        twin.unpack(full, leaves)
        out = torch.empty(self.numel, dtype=full.dtype)
        return self.pack(leaves, out)


def _layered_columns(sizes: List[int], layers: List[int], shards: int
                     ) -> Tuple[List[Tuple[int, int]], List[int], int]:
    """The per-layer form of the layout: ``(columns, strides, end)``.
    The layered leaves' slices of layer l fill block l (``R`` columns,
    the slices' ``r`` side by side), the L blocks first; the other
    leaves follow as in ``_leaf_columns``."""
    Ls = {n for n in layers if n}
    if len(Ls) != 1:
        raise ValueError(f"the layered leaves of a group must have one "
                         f"layer count, got {sorted(Ls)}")
    L = Ls.pop()
    cols: List[Tuple[int, int]] = [(0, 0)] * len(sizes)
    strides = [0] * len(sizes)
    R = 0
    for j, (n, size) in enumerate(zip(layers, sizes)):
        if n:
            if size % n:
                raise ValueError(f"a leaf of {size} elements does not "
                                 f"split into {n} layers")
            r = _leaf_rows(size // n, shards)
            cols[j] = (R, r)
            R += r
    end = L * R
    for j, (n, size) in enumerate(zip(layers, sizes)):
        if n:
            strides[j] = R
        else:
            r = _leaf_rows(size, shards)
            cols[j] = (end, r)
            end += r
    return cols, strides, end


# --------------------------------------------------------------------- #
# Plain PyTorch versions (CPU path, and the kernels' reference on card)
# --------------------------------------------------------------------- #
def sqnorm_plain(g: torch.Tensor) -> torch.Tensor:
    g = g.float()
    return torch.sum(g * g)


def _hash_u32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on uint32 values held in int64 (the JAX
    ``_hash_u32``); multiplications split so no product leaves int64."""
    def mul(a, c):
        lo, hi = c & 0xFFFF, c >> 16
        return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _U32
    x = x ^ (x >> 16)
    x = mul(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = mul(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def stochastic_round_bits(x: torch.Tensor, noise: torch.Tensor
                          ) -> torch.Tensor:
    """Add 16-bit ``noise`` (int64 in [0, 2^16)) to fp32 ``x``'s mantissa
    tail and truncate to bf16; inf/nan pass through rounded to
    nearest."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & _U32
    r = (bits + noise) & 0xFFFF0000
    r = torch.where(r >= 2 ** 31, r - 2 ** 32, r).to(torch.int32)
    out = r.view(torch.float32).to(torch.bfloat16)
    return torch.where(torch.isfinite(x), out, x.to(torch.bfloat16))


def fused_adam_plain(g, p, m, v, scalars, seed, *, b1: float, b2: float,
                     eps: float, wd: float, coupled: bool, use_inv: bool,
                     use_coeff: bool, one_pass: bool, sr: bool,
                     cast_dtype: Optional[torch.dtype] = None):
    """The K6 arithmetic, op by op in the JAX kernel's association order.
    Returns new ``(p, m, v, cast_or_None)``; the inputs are not
    modified. ``scalars`` = [neg_lr, bc1, bc2, coeff, inv, skip, 0, 0],
    ``seed`` = [sr seed, base index] (int32)."""
    f32 = torch.float32
    g = g.to(f32)
    if use_inv:
        g = g * scalars[4]
    if use_coeff:
        g = g * scalars[3]
    p32 = p.to(f32)
    if coupled and wd:
        g = g + wd * p32
    m_new = (1 - b1) * g + b1 * m
    v_new = (1 - b2) * (g * g) + b2 * v
    u = (m_new / scalars[1]) / (torch.sqrt(v_new / scalars[2]) + eps)
    if (not coupled) and wd:
        u = u + wd * p32
    new_p = p32 + u * scalars[0]
    if one_pass:
        keep_old = scalars[5] > 0.0
        new_p = torch.where(keep_old, p32, new_p)
        m_new = torch.where(keep_old, m, m_new)
        v_new = torch.where(keep_old, v, v_new)
    cast = None if cast_dtype is None else new_p.to(cast_dtype)
    p_new = stochastic_round_indexed(new_p, seed) if sr \
        else new_p.to(p.dtype)
    return p_new, m_new, v_new, cast


def stochastic_round_indexed(x: torch.Tensor, seed: torch.Tensor
                             ) -> torch.Tensor:
    """fp32 ``x`` (flat) to bf16 by stochastic rounding with K6's noise:
    element i draws ``hash((base + i) ^ seed)``, ``seed`` = [sr seed,
    base index] (int32), so an element's draw depends on its place in
    the V-layout, not on the rank that holds it."""
    idx = (seed[1].to(torch.int64) & _U32) + torch.arange(
        x.numel(), device=x.device, dtype=torch.int64)
    noise = _hash_u32((idx & _U32) ^ (seed[0].to(torch.int64) & _U32)) \
        & 0xFFFF
    return stochastic_round_bits(x, noise.reshape(x.shape))


# --------------------------------------------------------------------- #
# Kernel wrappers
# --------------------------------------------------------------------- #
def _check(name: str, dev: torch.device, **tensors: torch.Tensor) -> None:
    for key, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name}: {key} on {t.device}, expected {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


@costs.declares("K5", costs.sqnorm_decl)
def sqnorm(g: torch.Tensor) -> torch.Tensor:
    """K5: the sum of squares of a flat fp32 buffer (a 0-dim tensor)."""
    if g.device.type == "cpu":
        return sqnorm_plain(g)
    if g.device.type != "cuda":
        raise ValueError(f"sqnorm: no kernel for device {g.device}")
    _check("sqnorm", g.device, g=g)
    if g.dtype != torch.float32 or g.dim() != 1 or g.numel() == 0:
        raise TypeError("sqnorm: the kernel takes a non-empty flat float32 "
                        f"buffer, got {g.dtype} {tuple(g.shape)}")
    lib = op_builder.load()
    blocks = lib.dstt_sqnorm_blocks(g.numel())
    partial = torch.empty(blocks, dtype=torch.float32, device=g.device)
    rc = lib.dstt_sqnorm(g.data_ptr(), g.numel(), partial.data_ptr(),
                         op_builder.stream_ptr(g.device))
    op_builder.check(rc, "sqnorm")
    sqnorm.launches += 1
    return torch.sum(partial)


sqnorm.launches = 0


@costs.declares("K6", costs.fused_adam_decl)
def fused_adam_apply(g: torch.Tensor, p: torch.Tensor, m: torch.Tensor,
                     v: torch.Tensor, scalars: torch.Tensor,
                     seed: torch.Tensor, *, b1: float, b2: float,
                     eps: float, wd: float, coupled: bool, use_inv: bool,
                     use_coeff: bool, one_pass: bool, sr: bool,
                     cast_out: Optional[torch.Tensor] = None) -> None:
    """K6: one fused Adam pass over a flat group, in place on ``p``,
    ``m``, ``v`` (and ``cast_out`` when given)."""
    cast_dtype = None if cast_out is None else cast_out.dtype
    flags = dict(b1=b1, b2=b2, eps=eps, wd=wd, coupled=coupled,
                 use_inv=use_inv, use_coeff=use_coeff, one_pass=one_pass,
                 sr=sr)
    if p.device.type == "cpu":
        pn, mn, vn, cn = fused_adam_plain(g, p, m, v, scalars, seed,
                                          cast_dtype=cast_dtype, **flags)
        with torch.no_grad():
            p.copy_(pn)
            m.copy_(mn)
            v.copy_(vn)
            if cast_out is not None:
                cast_out.copy_(cn)
        return
    if p.device.type != "cuda":
        raise ValueError(f"fused_adam: no kernel for device {p.device}")
    extra = {} if cast_out is None else {"cast_out": cast_out}
    _check("fused_adam", p.device, g=g, p=p, m=m, v=v, scalars=scalars,
           seed=seed, **extra)
    n = p.numel()
    for key, t, dt in (("g", g, torch.float32), ("m", m, torch.float32),
                       ("v", v, torch.float32)):
        if t.dtype != dt or t.numel() != n:
            raise TypeError(f"fused_adam: {key} must be [{n}] {dt}, got "
                            f"{tuple(t.shape)} {t.dtype}")
    if scalars.dtype != torch.float32 or scalars.numel() != 8 or \
            seed.dtype != torch.int32 or seed.numel() != 2:
        raise TypeError("fused_adam: scalars must be [8] float32 and seed "
                        "[2] int32")
    if p.dtype == torch.float32:
        if sr:
            raise TypeError("fused_adam: stochastic rounding writes bf16 "
                            "params, got float32")
        if cast_out is not None and (cast_out.numel() != n or cast_dtype
                                     not in (torch.bfloat16, torch.float16)):
            raise TypeError("fused_adam: the cast copy must be [n] bfloat16 "
                            f"or float16, got {cast_dtype}")
    elif p.dtype != torch.bfloat16 or cast_out is not None:
        raise TypeError(f"fused_adam: params must be float32 (optionally "
                        f"with a cast copy) or bfloat16, got {p.dtype}")
    bits = (1 * coupled) | (2 * use_inv) | (4 * use_coeff) | \
        (8 * one_pass) | (16 * bool(wd))
    lib = op_builder.load()
    rc = lib.dstt_fused_adam(
        g.data_ptr(), p.data_ptr(), m.data_ptr(), v.data_ptr(),
        None if cast_out is None else cast_out.data_ptr(),
        scalars.data_ptr(), seed.data_ptr(), n, _DTYPE_CODES[p.dtype],
        _DTYPE_CODES.get(cast_dtype, -1), int(sr), bits, b1, 1 - b1, b2,
        1 - b2, eps, wd, op_builder.stream_ptr(p.device))
    op_builder.check(rc, "fused_adam")
    fused_adam_apply.launches += 1


fused_adam_apply.launches = 0


class FusedAdamState(NamedTuple):
    """One flat fp32 moment buffer per dtype group, in the groups'
    layout; ``count`` is the int32 number of updates taken."""
    count: torch.Tensor
    m: Tuple[torch.Tensor, ...]
    v: Tuple[torch.Tensor, ...]


__all__ = ["FusedAdamState", "FlatGroup", "ShardGroup",
           "virtual_shards", "group_nbytes", "leaf_moment_views",
           "float_groups",
           "tree_flatten", "tree_unflatten", "sqnorm", "sqnorm_plain",
           "fused_adam_apply", "fused_adam_plain", "stochastic_round_bits",
           "stochastic_round_indexed"]
