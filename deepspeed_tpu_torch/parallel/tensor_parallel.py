"""Tensor parallelism's bookkeeping: which rank holds which part of a
leaf (the JAX package's ``param_shardings`` placement, done by hand).

The JAX package places each parameter leaf by its ``PartitionSpec``
and lets GSPMD partition the program. The port runs one process per
rank, so each rank holds its own part of every leaf a spec splits over
the ``model`` axis (``topology.MP_AXIS``): the r-th of mp contiguous
ranges along the spec's dim, as JAX's shard r is. The one exception is
a fused QKV projection (the leaves a model declares as ``qkv_leaves``:
the transformer block's ``qkv_kernel`` and ``qkv_bias``): the port's
rank holds its heads of each of q, k and v side by side, so its last
axis is first put in the mp-major order of ``models/convert.
qkv_to_mp_order``; that permutation is applied where a whole leaf
enters or leaves a rank (``to_local``, ``to_whole``) and at the
checkpoint files, nowhere else.

``shard_params`` places a tree: each leaf's split dim, whether it is a
QKV leaf, and this rank's parts. The model names its own leaves (its
``vocab_leaves`` and ``qkv_leaves``); nothing here knows a model's leaf
names. ``ModelParallel`` is what a model's tensor-parallel program
reads: the model group, its size and this rank, whether the embedding
is split by vocab range (``vocab``: a vocabulary that mp does not
divide stays whole, as JAX's files keep a leaf that does not split
evenly), and the row-parallel product (``row_dense``).
"""
from __future__ import annotations

from typing import Any, Collection, List, NamedTuple, Optional, Sequence, \
    Tuple

import torch

from . import comm
from .topology import MP_AXIS, PartitionSpec


class ModelParallel(NamedTuple):
    """A rank's place in its tensor-parallel group."""
    group: Any
    size: int
    rank: int
    vocab: bool = True      # the embedding split by vocab range

    def local(self, n: int, what: str) -> int:
        """``n / size``, raising where ``size`` does not divide ``n``."""
        if n % self.size:
            raise ValueError(f"{what} ({n}) is not divisible by the model-"
                             f"parallel size {self.size}")
        return n // self.size

    def copy_in(self, x: torch.Tensor) -> torch.Tensor:
        return comm.copy_to_group(x, self.group)

    def row_dense(self, x: torch.Tensor, kernel: torch.Tensor,
                  bias: torch.Tensor) -> torch.Tensor:
        """A row-parallel product: the ranks' partial outputs summed
        over the group, then the bias once."""
        return comm.reduce_from_group(
            torch.matmul(x, kernel.to(x.dtype)), self.group) + \
            bias.to(x.dtype)


def spec_leaves(specs: Any, params: Any) -> List[PartitionSpec]:
    """The spec of each leaf of ``params`` in tree order (dict keys
    sorted, as ``tree_flatten`` orders them): ``specs`` follows the
    params' dicts down to a ``PartitionSpec`` (or None), which then
    covers every leaf under it; a missing key is replicated."""
    out: List[PartitionSpec] = []

    def walk(p, s):
        if isinstance(p, dict):
            for k in sorted(p):
                sub = s.get(k) if isinstance(s, dict) else s
                walk(p[k], sub)
        elif isinstance(p, (list, tuple)):
            for x in p:
                walk(x, s)
        else:
            out.append(s if isinstance(s, PartitionSpec) else
                       PartitionSpec(*s) if isinstance(s, tuple) else
                       PartitionSpec())
    walk(params, specs)
    return out


def leaf_names(params: Any) -> List[str]:
    """Each leaf's last key in tree order."""
    out: List[str] = []

    def walk(p, name):
        if isinstance(p, dict):
            for k in sorted(p):
                walk(p[k], str(k))
        elif isinstance(p, (list, tuple)):
            for x in p:
                walk(x, name)
        else:
            out.append(name)
    walk(params, "")
    return out


def shard_axes(shapes: Sequence[Sequence[int]],
               specs: Sequence[PartitionSpec], mp: int,
               axis: str = MP_AXIS) -> List[Optional[int]]:
    """Each leaf's split dim over ``axis``, demoted to None (whole on
    every rank) where the leaf cannot be split evenly (JAX
    ``_effective_axes``)."""
    out: List[Optional[int]] = []
    for shape, spec in zip(shapes, specs):
        ax = spec.axis_of(axis) if spec is not None else None
        if ax is not None and (len(shape) == 0 or ax >= len(shape) or
                               shape[ax] % mp):
            ax = None
        out.append(ax if mp > 1 else None)
    return out


def to_local(leaf: torch.Tensor, qkv: bool, ax: Optional[int], mp: int,
             rank: int) -> torch.Tensor:
    """Rank ``rank``'s part of a whole leaf (a copy); ``qkv``: its last
    axis is a fused q|k|v."""
    if ax is None:
        return leaf
    if qkv:
        from ..models.convert import qkv_to_mp_order
        leaf = qkv_to_mp_order(leaf, mp)
    c = leaf.shape[ax] // mp
    return leaf.narrow(ax, rank * c, c).clone()


def to_whole(parts: Sequence[torch.Tensor], qkv: bool,
             ax: Optional[int]) -> torch.Tensor:
    """The whole leaf from its mp parts in rank order."""
    if ax is None:
        return parts[0]
    whole = torch.cat(list(parts), dim=ax)
    if qkv:
        from ..models.convert import qkv_from_mp_order
        whole = qkv_from_mp_order(whole, len(parts))
    return whole


def whole_leaf(local: torch.Tensor, qkv: bool, ax: Optional[int],
               mp: ModelParallel) -> torch.Tensor:
    """The whole leaf gathered over the model group from every rank's
    part (a collective; not differentiable)."""
    if ax is None:
        return local
    flat = comm.all_gather(local.contiguous(), group=mp.group)
    return to_whole(list(flat.view(mp.size, *local.shape).unbind(0)),
                    qkv, ax)


def shard_params(params: Any, specs: Any, grid: Any,
                 vocab_leaves: Collection[str] = (),
                 qkv_leaves: Collection[str] = (), own: Any = None
                 ) -> Tuple[Any, ModelParallel, List[Optional[int]],
                            List[bool]]:
    """This rank's parts of ``params`` under ``specs`` (JAX's
    ``param_shardings``) on the grid's model axis.

    ``vocab_leaves`` and ``qkv_leaves`` name (by last key) the leaves the
    model declares as its vocabulary ends and its fused QKV projections;
    ``own``, the specs its tensor-parallel program takes, if it runs
    one: a leaf placed on another dim raises, except the vocabulary
    leaves left whole together (the program then computes the whole-
    vocabulary head, as where mp does not divide the vocabulary).
    Returns the local tree, the ``ModelParallel``, each leaf's split dim
    (None: whole on every rank) and whether it is a QKV leaf, in tree
    order."""
    from ..ops.fused_update import tree_flatten, tree_unflatten
    mp = int(grid.model_parallel_size)
    leaves, treedef = tree_flatten(params)
    shapes = [tuple(torch.as_tensor(x).shape) for x in leaves]
    names = leaf_names(params)
    axes = shard_axes(shapes, spec_leaves(specs, params), mp)
    want = axes if own is None else \
        shard_axes(shapes, spec_leaves(own, params), mp)
    split = {a is not None for n, a in zip(names, axes) if n in vocab_leaves}
    if len(split) > 1:
        raise ValueError(
            f"param_shardings splits some of the vocabulary leaves "
            f"{sorted(vocab_leaves)} and not others: split them together "
            f"or keep them all whole")
    for n, a, w in zip(names, axes, want):
        if a != w and not (n in vocab_leaves and a is None):
            raise ValueError(
                f"param_shardings places leaf {n!r} on dim {a}; the "
                f"model's tensor-parallel program takes it on dim {w} "
                f"(pass the model's param_shardings)")
    tp = ModelParallel(grid.mp_group, mp, int(grid.model_parallel_id),
                       split != {False})
    qkv = [n in qkv_leaves for n in names]
    local = [to_local(torch.as_tensor(x), q, a, mp, tp.rank)
             for x, q, a in zip(leaves, qkv, axes)]
    return tree_unflatten(treedef, local), tp, axes, qkv


__all__ = ["ModelParallel", "spec_leaves", "leaf_names", "shard_axes",
           "to_local", "to_whole", "whole_leaf", "shard_params"]
