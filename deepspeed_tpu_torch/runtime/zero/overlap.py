"""Bucketed, overlapped gradient collectives at ZeRO stages 1-2 across
ranks (``zero_optimization.overlap_comm`` with ``reduce_bucket_size``).

The JAX engine gets this overlap from XLA's latency-hiding scheduler,
which moves each gradient collective up to where its operand is ready
(JAX ``runtime/zero/config.py``, ``overlap_comm``). The port issues its
collectives itself, so it does what DeepSpeed's ZeRO does: a hook on
each leaf puts its grad into its group's open bucket as the backward
pass produces it, and a bucket's collective starts as async work
(``async_op=True``) as soon as the bucket is full (the next grad would
take it past ``reduce_bucket_size`` elements; a larger leaf fills one
alone) or the backward's last grad is in, while the backward pass goes
on. The buckets are thus made in the order the grads complete, on every
rank the same: the backward graph is the same on every rank, so the
hooks fire in the same order everywhere, and the ranks' gloo or NCCL
collectives pair up.

- Stage 2 (``reduce_scatter: true``): every micro-step, the bucket's
  grads are packed side by side, each leaf in its columns' V-interleaved
  form, in fp32, and reduce-scattered; at the end of the micro-step's
  backward the handles are waited on and each rank adds its rows of
  each leaf into its columns of its fp32 grads.
- Stage 1 (and stage 2 with ``reduce_scatter: false``): the hooks add
  each micro-step's grads into the fp32 flat buffers; on the last
  micro-step of the window each bucket's grads are all-reduced (the
  flat buffer's span when the bucket's leaves lie side by side there,
  else a packed copy), and the step waits on the handles before it
  packs this rank's rows, the norm and the update.

Every element is summed over the same ranks as the one collective a
group takes without overlap, so at dp 2 the result is bit-equal to it.
What overlaps is what the backward pass still has to run when a bucket
starts: with a model's layers stacked in one ``[L, ...]`` leaf per
parameter, those leaves complete together at the first layer's
backward, which leaves the embedding's backward to overlap.
"""
from __future__ import annotations

import weakref
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from ...ops.fused_update import _pack_leaf


class GradBuckets:
    """The buckets of one engine's groups, made during one micro-step's
    backward (``open`` … hooks' ``arrive`` … ``close``).

    ``group_leaves``: each group's leaf indices (tree order);
    ``reduce_scatter``: stage 2's mode (``shards``: the ShardGroups) or
    the all-reduce mode (``groups``: the FlatGroups, ``grad_views``: each
    leaf's view of its group's fp32 grads); ``group``: the data-parallel
    process group the collectives run on (None: the default group)."""

    def __init__(self, group_leaves: List[List[int]], sizes: List[int],
                 bucket_elems: int, reduce_scatter: bool,
                 shards: List[Any], groups: List[Any],
                 grad_views: List[Any], group: Any = None):
        self.reduce_scatter = reduce_scatter
        # (the keyword only where a group is named)
        self._group = {} if group is None else {"group": group}
        self.shards, self.groups = shards, groups
        self.grad_views = grad_views
        self.sizes = sizes
        self.bucket_elems = max(1, int(bucket_elems))
        self._where: Dict[int, Tuple[int, int]] = {}   # leaf → (group, j)
        for gi, idxs in enumerate(group_leaves):
            for j, leaf in enumerate(idxs):
                self._where[leaf] = (gi, j)
        self.n_leaves = len(self._where)
        self.active = False
        self.launched = self.early = 0

    def hook(self, leaf: int):
        """The grad hook of leaf ``leaf`` (holds this object weakly: an
        engine's leaves do not keep it alive)."""
        ref = weakref.ref(self)

        def on_grad(g):
            me = ref()
            if me is not None and me.active:
                me.arrive(leaf, g)
        return on_grad

    # ------------------------------------------------------------------ #
    def open(self, first: bool, last: bool) -> None:
        """Before a micro-step's backward: ``first``/``last`` of its
        window."""
        self.first, self.last = first, last
        self._seen: set = set()
        self._got: Dict[int, Optional[torch.Tensor]] = {}   # (stage 2)
        # each group's open bucket: its leaves in arrival order and size
        self._open: Dict[int, Tuple[List[int], int]] = {}
        self.works: List[Tuple[List[int], Any, Any]] = []
        # the buckets started, and those started before the backward's
        # last grad was in
        self.launched = self.early = 0
        self.active = True

    def arrive(self, leaf: int, g: Optional[torch.Tensor]) -> None:
        """Leaf ``leaf``'s grad of this micro-step (None: no grad)."""
        if leaf in self._seen:
            return
        self._seen.add(leaf)
        if self.reduce_scatter:
            self._got[leaf] = g
        else:
            dst = self.grad_views[leaf]
            with torch.no_grad():
                if g is None:
                    if self.first:
                        dst.zero_()
                elif self.first:
                    dst.copy_(g)
                else:
                    dst.add_(g)
        gi, _ = self._where[leaf]
        size = self.sizes[leaf]
        run, n = self._open.get(gi, ([], 0))
        if run and n + size > self.bucket_elems:
            self._launch(gi, run)
            run, n = [], 0
        run, n = run + [leaf], n + size
        self._open[gi] = (run, n)
        if len(self._seen) == self.n_leaves:
            # (the last grad: every open bucket is complete)
            for gj in sorted(self._open):
                self._launch(gj, self._open[gj][0])
            self._open = {}

    def _launch(self, gi: int, leaves: List[int]) -> None:
        if not (self.reduce_scatter or self.last):
            return                    # (the hooks only accumulate)
        self.launched += 1
        self.early += int(len(self._seen) < self.n_leaves)
        with torch.no_grad():
            if not self.reduce_scatter:
                span, packed = self._flat_span(gi, leaves)
                self.works.append((leaves, dist.all_reduce(
                    span, async_op=True, **self._group),
                    span if packed else None))
                return
            sg = self.shards[gi]
            w = sum(sg.columns[self._where[leaf][1]][1] for leaf in leaves)
            full = torch.empty((sg.shards, w), dtype=torch.float32,
                               device=sg.grad.device)
            pos = 0
            for leaf in leaves:
                r = sg.columns[self._where[leaf][1]][1]
                _pack_leaf(self._got.pop(leaf), full[:, pos:pos + r], 0, r)
                pos += r
            out = torch.empty((sg.rows_per_rank, w), dtype=torch.float32,
                              device=full.device)
            work = dist.reduce_scatter_tensor(out, full, async_op=True,
                                               **self._group)
            # (the send buffer lives until the wait)
            self.works.append((leaves, work, (out, full)))

    def _flat_span(self, gi: int, leaves: List[int]
                   ) -> Tuple[torch.Tensor, bool]:
        """The fp32 grads of ``leaves`` as one tensor: the group's span
        when they lie side by side in it, else a packed copy (True)."""
        grp = self.groups[gi]
        js = sorted(self._where[leaf][1] for leaf in leaves)
        if js == list(range(js[0], js[-1] + 1)):
            lo = grp.offsets[js[0]]
            hi = grp.offsets[js[-1]] + grp.sizes[js[-1]]
            return grp.grad.narrow(0, lo, hi - lo), False
        return torch.cat([self.grad_views[leaf].reshape(-1)
                          for leaf in leaves]), True

    def close(self, grads: List[Optional[torch.Tensor]]) -> None:
        """After the backward: the leaves no hook saw arrive with their
        grad from ``grads`` (None: zeros) in tree order, which launches
        the last buckets, and at stage 2 each bucket's rows are waited
        for and added into this rank's fp32 grads."""
        self.active = False
        for leaf, g in enumerate(grads):
            if leaf not in self._seen:
                self.arrive(leaf, g)
        if not self.reduce_scatter:
            return
        with torch.no_grad():
            if self.first:
                for sg in self.shards:
                    end = max(off + r for off, r in sg.columns)
                    sg.grad.view(sg.rows_per_rank, sg.Lpad)[:, end:].zero_()
            for leaves, work, (out, _) in self.works:
                work.wait()
                pos = 0
                for leaf in leaves:
                    gi, j = self._where[leaf]
                    sg = self.shards[gi]
                    off, r = sg.columns[j]
                    rows = sg.grad.view(sg.rows_per_rank,
                                        sg.Lpad)[:, off:off + r]
                    if self.first:
                        rows.copy_(out[:, pos:pos + r])
                    else:
                        rows.add_(out[:, pos:pos + r])
                    pos += r
        self.works = []

    def wait(self) -> None:
        """The all-reduce mode's handles, at the step (before the
        grads are read); a packed bucket's sums go back to its leaves."""
        with torch.no_grad():
            for leaves, work, packed in self.works:
                work.wait()
                if packed is None:
                    continue
                pos = 0
                for leaf in leaves:
                    n = self.sizes[leaf]
                    self.grad_views[leaf].view(-1).copy_(
                        packed[pos:pos + n])
                    pos += n
        self.works = []


__all__ = ["GradBuckets"]
