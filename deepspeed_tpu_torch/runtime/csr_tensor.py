"""CSR (compressed sparse row) tensor for sparse embedding gradients (port
of ``deepspeed_tpu/runtime/csr_tensor.py``).

An embedding's gradient touches only the rows whose tokens appeared in
the batch, so shipping ``(row_indices, row_values)`` instead of the dense
``[vocab, hidden]`` tensor cuts the exchange to ``rows / vocab`` of it.
The engine's sparse-gradient step (``runtime/engine.py::_csr_exchange``)
builds one ``CSRTensor`` a rank, all-gathers them and densifies their
sum. Everything stays on the tensor's own device; finding the nonzero
rows reads their count on the host (the only host sync of the path).

Duplicate rows accumulate in the order they appear (the JAX ``np.add.at``
order): ``coalesce`` adds a row's copies in passes, the k-th copy of
every row in pass k, each pass an ``index_add_`` whose indices are
distinct, so the sums do not depend on the order in which a device
schedules its atomic adds.
"""
from __future__ import annotations

from typing import List, Tuple

import torch


class CSRTensor:
    """Row-sparse view of a 2-D tensor (the embedding-gradient shape)."""

    def __init__(self, row_indices: torch.Tensor, values: torch.Tensor,
                 dense_shape: Tuple[int, int]):
        assert values.dim() == 2 and len(dense_shape) == 2
        assert row_indices.shape[0] == values.shape[0]
        assert values.shape[1] == dense_shape[1]
        self.row_indices = row_indices.to(torch.int64)
        self.values = values
        self.dense_shape = tuple(int(d) for d in dense_shape)

    @classmethod
    def from_dense(cls, dense: torch.Tensor) -> "CSRTensor":
        nz = torch.nonzero(torch.any(dense != 0, dim=1)).reshape(-1)
        return cls(nz, dense.index_select(0, nz), tuple(dense.shape))

    def to_dense(self) -> torch.Tensor:
        """The dense tensor; duplicate rows accumulate (scatter-add)."""
        c = self.coalesce()
        out = torch.zeros(self.dense_shape, dtype=self.values.dtype,
                          device=self.values.device)
        return out.index_add_(0, c.row_indices, c.values)

    def sparse_size(self) -> int:
        """Elements stored sparse (values and indices)."""
        return int(self.values.numel() + self.row_indices.numel())

    @property
    def dense_size(self) -> int:
        return int(self.dense_shape[0] * self.dense_shape[1])

    def add(self, other: "CSRTensor") -> "CSRTensor":
        """Sparse accumulate: the rows of both, concatenated."""
        assert self.dense_shape == other.dense_shape
        return CSRTensor(torch.cat([self.row_indices, other.row_indices]),
                         torch.cat([self.values, other.values]),
                         self.dense_shape)

    def coalesce(self) -> "CSRTensor":
        """Merge duplicate rows (summed in order of appearance) and sort
        the indices."""
        uniq, inv = torch.unique(self.row_indices, sorted=True,
                                 return_inverse=True)
        vals = torch.zeros((uniq.numel(), self.dense_shape[1]),
                           dtype=self.values.dtype, device=self.values.device)
        if inv.numel() == 0:
            return CSRTensor(uniq, vals, self.dense_shape)
        # Each entry's occurrence number among the entries of its row.
        order = torch.sort(inv, stable=True).indices
        sorted_inv = inv[order]
        pos = torch.arange(inv.numel(), device=inv.device)
        first = torch.ones_like(sorted_inv, dtype=torch.bool)
        first[1:] = sorted_inv[1:] != sorted_inv[:-1]
        start = torch.cummax(torch.where(first, pos, torch.zeros_like(pos)),
                             0).values
        occ = torch.empty_like(pos)
        occ[order] = pos - start
        for k in range(int(occ.max()) + 1):
            sel = torch.nonzero(occ == k).reshape(-1)
            vals.index_add_(0, inv[sel], self.values.index_select(0, sel))
        return CSRTensor(uniq, vals, self.dense_shape)


def all_gather_csr(shards: List[CSRTensor]) -> CSRTensor:
    """The ranks' rows concatenated in rank order and coalesced: the
    reference's all-gather of CSR halves followed by their sum."""
    assert shards, "need at least one shard"
    out = shards[0]
    for s in shards[1:]:
        out = out.add(s)
    return out.coalesce()


__all__ = ["CSRTensor", "all_gather_csr"]
