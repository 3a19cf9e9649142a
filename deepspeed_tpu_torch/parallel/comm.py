"""Process groups and collectives (port of the process-group part of
``deepspeed_tpu/parallel/comm.py``).

The JAX package runs one program over a mesh of devices and names its
collectives by mesh axis inside ``shard_map``. The port runs one process
per card, as DeepSpeed does: ``init_distributed`` brings up the default
``torch.distributed`` process group, and the collectives below are thin
calls on it, issued by every rank in the same order.

Backend. NCCL for CUDA tensors, gloo for CPU tensors, unless the caller
names one (the CPU tests run N gloo processes). Rendezvous: the caller's
``init_method`` (``tcp://host:port``, ``file:///path``), else the
launcher's environment (``MASTER_ADDR``/``MASTER_PORT``, ``RANK``,
``WORLD_SIZE``), as ``torch.distributed`` reads it. The card: the
launcher (``launcher/launch.py``) starts one process per card slot with
every slot of the node visible, so a process with ``LOCAL_RANK`` takes
``cuda:LOCAL_RANK % device_count`` as its device before the group comes
up (ranks beyond the cards share them, as two gloo ranks share one card
in the tests on the card).

Groups. Every collective here runs over the default group unless its
caller names one (``group=``): an engine passes its data-parallel
group, which is a pipeline stage's dp ranks in a pipeline
(``runtime/pipe/engine.py``, ``topology.PipelineParallelGrid``) and the
default group otherwise; the collectives that cross stages name the
pipe or the tied group. Ranks (``src``, ``dst``) are the group's.

Point to point (``isend``, ``recv``): the activations and
grads that flow between neighbouring pipeline stages. Gloo moves CPU
tensors only, so over gloo a CUDA tensor is staged through host memory
(its copy sent, a host buffer received and copied to the card).

Tensor and sequence parallelism (Megatron's operators, written by hand
where the JAX package lets GSPMD partition): ``copy_to_group`` (the
identity forward, an all-reduce of the grad backward) feeds a
column-parallel product from the replicated stream;
``reduce_from_group`` (an all-reduce forward, the identity backward)
sums a row-parallel product's partial outputs; ``gather_from_group``
(an all-gather along a dim forward, this rank's slice of the grad
backward) makes a split value whole where every rank goes on with the
same replicated computation; ``vocab_parallel_embedding`` looks up the
rows of a vocab range and sums the ranges. ``ring_exchange`` sends
tensors to the next rank of a ring and receives the previous rank's,
each hop's receives posted before its sends (a gloo send with no
receive posted would wait for ever) and waited at the hop's end.

Not ported here: the ``shard_map`` shim and the all-to-all (ROADMAP
queue 1 item 7). The sparse (CSR) exchange is ``runtime/csr_tensor.py``.
"""
from __future__ import annotations

import os
from typing import List, Optional

import torch
import torch.distributed as dist

from ..utils.logging import logger


def default_backend() -> str:
    """NCCL where there is a card, gloo elsewhere."""
    return "nccl" if torch.cuda.is_available() else "gloo"


def init_distributed(dist_backend: Optional[str] = None,
                     init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     store: Optional["dist.Store"] = None,
                     verbose: bool = True,
                     distributed_port: Optional[int] = None) -> None:
    """Bring up the default process group (no-op when one is up).

    ``world_size``/``rank`` default to ``WORLD_SIZE``/``RANK`` in the
    environment (1 and 0 without them); ``init_method`` to
    ``env://`` when ``MASTER_ADDR`` is set, else an in-process store
    for a world of one. ``store`` (a ``torch.distributed``
    store, e.g. a ``FileStore``) replaces ``init_method``.
    ``distributed_port`` is ``MASTER_PORT`` where ``MASTER_ADDR`` is set
    and ``MASTER_PORT`` is not (the reference's keyword). With a card and
    ``LOCAL_RANK`` set, the process's device becomes ``cuda:LOCAL_RANK %
    device_count`` first."""
    if is_initialized():
        return
    set_local_device()
    if distributed_port is not None and "MASTER_ADDR" in os.environ and \
            "MASTER_PORT" not in os.environ:
        os.environ["MASTER_PORT"] = str(int(distributed_port))
    world = int(world_size if world_size is not None
                else os.environ.get("WORLD_SIZE", "1"))
    rk = int(rank if rank is not None else os.environ.get("RANK", "0"))
    backend = dist_backend or default_backend()
    kw = dict(backend=backend, world_size=world, rank=rk)
    if store is not None:
        kw["store"] = store
    elif init_method is not None:
        kw["init_method"] = init_method
    elif "MASTER_ADDR" in os.environ:
        kw["init_method"] = "env://"
    elif world == 1:
        kw["store"] = dist.HashStore()
    else:
        raise ValueError(
            f"init_distributed: a world of {world} needs a rendezvous — "
            "pass init_method (tcp://host:port or file:///path) or a "
            "store, or set MASTER_ADDR/MASTER_PORT")
    if verbose:
        logger.info(f"Initializing torch.distributed: backend={backend} "
                    f"world_size={world} rank={rk}")
    dist.init_process_group(**kw)


def set_local_device() -> Optional[int]:
    """With a card and ``LOCAL_RANK`` in the environment, make
    ``cuda:LOCAL_RANK % device_count`` this process's device and return
    its index; None otherwise."""
    local = os.environ.get("LOCAL_RANK")
    if local is None or not torch.cuda.is_available():
        return None
    index = int(local) % torch.cuda.device_count()
    torch.cuda.set_device(index)
    return index


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def _global(group, rank: int) -> int:
    """The global rank of ``group``'s rank ``rank``."""
    return rank if group is None else dist.get_global_rank(group, rank)


def new_group(ranks: List[int]):
    """A group over the global ``ranks`` (a collective of the default
    group: every process calls it, in the same order, for every group
    made)."""
    return dist.new_group(ranks=list(ranks))


def get_world_size(group=None) -> int:
    if not is_initialized():
        return 1
    return dist.get_world_size(group)


def get_rank(group=None) -> int:
    if not is_initialized():
        return 0
    return dist.get_rank(group)


def global_rank() -> int:
    """This process's rank in the default group."""
    return dist.get_rank() if is_initialized() else 0


def global_world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def all_reduce(x: torch.Tensor, group=None, op: str = "sum"
               ) -> torch.Tensor:
    """Sum (``op="max"``: the maximum) over the ranks, in place on
    ``x``; returns it."""
    # (a 0-dim tensor goes as a 1-element view of itself)
    dist.all_reduce(x.view(1) if x.dim() == 0 else x, group=group,
                    op=dist.ReduceOp.MAX if op == "max" else
                    dist.ReduceOp.SUM)
    return x


def reduce_scatter(x: torch.Tensor, out: Optional[torch.Tensor] = None,
                   group=None) -> torch.Tensor:
    """Sum ``x`` (flat, ``world`` equal parts) over the ranks; rank d
    receives part d."""
    world = get_world_size(group)
    if out is None:
        out = torch.empty(x.numel() // world, dtype=x.dtype,
                          device=x.device)
    dist.reduce_scatter_tensor(out, x, group=group)
    return out


def all_gather(x: torch.Tensor, out: Optional[torch.Tensor] = None,
               group=None) -> torch.Tensor:
    """Every rank's flat ``x`` concatenated in rank order."""
    world = get_world_size(group)
    if out is None:
        out = torch.empty(x.numel() * world, dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x.reshape(-1), group=group)
    return out


def all_gather_start(x: torch.Tensor, out: torch.Tensor, group=None):
    """Start ``all_gather(x, out)`` (``x`` flat and contiguous; both must
    live until it ends); returns the work whose ``wait()`` ends it."""
    return dist.all_gather_into_tensor(out, x, async_op=True, group=group)


def gather(x: torch.Tensor, dst: int = 0,
           group=None) -> Optional[List[torch.Tensor]]:
    """Every rank's ``x`` on rank ``dst`` (in rank order); None
    elsewhere."""
    world = get_world_size(group)
    out = [torch.empty_like(x) for _ in range(world)] \
        if get_rank(group) == dst else None
    dist.gather(x, out, dst=_global(group, dst), group=group)
    return out


def broadcast(x: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """Rank ``src`` (of ``group``)'s ``x`` on every rank, in place;
    returns it."""
    dist.broadcast(x, _global(group, src), group=group)
    return x


def barrier() -> None:
    if is_initialized():
        dist.barrier()


def _host(x: torch.Tensor, group=None) -> bool:
    """Whether ``x`` crosses ``group`` through host memory (gloo moves
    CPU tensors only)."""
    return x.device.type != "cpu" and \
        dist.get_backend(group) == dist.Backend.GLOO


class _Send:
    """A send in flight: its work and the tensor it reads (the host
    copy, over gloo), which must live until ``wait()``."""

    def __init__(self, work, tensor: torch.Tensor):
        self.work, self.tensor = work, tensor

    def wait(self) -> None:
        self.work.wait()
        self.tensor = None


def isend(x: torch.Tensor, dst: int) -> _Send:
    """Start sending ``x`` to global rank ``dst``; returns the send
    (``wait()`` ends it; ``x`` may be reused once it returns)."""
    x = x.detach().to("cpu") if _host(x) else x.detach().contiguous()
    return _Send(dist.isend(x, dst), x)


def recv(shape, dtype: torch.dtype, device: torch.device,
         src: int) -> torch.Tensor:
    """A tensor of ``shape`` and ``dtype`` from global rank ``src``, on
    ``device``."""
    buf = torch.empty(shape, dtype=dtype,
                      device="cpu" if device.type != "cpu" and
                      dist.get_backend() == dist.Backend.GLOO else device)
    dist.recv(buf, src)
    return buf.to(device, non_blocking=False)


def ring_exchange(tensors: List[torch.Tensor], group) -> List[torch.Tensor]:
    """One hop of a ring over ``group``: each of ``tensors`` goes to the
    group's next rank (rank + 1 mod n), and the previous rank's come
    back, in the same shapes, on the same device. The receives are
    posted first, then the sends, and all of them end before it
    returns. Over gloo a CUDA tensor crosses through host memory."""
    n = get_world_size(group)
    me = get_rank(group)
    nxt, prv = _global(group, (me + 1) % n), _global(group, (me - 1) % n)
    host = bool(tensors) and _host(tensors[0], group)
    bufs = [torch.empty(t.shape, dtype=t.dtype,
                        device="cpu" if host else t.device)
            for t in tensors]
    works = [dist.irecv(b, prv, group=group) for b in bufs]
    sends = [(t.detach().to("cpu") if host else t.detach().contiguous())
             for t in tensors]
    works += [dist.isend(t, nxt, group=group) for t in sends]
    for w in works:
        w.wait()
    return [b.to(t.device) if host else b for b, t in zip(bufs, tensors)]


def all_gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank of ``group``'s ``x`` concatenated along ``dim``, in
    rank order (not differentiable: ``gather_from_group`` is)."""
    n = get_world_size(group)
    if n == 1:
        return x
    flat = all_gather(x.contiguous(), group=group)
    parts = flat.view(n, *x.shape).unbind(0)
    return torch.cat(parts, dim=dim)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(), group=ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.clone(), group=group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group, ctx.size = dim, group, x.shape[dim]
        return all_gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        r = get_rank(ctx.group)
        return g.narrow(ctx.dim, r * ctx.size, ctx.size).contiguous(), \
            None, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's f: the identity forward; the grad all-reduced over
    ``group`` backward (a replicated value entering a column-parallel
    product)."""
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's g: ``x`` summed over ``group`` forward; the grad
    passes unchanged backward (a row-parallel product's partial
    outputs)."""
    return _ReduceFromGroup.apply(x, group)


def gather_from_group(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """``x`` gathered along ``dim`` over ``group`` (rank order); backward
    this rank's slice of the grad, which every rank computes whole from
    the same replicated computation."""
    return _GatherFromGroup.apply(x, dim, group)


def vocab_parallel_embedding(wte: torch.Tensor, tokens: torch.Tensor,
                             start: int, group) -> torch.Tensor:
    """Rows ``tokens`` of an embedding split by vocab range: this rank
    holds rows ``[start, start + wte.shape[0])``; it looks up the tokens
    in its range, writes zeros for the others, and the ranges are summed
    over ``group`` (the grad of ``wte`` stays with its range)."""
    local = tokens - start
    inside = (local >= 0) & (local < wte.shape[0])
    rows = wte[torch.where(inside, local, torch.zeros_like(local))]
    rows = rows * inside.unsqueeze(-1).to(rows.dtype)
    return reduce_from_group(rows, group)


_HOST_GROUP = None


def host_group():
    """A group over every rank whose collectives take CPU tensors: the
    default group when its backend is gloo, else a gloo group made at
    the first call (every rank makes that call at the same point)."""
    global _HOST_GROUP
    if _HOST_GROUP is None:
        _HOST_GROUP = dist.group.WORLD \
            if dist.get_backend() == dist.Backend.GLOO \
            else dist.new_group(backend="gloo")
    return _HOST_GROUP


def any_ranks(*flags: bool) -> List[bool]:
    """Each flag True on every rank when it is True on any: one
    host-side all-reduce (max) of CPU ints, with no device work and no
    read from a card."""
    t = torch.tensor([int(bool(f)) for f in flags], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=host_group())
    return [bool(v) for v in t.tolist()]


__all__ = ["init_distributed", "set_local_device", "is_initialized",
           "get_world_size", "get_rank", "global_rank", "global_world_size",
           "new_group", "isend", "recv", "all_reduce", "reduce_scatter",
           "all_gather", "all_gather_start", "gather", "broadcast",
           "host_group", "any_ranks", "ring_exchange", "all_gather_dim",
           "copy_to_group", "reduce_from_group", "gather_from_group",
           "vocab_parallel_embedding",
           "barrier",
           "default_backend"]
