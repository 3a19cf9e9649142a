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


def get_world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def get_rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def all_reduce(x: torch.Tensor) -> torch.Tensor:
    """Sum over the ranks, in place on ``x``; returns it."""
    # (a 0-dim tensor goes as a 1-element view of itself)
    dist.all_reduce(x.view(1) if x.dim() == 0 else x)
    return x


def reduce_scatter(x: torch.Tensor,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sum ``x`` (flat, ``world`` equal parts) over the ranks; rank d
    receives part d."""
    world = get_world_size()
    if out is None:
        out = torch.empty(x.numel() // world, dtype=x.dtype,
                          device=x.device)
    dist.reduce_scatter_tensor(out, x)
    return out


def all_gather(x: torch.Tensor,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Every rank's flat ``x`` concatenated in rank order."""
    world = get_world_size()
    if out is None:
        out = torch.empty(x.numel() * world, dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x.reshape(-1))
    return out


def gather(x: torch.Tensor, dst: int = 0) -> Optional[List[torch.Tensor]]:
    """Every rank's ``x`` on rank ``dst`` (in rank order); None
    elsewhere."""
    world = get_world_size()
    out = [torch.empty_like(x) for _ in range(world)] \
        if get_rank() == dst else None
    dist.gather(x, out, dst=dst)
    return out


def broadcast(x: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``x`` on every rank, in place; returns it."""
    dist.broadcast(x, src)
    return x


def barrier() -> None:
    if is_initialized():
        dist.barrier()


__all__ = ["init_distributed", "set_local_device", "is_initialized",
           "get_world_size", "get_rank", "all_reduce", "reduce_scatter",
           "all_gather", "gather", "broadcast", "barrier",
           "default_backend"]
