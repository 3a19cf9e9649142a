"""KV cache: the block pool, its block-table primitives, the host-side
block allocator and the slot-major layout (port of
``deepspeed_tpu/inference/kv_cache.py``).

The cache is a pool of fixed-size blocks,

    k, v : [layers, groups, blocks_per_group, heads, block_size, head_dim]

and a request owns a list of block ids (its block-table row), not a
``max_seq_len`` reservation: blocks allocate lazily as a context grows,
and common prompt prefixes are shared copy-on-write across requests
(full-block granularity, chain-hashed, refcounted by ``BlockAllocator``).
On one GPU the ``groups`` axis has size 1.

The slot-major layout (``block_size: 0``, ``KVCacheSpec``) reserves
``max_len`` rows for every slot, with no allocator and no sharing. Its
rows live in a pool of the same layout: slot s owns the consecutive
blocks ``s*J .. s*J + J-1`` through a fixed identity table, so the
paged-attention kernel and the flash forward serve it exactly as they
serve the paged pool.

PyTorch idiom: the pool is written IN PLACE. ``paged_write_rows`` and
``paged_copy_block`` mutate the tensors they are given (the JAX versions
return new arrays), and rows whose block is dead are simply not indexed —
the JAX one-hot write exists only to stay GSPMD-partitionable.
"""
from __future__ import annotations

import dataclasses
import math
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

DEAD_BLOCK = -1     # block-table entry for "unallocated": writes through
                    # it land nowhere and the attend skips it


@dataclasses.dataclass(frozen=True)
class PagedKVCacheSpec:
    """Static geometry of the block pool, fixed at engine construction.
    ``num_blocks`` is the global pool size laid out as ``[num_groups,
    blocks_per_group]``."""
    num_layers: int
    num_slots: int
    num_blocks: int
    block_size: int
    max_len: int
    num_heads: int
    head_dim: int
    num_groups: int = 1
    dtype: Any = torch.bfloat16

    @property
    def blocks_per_group(self) -> int:
        return self.num_blocks // self.num_groups

    @property
    def slots_per_group(self) -> int:
        return self.num_slots // self.num_groups

    @property
    def max_blocks_per_slot(self) -> int:
        """Block-table width J: logical blocks a full slot spans."""
        return self.max_len // self.block_size

    @property
    def shape(self) -> Tuple[int, int, int, int, int, int]:
        return (self.num_layers, self.num_groups, self.blocks_per_group,
                self.num_heads, self.block_size, self.head_dim)

    def itemsize(self) -> int:
        return torch.empty((), dtype=self.dtype).element_size()

    def nbytes(self) -> int:
        """Total K+V pool bytes."""
        return 2 * int(np.prod(self.shape)) * self.itemsize()

    def block_nbytes(self) -> int:
        """K+V bytes one block holds across all layers."""
        return (2 * self.num_layers * self.num_heads * self.block_size *
                self.head_dim * self.itemsize())

    def validate(self) -> None:
        for name in ("num_layers", "num_slots", "num_blocks", "block_size",
                     "max_len", "num_heads", "head_dim", "num_groups"):
            if int(getattr(self, name)) <= 0:
                raise ValueError(f"PagedKVCacheSpec.{name} must be "
                                 f"positive, got {getattr(self, name)}")
        if self.max_len % self.block_size:
            raise ValueError(
                f"inference.block_size={self.block_size} must divide the "
                f"cache capacity ({self.max_len}) — a slot's last logical "
                "block would otherwise overhang the position table")
        if self.num_blocks % self.num_groups:
            raise ValueError(
                f"inference.num_blocks={self.num_blocks} must be divisible "
                f"by the number of groups ({self.num_groups})")
        if self.num_slots % self.num_groups:
            raise ValueError(
                f"inference.max_slots={self.num_slots} must be divisible "
                f"by the number of groups ({self.num_groups})")


def init_paged_cache(spec: PagedKVCacheSpec, device: torch.device
                     ) -> Dict[str, torch.Tensor]:
    """Zero-initialized K and V pools on ``device``."""
    spec.validate()
    return {"k": torch.zeros(spec.shape, dtype=spec.dtype, device=device),
            "v": torch.zeros(spec.shape, dtype=spec.dtype, device=device)}


# The pool block of the slot-major layout: the largest divisor of the
# slot's capacity up to the paged layout's usual 16, so the paged
# kernel splits a long context over blocks as it does for the pool.
SLOT_MAJOR_BLOCK = 16


@dataclasses.dataclass(frozen=True)
class KVCacheSpec:
    """Static geometry of the slot-major cache: every slot reserves
    ``max_len`` rows (the JAX ``KVCacheSpec``, logical shape ``[layers,
    slots, heads, max_len, head_dim]``). The rows are stored as the
    pool ``pool_spec()`` describes, slot s in blocks ``slot_tables()[s]``.
    """
    num_layers: int
    num_slots: int
    num_heads: int
    max_len: int
    head_dim: int
    dtype: Any = torch.bfloat16

    @property
    def shape(self) -> Tuple[int, int, int, int, int]:
        return (self.num_layers, self.num_slots, self.num_heads,
                self.max_len, self.head_dim)

    def nbytes(self) -> int:
        """Total K+V bytes: the whole reservation, whatever it holds."""
        return 2 * int(np.prod(self.shape)) * \
            torch.empty((), dtype=self.dtype).element_size()

    @property
    def pool_block(self) -> int:
        return math.gcd(self.max_len, SLOT_MAJOR_BLOCK)

    @property
    def blocks_per_slot(self) -> int:
        return self.max_len // self.pool_block

    def pool_spec(self) -> "PagedKVCacheSpec":
        """The block pool that stores the rows: one group, J blocks a
        slot."""
        return PagedKVCacheSpec(
            num_layers=self.num_layers, num_slots=self.num_slots,
            num_blocks=self.num_slots * self.blocks_per_slot,
            block_size=self.pool_block, max_len=self.max_len,
            num_heads=self.num_heads, head_dim=self.head_dim,
            dtype=self.dtype)

    def slot_tables(self) -> np.ndarray:
        """[slots, J] int32: the fixed identity table, slot s's blocks
        ``s*J .. s*J + J-1``."""
        J = self.blocks_per_slot
        return np.arange(self.num_slots * J,
                         dtype=np.int32).reshape(self.num_slots, J)


def init_cache(spec: KVCacheSpec, device: torch.device
               ) -> Dict[str, torch.Tensor]:
    """Zero-initialized slot-major K and V, in the pool layout of
    ``spec.pool_spec()``."""
    return init_paged_cache(spec.pool_spec(), device)


def slot_rows(pool: torch.Tensor, spec: KVCacheSpec,
              slot: int) -> torch.Tensor:
    """One slot's rows of one layer's slot-major pool ([1, B, nH, bs, D])
    as the JAX layout's ``[nH, max_len, D]``."""
    J = spec.blocks_per_slot
    rows = pool[0, slot * J:(slot + 1) * J]                  # [J, nH, bs, D]
    return rows.permute(1, 0, 2, 3).reshape(
        spec.num_heads, spec.max_len, spec.head_dim)


# --------------------------------------------------------------------- #
# Block-table primitives. ``pool`` is ONE layer's [G, B, nH, bs, D].
# --------------------------------------------------------------------- #
def positions_to_blocks(bt: torch.Tensor, pos: torch.Tensor,
                        block_size: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Resolve token positions through a block table.

    bt: [..., J] physical block ids (DEAD_BLOCK where unallocated); pos:
    [...] token positions, same leading shape. Returns int32 (block,
    offset), block == DEAD_BLOCK for positions past the table or through
    a dead entry."""
    J = bt.shape[-1]
    pos = pos.long()
    j = torch.div(pos, block_size, rounding_mode="floor")
    off = pos - j * block_size
    inside = (j >= 0) & (j < J)
    blk = torch.gather(bt.long(), -1, j.clamp(0, J - 1)[..., None])[..., 0]
    blk = torch.where(inside, blk, DEAD_BLOCK)
    return blk.to(torch.int32), off.to(torch.int32)


@dataclasses.dataclass(frozen=True)
class WritePlan:
    """Where the live rows of a [G, R] write land: flat pool-block index
    ``g * B + block``, the in-block offset, and the source row in the
    flattened [G * R] new-rows tensor. Dead rows are left out."""
    block: torch.Tensor
    offset: torch.Tensor
    row: torch.Tensor

    def to(self, device: torch.device) -> "WritePlan":
        return WritePlan(*(t.to(device, non_blocking=True)
                           for t in (self.block, self.offset, self.row)))


def write_plan(blk: torch.Tensor, off: torch.Tensor,
               blocks_per_group: int) -> WritePlan:
    """The plan of a [G, R] write (blk/off from ``positions_to_blocks``).
    Computing it on host tensors keeps the device free of the
    data-dependent row count."""
    G, R = blk.shape
    live = (blk >= 0).reshape(-1)
    g = torch.arange(G, device=blk.device)[:, None].expand(G, R)
    flat = (g * blocks_per_group + blk.long()).reshape(-1)
    rows = torch.arange(G * R, device=blk.device)
    return WritePlan(flat[live], off.long().reshape(-1)[live], rows[live])


def write_rows_planned(pool: torch.Tensor, new: torch.Tensor,
                       plan: WritePlan) -> None:
    """In place: ``pool[g, block, :, offset, :] = new[g, r]`` for every
    live row of the plan. new: [G, R, nH, D]."""
    G, B, nH, bs, D = pool.shape
    flat = pool.view(G * B, nH, bs, D)
    flat[plan.block, :, plan.offset, :] = \
        new.reshape(-1, nH, D)[plan.row].to(pool.dtype)


def paged_write_rows(pool: torch.Tensor, new: torch.Tensor,
                     blk: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    """Write R rows per group into the pool at (block, offset), in place.
    pool: [G, B, nH, bs, D]; new: [G, R, nH, D]; blk/off: [G, R]. Rows
    with blk == DEAD_BLOCK write nowhere. Returns ``pool``."""
    plan = write_plan(blk, off, pool.shape[1]).to(pool.device)
    write_rows_planned(pool, new, plan)
    return pool


def paged_copy_block(pool: torch.Tensor,
                     copies: Sequence[Tuple[int, int, int]]) -> None:
    """The device half of copy-on-write, in place: for each ``(group,
    src, dst)`` copy block ``src``'s rows to block ``dst`` of the same
    group, every layer at once. pool: [L, G, B, nH, bs, D]."""
    for g, src, dst in copies:
        pool[:, g, dst] = pool[:, g, src]


# --------------------------------------------------------------------- #
# Host-side block allocator: free lists, refcounts, prefix cache, CoW
# --------------------------------------------------------------------- #
def chain_hash(prev: int, tokens: np.ndarray) -> int:
    """Position-dependent hash of one full block's tokens given the hash
    of the preceding chain."""
    return hash((prev, tokens.astype(np.int64).tobytes()))


class PoolExhausted(RuntimeError):
    """No free or reclaimable block in the group — admission must be
    rejected (a live slot is never touched)."""


class BlockAllocator:
    """Host-authoritative state of the block pool.

    Per group: a free list, per-block refcounts, and the prefix cache — a
    chain-hash index over full PROMPT blocks plus an LRU of retained
    blocks whose refcount dropped to zero (they keep their bytes until
    pool pressure reclaims them).

    Admission is RESERVATION-based: ``can_admit`` checks that the group
    can cover the request's worst-case block need (prompt + max_new +
    spec lookahead, minus the live prefix blocks it shares), and
    ``admit_prompt`` books that reservation so later lazy allocations can
    never strand a live slot mid-flight.
    """

    def __init__(self, spec: PagedKVCacheSpec):
        self.spec = spec
        G, B = spec.num_groups, spec.blocks_per_group
        self._free: List[List[int]] = [list(range(B)) for _ in range(G)]
        self._ref = np.zeros((G, B), np.int64)
        self._hash_index: List[Dict[int, int]] = [{} for _ in range(G)]
        self._block_hash: List[Dict[int, int]] = [{} for _ in range(G)]
        self._lru: List["OrderedDict[int, None]"] = \
            [OrderedDict() for _ in range(G)]
        self._reserved: List[int] = [0] * G
        self._slot_reserved: Dict[int, int] = {}
        self._slot_group: Dict[int, int] = {}
        self.cow_copies = 0
        self.reclaimed = 0

    # ---- accounting ---- #
    def blocks_in_use(self) -> int:
        """Live (ref > 0) blocks; shared blocks count once."""
        return int((self._ref > 0).sum())

    def bytes_in_use(self) -> int:
        return self.blocks_in_use() * self.spec.block_nbytes()

    def available(self, group: int) -> int:
        """Free + reclaimable blocks minus outstanding reservations."""
        return (len(self._free[group]) + len(self._lru[group])
                - self._reserved[group])

    def need_blocks(self, prompt_len: int, max_new: int,
                    spec_k: int = 0) -> int:
        """Worst-case logical blocks a request spans (capped at the
        table width)."""
        tokens = prompt_len + max_new + spec_k
        need = -(-tokens // self.spec.block_size)
        return min(need, self.spec.max_blocks_per_slot)

    # ---- prefix cache ---- #
    def match_prefix(self, group: int, prompt: np.ndarray
                     ) -> Tuple[List[int], List[int]]:
        """Longest cached full-block chain matching ``prompt`` →
        (block ids, chain hashes); stops at the first miss."""
        bs = self.spec.block_size
        idx = self._hash_index[group]
        blocks: List[int] = []
        hashes: List[int] = []
        h = 0
        for j in range(len(prompt) // bs):
            h = chain_hash(h, prompt[j * bs:(j + 1) * bs])
            b = idx.get(h)
            if b is None:
                break
            blocks.append(b)
            hashes.append(h)
        return blocks, hashes

    def can_admit(self, group: int, prompt: np.ndarray, max_new: int,
                  spec_k: int = 0, share: bool = True) -> bool:
        need = self.need_blocks(len(prompt), max_new, spec_k)
        matched = self.match_prefix(group, prompt)[0] if share else []
        # Only LIVE shared blocks ride free; reviving an LRU-retained
        # block consumes reclaimable capacity like a fresh allocation.
        free_ride = sum(1 for b in matched if self._ref[group, b] > 0)
        return self.available(group) >= need - free_ride

    # ---- allocation primitives ---- #
    def _pop_block(self, group: int) -> int:
        if self._free[group]:
            return self._free[group].pop()
        if self._lru[group]:
            b, _ = self._lru[group].popitem(last=False)   # oldest
            h = self._block_hash[group].pop(b, None)
            if h is not None:
                self._hash_index[group].pop(h, None)
            self.reclaimed += 1
            return b
        raise PoolExhausted(
            f"group {group}: no free or reclaimable block "
            f"({self.spec.blocks_per_group} blocks, "
            f"{self._reserved[group]} reserved)")

    def _draw(self, group: int, slot: int) -> int:
        """Allocate one block for ``slot``, drawing down its reservation
        when one is booked."""
        b = self._pop_block(group)
        self._ref[group, b] = 1
        if self._slot_reserved.get(slot, 0) > 0:
            self._slot_reserved[slot] -= 1
            self._reserved[group] -= 1
        return b

    def _incref(self, group: int, b: int) -> None:
        if self._ref[group, b] == 0:
            self._lru[group].pop(b, None)       # revive from retention
        self._ref[group, b] += 1

    def _decref(self, group: int, b: int) -> None:
        self._ref[group, b] -= 1
        if self._ref[group, b] < 0:
            raise RuntimeError(f"block {b} of group {group}: refcount "
                               "underflow")
        if self._ref[group, b] == 0:
            if b in self._block_hash[group]:
                self._lru[group][b] = None      # retain prefix blocks
            else:
                self._free[group].append(b)

    # ---- request lifecycle ---- #
    def admit_prompt(self, slot: int, group: int, prompt: np.ndarray,
                     max_new: int, spec_k: int = 0,
                     share: bool = True) -> "AdmitPlan":
        """Allocate/share the prompt's blocks and book the request's
        worst-case reservation. Raises PoolExhausted when ``can_admit``
        would be False."""
        if not self.can_admit(group, prompt, max_new, spec_k,
                              share=share):
            raise PoolExhausted(
                f"group {group}: {self.available(group)} block(s) "
                f"available < worst-case need for a "
                f"{len(prompt)}+{max_new}-token request")
        bs = self.spec.block_size
        plen = len(prompt)
        matched_blocks, hashes = self.match_prefix(group, prompt) \
            if share else ([], [])
        # Always re-prefill at least the prompt's last token: its logits
        # seed the first sampled token, and its block must be privately
        # writable for the decode appends that follow.
        matched = min(len(matched_blocks) * bs, plen - 1)
        n_keep = matched // bs
        cow_src: Optional[int] = None
        for b in matched_blocks[:n_keep]:
            self._incref(group, b)
        table: List[int] = list(matched_blocks[:n_keep])
        if n_keep < len(matched_blocks):
            # The chain covered the whole prompt: fork its final block
            # copy-on-write into a private block.
            cow_src = matched_blocks[n_keep]
            table.append(self._draw(group, slot))
            self.cow_copies += 1
        while len(table) * bs < plen:
            table.append(self._draw(group, slot))
        need = self.need_blocks(plen, max_new, spec_k)
        remaining = max(0, need - len(table))
        self._slot_reserved[slot] = remaining
        self._slot_group[slot] = group
        self._reserved[group] += remaining
        # Register the prompt's full PRIVATE blocks in the prefix cache
        # (the CoW fork stays out: the cached original is authoritative).
        h = hashes[n_keep - 1] if n_keep else 0
        for j in range(n_keep, plen // bs) if share else ():
            h = chain_hash(h, prompt[j * bs:(j + 1) * bs])
            if cow_src is not None and j == n_keep:
                continue
            b = table[j]
            if h not in self._hash_index[group]:
                self._hash_index[group][h] = b
                self._block_hash[group][b] = h
        return AdmitPlan(slot=slot, group=group, table=table,
                         matched=matched, cow_src=cow_src,
                         cow_dst=table[n_keep] if cow_src is not None
                         else None)

    def alloc_block(self, slot: int) -> int:
        """Lazily allocate one more block for a live slot, drawing down
        its reservation."""
        if slot not in self._slot_group:
            raise RuntimeError(
                f"slot {slot} has no admitted prompt — prefill() admits "
                "through the allocator before any decode can append")
        return self._draw(self._slot_group[slot], slot)

    def release(self, slot: int, table: Sequence[int]) -> None:
        """Evict: drop every table reference and the unused reservation.
        Prefix blocks whose refcount hits zero are RETAINED (LRU)."""
        group = self._slot_group.pop(slot, None)
        if group is None:
            return
        rem = self._slot_reserved.pop(slot, 0)
        self._reserved[group] -= rem
        for b in table:
            if b != DEAD_BLOCK:
                self._decref(group, int(b))


@dataclasses.dataclass
class AdmitPlan:
    """What ``BlockAllocator.admit_prompt`` decided: the slot's initial
    block-table row, how many prompt tokens ride cached blocks, and the
    copy-on-write fork (src → dst) if any."""
    slot: int
    group: int
    table: List[int]
    matched: int
    cow_src: Optional[int] = None
    cow_dst: Optional[int] = None


__all__ = ["DEAD_BLOCK", "PagedKVCacheSpec", "init_paged_cache",
           "SLOT_MAJOR_BLOCK", "KVCacheSpec", "init_cache", "slot_rows",
           "positions_to_blocks", "WritePlan", "write_plan",
           "write_rows_planned", "paged_write_rows", "paged_copy_block",
           "chain_hash", "PoolExhausted", "BlockAllocator", "AdmitPlan"]
