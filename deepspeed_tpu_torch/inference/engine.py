"""InferenceEngine — batched autoregressive serving of GPT-2 over the
paged KV cache (port of ``deepspeed_tpu/inference/engine.py``, the paged
and chunked-prefill path).

- Three device operations serve everything: prefill — chunked
  (``prefill_many`` through ``decode.gpt2_prefill_chunk_paged``) or, with
  ``prefill_chunk: 0``, whole-prompt (``prefill`` through
  ``decode.gpt2_prefill_full_paged``, one admission at a time and no
  prefix sharing, as in the JAX engine) — ``decode_once`` (one token for
  every slot) and, with ``spec_k > 0``, ``spec_decode_once``
  (draft-then-verify). All of them run the port's kernels on a CUDA
  device: paged attention (flash attention for whole-prompt prefill),
  LayerNorm, bias+GELU.
- The block pool (``kv_cache``) is allocated once and updated in place.
  One GPU means one pool group (dp = 1, mp = 1).
- Host-side per-slot counters (lengths, active, last token) and the
  block tables are the scheduler's state; they enter each step as small
  host tensors. The one device fetch per iteration is the sampled-token
  readback — the host must see tokens to detect EOS and feed the next
  step.
- ``ServingAggregator`` accounts TTFT/TPOT/occupancy/tokens per second on
  host clocks.

Not ported: the slot-major layout (``block_size: 0``), weight
quantization, dp/mp meshes, the replica router, telemetry and SLO
overlays, and ``from_train_checkpoint``. Each of those configurations raises
``NotImplementedError``; so do ``paged_kernel: false`` and
``fused_kernels: False`` on a CUDA device, where the port has only its
kernels.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import decode as decode_mod
from . import kv_cache
from .quantize import check_quantize, resolve_kv_dtype
from .spec import NGramDrafter
from ..models.gpt2 import GPT2Config
from ..monitor.serving import ServingAggregator
from ..runtime.config import InferenceConfig
from ..runtime.config_utils import load_config_json
from ..utils.device import resolve_device
from ..utils.logging import log_dist


# Leaves the serving path casts to the compute dtype at every use: the
# embeddings, the matmul kernels and the biases ``dense`` adds. The
# LayerNorm parameters and the FFN bias feed the kernels in fp32.
_COMPUTE_DTYPE_LEAVES = ("wte", "wpe", "qkv_bias", "proj_bias",
                         "fc_out_bias")


def prepare_params(params: Dict[str, Any], dtype: torch.dtype,
                   device: torch.device) -> Dict[str, Any]:
    """The serving copy of a GPT-2 param tree on ``device``, with the
    leaves every step would cast to the compute dtype cast once (the
    JAX programs cast them at every use; casting once gives the same
    values and saves a copy kernel per leaf per layer per step)."""
    def leaf(name, t):
        t = torch.as_tensor(t).to(device)
        if name.endswith("_kernel") or name in _COMPUTE_DTYPE_LEAVES:
            t = t.to(dtype)
        return t.contiguous()

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else leaf(k, v)
                for k, v in tree.items()}
    return walk(params)


class InferenceEngine:
    """Batched autoregressive serving on one device."""

    def __init__(self, model_cfg: GPT2Config, params: Dict[str, Any],
                 config: Union[None, str, Dict[str, Any]] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 seed: int = 17):
        if isinstance(config, str):
            config = load_config_json(config)
        config = dict(config or {})
        self.model_cfg = model_cfg
        self.icfg = InferenceConfig(config)
        self.device = resolve_device(device)
        on_cuda = self.device.type == "cuda"

        # --- static serving geometry ---
        self.max_slots = int(self.icfg.max_slots)
        self.max_len = int(self.icfg.max_seq_len) or \
            int(model_cfg.max_seq_length)
        if self.max_len > model_cfg.max_seq_length:
            raise ValueError(
                f"inference.max_seq_len={self.max_len} exceeds the model's "
                f"position table ({model_cfg.max_seq_length})")
        self.prefill_chunk = int(self.icfg.prefill_chunk)
        if self.prefill_chunk and self.max_len % self.prefill_chunk:
            raise ValueError(
                f"inference.prefill_chunk={self.prefill_chunk} must divide "
                f"the cache capacity ({self.max_len}) — padded prompts "
                "would otherwise overrun the slot")
        self.block_size = int(self.icfg.block_size)
        if self.block_size == 0:
            raise NotImplementedError(
                "inference.block_size: 0 (slot-major cache) is not ported; "
                "the port serves from the paged cache")
        if self.max_len % self.block_size:
            raise ValueError(
                f"inference.block_size={self.block_size} must divide "
                f"inference.max_seq_len ({self.max_len})")
        if on_cuda and self.icfg.paged_kernel is False:
            raise NotImplementedError(
                "inference.paged_kernel: false has no CUDA path in the "
                "port — the paged-attention kernel is its only attend")
        if on_cuda and model_cfg.fused_kernels is False:
            raise NotImplementedError(
                "fused_kernels=False has no CUDA path in the port — the "
                "LayerNorm and bias+GELU kernels are its only ones")
        check_quantize(self.icfg.quantize)
        self.spec_k = int(self.icfg.spec_k)
        self.replica = str(self.icfg.replica)
        self.dp = 1
        self.num_blocks = int(self.icfg.num_blocks) or \
            self.max_slots * (self.max_len // self.block_size)

        self._params = prepare_params(params, model_cfg.dtype, self.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(seed))

        # --- the paged KV cache ---
        kv_dtype = resolve_kv_dtype(self.icfg.kv_cache_dtype,
                                    model_cfg.dtype)
        self.cache_spec = kv_cache.PagedKVCacheSpec(
            num_layers=model_cfg.num_layers, num_slots=self.max_slots,
            num_blocks=self.num_blocks, block_size=self.block_size,
            max_len=self.max_len, num_heads=model_cfg.num_heads,
            head_dim=model_cfg.head_dim, num_groups=self.dp, dtype=kv_dtype)
        self.cache = kv_cache.init_paged_cache(self.cache_spec, self.device)
        self.allocator = kv_cache.BlockAllocator(self.cache_spec)
        self.block_tables = np.full(
            (self.max_slots, self.cache_spec.max_blocks_per_slot),
            kv_cache.DEAD_BLOCK, np.int32)
        self.drafter = NGramDrafter(self.spec_k, self.icfg.spec_ngram) \
            if self.spec_k > 0 else None

        # --- host-authoritative per-slot counters ---
        self.lengths = np.zeros(self.max_slots, np.int32)
        self.active = np.zeros(self.max_slots, bool)
        self.last_tokens = np.zeros(self.max_slots, np.int32)
        self._held = set()               # acquired, not yet activated
        self.serving = ServingAggregator(self.max_slots,
                                         label=self.replica or None)
        prefill = f"chunk {self.prefill_chunk}" if self.prefill_chunk \
            else "whole-prompt"
        log_dist(
            f"InferenceEngine initialized: {model_cfg.name} on "
            f"{self.device}, slots={self.max_slots}, cache=paged "
            f"bs={self.block_size} x{self.num_blocks} blocks "
            f"({self.cache_spec.nbytes() / 2 ** 20:.1f} MiB K+V), prefill="
            f"{prefill}, spec_k={self.spec_k}", ranks=[0])

    # ------------------------------------------------------------------ #
    # Slot lifecycle (host counters + block accounting — no device work)
    # ------------------------------------------------------------------ #
    def activate_slot(self, slot: int, context_len: int,
                      last_token: int) -> None:
        """Mark a freshly prefilled slot live: the cache holds positions
        0..context_len-1 and ``last_token`` decodes at position
        context_len next step."""
        self.lengths[slot] = int(context_len)
        self.active[slot] = True
        self.last_tokens[slot] = int(last_token)
        self._held.discard(slot)
        if self.drafter is not None:
            self.drafter.observe(slot, [int(last_token)])

    def release_slot(self, slot: int) -> None:
        """Evict: counters clear and every block reference drops —
        private blocks return to the free list, prefix blocks whose
        refcount hits zero are LRU-retained for future hits."""
        self.active[slot] = False
        self.lengths[slot] = 0
        self.last_tokens[slot] = 0
        self._held.discard(slot)
        row = self.block_tables[slot]
        self.allocator.release(
            slot, [int(b) for b in row if b != kv_cache.DEAD_BLOCK])
        row[:] = kv_cache.DEAD_BLOCK
        if self.drafter is not None:
            self.drafter.reset(slot)

    def context_len(self, slot: int) -> int:
        return int(self.lengths[slot])

    @property
    def active_slots(self) -> int:
        return int(self.active.sum())

    @property
    def spec_enabled(self) -> bool:
        return self.spec_k > 0

    def _ensure_blocks(self, slot: int, upto_pos: int) -> None:
        """Lazily allocate table entries so ``slot`` can write token
        positions up to ``upto_pos``."""
        J = self.cache_spec.max_blocks_per_slot
        need_j = min(upto_pos // self.block_size, J - 1)
        row = self.block_tables[slot]
        j = int((row != kv_cache.DEAD_BLOCK).sum())
        while j <= need_j:
            row[j] = self.allocator.alloc_block(slot)
            j += 1

    # ------------------------------------------------------------------ #
    # Admission: slot occupancy AND pool blocks
    # ------------------------------------------------------------------ #
    def group_of(self, slot: int) -> int:
        """The pool group a slot's blocks live in."""
        return slot // self.cache_spec.slots_per_group

    def select_slot(self, prompt: Sequence[int], max_new_tokens: int = 0,
                    exclude_groups: Optional[set] = None) -> Optional[int]:
        """Pick and HOLD a free slot for this prompt, or None when the
        engine cannot admit it now: a group must cover the request's
        worst-case block need, and among admissible groups the one
        holding the longest cached prefix wins (ties toward the most
        available blocks). Whole-prompt prefill shares no prefix, so it
        counts no match. ``activate_slot``/``release_slot`` end the
        hold."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        free = [s for s in range(self.max_slots)
                if not self.active[s] and s not in self._held]
        if not free:
            return None
        share = self.prefill_chunk > 0
        Sg = self.cache_spec.slots_per_group
        first_free: Dict[int, int] = {}
        for s in free:
            g = s // Sg
            if exclude_groups and g in exclude_groups:
                continue
            first_free.setdefault(g, s)
        best = best_key = None
        for g, s in first_free.items():
            if not self.allocator.can_admit(g, prompt, int(max_new_tokens),
                                            self.spec_k, share=share):
                continue
            matched = len(self.allocator.match_prefix(g, prompt)[0]) \
                if share else 0
            key = (matched, self.allocator.available(g))
            if best_key is None or key > best_key:
                best, best_key = s, key
        if best is not None:
            self._held.add(best)
        return best

    # ------------------------------------------------------------------ #
    # Device operations
    # ------------------------------------------------------------------ #
    def prefill(self, prompt: Sequence[int], slot: int,
                temperature: float = 0.0, return_logits: bool = False,
                max_new_tokens: Optional[int] = None
                ) -> Tuple[int, Optional[np.ndarray]]:
        """Prefill one prompt into ``slot`` and sample its first output
        token. Returns (token, final-position fp32 logits [V] when asked).
        The caller activates the slot."""
        if self.prefill_chunk == 0:
            return self._prefill_whole(prompt, slot, temperature,
                                       return_logits, max_new_tokens)
        return self.prefill_many(
            [(slot, prompt, int(max_new_tokens or 0))], temperature,
            return_logits=return_logits)[0]

    def _check_prompt(self, prompt) -> np.ndarray:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.shape[0] < 1:
            raise ValueError("empty prompt")
        if prompt.shape[0] >= self.max_len:
            raise ValueError(
                f"prompt length {prompt.shape[0]} leaves no room to "
                f"generate in a {self.max_len}-token slot")
        return prompt

    def _prefill_whole(self, prompt, slot: int, temperature: float,
                       return_logits: bool, max_new_tokens: Optional[int]
                       ) -> Tuple[int, Optional[np.ndarray]]:
        """Whole-prompt prefill (``prefill_chunk: 0``): admit through the
        allocator with no prefix sharing, then run the prompt padded to
        the slot's capacity in one causal pass."""
        prompt = self._check_prompt(prompt)
        plen = int(prompt.shape[0])
        J = self.cache_spec.max_blocks_per_slot
        group = slot // self.cache_spec.slots_per_group
        plan = self.allocator.admit_prompt(
            slot, group, prompt, int(max_new_tokens or 0), self.spec_k,
            share=False)
        row = np.full(J, kv_cache.DEAD_BLOCK, np.int32)
        row[:len(plan.table)] = plan.table
        self.block_tables[slot] = row
        padded = np.zeros(self.max_len, np.int32)
        padded[:plen] = prompt
        bt_rows = np.full((self.dp, J), kv_cache.DEAD_BLOCK, np.int32)
        bt_rows[group] = row
        logits = decode_mod.gpt2_prefill_full_paged(
            self._params, self.cache["k"], self.cache["v"],
            torch.from_numpy(padded), torch.from_numpy(bt_rows), plen - 1,
            self.model_cfg)
        tok = int(decode_mod.sample_tokens(logits, self.generator,
                                           temperature))    # the host fetch
        if self.drafter is not None:
            self.drafter.begin(slot, prompt)
        self.serving.note_admit(plen, 0)
        return tok, logits.cpu().numpy() if return_logits else None

    def prefill_many(self, admissions: Sequence[Tuple[int, Any, int]],
                     temperature: float = 0.0, return_logits: bool = False
                     ) -> List[Tuple[int, Optional[np.ndarray]]]:
        """Batched admission: prefill up to ONE slot per pool group in
        one pass of group-batched chunk steps (one slot on one GPU).

        Each prompt is admitted through the block allocator first:
        cached full-block prefixes are shared by refcount (only the tail
        re-prefills), an exactly-matched chain forks its final block
        copy-on-write, and ``max_new_tokens`` books the worst-case
        reservation. Returns [(first token, logits | None)] in admission
        order. Chunked prefill only: a whole-prompt engine admits one
        prompt at a time through ``prefill``."""
        if self.prefill_chunk == 0:
            raise RuntimeError("prefill_many needs chunked prefill; with "
                               "prefill_chunk: 0 admit through prefill()")
        G = self.dp
        J = self.cache_spec.max_blocks_per_slot
        Sg = self.cache_spec.slots_per_group
        chunk = self.prefill_chunk
        plans = []
        seen_groups = set()
        copies = []
        for slot, prompt, max_new in admissions:
            prompt = self._check_prompt(prompt)
            plen = int(prompt.shape[0])
            group = slot // Sg
            if group in seen_groups:
                raise ValueError(
                    f"prefill_many: two admissions in group {group} — "
                    "batch at most one slot per group")
            seen_groups.add(group)
            plan = self.allocator.admit_prompt(
                slot, group, prompt, int(max_new), self.spec_k)
            row = np.full(J, kv_cache.DEAD_BLOCK, np.int32)
            row[:len(plan.table)] = plan.table
            self.block_tables[slot] = row
            if plan.cow_src is not None:
                copies.append((group, plan.cow_src, plan.cow_dst))
            plans.append((slot, group, plan, prompt, plen))
        if copies:
            kv_cache.paged_copy_block(self.cache["k"], copies)
            kv_cache.paged_copy_block(self.cache["v"], copies)
        # Chunk schedule: each admission runs chunks over its unshared
        # tail; groups whose tail is done go inactive.
        tails = []
        for slot, group, plan, prompt, plen in plans:
            tlen = plen - plan.matched
            n_chunks = -(-tlen // chunk)
            padded = np.zeros(n_chunks * chunk, np.int32)
            padded[:tlen] = prompt[plan.matched:]
            tails.append((padded, n_chunks, tlen))
        held = {}                       # slot -> (chunk index, group)
        steps = []                      # per chunk: (tokens [G], logits)
        for ci in range(max(n for _, n, _ in tails)):
            toks = np.zeros((G, chunk), np.int32)
            bt_rows = np.full((G, J), kv_cache.DEAD_BLOCK, np.int32)
            starts = np.zeros(G, np.int32)
            last_idxs = np.zeros(G, np.int32)
            act = np.zeros(G, np.int32)
            for (slot, group, plan, prompt, plen), \
                    (padded, n_chunks, tlen) in zip(plans, tails):
                if ci >= n_chunks:
                    continue
                toks[group] = padded[ci * chunk:(ci + 1) * chunk]
                bt_rows[group] = self.block_tables[slot]
                starts[group] = plan.matched + ci * chunk
                act[group] = 1
                if ci == n_chunks - 1:
                    last_idxs[group] = tlen - 1 - ci * chunk
                    held[slot] = (ci, group)
            logits = decode_mod.gpt2_prefill_chunk_paged(
                self._params, self.cache["k"], self.cache["v"],
                torch.from_numpy(toks), torch.from_numpy(bt_rows),
                torch.from_numpy(starts), torch.from_numpy(last_idxs),
                torch.from_numpy(act), self.model_cfg)
            steps.append((decode_mod.sample_tokens(
                logits, self.generator, temperature), logits))
        out = []
        for slot, group, plan, prompt, plen in plans:
            ci, g = held[slot]
            tok = int(steps[ci][0][g])              # the host fetch
            logits = steps[ci][1][g].cpu().numpy() if return_logits \
                else None
            if self.drafter is not None:
                self.drafter.begin(slot, prompt)
            self.serving.note_admit(plen, plan.matched)
            out.append((tok, logits))
        return out

    def _cache_accounting(self) -> Tuple[int, int]:
        """(cache bytes held, context tokens cached): live blocks only."""
        tokens = int(self.lengths[self.active].sum())
        return self.allocator.bytes_in_use(), tokens

    def decode_once(self, temperature: float = 0.0,
                    return_logits: bool = False
                    ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """One decode iteration for every slot (inactive slots compute
        too, on dead tables; their counters do not advance). Returns the
        sampled token per slot (and the [S, V] logits when asked)."""
        t0 = time.perf_counter()
        n_active = self.active_slots
        for s in np.flatnonzero(self.active):
            self._ensure_blocks(int(s), int(self.lengths[s]))
        logits = decode_mod.gpt2_decode_paged(
            self._params, self.cache["k"], self.cache["v"],
            torch.from_numpy(self.last_tokens),
            torch.from_numpy(self.lengths),
            torch.from_numpy(self.block_tables), self.model_cfg, self.dp)
        sampled = decode_mod.sample_tokens(logits, self.generator,
                                           temperature)
        # THE serving sync: one batched [S] fetch per iteration.
        sampled = sampled.cpu().numpy()
        adv = self.active
        self.lengths[adv] += 1
        self.last_tokens[adv] = sampled[adv]
        if self.drafter is not None:
            for s in np.flatnonzero(adv):
                self.drafter.observe(int(s), [int(sampled[s])])
        wall = time.perf_counter() - t0
        cache_bytes, ctx_tokens = self._cache_accounting()
        self.serving.note_iteration(n_active, wall, cache_bytes=cache_bytes,
                                    context_tokens=ctx_tokens)
        out_logits = logits.cpu().numpy() if return_logits else None
        return sampled, out_logits

    def spec_decode_once(self, temperature: float = 0.0
                         ) -> Tuple[np.ndarray, np.ndarray]:
        """One speculative draft-then-verify iteration for every slot:
        the n-gram drafter proposes ``spec_k`` tokens per live slot, ONE
        batched verify step scores [last, d_1..d_k] through the paged
        cache, and the acceptance rule emits the longest agreeing prefix
        plus the correction/bonus token — greedy-identical to plain
        decode, one host fetch. Returns (emitted [S, k+1] int32, n_new
        [S])."""
        if not self.spec_enabled:
            raise RuntimeError("spec_decode_once needs inference.spec_k > 0")
        if float(temperature) > 0.0:
            raise ValueError(
                "spec_decode_once is greedy-only; use decode_once for "
                "temperature > 0 — the scheduler falls back automatically")
        t0 = time.perf_counter()
        k = self.spec_k
        n_active = self.active_slots
        toks = np.zeros((self.max_slots, k + 1), np.int32)
        toks[:, 0] = self.last_tokens
        live = np.flatnonzero(self.active)
        for s in live:
            s = int(s)
            toks[s, 1:] = self.drafter.propose(s)
            self._ensure_blocks(
                s, min(int(self.lengths[s]) + k, self.max_len - 1))
        tok_t = torch.from_numpy(toks)
        logits = decode_mod.gpt2_verify_paged(
            self._params, self.cache["k"], self.cache["v"], tok_t,
            torch.from_numpy(self.lengths),
            torch.from_numpy(self.block_tables), self.model_cfg, self.dp)
        out = decode_mod.spec_accept(logits, tok_t.to(self.device),
                                     self.generator, temperature)
        out = out.cpu().numpy()                     # [S, k+2], the fetch
        n_new = out[:, 0].copy()
        emitted = out[:, 1:]
        n_new[~self.active] = 0
        accepted = 0
        for s in live:
            s = int(s)
            n = max(0, min(int(n_new[s]),
                           self.max_len - int(self.lengths[s])))
            n_new[s] = n
            if n == 0:
                continue
            self.lengths[s] += n
            self.last_tokens[s] = int(emitted[s, n - 1])
            self.drafter.observe(s, emitted[s, :n])
            accepted += n - 1
        wall = time.perf_counter() - t0
        cache_bytes, ctx_tokens = self._cache_accounting()
        self.serving.note_iteration(n_active, wall, cache_bytes=cache_bytes,
                                    context_tokens=ctx_tokens,
                                    emitted_tokens=int(n_new.sum()))
        self.serving.note_spec(k * len(live), accepted)
        return emitted, n_new

    def reset_serving_stats(self) -> None:
        """Fresh aggregator window (after a warmup pass)."""
        self.serving = ServingAggregator(self.max_slots,
                                         label=self.replica or None)

    def complete_request(self, rid: Any, ttft_s: float,
                         tpot_s: Optional[float], prompt_tokens: int,
                         new_tokens: int,
                         queue_wait_s: Optional[float] = None,
                         service_ttft_s: Optional[float] = None,
                         admission_attempts: Optional[int] = None) -> None:
        """Per-request accounting at completion (host clocks only)."""
        self.serving.note_request(ttft_s, tpot_s, new_tokens,
                                  queue_wait_s=queue_wait_s,
                                  service_ttft_s=service_ttft_s,
                                  admission_attempts=admission_attempts)

    def serve(self, requests, temperature: float = 0.0, **kwargs):
        """Drive a request list through the continuous-batching
        scheduler; see inference/scheduler.py."""
        from .scheduler import ContinuousBatchingScheduler
        sched = ContinuousBatchingScheduler(self, temperature=temperature,
                                            **kwargs)
        return sched.serve(requests)


__all__ = ["InferenceEngine", "prepare_params"]
