"""InferenceEngine — batched autoregressive serving of GPT-2 (port of
``deepspeed_tpu/inference/engine.py``).

- Three device operations serve everything: prefill — chunked or, with
  ``prefill_chunk: 0``, whole-prompt (one admission at a time and no
  prefix sharing, as in the JAX engine) — ``decode_once`` (one token for
  every slot) and, with ``spec_k > 0``, ``spec_decode_once``
  (draft-then-verify). All of them run the port's kernels on a CUDA
  device: paged attention (flash attention for whole-prompt prefill),
  LayerNorm, bias+GELU.
- The KV cache is allocated once and updated in place: the paged block
  pool (``block_size > 0``: allocator, prefix sharing, copy-on-write),
  or the slot-major layout (``block_size: 0``: every slot reserves
  ``max_len`` rows, stored as consecutive blocks of a pool behind a
  fixed identity table, so the same kernels serve it). One GPU means
  one pool group (dp = 1, mp = 1).
- Weights (``inference.quantize``): ``bf16`` stores stochastically
  rounded bf16 leaves; ``int8`` stores ``{"q", "scale"}`` leaves and
  dequantizes the whole tree to the compute dtype at the top of each
  device operation (int8 at rest, compute-dtype weights only as that
  call's transient), as the JAX programs dequantize in-program.
- Host-side per-slot counters (lengths, active, last token) and the
  block tables are the scheduler's state; they enter each step as small
  host tensors. The one device fetch per iteration is the sampled-token
  readback — the host must see tokens to detect EOS and feed the next
  step.
- ``ServingAggregator`` accounts TTFT/TPOT/occupancy/tokens per second
  on host clocks, with the goodput ledger always attached and the SLO
  tracker when ``inference.slo`` sets a target (``monitor/
  serving_slo.py``); the ledger's walls are the ones the aggregator
  already measures, so it adds no device sync.
- Telemetry (a ``telemetry`` block, or its ``tensorboard`` alias) rides
  the training engine's spine (``monitor/telemetry.py``): a ``meta``
  record with the serving geometry and the analytic attend pricing, a
  ``step`` record a decode iteration, ``report`` records carrying the
  aggregator's snapshot, ``admission_rejected`` / ``request_complete`` /
  ``request_abort`` events, and the scheduler's and router's
  ``request_trace`` events (``monitor/request_trace.py``). The decode,
  prefill, copy-block and verify steps run through the recompile
  sentinel. None of it reads the device: a decode step makes the same
  host syncs with telemetry on and off.

``from_train_checkpoint`` builds the engine from a training
checkpoint's model file (the port's or the JAX engine's: the same
files, runtime/flax_msgpack.py). ``inference/router.py`` routes one
request stream over several engines.

``profile_window`` arms a ``torch.profiler`` capture of the next decode
iterations (``decode_once`` and ``spec_decode_once`` tick it first), and
the report boundary ingests it into the ``profile`` event
(monitor/profile_ingest.py).

Tensor and sequence parallelism (``mesh=`` a ``parallel.topology.
build_mesh`` grid, or the config's ``mesh`` block; ``param_shardings``,
e.g. ``gpt2_param_shardings(cfg)``): at mp N x dp 1 each of N processes
holds its parts of the weights and its heads' K/V pools
(``inference/decode.py``); every rank runs the same scheduler on the
same request stream, the host deciding admission, blocks and sampling
(the ranks' generators draw in step), so the ranks stay in step and rank
0 reports. At sp > 1 the whole-prompt prefill (``prefill_chunk: 0``)
runs the ring (``ops/ring_attention.py``) and decode stays replicated
over sp.

Not ported: dp > 1 serving meshes (ROADMAP queue 1 item 7). Not
planned: serving a tensor-parallel training tag through
``from_train_checkpoint`` (the JAX engine refuses it too).
Not planned: ``lint_audit``, which lints XLA's jaxpr and optimized HLO;
the port has neither.
``paged_kernel: false`` and
``fused_kernels: False`` raise on a CUDA device, where the port has only
its kernels.
"""
from __future__ import annotations

import functools
import json
import os
import time
import weakref
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import decode as decode_mod
from . import kv_cache
from .quantize import (dequantize, is_quantized_leaf, quantize_params,
                       quantized_bytes, resolve_kv_dtype)
from .spec import NGramDrafter
from ..models.gpt2 import (VOCAB_LEAVES, GPT2Config, gpt2_init,
                           gpt2_param_shardings)
from ..models.transformer import QKV_LEAVES
from ..monitor.memory import analytic_state_bytes
from ..monitor.serving import ServingAggregator
from ..monitor.serving_slo import ServingGoodputLedger, SLOTracker
from ..monitor.telemetry import Telemetry
from ..ops import paged_attention as paged_attn_ops
from ..parallel import tensor_parallel as tpm
from ..parallel.topology import build_mesh
from ..runtime.config import InferenceConfig, MeshConfig, TelemetryConfig
from ..runtime.config_utils import load_config_json
from ..runtime.flax_msgpack import msgpack_restore
from ..utils.device import resolve_device
from ..utils.logging import log_dist


def _leaves(tree: Any) -> List[Any]:
    """Every tensor of a nested dict (quantized ``{"q", "scale"}`` leaves
    included)."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [tree]


def _copy_blocks(k_pool: torch.Tensor, v_pool: torch.Tensor,
                 copies: Sequence[Tuple[int, int, int]]) -> None:
    """The copy-on-write forks of one admission batch, K and V planes."""
    kv_cache.paged_copy_block(k_pool, copies)
    kv_cache.paged_copy_block(v_pool, copies)


# Leaves the serving path casts to the compute dtype at every use: the
# embeddings, the matmul kernels and the biases ``dense`` adds. The
# LayerNorm parameters and the FFN bias feed the kernels in fp32.
_COMPUTE_DTYPE_LEAVES = ("wte", "wpe", "qkv_bias", "proj_bias",
                         "fc_out_bias")


def prepare_params(params: Dict[str, Any], dtype: torch.dtype,
                   device: torch.device, cast: bool = True
                   ) -> Dict[str, Any]:
    """The serving copy of a GPT-2 param tree on ``device``. With
    ``cast``, the leaves every step would cast to the compute dtype are
    cast once (the JAX programs cast them at every use; casting once
    gives the same values and saves a copy kernel per leaf per layer per
    step); the leaves the kernels read in fp32 are widened once where
    they are narrower. ``{"q", "scale"}`` leaves stay as they are."""
    def leaf(name, t):
        if is_quantized_leaf(t):
            return {k: torch.as_tensor(v).to(device).contiguous()
                    for k, v in t.items()}
        t = torch.as_tensor(t).to(device)
        if name.endswith("_kernel") or name in _COMPUTE_DTYPE_LEAVES:
            if cast:
                t = t.to(dtype)
        elif t.is_floating_point() and t.element_size() < 4:
            t = t.float()
        return t.contiguous()

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) and
                not is_quantized_leaf(v) else leaf(k, v)
                for k, v in tree.items()}
    return walk(params)


class InferenceEngine:
    """Batched autoregressive serving on one device, or one process a
    rank of a tensor/sequence-parallel grid."""

    def __init__(self, model_cfg: GPT2Config, params: Dict[str, Any],
                 config: Union[None, str, Dict[str, Any]] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 seed: int = 17, param_shardings: Any = None,
                 mesh: Any = None):
        if isinstance(config, str):
            config = load_config_json(config)
        config = dict(config or {})
        self.model_cfg = model_cfg
        self.icfg = InferenceConfig(config)
        self.device = resolve_device(device)
        on_cuda = self.device.type == "cuda"
        self.grid = mesh
        if mesh is None:
            mc = MeshConfig(config)
            if mc.model_parallel_size > 1 or mc.sequence_parallel_size > 1:
                self.grid = build_mesh(mp=mc.model_parallel_size,
                                       sp=mc.sequence_parallel_size)
        self.sp = 1 if self.grid is None else \
            int(self.grid.seq_parallel_size)
        if self.grid is not None and self.grid.data_parallel_size > 1:
            raise NotImplementedError(
                f"a serving mesh with dp {self.grid.data_parallel_size} > "
                "1 (slot groups spread over dp processes under one "
                "scheduler) is not ported yet (ROADMAP queue 1 item 7)")

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
        if self.prefill_chunk == 0 and self.sp > 1 \
                and self.max_len % self.sp:
            raise ValueError(
                f"whole-prompt prefill with a seq axis needs max_seq_len "
                f"({self.max_len}) divisible by sp={self.sp}")
        self.block_size = int(self.icfg.block_size)
        self.paged = self.block_size > 0
        if self.paged and self.max_len % self.block_size:
            raise ValueError(
                f"inference.block_size={self.block_size} must divide "
                f"inference.max_seq_len ({self.max_len}); set "
                "block_size: 0 for the slot-major layout")
        if on_cuda and self.icfg.paged_kernel is False:
            raise NotImplementedError(
                "inference.paged_kernel: false has no CUDA path in the "
                "port — the paged-attention kernel is its only attend")
        if on_cuda and model_cfg.fused_kernels is False:
            raise NotImplementedError(
                "fused_kernels=False has no CUDA path in the port — the "
                "LayerNorm and bias+GELU kernels are its only ones")
        self.tcfg = TelemetryConfig(config)
        self.spec_k = int(self.icfg.spec_k)
        self.replica = str(self.icfg.replica)
        self.dp = 1
        self.num_blocks = int(self.icfg.num_blocks)
        if self.paged and self.num_blocks == 0:
            # Full provisioning: every slot can reach max_len.
            self.num_blocks = self.max_slots * \
                (self.max_len // self.block_size)

        # --- weights: quantize the tree as given, leaf by leaf on the
        # device, then the serving copy ---
        self.quantize = self.icfg.quantize
        self.seed = int(seed)
        if self.quantize != "none" and param_shardings is not None:
            raise NotImplementedError(
                "inference.quantize does not compose with tensor-parallel "
                "param_shardings yet (quantized leaves change the tree "
                "structure the specs address)")
        self._tp = None
        if self.grid is not None and param_shardings is not None and \
                self.grid.model_parallel_size > 1:
            # (this rank's parts: the decode program's GPT-2 placement)
            params, self._tp, _, _ = tpm.shard_params(
                params, param_shardings, self.grid,
                vocab_leaves=VOCAB_LEAVES, qkv_leaves=QKV_LEAVES,
                own=gpt2_param_shardings(model_cfg))
        params = quantize_params(
            params, self.quantize,
            torch.Generator(device=self.device).manual_seed(self.seed),
            device=self.device)
        self._params = prepare_params(params, model_cfg.dtype, self.device,
                                      cast=self.quantize == "none")
        self.param_bytes = quantized_bytes(self._params)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self.seed)

        # --- the KV cache: the paged block pool, or the slot-major rows
        # stored as a pool behind a fixed identity table ---
        kv_dtype = resolve_kv_dtype(self.icfg.kv_cache_dtype,
                                    model_cfg.dtype)
        # (under tensor parallelism a rank's pools hold its heads)
        heads = model_cfg.num_heads if self._tp is None else \
            self._tp.local(model_cfg.num_heads, "num_heads")
        if self.paged:
            self.cache_spec = kv_cache.PagedKVCacheSpec(
                num_layers=model_cfg.num_layers, num_slots=self.max_slots,
                num_blocks=self.num_blocks, block_size=self.block_size,
                max_len=self.max_len, num_heads=heads,
                head_dim=model_cfg.head_dim, num_groups=self.dp,
                dtype=kv_dtype)
            self.cache = kv_cache.init_paged_cache(self.cache_spec,
                                                   self.device)
            self.allocator = kv_cache.BlockAllocator(self.cache_spec)
            self.block_tables = np.full(
                (self.max_slots, self.cache_spec.max_blocks_per_slot),
                kv_cache.DEAD_BLOCK, np.int32)
            self._price_attend()
        else:
            self.cache_spec = kv_cache.KVCacheSpec(
                num_layers=model_cfg.num_layers, num_slots=self.max_slots,
                num_heads=heads, max_len=self.max_len,
                head_dim=model_cfg.head_dim, dtype=kv_dtype)
            self.cache = kv_cache.init_cache(self.cache_spec, self.device)
            self.allocator = None
            self.block_tables = None
            self._slot_tables = self.cache_spec.slot_tables()
        self.drafter = NGramDrafter(self.spec_k, self.icfg.spec_ngram) \
            if self.spec_k > 0 else None

        # --- host-authoritative per-slot counters ---
        self.lengths = np.zeros(self.max_slots, np.int32)
        self.active = np.zeros(self.max_slots, bool)
        self.last_tokens = np.zeros(self.max_slots, np.int32)
        self._held = set()               # acquired, not yet activated
        # Why the latest select_slot returned None: "no_slot" (every slot
        # busy) or "reservation" (the pool cannot book the request).
        self.last_admit_block: Optional[str] = None
        # Prefix-cache/CoW detail of each slot's latest admission (the
        # request trace's prefill span).
        self._last_admit: Dict[int, Dict[str, Any]] = {}
        self.reset_serving_stats()
        self.iterations = 0
        self._build_telemetry()
        prefill = f"chunk {self.prefill_chunk}" if self.prefill_chunk \
            else "whole-prompt"
        layout = (f"paged bs={self.block_size} x{self.num_blocks} blocks"
                  if self.paged else "slot-major")
        log_dist(
            f"InferenceEngine initialized: {model_cfg.name} on "
            f"{self.device}, slots={self.max_slots}, cache={layout} "
            f"({self.cache_spec.nbytes() / 2 ** 20:.1f} MiB K+V), prefill="
            f"{prefill}, spec_k={self.spec_k}, quantize={self.quantize}"
            + (f", replica={self.replica}" if self.replica else ""),
            ranks=[0])

    def _build_telemetry(self) -> None:
        """The serving telemetry on the shared spine, and the step paths
        through its recompile sentinel (identities with telemetry off).
        The serving engine builds no cost model (as in JAX), so its
        sentinel walks no path through the flops profiler."""
        cfg = self.model_cfg
        meta = dict(mode="serving", model=cfg.name, dp=self.dp, mp=1,
                    sp=1, max_slots=self.max_slots, max_seq_len=self.max_len,
                    prefill_chunk=self.prefill_chunk,
                    block_size=self.block_size,
                    num_blocks=self.num_blocks if self.paged else 0,
                    spec_k=self.spec_k, replica=self.replica,
                    quantize=self.quantize,
                    precision=str(cfg.dtype).replace("torch.", ""),
                    param_bytes=self.param_bytes,
                    kv_cache_bytes=self.cache_spec.nbytes())
        if self.paged:
            # Analytic attend pricing per generated token at the bounds:
            # the kernel's term scales with live context (quoted at
            # max_seq_len), the one-hot term with pool capacity.
            sp_ = self.cache_spec
            kw = dict(num_layers=sp_.num_layers)
            args = (sp_.num_heads, sp_.head_dim, sp_.block_size)
            kvi = sp_.itemsize()
            meta["paged_kernel"] = True
            meta["attend_flops_per_token"] = {
                "live_ctx_max": paged_attn_ops.attend_flops_per_token(
                    *args, context=sp_.max_len, **kw),
                "pool_capacity": paged_attn_ops.attend_flops_per_token(
                    *args, pool_blocks=sp_.blocks_per_group, **kw),
                "projection": "analytic"}
            meta["attend_hbm_bytes_per_token"] = {
                "live_ctx_max": paged_attn_ops.attend_hbm_bytes_per_token(
                    *args, context=sp_.max_len, kv_itemsize=kvi, **kw),
                "pool_capacity": paged_attn_ops.attend_hbm_bytes_per_token(
                    *args, pool_blocks=sp_.blocks_per_group,
                    kv_itemsize=kvi, **kw),
                "projection": "analytic"}
        tl = Telemetry(self.tcfg, default_report_steps=50, meta=meta,
                       device=self.device)
        if tl.sentinel is not None:
            tl.sentinel.walk_fn = None
        ref = weakref.ref(self)
        tl.step_provider = lambda: (ref().iterations if ref() is not None
                                    else -1)
        tl.set_analytic_footprint(analytic_state_bytes(
            _leaves({"params": self._params, "cache": self.cache})))
        self.telemetry = tl
        # The device paths: decode and prefill always; paged engines add
        # the copy-on-write block copy and, with spec_k > 0, the verify.
        # (the rank's tensor-parallel program; the ring for a whole-prompt
        # prefill at sp > 1)
        bind = functools.partial
        self._decode_fn = tl.instrument_step_fn(
            "decode_step", bind(decode_mod.gpt2_decode_paged, tp=self._tp))
        if self.prefill_chunk:
            prefill = bind(decode_mod.gpt2_prefill_chunk_paged, tp=self._tp)
        else:
            ring = None
            if self.sp > 1:
                from ..ops.ring_attention import ring_attention_fn
                ring = ring_attention_fn(self.grid)
            prefill = bind(decode_mod.gpt2_prefill_full_paged,
                         attention_fn=ring, tp=self._tp)
        self._prefill_fn = tl.instrument_step_fn("prefill_step", prefill)
        if self.paged:
            self._copy_fn = tl.instrument_step_fn("copy_block", _copy_blocks)
        if self.paged and self.spec_k > 0:
            self._verify_fn = tl.instrument_step_fn(
                "verify_step",
                bind(decode_mod.gpt2_verify_paged, tp=self._tp))

    def _runtime_params(self) -> Dict[str, Any]:
        """The weights one device operation computes with: under int8 the
        whole tree dequantized to the compute dtype (a transient of the
        call), else the stored tree."""
        if self.quantize == "int8":
            dtype = self.model_cfg.dtype
            return prepare_params(dequantize(self._params, dtype), dtype,
                                  self.device)
        return self._params

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
        """Evict: counters clear and (paged) every block reference drops
        — private blocks return to the free list, prefix blocks whose
        refcount hits zero are LRU-retained for future hits."""
        self.active[slot] = False
        self.lengths[slot] = 0
        self.last_tokens[slot] = 0
        self._held.discard(slot)
        if self.paged:
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

    def _decode_tables(self) -> np.ndarray:
        """The [S, J] tables a decode step reads: the allocator's rows, or
        (slot-major) each active slot's identity row and dead rows for
        the idle slots, which then write and attend nothing."""
        if self.paged:
            return self.block_tables
        return np.where(self.active[:, None], self._slot_tables,
                        kv_cache.DEAD_BLOCK).astype(np.int32)

    # ------------------------------------------------------------------ #
    # Admission: slot occupancy AND pool blocks
    # ------------------------------------------------------------------ #
    def group_of(self, slot: int) -> int:
        """The pool group a slot's blocks live in."""
        return slot // self.cache_spec.slots_per_group if self.paged \
            else 0

    def select_slot(self, prompt: Sequence[int], max_new_tokens: int = 0,
                    exclude_groups: Optional[set] = None) -> Optional[int]:
        """Pick and HOLD a free slot for this prompt, or None when the
        engine cannot admit it now. Slot-major: the first free slot.
        Paged: a group must cover the request's worst-case block need,
        and among admissible groups the one holding the longest cached
        prefix wins (ties toward the most available blocks); whole-prompt
        prefill shares no prefix, so it counts no match.
        ``activate_slot``/``release_slot`` end the hold."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        self.last_admit_block = None
        free = [s for s in range(self.max_slots)
                if not self.active[s] and s not in self._held]
        if not free:
            self.last_admit_block = "no_slot"
            return None
        if not self.paged:
            self._held.add(free[0])
            return free[0]
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
        else:
            self.last_admit_block = "reservation"
        return best

    def last_admit_info(self, slot: int) -> Dict[str, Any]:
        """Prefix-cache/CoW detail of the most recent admission into
        ``slot`` (for the request trace); empty where no chunked paged
        prefill admitted it."""
        return self._last_admit.get(slot, {})

    def note_admission_reject(self, rid: Any, reason: str, attempt: int,
                              queue_depth: int = 0) -> None:
        """Count one admission rejection; a request's FIRST rejection
        also writes an ``admission_rejected`` telemetry event."""
        self.serving.note_reject()
        if attempt == 1 and self.telemetry.enabled:
            payload = {"rid": rid, "reason": reason,
                       "queue_depth": int(queue_depth)}
            if self.replica:
                payload["replica"] = self.replica
            self.telemetry.event("admission_rejected", payload)

    def prefix_match_tokens(self, prompt: Sequence[int]) -> int:
        """Longest cached prompt prefix (tokens) resident anywhere in
        this engine's block pool — the router's affinity signal. Host
        hash walk only; 0 where nothing is shared (slot-major, or
        whole-prompt prefill)."""
        if not self.paged or self.prefill_chunk == 0:
            return 0
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        best = 0
        for g in range(self.dp):
            best = max(best,
                       len(self.allocator.match_prefix(g, prompt)[0]))
        return best * self.block_size

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
        if not self.paged:
            return self._prefill_slot_major(prompt, slot, temperature,
                                            return_logits)
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

    def _note_prefill(self, t0: float) -> None:
        self.serving.ledger.note("prefill", time.perf_counter() - t0)

    def _prefill_slot_major(self, prompt, slot: int, temperature: float,
                            return_logits: bool
                            ) -> Tuple[int, Optional[np.ndarray]]:
        """Slot-major prefill into the slot's own rows: the whole padded
        prompt in one causal pass (``prefill_chunk: 0``), or chunk after
        chunk from position 0 (no prefix to share)."""
        t0 = time.perf_counter()
        prompt = self._check_prompt(prompt)
        plen = int(prompt.shape[0])
        p = self._runtime_params()
        row = self._slot_tables[slot][None]                  # [1, J]
        if self.prefill_chunk == 0:
            padded = np.zeros(self.max_len, np.int32)
            padded[:plen] = prompt
            logits = self._prefill_fn(
                p, self.cache["k"], self.cache["v"],
                torch.from_numpy(padded), torch.from_numpy(row), plen - 1,
                self.model_cfg)
        else:
            chunk = self.prefill_chunk
            n_chunks = -(-plen // chunk)
            padded = np.zeros(n_chunks * chunk, np.int32)
            padded[:plen] = prompt
            for ci in range(n_chunks):
                start = ci * chunk
                last = (plen - 1 - start) if ci == n_chunks - 1 else 0
                logits = self._prefill_fn(
                    p, self.cache["k"], self.cache["v"],
                    torch.from_numpy(padded[start:start + chunk][None]),
                    torch.from_numpy(row), torch.tensor([start]),
                    torch.tensor([last]), torch.tensor([1]),
                    self.model_cfg)[0]
        self.telemetry.raise_pending()
        tok = int(decode_mod.sample_tokens(logits, self.generator,
                                           temperature))    # the host fetch
        self._note_prefill(t0)
        return tok, logits.cpu().numpy() if return_logits else None

    def _prefill_whole(self, prompt, slot: int, temperature: float,
                       return_logits: bool, max_new_tokens: Optional[int]
                       ) -> Tuple[int, Optional[np.ndarray]]:
        """Whole-prompt prefill (``prefill_chunk: 0``): admit through the
        allocator with no prefix sharing, then run the prompt padded to
        the slot's capacity in one causal pass."""
        t0 = time.perf_counter()
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
        logits = self._prefill_fn(
            self._runtime_params(), self.cache["k"], self.cache["v"],
            torch.from_numpy(padded), torch.from_numpy(bt_rows), plen - 1,
            self.model_cfg)
        self.telemetry.raise_pending()
        tok = int(decode_mod.sample_tokens(logits, self.generator,
                                           temperature))    # the host fetch
        if self.drafter is not None:
            self.drafter.begin(slot, prompt)
        self.serving.note_admit(plen, 0)
        self._note_prefill(t0)
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
        order. Paged chunked prefill only: other engines admit one
        prompt at a time through ``prefill``."""
        if not (self.paged and self.prefill_chunk > 0):
            raise RuntimeError("prefill_many needs the paged cache and "
                               "chunked prefill")
        t0 = time.perf_counter()
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
            self._copy_fn(self.cache["k"], self.cache["v"], copies)
        # Chunk schedule: each admission runs chunks over its unshared
        # tail; groups whose tail is done go inactive.
        tails = []
        for slot, group, plan, prompt, plen in plans:
            tlen = plen - plan.matched
            n_chunks = -(-tlen // chunk)
            padded = np.zeros(n_chunks * chunk, np.int32)
            padded[:tlen] = prompt[plan.matched:]
            tails.append((padded, n_chunks, tlen))
            self._last_admit[slot] = {
                "cached_tokens": int(plan.matched), "chunks": n_chunks,
                "cow_fork": plan.cow_src is not None}
        p = self._runtime_params()
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
            logits = self._prefill_fn(
                p, self.cache["k"], self.cache["v"],
                torch.from_numpy(toks), torch.from_numpy(bt_rows),
                torch.from_numpy(starts), torch.from_numpy(last_idxs),
                torch.from_numpy(act), self.model_cfg)
            steps.append((decode_mod.sample_tokens(
                logits, self.generator, temperature), logits))
        del p
        self.telemetry.raise_pending()
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
        self._note_prefill(t0)
        return out

    def _cache_accounting(self) -> Tuple[int, int]:
        """(cache bytes held, context tokens cached): the live blocks of
        the paged pool; slot-major reserves the whole cache whatever the
        contexts hold."""
        tokens = int(self.lengths[self.active].sum())
        if self.paged:
            return self.allocator.bytes_in_use(), tokens
        return self.cache_spec.nbytes(), tokens

    def _price_attend(self) -> None:
        """The attend cost model's terms, priced once per engine: one
        block of keys for the kernel's live-context term, and the
        pool-capacity (one-hot) terms."""
        sp_ = self.cache_spec
        kw = dict(num_layers=sp_.num_layers)
        args = (sp_.num_heads, sp_.head_dim, sp_.block_size)
        kvi = sp_.itemsize()
        self._attend_block = (
            paged_attn_ops.attend_flops_per_token(*args, context=1, **kw),
            paged_attn_ops.attend_hbm_bytes_per_token(
                *args, context=1, kv_itemsize=kvi, **kw))
        self._attend_pool = (
            paged_attn_ops.attend_flops_per_token(
                *args, pool_blocks=sp_.blocks_per_group, **kw)
            * self.max_slots,
            paged_attn_ops.attend_hbm_bytes_per_token(
                *args, pool_blocks=sp_.blocks_per_group, kv_itemsize=kvi,
                **kw) * sp_.num_groups)

    def _attend_work(self, k_rows: int) -> Tuple[int, int, int, int]:
        """Analytic attend work of the iteration just run, priced both
        ways: (flops_kernel, flops_onehot, bytes_kernel, bytes_onehot).
        Kernel terms sum each live slot's ceil(ctx/bs) blocks of keys
        (the K query rows share the block loads); one-hot terms (the JAX
        package's plain attend) score the whole pool for every slot.
        Host arithmetic, no device work."""
        bs = self.block_size
        ctxs = np.maximum(self.lengths[self.active], 1)
        blocks = int(((ctxs + bs - 1) // bs).sum())
        (f_blk, b_blk), (f_pool, b_pool) = self._attend_block, \
            self._attend_pool
        return blocks * f_blk * k_rows, f_pool * k_rows, blocks * b_blk, \
            b_pool

    def decode_once(self, temperature: float = 0.0,
                    return_logits: bool = False
                    ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """One decode iteration for every slot (inactive slots compute
        too, on dead tables; their counters do not advance). Returns the
        sampled token per slot (and the [S, V] logits when asked)."""
        t0 = time.perf_counter()
        self.telemetry.profiler_tick(self.iterations)
        n_active = self.active_slots
        if self.paged:
            for s in np.flatnonzero(self.active):
                self._ensure_blocks(int(s), int(self.lengths[s]))
        logits = self._decode_fn(
            self._runtime_params(), self.cache["k"], self.cache["v"],
            torch.from_numpy(self.last_tokens),
            torch.from_numpy(self.lengths),
            torch.from_numpy(self._decode_tables()), self.model_cfg,
            self.dp)
        self.telemetry.raise_pending()
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
        self.iterations += 1
        cache_bytes, ctx_tokens = self._cache_accounting()
        self.serving.note_iteration(n_active, wall, cache_bytes=cache_bytes,
                                    context_tokens=ctx_tokens)
        self.serving.ledger.note("decode_useful", wall)
        if self.paged and n_active:
            self.serving.note_attend(*self._attend_work(1), n_active)
        self._record_iteration(wall, n_active, n_active)
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
            raise RuntimeError("spec_decode_once needs inference.spec_k "
                               "> 0 and the paged cache")
        if float(temperature) > 0.0:
            raise ValueError(
                "spec_decode_once is greedy-only; use decode_once for "
                "temperature > 0 — the scheduler falls back automatically")
        t0 = time.perf_counter()
        self.telemetry.profiler_tick(self.iterations)
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
        logits = self._verify_fn(
            self._runtime_params(), self.cache["k"], self.cache["v"], tok_t,
            torch.from_numpy(self.lengths),
            torch.from_numpy(self.block_tables), self.model_cfg, self.dp)
        self.telemetry.raise_pending()
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
        emitted_total = int(n_new.sum())
        wall = time.perf_counter() - t0
        self.iterations += 1
        cache_bytes, ctx_tokens = self._cache_accounting()
        self.serving.note_iteration(n_active, wall, cache_bytes=cache_bytes,
                                    context_tokens=ctx_tokens,
                                    emitted_tokens=emitted_total)
        # The verify wall split by row share: of the (k+1) rows per live
        # slot, the emitted tokens are useful work, the rejected drafts
        # wall the draft caused and the target threw away.
        rows = (k + 1) * len(live)
        wasted = wall * (k * len(live) - accepted) / rows if rows else 0.0
        self.serving.ledger.note("spec_wasted", wasted)
        self.serving.ledger.note("decode_useful", wall - wasted)
        if n_active and emitted_total:
            self.serving.note_attend(*self._attend_work(k + 1),
                                     emitted_total)
        self.serving.note_spec(k * len(live), accepted)
        self._record_iteration(wall, n_active, emitted_total,
                               spec_accepted=accepted)
        return emitted, n_new

    def _record_iteration(self, wall: float, n_active: int, tokens: int,
                          **extra: Any) -> None:
        """The iteration's ``step`` record (host fields only) and, at a
        report boundary, the drain with the aggregator's snapshot."""
        tl = self.telemetry
        if not tl.enabled:
            return
        tl.record_step(self.iterations, {}, wall_ms=wall * 1e3,
                       active_slots=n_active,
                       occupancy=round(n_active / self.max_slots, 4),
                       tokens=tokens, **extra)
        tl.maybe_drain(self.iterations, extra_fn=self._report_extra)

    # ------------------------------------------------------------------ #
    # Serving accounting
    # ------------------------------------------------------------------ #
    def _attach_slo_overlays(self) -> None:
        """Attach the goodput ledger (always — host arithmetic) and,
        when ``inference.slo`` sets a target, the SLO tracker."""
        self.serving.ledger = ServingGoodputLedger(
            label=self.replica or None)
        scfg = self.icfg.slo
        if scfg.enabled:
            self.serving.slo = SLOTracker(
                ttft_ms=scfg.ttft_ms, tpot_ms=scfg.tpot_ms,
                availability=scfg.availability, window_s=scfg.window_s)

    def reset_serving_stats(self) -> None:
        """Fresh aggregator window (after a warmup pass), with its
        overlays."""
        self.serving = ServingAggregator(self.max_slots,
                                         label=self.replica or None)
        if self.paged:
            # The attend that runs: the table-driven kernel (its plain
            # version on CPU tensors computes the same function).
            self.serving.attend_mode = "kernel"
        self._attach_slo_overlays()

    def complete_request(self, rid: Any, ttft_s: float,
                         tpot_s: Optional[float], prompt_tokens: int,
                         new_tokens: int,
                         queue_wait_s: Optional[float] = None,
                         service_ttft_s: Optional[float] = None,
                         admission_attempts: Optional[int] = None) -> None:
        """Per-request accounting at completion (host clocks only): the
        aggregator and the SLO tracker."""
        self.serving.note_request(ttft_s, tpot_s, new_tokens,
                                  queue_wait_s=queue_wait_s,
                                  service_ttft_s=service_ttft_s,
                                  admission_attempts=admission_attempts)
        if self.serving.slo is not None:
            self.serving.slo.observe(ttft_s, tpot_s)
        if self.telemetry.enabled:
            payload = {"rid": rid, "ttft_ms": round(ttft_s * 1e3, 3),
                       "prompt_tokens": int(prompt_tokens),
                       "new_tokens": int(new_tokens)}
            if tpot_s is not None:
                payload["tpot_ms"] = round(tpot_s * 1e3, 3)
            if queue_wait_s is not None:
                payload["queue_wait_ms"] = round(queue_wait_s * 1e3, 3)
            if service_ttft_s is not None:
                payload["service_ttft_ms"] = round(service_ttft_s * 1e3, 3)
            if admission_attempts:
                payload["admission_attempts"] = int(admission_attempts)
            if self.replica:
                payload["replica"] = self.replica
            self.telemetry.event("request_complete", payload)

    def abort_request(self, rid: Any, reason: str = "abort") -> None:
        """An aborted or starved request: counts against the SLO's
        availability and writes a ``request_abort`` event."""
        if self.serving.slo is not None:
            self.serving.slo.observe_failure()
        if self.telemetry.enabled:
            payload = {"rid": rid, "reason": reason}
            if self.replica:
                payload["replica"] = self.replica
            self.telemetry.event("request_abort", payload)

    def serve(self, requests, temperature: float = 0.0, **kwargs):
        """Drive a request list through the continuous-batching
        scheduler; see inference/scheduler.py."""
        from .scheduler import ContinuousBatchingScheduler
        sched = ContinuousBatchingScheduler(self, temperature=temperature,
                                            **kwargs)
        return sched.serve(requests)

    def _report_extra(self) -> Dict[str, Any]:
        return {"serving": self.serving.snapshot()}

    def profile_window(self, steps: int,
                       start_step: Optional[int] = None) -> Optional[str]:
        """Arm a ``torch.profiler`` capture over ``steps`` decode
        iterations (default: starting at the next iteration). The trace
        is ingested at the next telemetry drain (``telemetry.profile``
        block); with telemetry off this is a no-op returning None.
        Returns the capture dir. No host sync is added outside the
        window."""
        return self.telemetry.arm_profile_window(
            int(steps), start_step=self.iterations + 1
            if start_step is None else int(start_step))

    def close(self) -> None:
        """Close the telemetry sink (the ``final`` record)."""
        self.telemetry.close()

    # ------------------------------------------------------------------ #
    # Training-checkpoint handoff
    # ------------------------------------------------------------------ #
    @classmethod
    def from_train_checkpoint(cls, load_dir: str, model_cfg: GPT2Config,
                              config: Union[None, str, Dict[str, Any]] = None,
                              tag: Optional[str] = None,
                              device: Optional[Union[str, torch.device]]
                              = None, seed: int = 17) -> "InferenceEngine":
        """A serving engine from a training engine's checkpoint directory
        (the tag ``latest`` names, or ``tag``): its
        ``mp_rank_00_model_states.msgpack``, written by the port's or
        the JAX engine. Every leaf of the GPT-2 tree for ``model_cfg``
        must be there with its shape (the tree is made on the meta
        device: no init runs)."""
        if tag is None:
            latest = os.path.join(load_dir, "latest")
            if not os.path.isfile(latest):
                raise FileNotFoundError(f"no 'latest' pointer in {load_dir}")
            with open(latest) as f:
                tag = f.read().strip()
        path = os.path.join(load_dir, str(tag))
        model_file = os.path.join(path, "mp_rank_00_model_states.msgpack")
        meta_file = os.path.join(path, "engine_meta.json")
        sharded = False
        if os.path.isfile(meta_file):
            with open(meta_file) as f:
                sharded = bool(json.load(f).get("mp_shards"))
        if sharded or not os.path.isfile(model_file):
            # (not planned: the JAX engine refuses these tags too)
            raise NotImplementedError(
                f"{path} holds TP-sharded (mp_rank_XX) model files, which "
                "need assembly: load them through the training engine and "
                "pass raw params instead (the JAX engine refuses them too)")
        with open(model_file, "rb") as f:
            blob = msgpack_restore(f.read())
        if not (isinstance(blob, dict) and "module" in blob):
            raise ValueError(f"{model_file} holds no 'module' tree")
        template = gpt2_init(model_cfg, torch.Generator(), "meta")

        def fill(want, got, at):
            if isinstance(want, dict):
                if not isinstance(got, dict):
                    raise ValueError(f"{model_file}: {at or 'module'} is "
                                     "not a subtree")
                missing = sorted(set(want) - set(got))
                if missing:
                    raise ValueError(f"{model_file}: {at or 'module'} lacks "
                                     f"{missing}")
                return {k: fill(v, got[k], f"{at}{k}/")
                        for k, v in want.items()}
            if tuple(got.shape) != tuple(want.shape):
                raise ValueError(
                    f"{model_file}: {at[:-1]} has shape {tuple(got.shape)}, "
                    f"{model_cfg.name} needs {tuple(want.shape)}")
            if isinstance(got, torch.Tensor):
                return got
            return torch.from_numpy(np.array(got, copy=True))
        params = fill(template, blob["module"], "")
        log_dist(f"serving from training checkpoint {path}", ranks=[0])
        return cls(model_cfg, params, config=config, device=device,
                   seed=seed)


__all__ = ["InferenceEngine", "prepare_params"]
