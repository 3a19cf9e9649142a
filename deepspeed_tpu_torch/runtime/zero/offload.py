"""ZeRO-Offload: the fp32 masters and both Adam moments in host memory
(port of ``deepspeed_tpu/runtime/zero/offload.py``).

The card keeps only the compute-dtype parameters. The masters and the
moments are fp32 CPU tensors, updated by the host SIMD Adam
(``ops/cpu_adam.py``), and the updated parameters go back to the card
from a compute-dtype staging buffer: in bf16 runs the kernel writes it
in the same pass (``ds_adam_step_plus_copy``).

The step is bucketed. The leaves (in tree order, dict keys sorted, as
in JAX) form contiguous buckets of about ``offload_bucket_size`` bytes
of fp32 masters (a larger leaf is a bucket of its own), and a step is a
two-phase protocol over them:

  phase 1 (norm):  each bucket's squared grad norm as its grads land on
                   the host; once every bucket is in, one vote resolves
                   the fp16 overflow, the clip coefficient and the lr —
                   until then no master or moment changes, so an
                   overflow leaves every bucket untouched;
  phase 2 (apply): Adam per bucket with one shared bias-correction tick,
                   then the bucket's compute-dtype copy goes up.

``run_bucketed_step`` runs the protocol serially (fetch, norm, vote,
apply, upload, bucket by bucket) or overlapped: the caller's thread
waits for each bucket's copy to the host while a ``ThreadPoolExecutor``
runs the norms, then the pool runs Adam per bucket and each finished
bucket is handed back for its upload at once. Every floating-point sum
is taken in bucket order, a norm's bits depend only on its OpenMP team
(``ops/cpu_adam.py``) and it gets the same team in both modes, and all
buckets share one tick, so the two modes give the same bits.

Teams. Each host call runs on an OpenMP team, so the pool's workers
share the cores: a worker's team is ``cores // host_threads``. The
norms take that team in both modes; Adam, whose bits do not depend on
the team, takes every core when serial. The pool's default width is one
worker: each call already runs on every core, and the overlap wanted is
of the copies to and from the card with the host work, not of two host
calls with each other.

Across dp ranks each rank holds its partition: each leaf is sliced along
its first axis that ``axis_divisor`` divides (``_partition_axis``; past
the layer axis for a stacked leaf a bound ``Zero3Scan`` covers, JAX's
``stage3_param_specs`` rule); a leaf with no such axis is held whole by
every rank, and every rank applies the same update to it. At ZeRO stage
3 the card holds the same split of the compute-dtype parameters. The partitioned leaves' squared norms are
summed over the ranks by ``sumsq_allreduce``.
"""
from __future__ import annotations

import time
import weakref
from concurrent.futures import ThreadPoolExecutor, as_completed
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ... import constants as C
from ...ops.cpu_adam import DeepSpeedCPUAdam, default_threads
from ...ops.fused_update import tree_flatten
from ...utils.logging import log_dist

SUPPORTED = (C.ADAM_OPTIMIZER, C.ADAMW_OPTIMIZER)


def _partition_axis(shape, num: int, start: int = 0) -> Optional[int]:
    """The first axis of ``shape`` from ``start`` on that ``num`` divides
    (None if none)."""
    for i in range(start, len(shape)):
        d = shape[i]
        if d >= num and d % num == 0:
            return i
    return None


def _partition_buckets(leaf_nbytes: List[int], bucket_bytes: int
                       ) -> List[List[int]]:
    """Contiguous leaf-index groups of about ``bucket_bytes`` each
    (greedy fill; an oversized leaf gets a bucket of its own)."""
    buckets: List[List[int]] = []
    cur: List[int] = []
    cur_bytes = 0
    for i, nb in enumerate(leaf_nbytes):
        if cur and cur_bytes + nb > bucket_bytes:
            buckets.append(cur)
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += nb
    if cur:
        buckets.append(cur)
    return buckets


def _f32_copy(x: Any) -> torch.Tensor:
    """An owned, contiguous fp32 CPU copy of ``x`` (tensor or array)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32).contiguous().clone()
    return torch.from_numpy(np.array(x, np.float32, order="C", copy=True))


class ZeroOffloadOptimizer:
    """The host side of the offload path: masters, moments, the staging
    copy, the loss-scale machine and the bucketed step."""

    def __init__(self, master_params: Any, opt_name: str,
                 opt_params: Dict[str, Any], schedule_fn: Callable,
                 compute_dtype: torch.dtype, gradient_clipping: float = 0.0,
                 fp16: bool = False, scaler_cfg: Optional[Dict] = None,
                 partition_rank: int = 0, partition_num: int = 1,
                 axis_divisor: Optional[int] = None,
                 sumsq_allreduce: Optional[Callable[[float], float]] = None,
                 bucket_bytes: int = 0, host_threads: int = 0,
                 pin_memory: bool = False,
                 axis_starts: Optional[List[int]] = None):
        """``axis_divisor``: the divisibility that picks each leaf's
        partition axis (default ``partition_num``). ``sumsq_allreduce``:
        the sum over the ranks of the partitioned leaves' squared norm,
        required at ``partition_num > 1`` with clipping or fp16.
        ``bucket_bytes``: the bucket size in fp32-master bytes (0: the
        64 MiB default). ``host_threads``: the overlapped pipeline's
        pool width (0: one worker; see "Teams" above). ``pin_memory``:
        allocate the staging copy in page-locked memory (a CUDA run's
        uploads). ``axis_starts``: per leaf, the first axis its partition
        axis may be (1 for a stacked leaf a bound ``Zero3Scan`` gathers
        layer by layer; default 0)."""
        name = (opt_name or C.ADAM_OPTIMIZER).lower()
        if name not in SUPPORTED:
            raise ValueError(
                f"zero_optimization.cpu_offload supports {SUPPORTED}, got "
                f"'{opt_name}'")
        p = dict(opt_params or {})
        adamw_mode = p.get("adam_w_mode", name == C.ADAMW_OPTIMIZER)

        self.partition_rank = int(partition_rank)
        self.partition_num = int(partition_num)
        self.sumsq_allreduce = sumsq_allreduce
        divisor = int(axis_divisor or self.partition_num)
        if divisor % self.partition_num != 0:
            raise ValueError(f"axis_divisor {divisor} must be a multiple of "
                             f"partition_num {self.partition_num}")
        leaves, self.spec = tree_flatten(master_params)
        self.full_shapes = [tuple(l.shape) for l in leaves]
        starts = axis_starts or [0] * len(self.full_shapes)
        self._axes = [_partition_axis(s, divisor, a)
                      if self.partition_num > 1 else None
                      for s, a in zip(self.full_shapes, starts)]
        self.masters = [_f32_copy(self.slice_leaf(i, l))
                        for i, l in enumerate(leaves)]
        self.shapes = [tuple(m.shape) for m in self.masters]
        self.opt = DeepSpeedCPUAdam(
            self.masters, lr=p.get("lr", 1e-3),
            betas=tuple(p.get("betas", (0.9, 0.999))),
            eps=p.get("eps", 1e-8), weight_decay=p.get("weight_decay", 0.0),
            adamw_mode=adamw_mode)
        self.schedule_fn = schedule_fn
        self.clip = float(gradient_clipping or 0.0)
        self.compute_dtype = compute_dtype
        # The compute-dtype copy of the local masters that goes to the
        # card: one flat buffer in leaf order (a bucket is one range of
        # it), a view a leaf. bf16: the Adam kernel writes it.
        sizes = [m.numel() for m in self.masters]
        self.offsets = [int(x) for x in np.cumsum([0] + sizes)]
        self.staging_flat = torch.empty(self.offsets[-1],
                                        dtype=compute_dtype,
                                        pin_memory=pin_memory)
        self.staging = [self.staging_flat[a:b].view(s) for a, b, s in
                        zip(self.offsets, self.offsets[1:], self.shapes)]
        self._sync_staging()

        # Host-side loss-scale machine (fp16 offload).
        self.fp16 = fp16
        sc = scaler_cfg or {}
        self.loss_scale = float(sc.get("init_scale", 1.0))
        self.static_scale = bool(sc.get("static", True))
        self.scale_window = int(sc.get("scale_window", 1000))
        self.min_scale = float(sc.get("min_scale", 1.0))
        self.hysteresis_init = int(sc.get("hysteresis", 2))
        self.hysteresis = self.hysteresis_init
        self.growth_count = 0
        self.step_count = 0
        self.skipped_steps = 0

        # Bucketed two-phase step state; OpenMP teams ("Teams" above).
        self.bucket_bytes = int(bucket_bytes) or \
            C.ZERO_OFFLOAD_BUCKET_SIZE_DEFAULT
        self.host_threads = int(host_threads) or 1
        cores = default_threads()
        self.norm_threads = max(1, cores // self.host_threads)
        self.adam_threads = {False: cores, True: self.norm_threads}
        self.buckets = _partition_buckets(
            [m.numel() * 4 for m in self.masters], self.bucket_bytes)
        self._pending_t: Optional[int] = None
        self._pool: Optional[ThreadPoolExecutor] = None

        nbytes = 12 * self.offsets[-1]
        log_dist(f"ZeRO-Offload: {len(self.masters)} tensors in "
                 f"{len(self.buckets)} bucket(s) "
                 f"(~{self.bucket_bytes / 2 ** 20:.0f} MiB), "
                 f"{nbytes / 2 ** 20:.1f} MiB optimizer state in host "
                 f"memory (host threads: {self.host_threads}, OpenMP "
                 f"teams: norm {self.norm_threads}, Adam "
                 f"{self.adam_threads[False]} serial / "
                 f"{self.adam_threads[True]} a pool thread)", ranks=[0])

    # ------------------------------------------------------------------ #
    def slice_leaf(self, i: int, leaf: Any) -> Any:
        """A full leaf → this rank's partition (itself when unsharded or
        already local-shaped)."""
        ax = self._axes[i]
        if ax is None or tuple(leaf.shape) != self.full_shapes[i]:
            return leaf
        d = leaf.shape[ax] // self.partition_num
        if isinstance(leaf, torch.Tensor):
            return leaf.narrow(ax, self.partition_rank * d, d)
        sl = [slice(None)] * leaf.ndim
        sl[ax] = slice(self.partition_rank * d, (self.partition_rank + 1) * d)
        return leaf[tuple(sl)]

    # ------------------------------------------------------------------ #
    # The bucketed two-phase step
    # ------------------------------------------------------------------ #
    def num_buckets(self) -> int:
        return len(self.buckets)

    def bucket_range(self, b: int) -> Tuple[int, int]:
        """Bucket ``b``'s elements ``[start, end)`` in the flat leaf
        order of the local leaves (the staging buffer's)."""
        idxs = self.buckets[b]
        return self.offsets[idxs[0]], self.offsets[idxs[-1] + 1]

    def ensure_pool(self) -> ThreadPoolExecutor:
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=self.host_threads,
                thread_name_prefix="ds-offload")
            # Engines have no teardown: the idle workers go with the
            # optimizer.
            weakref.finalize(self, self._pool.shutdown, wait=False)
        return self._pool

    def bucket_sumsq(self, b: int, g_local) -> Tuple[float, float]:
        """Phase 1 for bucket ``b``: (partitioned, replicated) squared
        norm partials over its local grad leaves, leaf by leaf in bucket
        order. Partitioned leaves are disjoint shards whose partials sum
        over the ranks; replicated leaves are the same everywhere and
        count once, outside the reduction."""
        inv_scale = 1.0 / self.loss_scale
        part = repl = 0.0
        for leaf_i, g in zip(self.buckets[b], g_local):
            s = self.opt.grad_norm_sq([g], inv_scale,
                                      threads=self.norm_threads)
            if self._axes[leaf_i] is not None:
                part += s
            else:
                repl += s
        return part, repl

    def resolve_vote(self, part_sumsqs, repl_sumsqs) -> Dict[str, float]:
        """Resolve the global norm once every bucket's partials are in
        (lists by bucket, summed in bucket order): the overflow vote and
        the loss-scale machine, the clip coefficient and the lr. On
        overflow no bucket may apply. Returns the step's metrics; phase
        2 reads ``clip_coeff`` and ``lr`` from them."""
        local_part = 0.0
        for s in part_sumsqs:
            local_part += s
        if self.sumsq_allreduce is not None:
            total = float(self.sumsq_allreduce(local_part))
        elif self.partition_num > 1 and (self.clip > 0 or self.fp16):
            raise RuntimeError(
                "partition_num > 1 with gradient clipping or fp16 "
                "requires sumsq_allreduce (cross-rank norm reduction)")
        else:
            total = local_part
        for s in repl_sumsqs:
            total += s
        grad_norm = float(np.sqrt(total))
        overflow = self.fp16 and not np.isfinite(grad_norm)
        if overflow:
            self.skipped_steps += 1
            self._scale_down()
            return {"loss_scale": self.loss_scale, "grad_norm": grad_norm,
                    "overflow": True, "lr": self._lr(), "clip_coeff": 1.0}
        coeff = 1.0
        if self.clip > 0 and np.isfinite(grad_norm) and grad_norm > self.clip:
            coeff = self.clip / (grad_norm + 1e-6)
        # One bias-correction tick for every bucket; step_count advances
        # in finish_step, after the last bucket.
        self._pending_t = self.opt.step_count + 1
        return {"loss_scale": self.loss_scale, "grad_norm": grad_norm,
                "overflow": False, "lr": self._lr(), "clip_coeff": coeff}

    def bucket_apply(self, b: int, g_local, lr: float, clip_coeff: float,
                     want_upload: bool = True,
                     threads: Optional[int] = None
                     ) -> Optional[List[torch.Tensor]]:
        """Phase 2 for bucket ``b``: Adam in place with the shared tick,
        then the bucket's compute-dtype leaves to upload. Buckets touch
        disjoint leaves, so calls may run at once."""
        assert self._pending_t is not None, \
            "bucket_apply before resolve_vote (or after an overflow vote)"
        idxs = self.buckets[b]
        bf16 = self.compute_dtype == torch.bfloat16
        self.opt.step_leaves(
            self.masters, g_local, idxs, lr=lr,
            grad_scale=(1.0 / self.loss_scale) * clip_coeff,
            bf16_out=self.staging if bf16 else None, step=self._pending_t,
            threads=threads)
        if not bf16:
            for i in idxs:
                self.staging[i].copy_(self.masters[i])
        return self.upload_leaves(idxs) if want_upload else None

    def finish_step(self) -> None:
        """Commit the step after every bucket applied: advance the shared
        tick, then the loss-scale growth side of the machine."""
        assert self._pending_t is not None
        self.opt.step_count = self._pending_t
        self._pending_t = None
        self.step_count += 1
        self._scale_up()

    def upload_leaves(self, idxs) -> List[torch.Tensor]:
        """The compute-dtype leaves ``idxs`` (staging views)."""
        return [self.staging[i] for i in idxs]

    # ------------------------------------------------------------------ #
    def host_step(self, grads: Any) -> Dict[str, float]:
        """One optimizer step from (loss-scaled) host grads, serially. Grad
        leaves may be full-shaped (sliced here) or partition-local."""
        g_leaves = [self.slice_leaf(i, torch.as_tensor(g))
                    for i, g in enumerate(tree_flatten(grads)[0])]
        metrics, _ = run_bucketed_step(
            self, lambda b: [g_leaves[i] for i in self.buckets[b]],
            overlap=False)
        return metrics

    def _lr(self) -> float:
        return float(self.schedule_fn(self.step_count))

    def _scale_down(self) -> None:
        if self.static_scale or not self.fp16:
            return
        if self.hysteresis > 1:
            self.hysteresis -= 1
        else:
            self.loss_scale = max(self.loss_scale / 2.0, self.min_scale)
            self.hysteresis = self.hysteresis_init
        self.growth_count = 0

    def _scale_up(self) -> None:
        if self.static_scale or not self.fp16:
            return
        self.growth_count += 1
        if self.growth_count >= self.scale_window:
            self.loss_scale *= 2.0
            self.growth_count = 0

    # ------------------------------------------------------------------ #
    def state_dict(self) -> Dict[str, Any]:
        """The JAX module's layout (lists of leaves, local shapes)."""
        return {"optimizer": self.opt.state_dict(),
                "masters": list(self.masters),
                "loss_scale": self.loss_scale,
                "growth_count": self.growth_count,
                "hysteresis": self.hysteresis,
                "step_count": self.step_count,
                "skipped_steps": self.skipped_steps}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        """Full or local-shaped leaves (a full leaf is sliced to this
        rank's partition)."""
        o = sd["optimizer"]
        self.opt.load_state_dict({
            "step": o["step"],
            "exp_avg": [self.slice_leaf(i, a)
                        for i, a in enumerate(o["exp_avg"])],
            "exp_avg_sq": [self.slice_leaf(i, a)
                           for i, a in enumerate(o["exp_avg_sq"])]})
        self.set_masters(sd["masters"])
        self.loss_scale = float(sd.get("loss_scale", self.loss_scale))
        self.growth_count = int(sd.get("growth_count", 0))
        self.hysteresis = int(sd.get("hysteresis", self.hysteresis_init))
        self.step_count = int(sd.get("step_count", 0))
        self.skipped_steps = int(sd.get("skipped_steps", 0))

    def set_masters(self, leaves) -> None:
        """Replace the fp32 masters (full or local-shaped leaves). Every
        replacement goes through here, so the staging copy is re-derived
        and never serves stale weights (also on a load without the
        optimizer state)."""
        self.masters = [_f32_copy(self.slice_leaf(i, m))
                        for i, m in enumerate(leaves)]
        self._sync_staging()

    def _sync_staging(self) -> None:
        for buf, m in zip(self.staging, self.masters):
            buf.copy_(m)


# --------------------------------------------------------------------- #
# The bucketed step: serial, or overlapped
# --------------------------------------------------------------------- #
def run_bucketed_step(off: ZeroOffloadOptimizer,
                      fetch_bucket: Callable[[int], list],
                      upload_bucket: Optional[Callable[[int, list], None]]
                      = None,
                      overlap: bool = False
                      ) -> Tuple[Dict[str, float], Dict[str, Any]]:
    """One two-phase bucketed step over ``off``.

    ``fetch_bucket(b)`` returns once bucket ``b``'s partition-local host
    grad leaves are in place (the wait for its copy to the host).
    ``upload_bucket(b, leaves)`` issues the bucket's copy to the card; it
    is always called on the caller's thread, in bucket order when serial
    and in the order the Adam calls finish when overlapped.

    Overlapped (pool width ``off.host_threads``)::

        caller thread:  fetch b0 | fetch b1 | ... | upload as applies land
        worker pool:         norm b0 | norm b1 | ...  [vote]  adam b*

    Returns ``(metrics, timings)``: per-bucket ``d2h_ms`` / ``norm_ms`` /
    ``adam_ms`` / ``h2d_ms`` with their start offsets, their sums, the
    pipeline's span and ``overlap_fraction`` (1 - span / work; 0 when
    serial, > 0 exactly when concurrency hid host work)."""
    nb = off.num_buckets()
    pb: Dict[str, List[float]] = {
        "d2h_ms": [0.0] * nb, "norm_ms": [0.0] * nb,
        "adam_ms": [0.0] * nb, "h2d_ms": [0.0] * nb}
    t0s: Dict[str, List[float]] = {
        "d2h_t0": [0.0] * nb, "norm_t0": [0.0] * nb,
        "adam_t0": [0.0] * nb, "h2d_t0": [0.0] * nb}
    parts = [0.0] * nb
    repls = [0.0] * nb
    host_grads: List[Optional[list]] = [None] * nb
    adam_threads = off.adam_threads[bool(overlap)]
    t_start = time.perf_counter()

    def fetch(b: int) -> None:
        t0 = time.perf_counter()
        t0s["d2h_t0"][b] = t0 - t_start
        host_grads[b] = fetch_bucket(b)
        pb["d2h_ms"][b] = (time.perf_counter() - t0) * 1e3

    def norm(b: int) -> None:
        t0 = time.perf_counter()
        t0s["norm_t0"][b] = t0 - t_start
        parts[b], repls[b] = off.bucket_sumsq(b, host_grads[b])
        pb["norm_ms"][b] = (time.perf_counter() - t0) * 1e3

    def adam(b: int, lr: float, coeff: float) -> Optional[list]:
        t0 = time.perf_counter()
        t0s["adam_t0"][b] = t0 - t_start
        out = off.bucket_apply(b, host_grads[b], lr, coeff,
                               want_upload=upload_bucket is not None,
                               threads=adam_threads)
        pb["adam_ms"][b] = (time.perf_counter() - t0) * 1e3
        return out

    def upload(b: int, leaves: Optional[list]) -> None:
        if upload_bucket is None:
            return
        t0 = time.perf_counter()
        t0s["h2d_t0"][b] = t0 - t_start
        upload_bucket(b, leaves)
        pb["h2d_ms"][b] = (time.perf_counter() - t0) * 1e3

    if not overlap:
        for b in range(nb):
            fetch(b)
            norm(b)
        metrics = off.resolve_vote(parts, repls)
        if not metrics["overflow"]:
            for b in range(nb):
                upload(b, adam(b, metrics["lr"], metrics["clip_coeff"]))
            off.finish_step()
    else:
        pool = off.ensure_pool()
        norm_futs = []
        for b in range(nb):
            fetch(b)                      # the copy's wait, this thread
            norm_futs.append(pool.submit(norm, b))   # the norm, the pool
        for f in norm_futs:
            f.result()
        metrics = off.resolve_vote(parts, repls)
        if not metrics["overflow"]:
            lr, coeff = metrics["lr"], metrics["clip_coeff"]
            futs = {pool.submit(adam, b, lr, coeff): b for b in range(nb)}
            for f in as_completed(futs):  # up the moment a bucket lands
                upload(futs[f], f.result())
            off.finish_step()

    span_ms = (time.perf_counter() - t_start) * 1e3
    work_ms = sum(sum(v) for v in pb.values())
    timings = {
        "per_bucket": pb,
        "per_bucket_t0": t0s,
        "t_origin": t_start,
        "d2h_ms": sum(pb["d2h_ms"]),
        "host_norm_ms": sum(pb["norm_ms"]),
        "host_step_ms": sum(pb["adam_ms"]),
        "h2d_dispatch_ms": sum(pb["h2d_ms"]),
        "pipeline_span_ms": span_ms,
        "pipeline_work_ms": work_ms,
        "overlap_fraction": max(0.0, 1.0 - span_ms / work_ms)
        if overlap and work_ms > 0 else 0.0,
        "num_buckets": nb,
        "overlapped": bool(overlap),
        "omp_threads": {"norm": off.norm_threads, "adam": adam_threads},
    }
    return metrics, timings


__all__ = ["ZeroOffloadOptimizer", "run_bucketed_step", "SUPPORTED"]
