"""The MoE FFN at expert-parallel size 1: top-k gating, capacity
bucketing, the grouped expert FFN, the weighted combine (port of
``deepspeed_tpu/moe/layer.py``, its ep = 1 path).

The layer replaces a transformer block's dense FFN (every
``moe_layer_freq``-th block; ``models/transformer.py`` wires it behind
``TransformerConfig.moe``):

- **Routing** is a linear router + softmax + top-k (k in {1, 2}) in
  fp32 whatever the compute dtype; the kept gates renormalize to sum 1.
  Equal probabilities take the lower expert first, as ``lax.top_k``
  does (a stable descending sort).
- **Capacity bucketing**: a ``[E, C, H]`` dispatch buffer (C =
  ``ceil(capacity_factor * k * T / E)``) filled by one scatter; tokens
  beyond an expert's capacity go to a drop row and their combine
  contribution is exactly 0 (they ride the residual path). Priority is
  j-major (every token's first choice before any second choice),
  position-in-expert by running count.
- **Expert FFN**: ``ops/grouped_gemm.grouped_ffn`` (the K9 kernel on the
  card, its plain versions on the CPU).
- **Losses and stats**: the load-balance aux loss ``E * sum(f_e *
  P_e)`` (f from the routed counts, treated as constant), the router
  z-loss ``mean(logsumexp(logits)^2)``, the routed token counts per
  expert and the drop fraction, returned beside the output.

The scatter, the gather back, the router matmul and the combine are
plain PyTorch, as the JAX package leaves them to XLA. Expert parallelism
(ep > 1: the all-to-all dispatch) is not ported yet and raises.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops.grouped_gemm import check_grouped_gemm, grouped_ffn

# The block-param keys the MoE FFN owns; their stacked leading axis
# counts the MoE layers only.
MOE_PARAM_KEYS = frozenset({
    "router_kernel", "moe_fc_kernel", "moe_fc_bias",
    "moe_out_kernel", "moe_out_bias",
})

EP_UNPORTED = ("moe expert_parallel_size > 1 is not ported yet (ROADMAP "
               "slice 6: parallel axes and comm extras)")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Model-side MoE hyperparameters (``TransformerConfig.moe``); build
    one from the ds_config ``moe`` block with ``from_ds_config``."""
    num_experts: int = 8
    top_k: int = 2                      # k in {1, 2}
    capacity_factor: float = 1.25       # inf => no token ever drops
    aux_loss_weight: float = 1e-2
    z_loss_weight: float = 1e-3
    expert_parallel_size: int = 1
    # Kept for ds_config parity: the expert FFN always runs as
    # grouped_ffn; False raises on a CUDA device (see
    # ops.grouped_gemm.check_grouped_gemm).
    grouped_gemm: Any = "auto"

    def __post_init__(self):
        assert self.num_experts >= 1, "num_experts must be >= 1"
        assert self.top_k in (1, 2), "top_k must be 1 or 2"
        assert self.top_k <= self.num_experts
        assert self.capacity_factor > 0
        assert self.expert_parallel_size >= 1
        assert self.num_experts % self.expert_parallel_size == 0, \
            (f"num_experts={self.num_experts} not divisible by "
             f"expert_parallel_size={self.expert_parallel_size}")
        assert self.grouped_gemm in (True, False, "auto"), \
            f"grouped_gemm must be True/False/'auto', got " \
            f"{self.grouped_gemm!r}"

    @classmethod
    def from_ds_config(cls, moe_cfg) -> "MoEConfig":
        """From a parsed ``runtime.config.MoeConfig``."""
        return cls(num_experts=moe_cfg.num_experts, top_k=moe_cfg.top_k,
                   capacity_factor=moe_cfg.capacity_factor,
                   aux_loss_weight=moe_cfg.aux_loss_weight,
                   z_loss_weight=moe_cfg.z_loss_weight,
                   expert_parallel_size=moe_cfg.expert_parallel_size,
                   grouped_gemm=getattr(moe_cfg, "grouped_gemm", "auto"))


def expert_capacity(tokens: int, num_experts: int, top_k: int,
                    capacity_factor: float) -> int:
    """Per-expert slot count C for ``tokens`` routed tokens:
    ``ceil(cf * k * T / E)``, clamped to [1, T]; ``inf`` => C = T."""
    if math.isinf(capacity_factor):
        return max(1, tokens)
    c = int(math.ceil(capacity_factor * top_k * tokens / num_experts))
    return max(1, min(c, tokens))


def moe_layer_indices(num_layers: int, moe_layer_freq: int) -> List[int]:
    """Which block indices carry the MoE FFN: every ``freq``-th block,
    counting from the first (layer freq-1, 2*freq-1, ...)."""
    assert moe_layer_freq >= 1
    return [i for i in range(num_layers) if (i + 1) % moe_layer_freq == 0]


def router_topk(x32: torch.Tensor, router_kernel: torch.Tensor, top_k: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor]:
    """fp32 routing: ``(gates [T,k], expert_idx [T,k], probs [T,E],
    logits [T,E])``. Gates renormalize over the kept k (exactly 1.0 for
    k = 1)."""
    logits = x32 @ router_kernel.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_vals, idx = vals[:, :top_k], idx[:, :top_k]
    gates = top_vals / torch.sum(top_vals, dim=-1, keepdim=True)
    return gates, idx, probs, logits


def _dispatch_plan(idx: torch.Tensor, num_experts: int, capacity: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Token → bucket-slot assignment. ``idx``: [T, k] expert choices.

    Returns ``(dest [k*T] int64 in [0, E*C] (E*C = dropped), keep [k*T]
    bool, routed_counts [E] fp32)`` in j-major order (choice 0 of every
    token outranks any choice 1). Positions are an integer running count
    (the JAX package's fp32 cumsum of one-hots gives the same integers),
    taken along the last axis of the [E, k*T] one-hots: a scan along a
    leading axis of only E columns runs nearly serially on the card."""
    idx_j = idx.t().reshape(-1)                                  # [k*T]
    oh = F.one_hot(idx_j, num_experts).t().contiguous()          # [E, k*T]
    prior = torch.cumsum(oh, dim=1) - oh
    pos_in_e = torch.sum(prior * oh, dim=0)
    keep = pos_in_e < capacity
    dest = torch.where(keep, idx_j * capacity + pos_in_e,
                       torch.full_like(idx_j, num_experts * capacity))
    return dest, keep, torch.sum(oh, dim=1).to(torch.float32)


def _moe_tokens(params: Dict[str, torch.Tensor], xt: torch.Tensor,
                moe: MoEConfig, gelu_approx: bool,
                expert_ffn: Optional[Callable] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The token path: route → bucket → expert FFN → weighted combine.
    ``xt``: [T, H] tokens in the compute dtype. ``expert_ffn`` is the
    grouped FFN (default ``grouped_ffn``). Returns (y [T, H], stats)."""
    check_grouped_gemm(moe.grouped_gemm, xt.device)
    T, H = xt.shape
    E, k = moe.num_experts, moe.top_k
    C = expert_capacity(T, E, k, moe.capacity_factor)
    gates, idx, probs, logits = router_topk(
        xt.to(torch.float32), params["router_kernel"], k)
    dest, keep, counts = _dispatch_plan(idx, E, C)

    # Scatter into the [E, C, H] dispatch buffer; row E*C is the drop
    # bin (kept (e, pos) slots are unique by construction, so the
    # scatter's backward is a gather and a dropped token's gradient from
    # the experts is exactly 0).
    xk = xt.repeat(k, 1)                                         # [k*T, H]
    buckets = xt.new_zeros((E * C + 1, H)).index_put((dest,), xk)
    b = buckets[:E * C].reshape(E, C, H)

    w1 = params["moe_fc_kernel"].to(xt.dtype)
    b1 = params["moe_fc_bias"].to(xt.dtype)
    w2 = params["moe_out_kernel"].to(xt.dtype)
    b2 = params["moe_out_bias"].to(xt.dtype)
    y = (expert_ffn or grouped_ffn)(b, w1, b1, w2, b2, not gelu_approx)

    # Gather back per token; dropped tokens read the appended zero row.
    yf = torch.cat([y.reshape(E * C, H), y.new_zeros((1, H))], dim=0)
    yk = yf.index_select(0, dest)                                # [k*T, H]
    gk = gates.t().reshape(-1).to(yf.dtype)
    out = torch.sum((yk * gk[:, None]).reshape(k, T, H), dim=0)

    frac = counts.detach() / (k * T)
    stats = {
        "expert_tokens": counts,                                 # [E] fp32
        "drop_fraction":
            1.0 - torch.sum(keep.to(torch.float32)) / (k * T),
        "aux_loss": E * torch.sum(frac * torch.mean(probs, dim=0)),
        "z_loss": torch.mean(torch.square(
            torch.logsumexp(logits, dim=-1))),
    }
    return out, stats


def moe_ffn(params: Dict[str, torch.Tensor], x: torch.Tensor, cfg,
            expert_ffn: Optional[Callable] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The MoE FFN sublayer. ``x``: [B, S, H] (compute dtype); ``params``
    holds this layer's ``MOE_PARAM_KEYS`` (no stacking axis); ``cfg`` is
    the ``TransformerConfig`` (reads ``cfg.moe`` and ``cfg.gelu_exact``).
    Returns ``(y [B, S, H], stats)``."""
    moe: MoEConfig = cfg.moe
    if moe.expert_parallel_size > 1:
        raise NotImplementedError(EP_UNPORTED)
    B, S, H = x.shape
    y, stats = _moe_tokens(params, x.reshape(B * S, H), moe,
                           not cfg.gelu_exact, expert_ffn)
    return y.reshape(B, S, H), stats


def aggregate_moe_stats(per_layer: List[Dict[str, torch.Tensor]]
                        ) -> Dict[str, torch.Tensor]:
    """The per-step record from per-MoE-layer stats: each stat averaged
    over the MoE layers."""
    return {name: torch.mean(torch.stack([st[name] for st in per_layer]),
                             dim=0)
            for name in per_layer[0]}


__all__ = ["MOE_PARAM_KEYS", "MoEConfig", "expert_capacity",
           "moe_layer_indices", "router_topk", "moe_ffn",
           "aggregate_moe_stats"]
