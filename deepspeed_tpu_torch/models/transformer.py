"""Transformer building blocks (port of
``deepspeed_tpu/models/transformer.py``: the serving ops and the
training block — pre-LN (GPT-2) or post-LN (BERT), causal or
bidirectional, with an optional additive mask — whose attention defaults
to ``auto_attention`` — the flash kernels on a CUDA device,
``dense_attention`` on the CPU — and whose FFN is dense, or with
``TransformerConfig.moe`` the MoE FFN of ``moe/layer.py`` on every
``moe_layer_freq``-th block).

Params are plain dicts of tensors; per-layer tensors are STACKED on a
leading layer axis ``[L, ...]`` and matmul kernels are stored ``[in,
out]`` and applied as ``x @ W`` — the JAX layout, so the converter maps
trees one to one. Softmax and LayerNorm statistics run in fp32; matmuls
run in the compute dtype with ``torch.matmul``.

The elementwise ops of a block come in two sets (``ElementwiseOps``):
``KERNEL_OPS``, the differentiable kernel-backed ops (their plain
versions run for CPU tensors), which the model runs; and ``PLAIN_OPS``,
plain PyTorch differentiated by autograd — the reference that
``gpt2_apply`` and the card's yardstick step use. Each set carries the
grouped expert FFN of the MoE blocks too (``grouped_ffn`` and
``grouped_ffn_plain``). ``elementwise_ops``
resolves ``TransformerConfig.fused_kernels``: on a CUDA device the port
has only the kernels, so ``False`` raises there.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence

import torch

from ..ops.flash_attention import auto_attention, flash_attention
from ..ops.fused_elementwise import (bias_gelu_plain, fused_bias_gelu,
                                     fused_layer_norm,
                                     fused_residual_layer_norm, gelu_tanh,
                                     layer_norm_plain)
from ..ops.grouped_gemm import grouped_ffn, grouped_ffn_plain
from ..moe.layer import (EP_UNPORTED, MOE_PARAM_KEYS, aggregate_moe_stats,
                         moe_ffn, moe_layer_indices)
from .remat import GeneratorReplay, Op, Recompute, remat_policy, run_program


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """Shared transformer hyperparameters (the JAX config's subset; the
    scan knob is not ported: the layers run as the JAX
    ``scan_layers=False`` program; segment embeddings are
    ``models/bert.BertConfig``'s)."""
    hidden_size: int = 768
    num_heads: int = 12
    num_layers: int = 12
    intermediate_size: int = 0          # 0 → 4*hidden
    max_seq_length: int = 1024
    vocab_size: int = 50257
    pre_layer_norm: bool = True
    hidden_dropout: float = 0.1
    attn_dropout: float = 0.1
    layer_norm_eps: float = 1e-5
    initializer_range: float = 0.02
    # Activation recomputation: "none", "full", "dots", "dots_flash" or
    # "attn" (models/remat.py says what each holds).
    remat_policy: str = "none"
    causal: bool = False
    dtype: Any = torch.bfloat16
    # The erf form of GELU (True) or the tanh form (False), in the dense
    # FFN's bias+GELU kernels and the MoE experts' grouped GEMM alike.
    gelu_exact: bool = False
    # The fused kernels knob: "auto"/True run the kernels; False has no
    # CUDA path in the port (the engines raise). On the CPU the kernels'
    # plain versions run whatever it says.
    fused_kernels: Any = "auto"
    # Mixture-of-Experts: a ``moe.MoEConfig`` swaps the dense FFN for the
    # MoE FFN on every ``moe_layer_freq``-th block (freq 1 = every block).
    moe: Any = None
    moe_layer_freq: int = 1

    @property
    def ffn_size(self) -> int:
        return self.intermediate_size or 4 * self.hidden_size

    @property
    def head_dim(self) -> int:
        assert self.hidden_size % self.num_heads == 0
        return self.hidden_size // self.num_heads


def check_trainable(cfg: TransformerConfig) -> None:
    """Raise for the model knobs the port's training path does not run
    (and ``ValueError`` for an unknown ``remat_policy``). The block runs
    pre-LN and post-LN, causal and bidirectional, as in JAX."""
    remat_policy(cfg.remat_policy)
    if cfg.moe is not None and cfg.moe.expert_parallel_size > 1:
        raise NotImplementedError(EP_UNPORTED)


# --------------------------------------------------------------------- #
# Plain reference ops
# --------------------------------------------------------------------- #
def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with fp32 statistics, output in x's dtype."""
    return layer_norm_plain(x, None, scale, bias, eps)[1]


def dense(x: torch.Tensor, kernel: torch.Tensor,
          bias: Optional[torch.Tensor]) -> torch.Tensor:
    y = torch.matmul(x, kernel.to(x.dtype))
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y


# tanh-approximation GELU in x's dtype (``jax.nn.gelu(approximate=True)``).
gelu = gelu_tanh


def dropout_mask(shape, rate: float, generator: torch.Generator,
                 device: torch.device) -> torch.Tensor:
    """The keep mask of inverted dropout, drawn from ``generator``."""
    return torch.rand(shape, generator=generator, device=device) < \
        (1.0 - rate)


def apply_dropout(x: torch.Tensor, keep: Optional[torch.Tensor],
                  rate: float) -> torch.Tensor:
    """``x`` through the keep mask ``keep`` (the identity for None)."""
    if keep is None:
        return x
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator],
            deterministic: bool) -> torch.Tensor:
    """Inverted dropout with a keep mask drawn from ``generator`` (which
    must live on x's device); the identity when deterministic, at rate 0
    or without a generator, as in the JAX package."""
    if deterministic or rate == 0.0 or generator is None:
        return x
    return apply_dropout(x, dropout_mask(x.shape, rate, generator,
                                         x.device), rate)


def heads(x: torch.Tensor) -> torch.Tensor:
    """[B, S, nH, D] → [B·nH, S, D] (a copy, head-major)."""
    B, S, nH, D = x.shape
    return x.permute(0, 2, 1, 3).reshape(B * nH, S, D)


def heads_t(x: torch.Tensor) -> torch.Tensor:
    """[B, T, nH, D] → [B·nH, D, T] (a copy, head-major, transposed)."""
    B, T, nH, D = x.shape
    return x.permute(0, 2, 3, 1).reshape(B * nH, D, T)


def attention_probs(s: torch.Tensor, dh: int, causal: bool,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """QKᵀ [B, nH, S, T] → fp32 scale → causal and additive masks → fp32
    softmax."""
    s = s.float() / math.sqrt(dh)
    if causal:
        S, T = s.shape[-2], s.shape[-1]
        cmask = torch.ones(S, T, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~cmask, -1e9)
    if mask is not None:
        s = s + mask.float()
    return torch.softmax(s, dim=-1)


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor] = None,
                    causal: bool = False, attn_dropout: float = 0.0,
                    rng: Optional[torch.Generator] = None,
                    deterministic: bool = True) -> torch.Tensor:
    """Reference attention: QK^T → scale → mask → fp32 softmax →
    dropout → AV. q, k, v: [B, S, nH, D]; ``mask`` additive, broadcast
    to [B, 1, S, S]. The two products are batched matmuls over head-major
    copies in the compute dtype (what ``torch.einsum`` runs for them, bit
    for bit; the JAX package leaves them to XLA), written out so that
    ``block_program`` can hold them as values."""
    B, S, nH, dh = q.shape
    T = k.shape[1]
    s = torch.bmm(heads(q), heads_t(k)).view(B, nH, S, T)
    w = attention_probs(s, dh, causal, mask)
    w = dropout(w, attn_dropout, rng, deterministic)
    o = torch.bmm(w.to(v.dtype).reshape(B * nH, S, T), heads(v))
    return o.view(B, nH, S, dh).permute(0, 2, 1, 3)


# --------------------------------------------------------------------- #
# The block's elementwise ops
# --------------------------------------------------------------------- #
class ElementwiseOps(NamedTuple):
    """``ln(x, scale, bias) -> y``; ``res_ln(x, delta, scale, bias, eps)
    -> (s, y)`` with ``s = x + delta``; ``gelu_up(h, kernel, bias, exact)
    -> gelu(h @ kernel + bias)`` (the erf form where ``exact``, else the
    tanh form). Each takes ``eps`` where it normalizes.
    ``expert_ffn(x, w1, b1, w2, b2, exact)``: the MoE blocks' grouped
    expert FFN where ``MoEConfig.grouped_gemm`` selects it.
    ``bias_gelu(z, bias, exact) -> gelu(z + bias)``: ``gelu_up``'s
    epilogue alone (the block runs the product and the epilogue as two
    steps)."""
    ln: Callable
    res_ln: Callable
    gelu_up: Callable
    expert_ffn: Callable
    bias_gelu: Callable


KERNEL_OPS = ElementwiseOps(
    ln=fused_layer_norm, res_ln=fused_residual_layer_norm,
    gelu_up=lambda h, kernel, bias, exact=False: fused_bias_gelu(
        torch.matmul(h, kernel.to(h.dtype)), bias, exact),
    expert_ffn=grouped_ffn, bias_gelu=fused_bias_gelu)

PLAIN_OPS = ElementwiseOps(
    ln=lambda x, scale, bias, eps: layer_norm_plain(x, None, scale, bias,
                                                    eps)[1],
    res_ln=layer_norm_plain,
    gelu_up=lambda h, kernel, bias, exact=False: bias_gelu_plain(
        torch.matmul(h, kernel.to(h.dtype)), bias, exact),
    expert_ffn=grouped_ffn_plain, bias_gelu=bias_gelu_plain)


def elementwise_ops(cfg: TransformerConfig,
                    device: torch.device) -> ElementwiseOps:
    """The ops ``cfg.fused_kernels`` selects on ``device``."""
    if cfg.fused_kernels is False:
        if device.type == "cuda":
            raise NotImplementedError(
                "fused_kernels=False has no CUDA path in the port — the "
                "LayerNorm and GELU run as its kernels there (ROADMAP: not "
                "planned)")
        return PLAIN_OPS
    return KERNEL_OPS


def layer_norm_fn(cfg: TransformerConfig) -> Callable:
    """``(x, scale, bias) -> y`` through the LayerNorm kernel (its plain
    version for CPU tensors)."""
    return lambda x, scale, bias: fused_layer_norm(
        x, scale, bias, cfg.layer_norm_eps)


def gelu_dense_fn(cfg: TransformerConfig) -> Callable:
    """``(h, kernel, bias) -> gelu(h @ kernel + bias)``: the matmul stays
    with ``torch.matmul``, the bias+GELU epilogue is one kernel pass in
    the form ``cfg.gelu_exact`` selects."""
    return lambda h, kernel, bias: KERNEL_OPS.gelu_up(h, kernel, bias,
                                                      cfg.gelu_exact)


# --------------------------------------------------------------------- #
# Params and the block
# --------------------------------------------------------------------- #
def init_block_params(cfg: TransformerConfig, generator: torch.Generator,
                      device: torch.device) -> Dict[str, torch.Tensor]:
    """STACKED block params, fp32, the tree of the JAX
    ``init_block_params``: [L, ...] for the attention and LayerNorm
    tensors; with ``cfg.moe`` the FFN tensors split into a dense stack
    ([n_dense, ...]) and an expert stack ([n_moe, E, ...]), each
    covering only its own layers."""
    L, H, F = cfg.num_layers, cfg.hidden_size, cfg.ffn_size
    std = cfg.initializer_range
    proj_std = std / math.sqrt(2.0 * L)

    def norm(shape, s):
        return torch.randn(shape, generator=generator, device=device,
                           dtype=torch.float32) * s

    def zeros(shape):
        return torch.zeros(shape, device=device, dtype=torch.float32)

    def ones(shape):
        return torch.ones(shape, device=device, dtype=torch.float32)

    n_moe = 0 if cfg.moe is None else \
        len(moe_layer_indices(L, cfg.moe_layer_freq))
    if cfg.moe is not None and n_moe == 0:
        raise ValueError(
            f"cfg.moe is set but moe_layer_freq={cfg.moe_layer_freq} "
            f"selects no MoE layer out of {L} — use freq <= num_layers "
            "or drop cfg.moe")
    n_dense = L - n_moe
    params = {
        "ln1_scale": ones((L, H)), "ln1_bias": zeros((L, H)),
        "qkv_kernel": norm((L, H, 3 * H), std),
        "qkv_bias": zeros((L, 3 * H)),
        "proj_kernel": norm((L, H, H), proj_std),
        "proj_bias": zeros((L, H)),
        "ln2_scale": ones((L, H)), "ln2_bias": zeros((L, H)),
    }
    if n_dense > 0:
        params.update({
            "fc_kernel": norm((n_dense, H, F), std),
            "fc_bias": zeros((n_dense, F)),
            "fc_out_kernel": norm((n_dense, F, H), proj_std),
            "fc_out_bias": zeros((n_dense, H)),
        })
    if n_moe > 0:
        E = cfg.moe.num_experts
        params.update({
            "router_kernel": norm((n_moe, H, E), std),
            "moe_fc_kernel": norm((n_moe, E, H, F), std),
            "moe_fc_bias": zeros((n_moe, E, F)),
            "moe_out_kernel": norm((n_moe, E, F, H), proj_std),
            "moe_out_bias": zeros((n_moe, E, H)),
        })
    return params


def layer_slice(stacked: Dict[str, torch.Tensor], i: int
                ) -> Dict[str, torch.Tensor]:
    """Layer ``i``'s params (views of the stacked tensors)."""
    return {name: t[i] for name, t in stacked.items()}


def _attention_route(attention_fn: Callable, device: torch.device,
                     S: int, masked: bool = False) -> str:
    """``"dense"`` where the attention is ``dense_attention`` (the
    default's route for CPU tensors, and the flash function's for a
    sequence that is not a multiple of 128 or an additive mask, as in
    JAX), ``"flash"`` where it is the flash kernels, else ``"custom"``
    (an opaque ``attention_fn``, such as a sparse closure)."""
    if attention_fn is dense_attention:
        return "dense"
    if attention_fn is auto_attention or attention_fn is flash_attention:
        if masked or S % 128 != 0 or (attention_fn is auto_attention and
                                      device.type != "cuda"):
            return "dense"
        return "flash"
    return "custom"


def additive_mask(attention_mask: Optional[torch.Tensor]
                  ) -> Optional[torch.Tensor]:
    """A ``[B, S]`` keep mask (1 = attend) as JAX's additive ``[B, 1, 1,
    S]`` fp32 form, ``(1 - m) * -1e9``; None stays None."""
    if attention_mask is None:
        return None
    return (1.0 - attention_mask.to(torch.float32))[:, None, None, :] * -1e9


def block_program(cfg: TransformerConfig, shape, device: torch.device,
                  dtype: torch.dtype, deterministic: bool = True,
                  attention_fn: Optional[Callable] = None,
                  ops: Optional[ElementwiseOps] = None,
                  moe: bool = False,
                  mask: Optional[torch.Tensor] = None) -> List[Op]:
    """One block as a program of named steps (``models/remat.py``) over
    an input ``x`` of ``shape`` [B, S, H] and ``dtype`` on ``device``:
    the one definition of the block, which ``transformer_block`` runs
    plainly and ``apply_blocks`` runs under a ``remat_policy``.

    Pre-LN (``cfg.pre_layer_norm``, GPT-2): ``h1`` (LN1), ``qkv`` (a
    product), the attention's ``a`` [B, S, H], ``pr`` (a product), the
    dropout masks ``m1``/``m2`` (drawn from the shape alone), ``d1``,
    ``s``/``h2`` (the fused residual + LN2), then ``z`` (the FC
    product), ``f`` (bias + GELU), ``o2`` (the FC-out product), or the
    MoE FFN's ``o2`` and ``moe_stats``; ``d2`` and the output ``y = s +
    d2``. Post-LN (original BERT): no ``h1`` (the QKV product reads
    ``x``); ``res_ln1`` gives ``s1``/``h2`` with LN1's params and
    ``res_ln2`` gives ``s2``/``y`` from ``h2 + d2`` with LN2's: the
    normalised value is the residual stream and the sums ``s1``/``s2``
    go unused (their cotangent is None, so K3b runs without gs).

    The attention is one step on the flash route (kind ``"flash"``) or
    of an opaque ``attention_fn``; on the dense route its steps are the
    head-major copies, QKᵀ and PV (kind ``"dot_batch"``), the softmax,
    its dropout mask and the merge of the heads. ``cfg.causal`` reaches
    the attention either way. ``mask`` (additive, broadcast to [B, nH,
    S, S]; ``additive_mask``) is a constant of the program: with it the
    flash route runs dense, as JAX's flash function does."""
    ops = ops or elementwise_ops(cfg, device)
    pre = cfg.pre_layer_norm
    attention_fn = attention_fn or auto_attention
    eps = cfg.layer_norm_eps
    B, S, H = shape
    nH, dH = cfg.num_heads, cfg.head_dim
    hd = 0.0 if deterministic else cfg.hidden_dropout
    ad = 0.0 if deterministic else cfg.attn_dropout

    def mask_op(name, rate, mshape):
        def fn(p, g):
            return (None if g is None else
                    dropout_mask(mshape, rate, g, device),)
        return Op(name, (), (name,), fn, draws=rate > 0.0)

    def qkv_split(qkv):
        return [t.reshape(B, S, nH, dH) for t in qkv.split(H, dim=-1)]

    prog = [
        Op("ln1", ("x",), ("h1",), lambda p, g, x: (
            ops.ln(x, p["ln1_scale"], p["ln1_bias"], eps),)),
    ] if pre else []
    prog.append(Op("qkv", ("h1" if pre else "x",), ("qkv",),
                   lambda p, g, h: (dense(h, p["qkv_kernel"],
                                          p["qkv_bias"]),), kind="dot"))
    route = _attention_route(attention_fn, device, S, mask is not None)
    if route == "dense":
        def k_v(qkv):
            q, k, v = qkv_split(qkv)
            return heads(q), heads_t(k), heads(v)
        prog += [
            Op("heads", ("qkv",), ("qh", "kt", "vh"),
               lambda p, g, qkv: k_v(qkv)),
            Op("qk", ("qh", "kt"), ("sc",), lambda p, g, q, k: (
                torch.bmm(q, k).view(B, nH, S, S),), kind="dot_batch"),
            Op("probs", ("sc",), ("w",), lambda p, g, sc: (
                attention_probs(sc, dH, cfg.causal, mask),)),
            mask_op("am", ad, (B, nH, S, S)),
            Op("adrop", ("w", "am"), ("wd",), lambda p, g, w, m: (
                apply_dropout(w, m, ad).to(dtype),)),
            Op("pv", ("wd", "vh"), ("o",), lambda p, g, w, v: (
                torch.bmm(w.reshape(B * nH, S, S), v),), kind="dot_batch"),
            Op("merge", ("o",), ("a",), lambda p, g, o: (
                o.view(B, nH, S, dH).permute(0, 2, 1, 3).reshape(B, S, H),)),
        ]
    else:
        def attend(p, g, qkv):
            q, k, v = qkv_split(qkv)
            return (attention_fn(q, k, v, mask=mask, causal=cfg.causal,
                                 attn_dropout=cfg.attn_dropout, rng=g,
                                 deterministic=deterministic
                                 ).reshape(B, S, H),)
        prog.append(Op("attn", ("qkv",), ("a",), attend,
                       kind="flash" if route == "flash" else None,
                       draws=True))
    prog += [
        Op("proj", ("a",), ("pr",), lambda p, g, a: (
            dense(a, p["proj_kernel"], p["proj_bias"]),), kind="dot"),
        mask_op("m1", hd, (B, S, H)),
        Op("drop1", ("pr", "m1"), ("d1",), lambda p, g, v, m: (
            apply_dropout(v, m, hd),)),
    ]
    if pre:
        # Fused residual-add + the FFN's LN: s continues the residual
        # stream, h2 feeds the FFN.
        prog.append(Op("res_ln", ("x", "d1"), ("s", "h2"),
                       lambda p, g, x, d: tuple(ops.res_ln(
                           x, d, p["ln2_scale"], p["ln2_bias"], eps))))
    else:
        # Post-LN: the normalised value is the residual stream.
        prog.append(Op("res_ln1", ("x", "d1"), ("s1", "h2"),
                       lambda p, g, x, d: tuple(ops.res_ln(
                           x, d, p["ln1_scale"], p["ln1_bias"], eps))))
    if moe:
        prog.append(Op("moe", ("h2",), ("o2", "moe_stats"),
                       lambda p, g, h: tuple(moe_ffn(
                           p, h, cfg, expert_ffn=ops.expert_ffn))))
    else:
        prog += [
            Op("fc", ("h2",), ("z",), lambda p, g, h: (
                torch.matmul(h, p["fc_kernel"].to(h.dtype)),), kind="dot"),
            Op("gelu", ("z",), ("f",), lambda p, g, z: (
                ops.bias_gelu(z, p["fc_bias"], cfg.gelu_exact),)),
            Op("fc_out", ("f",), ("o2",), lambda p, g, f: (
                dense(f, p["fc_out_kernel"], p["fc_out_bias"]),),
               kind="dot"),
        ]
    prog += [
        mask_op("m2", hd, (B, S, H)),
        Op("drop2", ("o2", "m2"), ("d2",), lambda p, g, v, m: (
            apply_dropout(v, m, hd),)),
    ]
    if pre:
        prog.append(Op("out", ("s", "d2"), ("y",),
                       lambda p, g, s, d: (s + d,)))
    else:
        prog.append(Op("res_ln2", ("h2", "d2"), ("s2", "y"),
                       lambda p, g, h, d: tuple(ops.res_ln(
                           h, d, p["ln2_scale"], p["ln2_bias"], eps))))
    return prog


def transformer_block(p: Dict[str, torch.Tensor], x: torch.Tensor,
                      cfg: TransformerConfig,
                      rng: Optional[torch.Generator] = None,
                      deterministic: bool = True,
                      attention_fn: Optional[Callable] = None,
                      ops: Optional[ElementwiseOps] = None,
                      mask: Optional[torch.Tensor] = None):
    """One block, pre-LN or post-LN (params WITHOUT the layer axis): x
    [B, S, H] → [B, S, H] (``block_program`` run plainly). The residual
    adds are fused into the LayerNorms (``res_ln``), as in the JAX
    block; ``mask`` is additive. ``rng`` drives the
    attention and hidden dropout (ignored when deterministic);
    ``attention_fn`` defaults to ``auto_attention``; ``ops`` defaults to
    the ones ``cfg.fused_kernels`` selects. With ``cfg.moe`` the FFN is
    the MoE FFN wherever ``p`` carries the expert tensors, and the block
    returns ``(x, moe_stats_or_None)``."""
    moe = "moe_fc_kernel" in p
    env = run_program(block_program(cfg, x.shape, x.device, x.dtype,
                                    deterministic, attention_fn, ops, moe,
                                    mask),
                      p, {"x": x}, rng)
    if cfg.moe is not None:
        return env["y"], env.get("moe_stats")
    return env["y"]


def _host_data(x: Any, what: str) -> Any:
    if isinstance(x, torch.Tensor):
        if x.device.type != "cpu":
            raise ValueError(
                f"{what} must be host data (a number, a sequence or a CPU "
                "tensor): a layer is skipped outright, so the host decides "
                "it, and reading a device tensor would wait for the card")
        return x.tolist()
    return x


def pld_keep(num_layers: int, theta: float,
             rng: torch.Generator) -> List[bool]:
    """Progressive layer drop's keep draws: layer l is kept with
    probability ``1 - (l+1)/L * (1 - theta)``, from L uniform fp64 draws
    of a CPU generator seeded with a digest of ``rng``'s state (a host
    copy: no sync with the card; ``rng`` does not advance). Each call with
    the step's generator at another state (each micro-step) draws anew,
    a run resumed at a step draws what an uninterrupted one would, and a
    caller holding the generator a loss gets can tell which layers that
    loss runs."""
    digest = hashlib.blake2b(rng.get_state().numpy().tobytes(),
                             digest_size=8, person=b"ds-pld").digest()
    seed = int.from_bytes(digest, "little") & ((1 << 63) - 1)
    u = torch.rand(num_layers, dtype=torch.float64,
                   generator=torch.Generator().manual_seed(seed)).tolist()
    return [u[i] < 1.0 - (i + 1) / num_layers * (1.0 - float(theta))
            for i in range(num_layers)]


def apply_blocks(stacked: Dict[str, torch.Tensor], x: torch.Tensor,
                 cfg: TransformerConfig,
                 rng: Optional[torch.Generator] = None,
                 deterministic: bool = True,
                 attention_fn: Optional[Callable] = None,
                 ops: Optional[ElementwiseOps] = None,
                 pld_theta: Optional[float] = None,
                 layer_valid: Optional[Sequence] = None,
                 mask: Optional[torch.Tensor] = None):
    """All L layers as a Python loop over the stacked leading axis (the
    JAX ``scan_layers=False`` program). Each stacked tensor is unbound
    once, so its gradient comes back as one stack, not as L scatters.
    With ``cfg.moe`` the dense and expert FFN stacks cover different
    layers, each indexed at its own position, and the return value is
    ``(x, moe_stats)``: the MoE layers' stats averaged over them.

    ``cfg.remat_policy`` other than ``"none"`` runs each block as a
    ``models/remat.Recompute`` region: the backward pass recomputes what
    the policy does not hold, replaying the block's dropout draws.

    ``pld_theta`` (a host float in (0, 1]) enables progressive layer
    drop, only with ``rng`` and not deterministic: layer l is kept with
    probability ``1 - (l+1)/L * (1 - theta)`` (``pld_keep``); a dropped
    layer is skipped outright (no launch; its params' grads are zero).
    ``layer_valid`` ([L] 0/1 host data): identity-skip slots, as the
    JAX pipeline's padded stages use them. Neither composes with MoE
    (as in JAX). ``mask``: the additive attention mask of every block
    (``additive_mask``)."""
    L = stacked["ln1_scale"].shape[0]
    kinds = remat_policy(cfg.remat_policy)
    moe_layers = [] if cfg.moe is None else \
        moe_layer_indices(L, cfg.moe_layer_freq)
    if cfg.moe is not None:
        if not moe_layers:
            raise ValueError(
                f"cfg.moe is set but moe_layer_freq={cfg.moe_layer_freq} "
                f"selects no MoE layer out of {L}")
        if pld_theta is not None or layer_valid is not None:
            raise ValueError(
                "moe blocks do not compose with progressive layer drop "
                "or padded layer_valid slots (a skipped layer has no "
                "fixed-shape expert stats)")
    run = [True] * L
    if layer_valid is not None:
        run = [bool(v) for v in _host_data(layer_valid, "layer_valid")]
        if len(run) != L:
            raise ValueError(f"layer_valid has {len(run)} slots for {L} "
                             "layers")
    if pld_theta is not None and rng is not None and not deterministic:
        keep = pld_keep(L, _host_data(pld_theta, "pld_theta"), rng)
        run = [r and k for r, k in zip(run, keep)]
    per_layer = {name: t.unbind(0) for name, t in stacked.items()}
    moe_pos = {li: j for j, li in enumerate(moe_layers)}
    dense_pos = {li: j for j, li in enumerate(
        i for i in range(L) if i not in moe_pos)}
    ffn_keys = MOE_PARAM_KEYS | {"fc_kernel", "fc_bias", "fc_out_kernel",
                                 "fc_out_bias"}
    programs: Dict[bool, List[Op]] = {}
    replay = GeneratorReplay(rng) if rng is not None and \
        kinds is not None else None
    stats = []
    for i in range(L):
        if not run[i]:
            continue
        p_i = {}
        for name, t in per_layer.items():
            if name not in ffn_keys:
                p_i[name] = t[i]
            elif name in MOE_PARAM_KEYS:
                if i in moe_pos:
                    p_i[name] = t[moe_pos[i]]
            elif i in dense_pos:
                p_i[name] = t[dense_pos[i]]
        moe = i in moe_pos
        if moe not in programs:
            programs[moe] = block_program(cfg, x.shape, x.device, x.dtype,
                                          deterministic, attention_fn, ops,
                                          moe, mask)
        if kinds is None:
            env = run_program(programs[moe], p_i, {"x": x}, rng)
        else:
            env = Recompute(programs[moe], kinds, replay).forward(
                p_i, {"x": x})
        x = env["y"]
        if moe:
            stats.append(env["moe_stats"])
    return x if cfg.moe is None else (x, aggregate_moe_stats(stats))


__all__ = ["TransformerConfig", "check_trainable", "layer_norm", "dense",
           "gelu", "dropout_mask", "apply_dropout", "dropout", "heads",
           "heads_t", "attention_probs", "dense_attention", "additive_mask",
           "ElementwiseOps",
           "KERNEL_OPS", "PLAIN_OPS", "elementwise_ops", "layer_norm_fn",
           "gelu_dense_fn", "init_block_params", "layer_slice",
           "block_program", "transformer_block", "pld_keep",
           "apply_blocks"]
