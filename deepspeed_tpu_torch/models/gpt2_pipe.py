"""GPT-2 expressed for the pipeline engine (port of
``deepspeed_tpu/models/gpt2_pipe.py``).

A ``PipeSpec`` is a uniform-stage pipeline model: three functions and
one parameter tree, ``{"shared": ..., "blocks": ...}``. ``shared`` holds
what the first and the last stage share (GPT-2's embeddings and final
LayerNorm: the tied embed/unembed pair, the reference's
``TiedLayerSpec``), ``blocks`` the transformer blocks stacked on a
leading layer axis, which the stages split in equal slices. The
contract (``runtime/pipe/engine.py`` runs it, one process a stage):

- ``embed_fn(shared, tokens, rng) -> x`` on the first stage;
- ``stage_fn(blocks_local, x, rng, stage) -> x`` on every stage, over
  its slice of the stacked blocks (``stage``: the stage's index, which
  the JAX package reads from the mesh inside its SPMD program);
- ``head_fn(shared, x, targets, rng) -> loss`` on the last stage.

Non-uniform cuts (``stage_layers``): each stage's slice is padded to
the longest with identity layers (zeros, skipped at run time through
``apply_blocks(layer_valid=...)``), so every stage holds a slice of one
shape and the parameter tree keeps the JAX package's layout.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..ops.cross_entropy import chunked_softmax_xent
from .gpt2 import GPT2Config, gpt2_init
from .transformer import apply_blocks, elementwise_ops


@dataclasses.dataclass
class PipeSpec:
    """Uniform-stage pipeline model: functions + parameters (module
    docstring). ``stage_layers`` is set when the spec was built with
    explicit per-stage layer counts; the stage count is then fixed."""
    embed_fn: Callable
    stage_fn: Callable
    head_fn: Callable
    params: Dict[str, Any]
    num_layers: int
    stage_layers: Optional[List[int]] = None

    def check_stages(self, num_stages: int) -> None:
        """JAX's build-time checks of a stage count, in its order."""
        if num_stages > 1 and self.num_layers % num_stages != 0:
            raise ValueError(f"{self.num_layers} layers not divisible by "
                             f"{num_stages} pipeline stages")
        if self.stage_layers is not None and \
                len(self.stage_layers) != num_stages:
            raise ValueError(
                f"this PipeSpec was built for {len(self.stage_layers)} "
                f"stages (stage_layers={list(self.stage_layers)}) but the "
                f"mesh has pp={num_stages}")

    def stage_params(self, stage: int, num_stages: int) -> Dict[str, Any]:
        """What stage ``stage`` of ``num_stages`` holds: its slice of the
        stacked blocks, and ``shared`` on the first and the last stage
        (the middle stages run neither the embedding nor the head)."""
        per = self.num_layers // num_stages
        blocks = _tree_map(lambda t: t[stage * per:(stage + 1) * per],
                           self.params["blocks"])
        ends = stage in (0, num_stages - 1)
        return {"shared": self.params.get("shared", {}) if ends else {},
                "blocks": blocks}


def _tree_map(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def pad_stacked_blocks(blocks: Dict[str, Any], num_layers: int,
                       stage_layers: Sequence[int]
                       ) -> Tuple[Dict[str, Any], List[float]]:
    """Non-uniform pipeline cuts: re-stack ``[L, ...]`` blocks as
    ``[P * Lmax, ...]``, stage s owning slice ``[s*Lmax, (s+1)*Lmax)``
    with its ``stage_layers[s]`` real layers followed by identity
    padding (zeros). Returns ``(padded_blocks, valid)``, ``valid`` the
    ``[P * Lmax]`` 0/1 list of real slots."""
    stage_layers = [int(n) for n in stage_layers]
    if sum(stage_layers) != num_layers:
        raise ValueError(f"stage_layers {stage_layers} must sum to "
                         f"{num_layers}")
    Pn, Lmax = len(stage_layers), max(stage_layers)
    bounds = [0]
    for n in stage_layers:
        bounds.append(bounds[-1] + n)

    def pad_leaf(leaf):
        out = torch.zeros((Pn * Lmax,) + tuple(leaf.shape[1:]),
                          dtype=leaf.dtype, device=leaf.device)
        for s in range(Pn):
            lo, hi = bounds[s], bounds[s + 1]
            out[s * Lmax: s * Lmax + (hi - lo)] = leaf[lo:hi]
        return out

    valid = [0.0] * (Pn * Lmax)
    for s in range(Pn):
        for i in range(stage_layers[s]):
            valid[s * Lmax + i] = 1.0
    return _tree_map(pad_leaf, blocks), valid


def gpt2_pipe_spec(cfg: GPT2Config,
                   generator: Optional[torch.Generator] = None,
                   stage_layers: Optional[Sequence[int]] = None,
                   params: Optional[Dict[str, Any]] = None,
                   attention_fn: Optional[Callable] = None,
                   device=None) -> PipeSpec:
    """GPT-2 as a ``PipeSpec``. ``params``: a ``models/gpt2`` parameter
    tree (``gpt2_init``'s, or one carried from JAX by
    ``models/convert.from_jax_params``), by default ``gpt2_init(cfg,
    generator, device)``. ``stage_layers``: optional per-stage layer
    counts (non-uniform cuts, e.g. ``[10, 9, 9, 8]``)."""
    flat = params if params is not None else \
        gpt2_init(cfg, generator, device)
    blocks = flat["blocks"]
    stage_valid = None
    if stage_layers is not None:
        stage_layers = [int(n) for n in stage_layers]
        blocks, valid = pad_stacked_blocks(blocks, cfg.num_layers,
                                           stage_layers)
        Lmax = max(stage_layers)
        stage_valid = [valid[s * Lmax:(s + 1) * Lmax]
                       for s in range(len(stage_layers))]
    tree = {"shared": {"wte": flat["wte"], "wpe": flat["wpe"],
                       "ln_f_scale": flat["ln_f_scale"],
                       "ln_f_bias": flat["ln_f_bias"]},
            "blocks": blocks}

    def embed_fn(shared, tokens, rng):
        S = tokens.shape[-1]
        return shared["wte"].to(cfg.dtype)[tokens] + \
            shared["wpe"].to(cfg.dtype)[None, :S]

    def stage_fn(blocks_local, x, rng, stage):
        if cfg.moe is not None:
            raise NotImplementedError(
                "MoE blocks do not compose with the pipeline stage path "
                "(apply_blocks would return a stats tuple the stage fn "
                "cannot thread), as in the JAX package")
        valid = None if stage_valid is None else stage_valid[stage]
        return apply_blocks(blocks_local, x, cfg, rng=rng,
                            deterministic=cfg.hidden_dropout == 0.0,
                            attention_fn=attention_fn, layer_valid=valid)

    def head_fn(shared, x, targets, rng):
        ops = elementwise_ops(cfg, x.device)
        x = ops.ln(x, shared["ln_f_scale"], shared["ln_f_bias"],
                   cfg.layer_norm_eps)
        B, S, H = x.shape
        return chunked_softmax_xent(x.reshape(B * S, H),
                                    shared["wte"].to(cfg.dtype),
                                    targets.reshape(-1))

    stage_fn.cfg = cfg
    num = cfg.num_layers if stage_layers is None else \
        len(stage_layers) * max(stage_layers)
    return PipeSpec(embed_fn=embed_fn, stage_fn=stage_fn, head_fn=head_fn,
                    params=tree, num_layers=num, stage_layers=stage_layers)


__all__ = ["PipeSpec", "pad_stacked_blocks", "gpt2_pipe_spec"]
