"""Heterogeneous per-stage pipeline programs (port of
``deepspeed_tpu/runtime/pipe/hetero.py``).

The reference partitions any layer list across stages, e.g. a conv stem
on stage 0 feeding transformer stages. ``hetero_pipe_spec`` builds a
``PipeSpec`` whose stages run different programs: ``programs[k]`` is
``prog(params, x, rng) -> x`` and ``stage_programs[s]`` names stage s's.

The JAX package runs every program on every stage and selects the
owner's output (its SPMD program has one body for all stages). In the
port each stage is its own process, so a stage runs only the program it
owns: the same output, without the other programs' work. The parameters
keep the JAX layout: each program's parameters stacked over the P
stages (``blocks["prog{k}"]``, a ``[P, ...]`` leaf each), zeros on the
stages that do not own it. Those zeros are never read, so their grads
are exactly zero and the optimizer keeps them at zero (decoupled weight
decay of a zero is zero), and the checkpoint files are the JAX ones.

A program must keep the boundary activation's shape and dtype (the
tensor one stage sends the next); JAX's checks and messages are kept,
at build time against ``sample_x`` and at every stage call.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence

import torch

from ...models.gpt2_pipe import PipeSpec
from ...ops.fused_update import tree_flatten, tree_unflatten


def _check_boundary(p: int, got_shape, got_dtype, want_shape,
                    want_dtype) -> None:
    if tuple(got_shape) != tuple(want_shape):
        raise ValueError(
            f"program {p} changes the boundary shape {tuple(want_shape)}"
            f" -> {tuple(got_shape)}; pipeline stages must preserve it (the "
            "ppermute buffer is one uniform array)")
    if got_dtype != want_dtype:
        raise ValueError(
            f"program {p} changes the boundary dtype {want_dtype} -> "
            f"{got_dtype}; pipeline stages must preserve it (the "
            "ppermute buffer is one uniform array)")


def hetero_pipe_spec(embed_fn: Callable, head_fn: Callable,
                     programs: Sequence[Callable],
                     stage_programs: Sequence[int],
                     stage_params: Sequence[Any],
                     shared_params: Optional[Dict[str, Any]] = None,
                     sample_x: Optional[torch.Tensor] = None,
                     rng: Optional[torch.Generator] = None) -> PipeSpec:
    """A ``PipeSpec`` whose stages run different programs (module
    docstring). ``stage_params``: one parameter tree a stage, of its
    program's structure (stages sharing a program have equal leaf
    shapes). ``sample_x``: an optional boundary-shaped tensor every
    program is checked against at build time."""
    K, Pn = len(programs), len(stage_programs)
    stage_programs = [int(p) for p in stage_programs]
    if sorted(set(stage_programs)) != list(range(K)):
        raise ValueError(f"stage_programs {list(stage_programs)} must use "
                         f"every program index 0..{K - 1}")
    if len(stage_params) != Pn:
        raise ValueError(f"need one param tree per stage: "
                         f"{len(stage_params)} != {Pn}")
    templates: Dict[int, Any] = {}
    for s, p in enumerate(stage_programs):
        t = templates.setdefault(p, stage_params[s])
        if tree_flatten(stage_params[s])[1] != tree_flatten(t)[1]:
            raise ValueError(f"stage {s} param structure differs from "
                             f"program {p}'s other stages")
    blocks = {}
    for p in range(K):
        leaves, spec = tree_flatten(templates[p])
        per_stage = [tree_flatten(stage_params[s])[0]
                     if stage_programs[s] == p else
                     [torch.zeros_like(torch.as_tensor(x)) for x in leaves]
                     for s in range(Pn)]
        blocks[f"prog{p}"] = tree_unflatten(spec, [
            torch.stack([torch.as_tensor(per_stage[s][j])
                         for s in range(Pn)])
            for j in range(len(leaves))])

    if sample_x is not None:
        with torch.no_grad():
            for p in range(K):
                got = programs[p](templates[p], sample_x, rng)
                _check_boundary(p, got.shape, got.dtype, sample_x.shape,
                                sample_x.dtype)

    def stage_fn(blocks_local, x, rng, stage):
        # (each stage holds a [1, ...] slice of every program's stack)
        p = stage_programs[stage]
        leaves, spec = tree_flatten(blocks_local[f"prog{p}"])
        out = programs[p](tree_unflatten(spec, [t[0] for t in leaves]), x,
                          rng)
        _check_boundary(p, out.shape, out.dtype, x.shape, x.dtype)
        return out

    return PipeSpec(embed_fn=embed_fn, stage_fn=stage_fn, head_fn=head_fn,
                    params={"shared": shared_params or {}, "blocks": blocks},
                    num_layers=Pn, stage_layers=[1] * Pn)


__all__ = ["hetero_pipe_spec"]
