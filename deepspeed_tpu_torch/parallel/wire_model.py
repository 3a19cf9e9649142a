"""Analytic per-step gradient-sync wire bytes (the JAX package's ring
model, ``parallel/hlo_audit.ring_wire_bytes`` and
``grad_sync_wire_model``, for a param tree at dp ranks).

A leaf is "scatterable" when one of its dims is at least dp and
divisible by it (the JAX ZeRO partition rule, ``zero/partition.
_leaf_spec``); the rest is the replicated tail, which all-reduces in
either lowering. The figures are the telemetry ``meta`` record's wire
bytes and the cost model's interconnect term.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, Optional, Sequence


def ring_wire_bytes(kind: str, payload_bytes: int, group_size: int) -> int:
    """Per-participant wire bytes of one collective under the ring model:
    all-reduce 2(g-1)/g · B; reduce-scatter, all-gather and all-to-all
    (g-1)/g · B over the full buffer B; a collective-permute B."""
    g = max(1, group_size)
    if kind == "all-reduce":
        return 2 * (g - 1) * payload_bytes // g
    if kind in ("reduce-scatter", "all-gather", "all-to-all"):
        return (g - 1) * payload_bytes // g
    if kind == "collective-permute":
        return payload_bytes
    raise ValueError(f"unknown collective kind {kind!r}")


def _scatterable(shape: Sequence[int], dp: int) -> bool:
    return any(d >= dp and d % dp == 0 for d in shape)


def grad_sync_wire_model(shapes: Iterable[Sequence[int]], dp: int,
                         grad_bytes_per_el: int = 4, zero3: bool = False,
                         param_bytes_per_el: Optional[int] = None,
                         gas: int = 1) -> Dict[str, Any]:
    """Per-step wire bytes of the grad sync of leaves of ``shapes`` at
    ``dp`` ranks, in both lowerings; with ``zero3`` the two param
    gathers a micro-step (at ``param_bytes_per_el``) and the grad
    reduce-scatter, gas times a step."""
    scatterable = replicated = scatterable_el = 0
    for shape in shapes:
        shape = tuple(int(s) for s in shape)
        if len(shape) < 1:
            continue
        nel = 1
        for s in shape:
            nel *= s
        if _scatterable(shape, dp):
            scatterable += nel * grad_bytes_per_el
            scatterable_el += nel
        else:
            replicated += nel * grad_bytes_per_el
    repl_wire = ring_wire_bytes("all-reduce", replicated, dp)
    out = {
        "dp": dp,
        "grad_bytes": scatterable + replicated,
        "scatterable_bytes": scatterable,
        "replicated_bytes": replicated,
        "reduce_scatter_wire_bytes":
            ring_wire_bytes("reduce-scatter", scatterable, dp) + repl_wire,
        "all_reduce_wire_bytes":
            ring_wire_bytes("all-reduce", scatterable, dp) + repl_wire,
    }
    if zero3:
        pbytes = int(param_bytes_per_el or grad_bytes_per_el)
        gather_payload = scatterable_el * pbytes
        one_gather = ring_wire_bytes("all-gather", gather_payload, dp)
        out.update({
            "param_gather_payload_bytes": gather_payload,
            "param_gather_wire_bytes": 2 * int(gas) * one_gather,
            "param_gathers_per_step": 2 * int(gas),
            "zero3_wire_bytes":
                int(gas) * (out["reduce_scatter_wire_bytes"]
                            + 2 * one_gather),
        })
    return out


__all__ = ["ring_wire_bytes", "grad_sync_wire_model"]
