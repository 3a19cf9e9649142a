"""Stochastic rounding to bf16 for master-free training (port of
``deepspeed_tpu/ops/stochastic_rounding.py``).

A bf16 value is the top 16 bits of an fp32. Adding a uniform random
16-bit integer to the fp32's low mantissa bits before truncating makes
the carry into bit 16 fire with probability equal to the fractional
distance to the next bf16 value: unbiased rounding, E[round(x)] == x.
The noise here comes from a ``torch.Generator`` instead of a JAX key;
the fused optimizer step draws its noise inside the kernel from a
counter hash instead (``ops/fused_update.py``).
"""
from __future__ import annotations

from typing import Optional

import torch

from .fused_update import stochastic_round_bits


def stochastic_round_bf16(x: torch.Tensor,
                          generator: Optional[torch.Generator] = None
                          ) -> torch.Tensor:
    """Round ``x`` (widened to fp32) to bf16 stochastically; inf/nan
    pass through rounded to nearest."""
    x = x.float()
    noise = torch.randint(0, 1 << 16, x.shape, generator=generator,
                          device=x.device, dtype=torch.int64)
    return stochastic_round_bits(x, noise)


__all__ = ["stochastic_round_bf16"]
