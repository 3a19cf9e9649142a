"""The card's peak table: the one place the port's hardware ceilings
live (port of ``deepspeed_tpu/monitor/peaks.py``, with the card's rows
in place of the TPU generations).

``ChipPeaks`` keeps the JAX field names, so a ``cost_model`` record's
``chip`` dict reads the same in either stream:

- ``bf16_tflops``: dense bf16 tensor-core peak (the MFU denominator);
- ``hbm_gbs``: HBM bandwidth, GB/s (the memory ceiling);
- ``ici_gbs``: the card-to-card link, GB/s one way (NVLink: the
  ceiling of a collective between the cards of one host);
- ``dcn_gbs``: the host's network share a card, GB/s one way (the
  ceiling of a hop between hosts; the port runs one host).

They are ceilings for roofline verdicts and utilisation fractions, not
measurements. A card with no row (or the CPU) takes the H100 SXM row
flagged ``assumed=True``, as the JAX table falls back to its v5e row.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

# NVIDIA H100 SXM5 80GB (the data sheet of the H100 Tensor Core GPU,
# SXM form factor, dense figures at the 700 W limit): bf16 989 TFLOP/s,
# HBM3 3.35 TB/s, fourth-generation NVLink 900 GB/s both ways (450 one
# way); one ConnectX-7 400 Gb/s port a GPU (the DGX H100 layout) for the
# network. chip_smoke.py prices its kernel bounds at the same bf16 and
# HBM figures.
H100_SXM = {"bf16_tflops": 989.0, "hbm_gbs": 3350.0, "ici_gbs": 450.0,
            "dcn_gbs": 50.0}

# Rows by the device-name key they are resolved from
# (``torch.cuda.get_device_name()``: "NVIDIA H100 80GB HBM3" is the SXM
# part; the PCIe card names itself "NVIDIA H100 PCIe").
GPU_PEAKS: Dict[str, Dict[str, float]] = {
    "h100-sxm": H100_SXM,
}
_KIND_KEYS = (("h100 80gb hbm3", "h100-sxm"), ("h100 sxm", "h100-sxm"))
_DEFAULT = "h100-sxm"


@dataclasses.dataclass(frozen=True)
class ChipPeaks:
    """Per-card hardware ceilings."""
    name: str                  # resolved row key, e.g. "h100-sxm"
    bf16_tflops: float
    hbm_gbs: float
    ici_gbs: float
    dcn_gbs: float = H100_SXM["dcn_gbs"]
    assumed: bool = False      # True when the device name had no row

    @property
    def flops_per_sec(self) -> float:
        return self.bf16_tflops * 1e12

    @property
    def hbm_bytes_per_sec(self) -> float:
        return self.hbm_gbs * 1e9

    @property
    def ici_bytes_per_sec(self) -> float:
        return self.ici_gbs * 1e9

    @property
    def dcn_bytes_per_sec(self) -> float:
        return self.dcn_gbs * 1e9

    def as_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)


def _resolve(device_kind: str) -> Optional[str]:
    kind = (device_kind or "").lower()
    for needle, key in _KIND_KEYS:
        if needle in kind:
            return key
    return None


def peaks_for_kind(device_kind: str) -> ChipPeaks:
    """ChipPeaks for a device name; an unknown one (the CPU, another
    card) gets the H100 SXM row flagged ``assumed``."""
    key = _resolve(device_kind)
    key, assumed = (key, False) if key else (_DEFAULT, True)
    return ChipPeaks(name=key, assumed=assumed, **GPU_PEAKS[key])


def chip_peaks(device=None) -> ChipPeaks:
    """ChipPeaks of ``device`` (a ``torch.device`` or name; default: the
    current CUDA device, or the CPU)."""
    import torch
    dev = torch.device(device) if device is not None else (
        torch.device("cuda") if torch.cuda.is_available()
        else torch.device("cpu"))
    if dev.type != "cuda":
        return peaks_for_kind("cpu")
    return peaks_for_kind(torch.cuda.get_device_name(dev))


__all__ = ["GPU_PEAKS", "H100_SXM", "ChipPeaks", "peaks_for_kind",
           "chip_peaks"]
