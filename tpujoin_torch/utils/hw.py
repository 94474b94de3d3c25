"""Device constants for roofline accounting (the port of tpujoin/utils/hw.py).

HBM peak bandwidth of NVIDIA's H100 parts, from NVIDIA's data sheets,
looked up from the CUDA device's name.
"""
from __future__ import annotations

import torch

# device-name substring -> GB/s; the first match wins
_HBM_GBPS = (
    ("H100 PCIe", 2000.0),
    ("H100 NVL", 3900.0),
    ("H100", 3350.0),       # H100 SXM ("NVIDIA H100 80GB HBM3")
)


def hbm_peak_gbps(device: torch.device | str | None = None) -> float:
    """HBM peak of a CUDA device in GB/s; 0.0 when unknown or not CUDA."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return 0.0
    name = torch.cuda.get_device_name(device)
    for marker, gbps in _HBM_GBPS:
        if marker in name:
            return gbps
    return 0.0
