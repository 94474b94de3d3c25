"""The yardstick of the rooflines: the card's peak and the bytes each
layer's function needs from its inputs, whatever implements it.

Each count is the function's own traffic, every input byte read once and
every output byte written once, so it does not move when a kernel is
fused, renamed or replaced, and a share of it cannot pass 100% unless the
time leaves out part of the work.
"""
from __future__ import annotations

I32 = 4

# HBM peak in bytes/s by device-name marker, from NVIDIA's data sheets; the
# first marker found in the name wins.
HBM_PEAK = (
    ("H100 PCIe", 2.0e12),
    ("H100 NVL", 3.9e12),
    ("H100", 3.35e12),   # H100 SXM, "NVIDIA H100 80GB HBM3"
)


def hbm_peak(device_name: str) -> float | None:
    """The card's HBM peak in bytes/s, None for a card not in the table."""
    for marker, peak in HBM_PEAK:
        if marker in device_name:
            return peak
    return None


def sort_bytes(build_rows: int) -> int:
    """The build's (key, row id) sort: the keys read once, the sorted keys
    and their row ids written once."""
    return 3 * I32 * build_rows


def materialize_bytes(matched_rows: int, pairs: int) -> int:
    """The pair columns from the count's state: a probe id, a first build
    position and a count read once for each matched probe row, and two
    i32 ids written once for each pair."""
    return 3 * I32 * matched_rows + 2 * I32 * pairs
