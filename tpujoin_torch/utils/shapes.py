"""Shape and tile arithmetic (the port of tpujoin/utils/shapes.py)."""
from __future__ import annotations


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    """Round x up to a multiple of m (m >= 1); m when x <= 0. Buckets
    dynamic result sizes into a few capacities."""
    if x <= 0:
        return m
    return cdiv(x, m) * m
