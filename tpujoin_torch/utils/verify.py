"""Full-coverage verification of materialized pair columns (the port of
tpujoin/utils/verify.py: the position-sensitive window checksums that the
high-selectivity bench needs).

A ~1e9-pair result is checked in two halves: the native oracle checks the
factorized (RLE) form, which is the join; then every materialized slot is
covered by 64-bit checksums over 2^20-slot windows, reduced on the device
(:func:`window_checksums`) and recomputed on the host from the verified RLE
form (:func:`expected_checksums`), one window at a time. Any slot whose
(r, s) differs from the expectation flips its window's checksum with
probability 1 - 2^-64.

The device half works in int64, which torch shifts arithmetically: each
right shift is masked to its logical result, and the constants above 2^63
are written as their two's-complement int64 values. Products wrap modulo
2^64 as the uint64 ones do.
"""
from __future__ import annotations

import numpy as np
import torch

VERIFY_WINDOW = 1 << 20
_M1 = 0xBF58476D1CE4E5B9
_M2 = 0x94D049BB133111EB
GOLDEN = 0x9E3779B97F4A7C15
CHUNK_WINDOWS = 8   # windows per device step: ~0.5 GB of int64 temporaries


def _i64(c: int) -> int:
    """The int64 with the bits of the uint64 ``c``."""
    return c - (1 << 64) if c >= 1 << 63 else c


def _srl(z: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 ``z`` by ``k`` bits."""
    return (z >> k) & ((1 << (64 - k)) - 1)


def mix64(z: torch.Tensor) -> torch.Tensor:
    """The splitmix64 finalizer on int64 bits."""
    z = (z ^ _srl(z, 30)) * _i64(_M1)
    z = (z ^ _srl(z, 27)) * _i64(_M2)
    return z ^ _srl(z, 31)


def mix64_np(z):
    z = (z ^ (z >> np.uint64(30))) * np.uint64(_M1)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(_M2)
    return z ^ (z >> np.uint64(31))


def window_checksums(r_ids: torch.Tensor, s_ids: torch.Tensor, total: int,
                     num_windows: int):
    """Position-sensitive checksums of the first ``num_windows`` 2^20-slot
    windows of the pair columns, as numpy (hi32, lo32) uint32 arrays: per
    window the xor of mix64((r << 32 | s) + t * GOLDEN) over its slots
    t < total (slots from the total on contribute nothing). Reduced on the
    columns' device, CHUNK_WINDOWS windows at a time."""
    w = VERIFY_WINDOW
    if r_ids.shape[0] < num_windows * w or s_ids.shape[0] < num_windows * w:
        raise ValueError("window_checksums: columns shorter than the windows")
    dev = r_ids.device
    out = []
    for c0 in range(0, num_windows, CHUNK_WINDOWS):
        c1 = min(c0 + CHUNK_WINDOWS, num_windows)
        r = r_ids[c0 * w:c1 * w].long()
        s = s_ids[c0 * w:c1 * w].long()
        t = torch.arange(c0 * w, c1 * w, dtype=torch.int64, device=dev)
        z = mix64(((r << 32) | s) + t * _i64(GOLDEN))
        z = torch.where(t < total, z, 0).view(c1 - c0, w)
        while z.shape[1] > 1:   # xor fold: log2(2^20) = 20 halvings
            half = z.shape[1] // 2
            z = z[:, :half] ^ z[:, half:]
        out.append(z[:, 0])
    h = (torch.cat(out) if out else torch.zeros(0, dtype=torch.int64)).cpu()
    return (((h >> 32) & 0xFFFFFFFF).numpy().astype(np.uint32),
            (h & 0xFFFFFFFF).numpy().astype(np.uint32))


def expected_checksums(src, sid, lo, cnt, total: int, num_windows: int):
    """Host-streamed per-window checksums and the multiset sum from an
    (already verified) RLE form, never materializing more than one window.
    ``src`` maps build positions to ids; run r expands to the pairs
    (src[lo[r] + j], sid[r]) for j < cnt[r]. Returns (hi32, lo32, msum)."""
    w = VERIFY_WINDOW
    cnt64 = cnt.astype(np.int64)
    offs = np.cumsum(cnt64) - cnt64
    hi32 = np.empty(num_windows, np.uint32)
    lo32 = np.empty(num_windows, np.uint32)
    msum = np.uint64(0)
    for c in range(num_windows):
        a, b = c * w, min((c + 1) * w, total)
        if a >= b:
            hi32[c] = lo32[c] = 0
            continue
        i0 = max(np.searchsorted(offs, a, side="right") - 1, 0)
        i1 = np.searchsorted(offs, b, side="left")
        rs, rl, rc, rid = offs[i0:i1], lo[i0:i1], cnt64[i0:i1], sid[i0:i1]
        starts = np.maximum(rs, a)
        ends = np.minimum(rs + rc, b)
        lens = ends - starts
        j = (np.arange(b - a) - np.repeat(np.cumsum(lens) - lens, lens)
             + np.repeat(starts - rs, lens))
        r = src[np.repeat(rl, lens) + j].astype(np.uint64)
        s = np.repeat(rid, lens).astype(np.uint64)
        t = np.arange(a, b, dtype=np.uint64)
        pack = (r << np.uint64(32)) | s
        h = mix64_np(pack + t * np.uint64(GOLDEN))
        folded = np.bitwise_xor.reduce(h)
        hi32[c] = np.uint32(folded >> np.uint64(32))
        lo32[c] = np.uint32(folded & np.uint64(0xFFFFFFFF))
        with np.errstate(over="ignore"):
            msum = msum + mix64_np(pack).sum(dtype=np.uint64)
    return hi32, lo32, int(msum)
