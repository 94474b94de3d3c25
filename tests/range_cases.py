"""The equal-range search's test cases, shared by
tests/test_torch_range_search.py (on the CPU) and tests/test_torch_cuda.py
(on the card). Imports no JAX."""
import numpy as np
import torch

# (lo, cnt) by two torch.searchsorted, left and right: the yardstick
from tpujoin_torch.kernels.merge_count import (  # noqa: F401
    merge_count_plain as two_searchsorted)

IMAX = np.iinfo(np.int32).max
IMIN = np.iinfo(np.int32).min

CASES = ("uniform", "narrow", "dup8", "one_key", "outlier", "negative",
         "extremes", "outside", "n1", "n0", "m0")


def _build_keys(case: str, rng) -> np.ndarray:
    if case == "uniform":           # ref_low's keys at a small n
        return rng.integers(1, 10**9 + 1, 20_000)
    if case == "narrow":            # a range narrower than 2^p: shift 0
        return rng.integers(1, 401, 20_000)
    if case == "dup8":              # heavy duplication
        return rng.integers(0, 8, 10_000)
    if case == "one_key":           # one key repeated
        return np.full(5000, 42)
    if case == "outlier":           # one key stretches the range
        return np.append(rng.integers(1, 1001, 9999), IMAX)
    if case == "negative":
        return rng.integers(-10**6, 0, 10_000)
    if case == "extremes":          # both i32 ends, each repeated
        return rng.choice(np.array([IMIN, IMIN + 1, -1, 0, 5, IMAX - 1,
                                    IMAX]), 7000)
    if case == "outside":           # probes below and above every key
        return rng.integers(1000, 2001, 3000)
    if case == "n1":
        return np.array([7])
    if case in ("n0", "m0"):
        return np.zeros(0) if case == "n0" else rng.integers(1, 100, 1000)
    raise ValueError(case)


def range_case(case: str, device="cpu", seed: int = 25):
    """(sorted build keys, unsorted probe keys), int32 on ``device``: half
    the probe keys drawn from the build keys, half from a range wider than
    theirs, and each i32 end and the keys just outside the build keys'
    range among them. The same arguments give the same data everywhere."""
    rng = np.random.default_rng(seed)
    b = np.sort(_build_keys(case, rng)).astype(np.int64)
    if case == "m0":
        p = np.zeros(0, np.int64)
    else:
        lo, hi = (int(b[0]), int(b[-1])) if len(b) else (-50, 50)
        width = max(hi - lo, 100)
        wide = rng.integers(max(lo - width, IMIN), min(hi + width, IMAX) + 1,
                            4000)
        hits = rng.choice(b, 4000) if len(b) else wide
        ends = np.array([IMIN, IMIN + 1, IMAX - 1, IMAX, lo - 1, lo, hi,
                         hi + 1]).clip(IMIN, IMAX)
        p = rng.permutation(np.concatenate([wide, hits, ends]))
    return (torch.from_numpy(b.astype(np.int32)).to(device),
            torch.from_numpy(p.astype(np.int32)).to(device))
