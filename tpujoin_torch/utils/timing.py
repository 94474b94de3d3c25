"""Wall-clock phase timing (the port of tpujoin/utils/timing.py).

Each timed call ends in ``torch.cuda.synchronize()`` on a CUDA device, so a
time covers the device work and not only its launch. A phase reports the
minimum of its runs: the steadiest statistic of runs that are otherwise
identical.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch

from tpujoin_torch.utils.hw import hbm_peak_gbps


@dataclasses.dataclass
class PhaseStat:
    name: str
    seconds: float
    bytes_touched: int = 0
    rows: int = 0
    device: str = "cpu"

    @property
    def gbps(self) -> float:
        return self.bytes_touched / self.seconds / 1e9 if self.seconds > 0 else 0.0

    @property
    def rows_per_sec(self) -> float:
        return self.rows / self.seconds if self.seconds > 0 else 0.0

    def as_dict(self) -> dict:
        d = {"phase": self.name, "seconds": self.seconds}
        if self.rows:
            d["rows_per_sec"] = self.rows_per_sec
        if self.bytes_touched:
            d["achieved_gbps"] = self.gbps
            peak = hbm_peak_gbps(self.device)
            if peak:
                d["hbm_fraction"] = self.gbps / peak
        return d


def sync(device: torch.device | str) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def time_fn(
    fn: Callable,
    *args,
    device: torch.device | str = "cpu",
    warmup: int = 1,
    iters: int = 3,
    name: str = "op",
    bytes_touched: int = 0,
    rows: int = 0,
) -> PhaseStat:
    """Time ``fn(*args)`` ``iters`` times after ``warmup`` runs; report the
    minimum."""
    for _ in range(warmup):
        fn(*args)
        sync(device)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        sync(device)
        times.append(time.perf_counter() - t0)
    return PhaseStat(name, min(times), bytes_touched, rows, str(device))
