"""Benchmark / operator configuration (a copy of tpujoin/core/config.py,
which cannot be imported here: importing ``tpujoin`` imports jax).

The reference hard-codes its configuration as module-level
``memref.global constant`` scalars (reference join_v1.mlir:5-10: rows=1e8,
hashTableSize=1e6, threadsPerBlock=256) and key-range constants in C++
(reference shared_stuff/shared.cpp:13-14: keys in [1, 1e9]); changing a
benchmark config means editing source. Here configs are dataclasses with the
reference's two published benchmark configs as presets
(reference join-performances.md:3-11, :16-24) plus the extension configs
required by BASELINE.json.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class JoinConfig:
    """One join benchmark workload."""

    name: str
    build_rows: int
    probe_rows: int
    key_min: int = 1          # reference shared.cpp:13 lowerRange
    key_max: int = 1_000_000_000  # reference shared.cpp:14 upperRange
    distribution: str = "uniform"   # "uniform" | "zipf"
    zipf_s: float = 1.0
    seed: int = 0
    # engine knobs (the analogue of hashTableSize/threadsPerBlock):
    probe_chunk_rows: int = 8 * 1024 * 1024   # rows of probe side per device pass
    result_pad_multiple: int = 1 << 20        # result capacity rounding granule

    @property
    def expected_matches(self) -> float:
        """E[|R ⋈ S|]: n*m*sum_k p_k*q_k. Uniform keys: n*m/|domain|.
        Zipf(s~1): p_k ~ 1/(k*H_N), so sum p_k^2 ~ zeta(2)/H_N^2 — vastly
        larger than uniform (the head keys collide quadratically)."""
        import math

        domain = self.key_max - self.key_min + 1
        if self.distribution == "zipf":
            h = math.log(domain) + 0.5772156649
            return (self.build_rows * self.probe_rows
                    * (math.pi ** 2 / 6.0) / (h * h))
        return self.build_rows * self.probe_rows / domain


# The reference's two published configs (join-performances.md:3-11, :16-24)
# plus scaled-down variants for tests and the BASELINE.json extension configs.
PRESETS = {
    # reference config 1: 10M x 10M, keys 1..100k  => ~1B result rows
    "ref_high_selectivity": JoinConfig(
        name="ref_high_selectivity",
        build_rows=10_000_000, probe_rows=10_000_000,
        key_min=1, key_max=100_000,
    ),
    # reference config 2: 100M x 100M, keys 1..1B  => ~10M result rows
    "ref_low_selectivity": JoinConfig(
        name="ref_low_selectivity",
        build_rows=100_000_000, probe_rows=100_000_000,
        key_min=1, key_max=1_000_000_000,
    ),
    # BASELINE.json config "join_v1 equi-join ~1M x 1M"
    "baseline_1m": JoinConfig(
        name="baseline_1m",
        build_rows=1_000_000, probe_rows=1_000_000,
        key_min=1, key_max=1_000_000,
    ),
    # small configs for CI / CPU tests
    "test_small": JoinConfig(
        name="test_small",
        build_rows=4096, probe_rows=4096, key_min=1, key_max=512,
        probe_chunk_rows=2048, result_pad_multiple=1024,
    ),
    "test_tiny": JoinConfig(
        name="test_tiny",
        build_rows=64, probe_rows=64, key_min=1, key_max=16,
        probe_chunk_rows=64, result_pad_multiple=64,
    ),
    # BASELINE.json config 5: skewed Zipf(1.0) keys
    "zipf_skew": JoinConfig(
        name="zipf_skew",
        build_rows=10_000_000, probe_rows=10_000_000,
        key_min=1, key_max=1_000_000, distribution="zipf", zipf_s=1.0,
    ),
}
