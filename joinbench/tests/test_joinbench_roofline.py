"""The roofline's byte counts and peaks, worked by hand for both
configurations."""
import json
import math
from pathlib import Path

import pytest

from joinbench import roofline

CONFIGS = Path(__file__).resolve().parent.parent / "configs"


def config(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


def expected_join(cfg):
    """(matched probe rows, pairs) of uniform keys, in expectation."""
    domain = cfg["key_max"] - cfg["key_min"] + 1
    n, m = cfg["build_rows"], cfg["probe_rows"]
    return m * (1 - math.exp(-n / domain)), n * m / domain


def test_sort_bytes_of_ref_low():
    # 1e8 keys read, 1e8 sorted keys and 1e8 ids written, 4 B each
    assert roofline.sort_bytes(config("ref_low_selectivity")["build_rows"]) \
        == 1_200_000_000


@pytest.mark.parametrize("name,want", [
    # 9.516e6 matched rows x 12 B + 1e7 pairs x 8 B
    ("ref_low_selectivity", 1.94e8),
    # 1e7 matched rows x 12 B + 1e9 pairs x 8 B
    ("ref_high_selectivity", 8.12e9),
])
def test_materialize_bytes(name, want):
    rows, pairs = expected_join(config(name))
    assert roofline.materialize_bytes(round(rows), round(pairs)) == \
        pytest.approx(want, rel=2e-3)


def test_materialize_bytes_by_hand():
    assert roofline.materialize_bytes(1, 1) == 20
    assert roofline.materialize_bytes(10, 0) == 120


@pytest.mark.parametrize("name,peak", [
    ("NVIDIA H100 80GB HBM3", 3.35e12), ("NVIDIA H100 PCIe", 2.0e12),
    ("NVIDIA H100 NVL", 3.9e12), ("cpu", None), ("NVIDIA A100", None)])
def test_hbm_peak(name, peak):
    assert roofline.hbm_peak(name) == peak
