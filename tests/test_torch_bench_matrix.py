"""The bench's matrix of tpujoin_torch: the multiset checksums against
tpujoin.utils.verify (bitwise), the summary line against bench.py's own
``_summary_line`` (loaded from the file, byte for byte), the signal
handler, the soft budget, and the v1 and multi-join cells end to end on
the CPU at small sizes (their plain versions)."""
import dataclasses
import importlib.util
import itertools
import json
import signal
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpujoin.utils import verify as jax_vf
from tpujoin_torch import bench
from tpujoin_torch.core.config import PRESETS
from tpujoin_torch.utils import verify as vf

REPO = Path(__file__).resolve().parent.parent
W = vf.VERIFY_WINDOW


@pytest.fixture(scope="module")
def jax_bench():
    """bench.py, the JAX package's benchmark, loaded from its file."""
    spec = importlib.util.spec_from_file_location("jax_bench_main",
                                                  REPO / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _columns(seed, n):
    rng = np.random.default_rng(seed)
    return (rng.integers(-1, 2**31 - 1, n).astype(np.int32),
            rng.integers(-1, 2**31 - 1, n).astype(np.int32))


@pytest.mark.parametrize("total", [0, 5, W + 77, 2 * W + 5])
def test_device_multiset_sum_matches_jax(total):
    r, s = _columns(0, 2 * W + 5)   # a ragged last window
    got = vf.device_multiset_sum(torch.from_numpy(r), torch.from_numpy(s),
                                 total)
    assert got == jax_vf.device_multiset_sum(jnp.asarray(r), jnp.asarray(s),
                                             total)


def test_multiset_checksum_matches_jax_and_ignores_order():
    r, s = _columns(1, 2 * W)
    total = 2 * W - 3
    got = vf.multiset_checksum(torch.from_numpy(r), torch.from_numpy(s),
                               total, 2)
    want = jax_vf.multiset_checksum(jnp.asarray(r), jnp.asarray(s),
                                    jnp.asarray(total), 2)
    assert got == (int(want[0]), int(want[1]))
    perm = np.random.default_rng(2).permutation(total)
    r2, s2 = r.copy(), s.copy()
    r2[:total], s2[:total] = r[perm], s[perm]
    assert vf.multiset_checksum(torch.from_numpy(r2), torch.from_numpy(s2),
                                total, 2) == got
    assert (vf.device_multiset_sum(torch.from_numpy(r), torch.from_numpy(s),
                                   total)
            == vf.expected_multiset_sum_pairs(r[:total], s[:total])
            == jax_vf.expected_multiset_sum_pairs(r[:total], s[:total]))
    r2[0] += 1
    assert vf.multiset_checksum(torch.from_numpy(r2), torch.from_numpy(s2),
                                total, 2) != got


def test_host_join_expectation_matches_jax_and_the_pairs():
    rng = np.random.default_rng(3)
    bk = rng.integers(1, 50, 3000).astype(np.int32)
    pk = rng.integers(1, 50, 2000).astype(np.int32)
    got = vf.host_join_expectation(bk, pk, chunk=300)
    assert got == jax_vf.host_join_expectation(bk, pk, chunk=300)
    ri, si = np.nonzero(bk[:, None] == pk[None, :])
    assert got == (len(ri), vf.expected_multiset_sum_pairs(ri, si))


def _entry(engine, k, rows=10**8):
    """A summary entry of ``engine``'s keys, numbers from index k."""
    x = 1.0 + k / 7
    out = {"engine": engine, "config": f"c{k}", "device": "NVIDIA H100",
           "build_rows": rows, "probe_rows": rows, "result_rows": 10**7 + k,
           "build_seconds": 0.00471 * x, "count_seconds": 0.00693 * x,
           "materialize_seconds": 0.001234567 * x,
           "total_seconds": 0.0131 * x, "probe_rows_per_sec": 1.19e10 / x,
           "hbm_peak_gbps": 3350.0, "verified": True}
    if engine in ("v2-rle", "v1"):
        out.update({"pair_kernel": "fill",
                    "pair_expansion_rows_per_sec": 2.2e11 * x,
                    "pair_materialize_seconds": 0.0045 * x,
                    "total_seconds_materialized": 0.0061 * x,
                    "pairs_checked": 999968628})
    if engine in ("v1", "v1-rle"):
        out.update({"rle_result_seconds": 0.0021 * x,
                    "total_seconds_rle": 0.0033 * x, "rle_verified": True,
                    "probe_chunks": 4})
    return out


MULTI = {"op": "multi_join", "rows": 10**8, "device": "NVIDIA H100",
         "result_rows": 9_999_123, "join_seconds": 0.031, "pushdown_seconds":
         0.027, "pushdown_result_rows": 2_499_000, "total_seconds": 0.031,
         "rows_per_sec": 3.2e9, "verified": True}


def _matrix_like(n_extra=0, verified=True):
    configs = {"ref_low_selectivity": _entry("v2", 0),
               "ref_high_selectivity": _entry("v2-rle", 1),
               "ref_low_selectivity[v1]": _entry("v1", 2),
               "ref_high_selectivity[v1-rle]": _entry("v1-rle", 3),
               "zipf_skew": _entry("v2-rle", 4), "multi_join": MULTI}
    for k in range(n_extra):
        configs[f"extra_{k}"] = _entry("v1", 5 + k)
    configs["zipf_skew"]["verified"] = verified
    return configs


@pytest.mark.parametrize("case", ["empty", "one", "matrix", "unverified",
                                  "op_only", "fallback", "too_long"])
@pytest.mark.parametrize("verify", [True, False])
def test_summary_line_is_bench_py_byte_for_byte(jax_bench, case, verify):
    configs = {"empty": {}, "one": {"zipf_skew": _entry("v2-rle", 1)},
               "matrix": _matrix_like(),
               "unverified": _matrix_like(verified=False),
               "op_only": {"multi_join": MULTI},
               "fallback": _matrix_like(n_extra=1),
               # past 1900 bytes even on the reduced keys: bench.py still
               # prints that line
               "too_long": _matrix_like(n_extra=6)}[case]
    got = bench._summary_line(configs, verify)
    assert got == jax_bench._summary_line(configs, verify)
    parsed = json.loads(got)
    assert parsed["metric"] == "hash_join_probe_rows_per_sec"
    if case == "fallback":
        # the full keys pass 1900 bytes: the reduced keys keep it under
        assert len(got) <= 1900 and "count_seconds" not in got
        full = json.dumps(bench._round5({"configs": {
            n: bench._config_entry(c, bench._CFG_KEYS)
            for n, c in configs.items()}}), separators=(",", ":"))
        assert len(full) > 1900
    if case == "matrix":
        assert len(parsed["configs"]) == 6
        assert parsed["verified"] is (True if verify else None)
        assert parsed["vs_baseline"] == float(
            f"{1.19e10 / bench.REFERENCE_PROBE_ROWS_PER_SEC:.5g}")


def test_the_reference_bars_are_bench_py_s(jax_bench):
    assert (bench.REFERENCE_PROBE_ROWS_PER_SEC
            == jax_bench.REFERENCE_PROBE_ROWS_PER_SEC)
    assert bench._HIGH_BAR == jax_bench._HIGH_BAR
    assert bench._CFG_KEYS == jax_bench._CFG_KEYS
    assert bench._CFG_KEYS_MIN == jax_bench._CFG_KEYS_MIN


@pytest.mark.parametrize("finished", [0, 2])
def test_signal_handler_prints_the_finished_entries(monkeypatch, capsys,
                                                    finished):
    exits = []

    def fake_exit(code):
        exits.append(code)
        raise SystemExit(code)

    monkeypatch.setattr(bench.os, "_exit", fake_exit)
    completed = dict(itertools.islice(_matrix_like().items(), finished))
    handler = bench.summary_on_signal(completed, True)
    with pytest.raises(SystemExit):
        handler(signal.SIGTERM, None)
    out = capsys.readouterr().out.strip().splitlines()
    if finished:
        assert out == [bench._summary_line(completed, True)]
        assert exits == [0]
    else:
        assert out == [] and exits == [1]


def test_budget_skips_the_later_entries(monkeypatch, capsys):
    """A fake clock that advances 100 s an entry: with a 150 s budget the
    third entry and the multi-join are skipped, and the last stdout line
    is the summary of the two that ran."""
    ran = []

    def fake_join(cfg, verify, engine, device):
        ran.append((cfg.name, engine))
        return _entry("v2", len(ran))

    monkeypatch.setattr(bench, "bench_join", fake_join)
    monkeypatch.setattr(bench, "bench_multi_join",
                        lambda *a: pytest.fail("multi-join ran"))
    ticks = iter(range(0, 10**4, 100))
    completed = {}
    bench.run_matrix(bench.matrix_entries(), completed, budget=150.0,
                     multi_join=True, device="cpu",
                     clock=lambda: next(ticks))
    assert ran == [("ref_low_selectivity", "v2"),
                   ("ref_high_selectivity", "v2")]
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2
    assert lines[-1] == bench._summary_line(completed, True)
    assert list(json.loads(lines[-1])["configs"]) == [
        "ref_low_selectivity", "ref_high_selectivity"]


def test_matrix_entries_are_bench_py_s():
    assert [e[2] for e in bench.matrix_entries()] == [
        "ref_low_selectivity", "ref_high_selectivity",
        "ref_low_selectivity[v1]", "ref_high_selectivity[v1-rle]",
        "zipf_skew"]
    assert bench.matrix_entries(engine="v1") == [
        ("ref_low_selectivity", "v1", "ref_low_selectivity"),
        ("ref_high_selectivity", "v1", "ref_high_selectivity")]
    assert [e[0] for e in bench.matrix_entries(engine="v2")][-1] == \
        "zipf_skew"
    assert bench.matrix_entries("test_small", "v1") == [
        ("test_small", "v1", "test_small")]


def test_run_matrix_calls_each_entry_through_run(capsys):
    """The hook ``run`` gets each entry's key; the summary lands after
    every entry."""
    seen = []
    small = [("test_small", "v2", "a"), ("test_small", "v1", "b")]
    completed = {}
    bench.run_matrix(small, completed, device="cpu",
                     run=lambda key, fn: seen.append(key) or fn())
    assert seen == ["a", "b"]
    assert [completed[k]["engine"] for k in seen] == ["v2", "v1"]
    assert all(c["verified"] is True for c in completed.values())
    assert len(capsys.readouterr().out.strip().splitlines()) == 2


@pytest.mark.parametrize("rle_only", [False, True])
def test_v1_dense_cell_verifies_every_pair_on_cpu(rle_only):
    cfg = PRESETS["test_small"]
    out = bench.bench_join_dense_v1(cfg, True, cap_bucket=1 << 14,
                                    rle_only=rle_only, device="cpu")
    want = int((np.asarray(bench.config_keys(cfg, "cpu")[0])[:, None]
                == np.asarray(bench.config_keys(cfg, "cpu")[1])[None, :])
               .sum())
    assert out["verified"] is True and out["rle_verified"] is True
    assert out["result_rows"] == want
    assert out["engine"] == ("v1-rle" if rle_only else "v1")
    if not rle_only:
        assert out["pairs_checked"] == want and out["probe_chunks"] == 4


def test_v1_dense_cell_fails_on_a_wrong_expectation(monkeypatch):
    cfg = dataclasses.replace(PRESETS["test_small"], seed=5)
    monkeypatch.setitem(bench._RLE_CACHE, cfg, {"total": 1, "msum": 0})
    out = bench.bench_join_dense_v1(cfg, True, cap_bucket=1 << 14,
                                    device="cpu")
    assert out["verified"] is False and "pairs_checked" not in out


def test_v1_join_cell_on_cpu():
    out = bench.bench_join(PRESETS["test_small"], True, "v1", "cpu")
    assert out["engine"] == "v1" and out["verified"] is True
    assert out["result_rows"] > 0


def test_multi_join_cell_on_cpu():
    out = bench.bench_multi_join(300_000, True, "cpu")
    assert out["verified"] is True and out["result_rows"] > 0
    assert 0 < out["pushdown_result_rows"] < out["result_rows"]
    assert out["op"] == "multi_join" and out["rows"] == 300_000
