"""The support code of tpujoin_torch — config, shapes, data generation,
timing, device constants, the oracle binding, the bench and the smoke
script — and the port's independence from JAX."""
import dataclasses
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import tpujoin
import tpujoin_torch
from tpujoin import oracle as jax_oracle
from tpujoin.utils import shapes as jax_shapes
from tpujoin_torch import bench, oracle, profile
from tpujoin_torch.core import config, datagen
from tpujoin_torch.probes import (bench_mat2, count_variants, fill_variants,
                                  primitives, probe_fill, probe_flatroll,
                                  probe_mosaic, probe_mosaic2, probe_mosaic3,
                                  probe_opcost, profile_expand_runs,
                                  roll_cost)
from tpujoin_torch.utils import hw, shapes, timing

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "tpujoin_torch"


def test_presets_match_jax():
    assert config.PRESETS.keys() == tpujoin.PRESETS.keys()
    for name, cfg in config.PRESETS.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(
            tpujoin.PRESETS[name])
        assert cfg.expected_matches == tpujoin.PRESETS[name].expected_matches


def test_shapes_match_jax():
    for x in (-3, 0, 1, 7, 8, 9, 1023, 1 << 20):
        for m in (1, 8, 1024):
            assert shapes.round_up(x, m) == jax_shapes.round_up(x, m)
            assert shapes.cdiv(x, m) == jax_shapes.cdiv(x, m)


@pytest.mark.parametrize("dist", ["uniform", "zipf"])
def test_keys_are_seeded_i32_in_range(dist):
    def draw(seed):
        gen = torch.Generator(device="cpu")
        gen.manual_seed(seed)
        return datagen.make_keys(gen, 50_000, 10, 1000, dist)

    a, b, c = draw(0), draw(0), draw(1)
    assert a.dtype == torch.int32 and a.shape == (50_000,)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert int(a.min()) >= 10 and int(a.max()) <= 1000
    counts = torch.bincount(a.long() - 10)
    if dist == "zipf":   # key_min is the heaviest hitter
        assert int(counts.argmax()) == 0
    else:                # every key of a small domain shows up
        assert bool((counts > 0).all())


def test_make_keys_rejects_unknown_distribution():
    with pytest.raises(ValueError):
        datagen.make_keys(torch.Generator(), 4, 1, 2, "normal")


def test_time_fn_reports_min_and_rates():
    calls = []
    stat = timing.time_fn(lambda: calls.append(1), name="x", warmup=2,
                          iters=5, rows=10, bytes_touched=100)
    assert len(calls) == 7 and stat.name == "x" and stat.seconds >= 0
    d = timing.PhaseStat("p", 2.0, bytes_touched=4e9, rows=10).as_dict()
    assert d == {"phase": "p", "seconds": 2.0, "rows_per_sec": 5.0,
                 "achieved_gbps": 2.0}


def test_hbm_peak_is_zero_off_cuda():
    assert hw.hbm_peak_gbps("cpu") == 0.0


def test_oracle_verdicts_match_jax_binding():
    rng = np.random.default_rng(0)
    r = rng.integers(0, 50, 300).astype(np.int32)
    s = rng.integers(0, 50, 200).astype(np.int32)
    rr, ss = np.nonzero(r[:, None] == s[None, :])
    assert oracle.join_count(r, s) == jax_oracle.join_count(r, s) == len(rr)
    assert oracle.check_join(r, s, rr, ss) == 1
    assert oracle.check_join(r, s, torch.from_numpy(rr.astype(np.int32)),
                             ss) == 1
    bad = ss.copy()
    bad[0] = (bad[0] + 1) % 200
    assert oracle.check_join(r, s, rr, bad) == jax_oracle.check_join(
        r, s, rr, bad) == 0
    assert oracle.check_join(r, s, rr[1:], ss[1:]) == -1


def test_bench_runs_test_small_on_cpu():
    out = bench.bench_join(config.PRESETS["test_small"], verify=True,
                           device="cpu")
    assert out["verified"] is True and out["device"] == "cpu"
    assert out["engine"] == "v2" and out["result_rows"] > 0
    assert set(out) == {
        "engine", "config", "device", "build_rows", "probe_rows",
        "result_rows", "build_seconds", "count_seconds",
        "materialize_seconds", "total_seconds", "probe_rows_per_sec",
        "hbm_peak_gbps", "verified"}


def test_bench_refuses_unported_config_and_scales(monkeypatch):
    """No preset is refused any more: the high-selectivity config goes to
    the dense bench (stubbed here; it runs at full size on the card)."""
    calls = []
    monkeypatch.setattr(bench, "bench_join_dense",
                        lambda cfg, verify, device: calls.append(cfg.name))
    bench.bench_join(config.PRESETS["ref_high_selectivity"], False,
                     device="cpu")
    assert calls == ["ref_high_selectivity"]
    cfg = bench.scaled_config("ref_low_selectivity", 0.01)
    assert (cfg.build_rows, cfg.probe_rows) == (1_000_000, 1_000_000)


def _run(args, cwd=REPO):
    return subprocess.run([sys.executable, *args], cwd=cwd,
                          capture_output=True, text=True, timeout=120)


def test_port_imports_without_jax():
    code = ("import sys; sys.modules['jax'] = None\n"
            "import tpujoin_torch, tpujoin_torch.bench, tpujoin_torch.oracle, "
            "tpujoin_torch.profile\n"
            "from tpujoin_torch.kernels import _build, carry_scan, compact, "
            "expand, expand_fill, expand_groups, expand_runs, fill_phases, "
            "flat_roll, forward_fill, merge_count, merge_sort, mosaic, "
            "mosaic2, mosaic3, op_chain, runs_phases, select_chain, "
            "shift_loop, slab_count, smem_gather, stream\n"
            "from tpujoin_torch.probes import bench_mat2, count_variants, "
            "fill_variants, primitives, probe_fill, probe_flatroll, "
            "probe_mosaic, probe_mosaic2, probe_mosaic3, probe_opcost, "
            "profile_expand_runs, roll_cost\n"
            "from tpujoin_torch.ops import aggregate, filter, hash_join, "
            "merge_join, multi_join, nested_loop_join, radix, sort, "
            "table_join\n"
            "from tpujoin_torch.core import io, table\n"
            "from tpujoin_torch.utils import device, verify\n"
            "assert 'tpujoin' not in sys.modules\n"
            "assert sys.modules['jax'] is None\n")
    proc = _run(["-c", code])
    assert proc.returncode == 0, proc.stderr
    pattern = re.compile(r"^\s*(import|from)\s+(jax|tpujoin)\b",
                         re.M)
    # build/ holds what the kernels' build writes, no source of the port
    sources = [p for p in PORT.rglob("*.py")
               if "build" not in p.relative_to(PORT).parts]
    sources.append(REPO / "chip_smoke.py")
    offenders = [str(p) for p in sources if pattern.search(p.read_text())]
    assert not offenders


@pytest.mark.skipif("torch.cuda.is_available()",
                    reason="checks the refusal without a CUDA device")
def test_gpu_entry_points_refuse_without_cuda(tmp_path):
    smoke = _run(["chip_smoke.py"])
    assert smoke.returncode != 0
    assert '"ok": true' not in smoke.stdout
    (tmp_path / "chip_smoke.py").write_text(
        (REPO / "chip_smoke.py").read_text())
    alone = _run(["chip_smoke.py"], cwd=tmp_path)
    assert alone.returncode != 0 and '"ok"' not in alone.stdout
    assert bench.main(["--scale", "0.001"]) == 1
    assert bench.main([]) == 1
    assert bench.main(["--engine", "v1", "--no-verify"]) == 1
    assert profile.main(["--scale", "0.001"]) == 1
    for op in ("filter", "aggregate", "sort", "multi_join"):
        assert bench.main(["--op", op, "--rows", "1000"]) == 1
    for op in ("filter", "aggregate", "multi_join"):
        assert profile.main(["--op", op, "--rows", "1000"]) == 1
    assert profile.main(["--engine", "v1", "--scale", "0.001"]) == 1
    assert primitives.main(["--rows", "1000"]) == 1
    assert bench_mat2.main(["pscan", "--n", "4096"]) == 1
    assert count_variants.main(["--scale", "0.0001"]) == 1
    assert fill_variants.main(["--groups", "2"]) == 1
    assert profile_expand_runs.main(["--runs", "300"]) == 1
    assert probe_fill.main(["--rows", "1000"]) == 1
    assert roll_cost.main(["--rows", "16"]) == 1
    assert probe_opcost.main(["--n", "16384"]) == 1
    assert probe_flatroll.main(["--n", "16384"]) == 1
    assert probe_mosaic.main(["--scale", "0.0001"]) == 1
    assert probe_mosaic2.main([]) == 1
    assert probe_mosaic3.main([]) == 1


_KEYS = np.arange(1, 65, dtype=np.int32)
ENTRY_POINTS = {
    "filter_table": lambda **kw: tpujoin_torch.filter_table(
        {"v": _KEYS}, lambda v: v < 10, "v", **kw),
    "filter_device": lambda **kw: tpujoin_torch.ops.filter.filter_device(
        _KEYS, 10, 64, **kw),
    "group_by_count": lambda **kw: tpujoin_torch.group_by_count(_KEYS, **kw),
    "group_by_agg": lambda **kw: tpujoin_torch.group_by_agg(_KEYS, _KEYS,
                                                            **kw),
    "nested_loop_join": lambda **kw: tpujoin_torch.nested_loop_join(
        _KEYS, _KEYS, **kw),
    "merge_join": lambda **kw: tpujoin_torch.merge_join(_KEYS, _KEYS, **kw),
    "hash_join": lambda **kw: tpujoin_torch.hash_join(_KEYS, _KEYS, **kw),
    "semi_join": lambda **kw: tpujoin_torch.semi_join(_KEYS, _KEYS, **kw),
    "anti_join": lambda **kw: tpujoin_torch.anti_join(_KEYS, _KEYS, **kw),
    "left_outer_join": lambda **kw: tpujoin_torch.left_outer_join(
        _KEYS, _KEYS, **kw),
    "hash_join_multi": lambda **kw: tpujoin_torch.hash_join_multi(
        {"k": _KEYS}, {"k": _KEYS}, "k", **kw),
    "join_with_pushdown": lambda **kw: tpujoin_torch.join_with_pushdown(
        {"k": _KEYS}, {"k": _KEYS}, "k", r_pred=lambda v: v < 9,
        r_pred_col="k", **kw),
    "join_tables": lambda **kw: tpujoin_torch.join_tables(
        {"key": _KEYS}, {"key": _KEYS}, **kw),
}


@pytest.mark.skipif("torch.cuda.is_available()",
                    reason="checks the refusal without a CUDA device")
@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_default_to_the_card(name):
    """With numpy input and no device, an entry point runs on CUDA, so
    without a card it raises; it never falls back to the CPU silently.
    With device="cpu" it runs."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[name]()
    ENTRY_POINTS[name](device="cpu")


def test_public_api_is_jax_s_but_the_distributed_join():
    assert set(tpujoin_torch.__all__) == (set(tpujoin.__all__)
                                          - {"distributed_hash_join"})
    for name in tpujoin_torch.__all__:
        assert getattr(tpujoin_torch, name) is not None


@pytest.mark.skipif("torch.cuda.is_available()",
                    reason="checks the refusal without a CUDA device")
def test_table_loads_default_to_the_card(tmp_path):
    from tpujoin_torch.core import io
    t = tpujoin_torch.Table.from_numpy({"k": _KEYS}, "cpu")
    io.save_table_npz(t, tmp_path / "t.npz")
    io.save_table_dir(t, tmp_path / "t")
    for load in (lambda **kw: io.load_table_npz(tmp_path / "t.npz", **kw),
                 lambda **kw: io.load_table_dir(tmp_path / "t", **kw)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            load()
        assert load(device="cpu")["k"].device.type == "cpu"


@pytest.mark.parametrize("op", ["filter", "aggregate", "sort"])
def test_bench_ops_run_small_on_cpu(op):
    out = bench.run_op(op, 50_000, verify=True, device="cpu")
    keys = {"op", "rows", "device", "total_seconds", "rows_per_sec"}
    if op != "sort":
        keys |= {"compaction", "verified"}
        assert out["verified"] is True and out["compaction"] == "plain"
    if op == "aggregate":
        keys |= {"groups", "agg_values_seconds", "agg_values_rows_per_sec"}
        assert 4000 < out["groups"] <= 5000
    assert set(out) == keys
    assert out["op"] == op and out["rows"] == 50_000
    assert out["device"] == "cpu"


@pytest.mark.parametrize("intervals,busy", [
    ([], 0.0),
    ([(0, 2), (5, 6)], 3.0),
    ([(4, 9), (0, 5), (1, 2)], 9.0),     # overlapping and nested, unsorted
    ([(0, 3), (3, 4), (10, 10)], 4.0),   # touching and empty
])
def test_profile_busy_time_is_the_union_of_intervals(intervals, busy):
    assert profile.union_length(intervals) == busy


@pytest.mark.parametrize("engine", ["v1", "v2"])
def test_profiled_join_is_the_join(engine):
    cfg = config.PRESETS["test_small"]
    bk, pk = bench.config_keys(cfg, "cpu")
    r, s, *_ = profile.join_once(cfg, bk, pk, engine)
    total = oracle.join_count(bk, pk)
    assert (r[total:] == -1).all()
    assert oracle.check_join(bk, pk, r[:total], s[:total]) == 1


def test_cpu_tensor_only_takes_plain_versions():
    """A tensor that is neither on the CPU nor CUDA is refused, not sent to
    a plain version."""
    from tpujoin_torch.kernels import (_build, carry_scan, shift_loop,
                                       smem_gather, stream)
    meta = torch.empty(4, dtype=torch.int32, device="meta")
    assert not _build.on_cpu(meta)
    with pytest.raises(ValueError):
        _build.check_cuda_i32(meta)
    with pytest.raises(ValueError):
        _build.check_cuda_i32(torch.zeros(4, dtype=torch.int64))
    tile = torch.empty(1024, dtype=torch.int32, device="meta")
    for wrapper in (stream.stream_scale, carry_scan.carry_scan,
                    lambda x: shift_loop.shift_loop(x, 4),
                    lambda x: smem_gather.smem_gather(x, x)):
        with pytest.raises(ValueError):
            wrapper(tile)
