"""The primitive-cost probes of tpujoin_torch against the JAX programs they
port: the four kernels' plain versions against the Pallas kernels of
exp/bench_mat2.py (loaded from its file, unchanged) and of
bench/primitives.py (closures inside its main(), restated here with their
VMEM specs), all in interpret mode and bitwise, i32 wrap-around included;
then both probe programs end to end on the CPU at small sizes.
"""
import functools
import importlib.util
import json
import re
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from tpujoin_torch.kernels import carry_scan as cs
from tpujoin_torch.kernels import shift_loop as sl
from tpujoin_torch.kernels import smem_gather as sg
from tpujoin_torch.kernels import stream as st
from tpujoin_torch.probes import bench_mat2, primitives
from tpujoin_torch.trace import launches

REPO = Path(__file__).resolve().parent.parent
IMIN, IMAX = np.iinfo(np.int32).min, np.iinfo(np.int32).max


class _InterpretPallas(types.ModuleType):
    """jax.experimental.pallas with pallas_call in interpret mode."""

    def __init__(self):
        super().__init__("pallas_interpret")
        self.pallas_call = functools.partial(pl.pallas_call, interpret=True)

    def __getattr__(self, name):
        return getattr(pl, name)


def load_exp(name: str, interpret: bool = False):
    """exp/<name>.py as a module (its main() does not run), unchanged.
    The file puts a fixed directory first on sys.path before it imports
    tpujoin, so the checkout's tpujoin package is imported first (its
    submodules then resolve inside it), sys.path is restored after the
    file ran, and every tpujoin name the file holds must come from this
    checkout. With ``interpret``, its ``pl.pallas_call`` runs in interpret
    mode, as the JAX package's own tests run its kernels on the CPU."""
    import tpujoin  # noqa: F401
    spec = importlib.util.spec_from_file_location(
        f"exp_{name}", REPO / "exp" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    saved = list(sys.path)
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = saved
    for value in vars(mod).values():
        origin = (value if isinstance(value, types.ModuleType)
                  else sys.modules.get(getattr(value, "__module__", "")))
        if (origin is not None and origin.__name__.split(".")[0] == "tpujoin"
                and getattr(origin, "__file__", None)):
            path = Path(origin.__file__).resolve()
            assert path.is_relative_to(REPO), path
    if interpret:
        mod.pl = _InterpretPallas()
    return mod


@pytest.fixture(scope="module")
def jax_mat2():
    """exp/bench_mat2.py as a module."""
    mod = load_exp("bench_mat2")
    from tpujoin.core import datagen
    from tpujoin.ops import merge_join
    assert mod.datagen is datagen and mod.mj is merge_join
    return mod


def _full_range(rng, n):
    x = rng.integers(IMIN, IMAX, n, endpoint=True).astype(np.int32)
    x[:4] = [IMAX, IMAX, IMIN, -1]
    return x


def _wrapped_cumsum(x):
    c = np.cumsum(x.astype(np.int64)) & 0xFFFFFFFF
    return (c - (c >= 2**31) * 2**32).astype(np.int32)


def _block(size):
    return pl.BlockSpec((size,), lambda i: (i,))


@pytest.mark.parametrize("values", ["ones", "full_range"])
def test_carry_scan_matches_pallas_scan(jax_mat2, values):
    """Two 65,536-row blocks, so the TPU kernel's carry crosses a grid
    step; full-range values overflow i32 many times over."""
    blk = jax_mat2.SCAN_BLK
    n = 2 * blk
    rng = np.random.default_rng(4)
    x = (np.ones(n, np.int32) if values == "ones"
         else _full_range(rng, n))
    scan = pl.pallas_call(
        jax_mat2._scan_kernel, grid=(n // blk,), in_specs=[_block(blk)],
        out_specs=_block(blk),
        out_shape=jax.ShapeDtypeStruct((n,), jnp.int32),
        scratch_shapes=[pltpu.SMEM((1,), jnp.int32)], interpret=True)
    want = np.asarray(scan(jnp.asarray(x)))
    before = launches["tj_carry_scan"]
    got = cs.carry_scan(torch.from_numpy(x))
    assert got.dtype == torch.int32 and launches["tj_carry_scan"] == before
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, _wrapped_cumsum(x))


@pytest.mark.parametrize("rolls", [0, 1, 4, 20])
def test_shift_loop_matches_rollloop(jax_mat2, rolls):
    step = jax_mat2.RTILE * jax_mat2.RBATCH
    n = 2 * step
    x = _full_range(np.random.default_rng(rolls), n)
    loop = pl.pallas_call(
        functools.partial(jax_mat2._rollloop_kernel, rolls=rolls),
        grid=(n // step,), in_specs=[_block(step)], out_specs=_block(step),
        out_shape=jax.ShapeDtypeStruct((n,), jnp.int32), interpret=True)
    want = np.asarray(loop(jnp.asarray(x)))
    got = sl.shift_loop(torch.from_numpy(x), rolls)
    np.testing.assert_array_equal(got.numpy(), want)
    assert sl.TILE == jax_mat2.RTILE


def _vmem_gather_kernel(tbl_ref, idx_ref, out_ref):
    """bench/primitives.py's E6 kernel body (`kern`)."""
    out_ref[:] = tbl_ref[:][idx_ref[:]]


def _stream_kernel(x_ref, o_ref):
    """bench/primitives.py's E7 kernel body (`copy_kern`)."""
    o_ref[:] = x_ref[:] * 2


def test_smem_gather_matches_vmem_gather():
    tbl_n, tile = primitives.TBL, primitives.TILE
    rng = np.random.default_rng(6)
    tbl = _full_range(rng, tbl_n)
    idx = rng.integers(0, tbl_n, tile).astype(np.int32)
    idx[:2] = [0, tbl_n - 1]
    vmem = pl.BlockSpec(memory_space=pltpu.VMEM)
    gather = pl.pallas_call(
        _vmem_gather_kernel,
        out_shape=jax.ShapeDtypeStruct((tile,), jnp.int32),
        in_specs=[vmem, vmem], out_specs=vmem, interpret=True)
    want = np.asarray(gather(jnp.asarray(tbl), jnp.asarray(idx)))
    before = launches["tj_smem_gather"]
    got = sg.smem_gather(torch.from_numpy(tbl), torch.from_numpy(idx))
    assert launches["tj_smem_gather"] == before
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        want, np.asarray(jnp.take(jnp.asarray(tbl), jnp.asarray(idx))))


def test_stream_scale_matches_stream_copy():
    ch = primitives.CH
    n = 2 * ch
    x = _full_range(np.random.default_rng(7), n)
    stream = pl.pallas_call(
        _stream_kernel, grid=(n // ch,),
        in_specs=[pl.BlockSpec((ch,), lambda i: (i,),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((ch,), lambda i: (i,),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((n,), jnp.int32), interpret=True)
    want = np.asarray(stream(jnp.asarray(x)))
    before = launches["tj_stream_scale"]
    got = st.stream_scale(torch.from_numpy(x))
    assert launches["tj_stream_scale"] == before
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, np.asarray(jnp.asarray(x) * 2))
    assert want[0] == -2 and want[2] == 0     # 2 * IMAX, 2 * IMIN wrap


@pytest.mark.parametrize("n", [0, 1, cs.TILE - 1, cs.TILE, cs.TILE + 1,
                               3 * cs.TILE + 17])
def test_carry_scan_ragged_sizes(n):
    x = _full_range(np.random.default_rng(n), n) if n >= 4 else (
        np.full(n, IMAX, np.int32))
    got = cs.carry_scan(torch.from_numpy(x))
    assert got.shape == (n,) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _wrapped_cumsum(x))


def _shift_loop_reference(x, rolls, tile):
    """The TPU kernel's loop, written out in numpy."""
    out = np.empty_like(x)
    for base in range(0, len(x), tile):
        t = x[base:base + tile]
        acc = np.zeros(tile, np.int32)
        for d in range(rolls):
            acc = np.where(np.arange(tile) >= d, np.roll(t, d), acc)
        out[base:base + tile] = acc
    return out


@pytest.mark.parametrize("rolls", [0, 1, 2, 1023, 1024, 1500])
def test_shift_loop_closed_form_is_the_loop(rolls):
    x = _full_range(np.random.default_rng(rolls), 3 * sl.TILE)
    got = sl.shift_loop(torch.from_numpy(x), rolls)
    np.testing.assert_array_equal(got.numpy(),
                                  _shift_loop_reference(x, rolls, sl.TILE))


def test_wrappers_refuse_bad_shapes():
    x = torch.zeros(sl.TILE + 1, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple"):
        sl.shift_loop(x, 1)
    with pytest.raises(ValueError, match="rolls"):
        sl.shift_loop(x[:sl.TILE], -1)
    # the shared-memory limit is the card's: the plain version takes any
    # table on the CPU
    tbl = torch.arange(1 << 20, dtype=torch.int32)
    idx = torch.tensor([0, 5, (1 << 20) - 1], dtype=torch.int32)
    assert sg.smem_gather(tbl, idx).tolist() == [0, 5, (1 << 20) - 1]


def _jax_primitives_names():
    """The bench names bench/primitives.py prints, with its per-method E4
    lines folded into the port's one searchsorted line."""
    src = (REPO / "bench" / "primitives.py").read_text()
    names = re.findall(r'report\("(\w+)"|"bench": "(\w+)"', src)
    names = [a or b for a, b in names]
    assert 'f"searchsorted_{method}_M_in_N"' in src
    ss = names.index("cumsum_N")
    return names[:ss] + ["searchsorted_M_in_N"] + names[ss:]


def test_primitives_runs_small_on_cpu(capsys):
    before = (launches["tj_stream_scale"], launches["tj_smem_gather"])
    assert primitives.main(["--device", "cpu", "--rows", "65536"]) == 0
    lines = [json.loads(line)
             for line in capsys.readouterr().out.splitlines()]
    assert [line["bench"] for line in lines] == _jax_primitives_names()
    for line in lines:
        assert line["device"] == "cpu" and line["seconds"] > 0
        if line["bench"].startswith("pallas_vmem_gather"):
            assert set(line) == {"bench", "seconds", "gelems_per_sec",
                                 "device"}
        else:
            assert set(line) == {"bench", "seconds", "gbps", "hbm_frac",
                                 "device"}
            assert line["hbm_frac"] is None     # no HBM on the CPU
    assert (launches["tj_stream_scale"], launches["tj_smem_gather"]) == before
    assert primitives.stream_rows(100_000_000) == 99_614_720


SMALL_MAT2 = ["--device", "cpu", "--n", "262144", "--rows", "4096",
              "--key-max", "64"]


def test_bench_mat2_runs_small_on_cpu(capsys):
    assert bench_mat2.main(SMALL_MAT2) == 0
    out = capsys.readouterr()
    lines = [json.loads(line) for line in out.out.splitlines()]
    assert [line["bench"] for line in lines] == [
        "runs", "groups", "scatter", "cumsum", "pscan", "take", "roll1",
        "roll4", "roll10", "roll20"]
    by_name = {line["bench"]: line for line in lines}
    assert by_name["runs"]["pairs"] == by_name["groups"]["pairs"] > 0
    assert by_name["runs"]["fits"] is True
    assert by_name["roll20"]["rows"] == 65536
    assert all(line["device"] == "cpu" and line["seconds"] > 0
               for line in lines)
    assert "carry_scan correct=True" in out.err
    assert out.err.rstrip().endswith("DONE")


def test_bench_mat2_pscan_check_raises(monkeypatch, capsys):
    assert bench_mat2.main(["pscan", "--device", "cpu", "--n", "20000"]) == 0
    assert [json.loads(line)["bench"]
            for line in capsys.readouterr().out.splitlines()] == ["pscan"]
    monkeypatch.setattr(bench_mat2, "carry_scan", lambda x: x.cumsum(0) - 1)
    with pytest.raises(AssertionError, match="carry_scan"):
        bench_mat2.main(["pscan", "--device", "cpu", "--n", "20000"])
