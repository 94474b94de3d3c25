"""The Mosaic capability probes' ten kernels against the JAX programs they
port: exp/probe_mosaic.py, probe_mosaic2.py and probe_mosaic3.py, loaded
from their files unchanged, each ``t_*`` run once with ``pallas_call`` in
interpret mode and recorded (the built callable, its inputs, its output).

Each plain version is held bitwise against its Pallas kernel at the
program's own input, then through the recorded callable at other scalars
and full-range i32 data inside the TPU kernels' domain, and against a numpy
model of the port's definition. Outside that domain (an index outside its
input, a copy past x's end) the port is held to the numpy model only: the
JAX kernels clamp there in interpret mode, and the port reads 0.
``t_flat_rotate`` is wrong for negative shifts that are not a multiple of
128, so those are held against numpy only. Then the three programs end to
end on the CPU, and each failing on a wrong kernel.
"""
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from test_torch_probes import load_exp

from tpujoin_torch.kernels import mosaic, mosaic2, mosaic3
from tpujoin_torch.probes import probe_mosaic, probe_mosaic2, probe_mosaic3
from tpujoin_torch.trace import launches

IMIN, IMAX = int(np.iinfo(np.int32).min), int(np.iinfo(np.int32).max)

# JAX file -> its t_* kernels, by the names after "t_"
PROGRAMS = {"probe_mosaic": ("roll", "smem_dyn", "vmem_dyn", "fori",
                             "smem_block"),
            "probe_mosaic2": ("hbm_to_smem", "dyn_vec_load"),
            "probe_mosaic3": ("sublane_roll", "2d_row_dma", "flat_rotate")}
# t_* name -> (port wrapper, its module, its plain version's name)
PORT = {"roll": (mosaic, "roll"), "smem_dyn": (mosaic, "smem_dyn"),
        "vmem_dyn": (mosaic, "vmem_dyn"), "fori": (mosaic, "fori"),
        "smem_block": (mosaic, "smem_block"),
        "hbm_to_smem": (mosaic2, "hbm_to_smem"),
        "dyn_vec_load": (mosaic2, "dyn_vec_load"),
        "sublane_roll": (mosaic3, "sublane_roll"),
        "2d_row_dma": (mosaic3, "row_dma_2d"),
        "flat_rotate": (mosaic3, "flat_rotate")}
ENTRIES = tuple(f"tj_mosaic_{fn}" for _, fn in PORT.values())

# scalars inside the TPU kernels' domain, beyond the programs' own
JAX_CASES = {
    "roll": [[5], [0], [-3], [1023], [1024], [2000], [-2000], [IMAX],
             [IMIN]],
    "smem_dyn": [[i, IMAX, IMIN, -1, 7] for i in range(5)],
    "vmem_dyn": [[0], [9], [500], [1023]],
    "fori": [[5], [0], [-3], [1], [1000], [IMIN]],
    "smem_block": [[0], [1], [2], [3]],
    "hbm_to_smem": [[2048, 17], [0, 0], [6144, 2047], [4, 2047], [4100, 5],
                    [1024, 1000], [3, 5]],
    "dyn_vec_load": [[37], [0], [1], [1000], [3072]],
    "sublane_roll": [[3], [0], [-1], [31], [32], [-2000], [IMAX], [IMIN]],
    "2d_row_dma": [[40], [0], [1], [8], [223], [224]],
    "flat_rotate": [[517], [0], [128], [4095], [4101], [-128], [IMAX],
                    [IMIN]],
}
# scalars outside it, where the port defines the result
PORT_CASES = {
    "smem_dyn": [[-1, 1, 2, 3, 4], [5, 1, 2, 3, 4], [IMIN, 1, 2, 3, 4],
                 [IMAX, 1, 2, 3, 4]],
    "vmem_dyn": [[-1], [1024], [IMIN], [IMAX]],
    "fori": [[IMAX]],
    "smem_block": [[-1], [4], [IMIN], [IMAX]],
    "hbm_to_smem": [[-4, 3], [-4, 5], [-2047, 2047], [-2048, 2047],
                    [8190, 1], [8190, 2], [6148, 2047], [0, 2048], [0, -1],
                    [IMIN, IMAX], [IMAX, 0], [IMAX, IMAX]],
    "dyn_vec_load": [[-1], [3073], [4095], [4096], [IMIN], [IMAX]],
    "2d_row_dma": [[-1], [-31], [-32], [225], [255], [256], [IMIN], [IMAX]],
    "flat_rotate": [[-1], [-129], [-5000], [IMIN + 1]],
}


class _RecordingPallas(types.ModuleType):
    """jax.experimental.pallas with pallas_call in interpret mode, keeping
    each built callable (jitted), its inputs and its output."""

    def __init__(self):
        super().__init__("pallas_recording")
        self.calls = []

    def pallas_call(self, kernel, **kwargs):
        built = pl.pallas_call(kernel, interpret=True, **kwargs)

        def run(*args):
            out = built(*args)
            self.calls.append((jax.jit(built), args, out))
            return out

        return run

    def __getattr__(self, name):
        return getattr(pl, name)


@pytest.fixture(scope="module")
def jax_kernels():
    """t_* name -> (the Pallas kernel's callable, the program's inputs,
    its output), each file loaded unchanged and each t_* run once; its own
    expected value must hold."""
    kernels = {}
    for file, names in PROGRAMS.items():
        mod = load_exp(file)
        mod.pl = _RecordingPallas()
        for name in names:
            text = getattr(mod, f"t_{name}")()
            assert "correct=False" not in text, (name, text)
            if "want" in text:
                val, want = text.split("val=")[1].split(" (want ")
                assert val == want.rstrip(")"), (name, text)
            kernels[name] = mod.pl.calls[-1]
    return kernels


def _launches():
    return [launches[entry] for entry in ENTRIES]


def _port(name, jax_args):
    """The port on the JAX call's inputs (scalars first there, last here),
    on the CPU: the plain version, no launch."""
    mod, fn = PORT[name]
    args = [torch.from_numpy(np.array(a)) for a in reversed(jax_args)]
    before = _launches()
    out = getattr(mod, fn)(*args)
    assert _launches() == before and out.dtype == torch.int32
    return out.numpy()


def _wrap(v):
    return ((v + 2**31) % 2**32 - 2**31).astype(np.int32)


def _model(name, jax_args):
    """numpy's answer of the port's definition, on the JAX call's inputs."""
    s = [int(v) for v in np.asarray(jax_args[0])]
    x = np.asarray(jax_args[-1]).astype(np.int64)
    k = s[0]

    def at(col, i):
        return col[i] if 0 <= i < col.size else 0

    if name == "roll":
        return x[:, (np.arange(1024) + k) % 1024]
    if name == "sublane_roll":
        return np.roll(x, -k, 0)
    if name == "flat_rotate":
        return x.reshape(-1)[(np.arange(1024) + k) % 4096].reshape(8, 128)
    if name == "dyn_vec_load":
        return np.array([[at(x[0], k + j) for j in range(1024)]])
    if name == "2d_row_dma":
        return np.array([x[k + r] if 0 <= k + r < 256 else np.zeros(128)
                         for r in range(32)])
    if name == "fori":
        n = max(k, 0)
        return _wrap(n * x + n * (n - 1) // 2)
    v = {"smem_dyn": lambda: at(np.array(s), k),
         "vmem_dyn": lambda: at(x[0], k),
         "smem_block": lambda: at(x, 1024 * k) if 0 <= k < 4 else 0,
         "hbm_to_smem": lambda: (at(x, k + s[1]) if 0 <= s[1] < 2048
                                 else 0)}[name]()
    return np.full((1, 128), v)


def _inputs(name, recorded, scalars):
    """The recorded call's inputs with ``scalars`` and, in place of the
    program's data, full-range i32 of the same shape."""
    s, *data = recorded
    rng = np.random.default_rng([ord(c) for c in name] +
                                [v % 2**32 for v in scalars])
    data = [rng.integers(IMIN, IMAX, d.shape, endpoint=True).astype(np.int32)
            for d in data]
    for d in data:
        d.reshape(-1)[:3] = [IMAX, IMIN, -1]
    return [jnp.array(scalars, jnp.int32)] + [jnp.asarray(d) for d in data]


@pytest.mark.parametrize("name", list(PORT))
def test_matches_program_input(jax_kernels, name):
    _, args, out = jax_kernels[name]
    got = _port(name, args)
    np.testing.assert_array_equal(got, np.asarray(out))
    assert got.shape == out.shape
    np.testing.assert_array_equal(got, _model(name, args))


@pytest.mark.parametrize("name,scalars", [
    (name, s) for name, cases in JAX_CASES.items() for s in cases])
def test_matches_jax_kernel(jax_kernels, name, scalars):
    fn, recorded, _ = jax_kernels[name]
    args = _inputs(name, recorded, scalars)
    want = np.asarray(fn(*args))
    np.testing.assert_array_equal(_port(name, args), want)
    np.testing.assert_array_equal(want, _model(name, args))


@pytest.mark.parametrize("name,scalars", [
    (name, s) for name, cases in PORT_CASES.items() for s in cases])
def test_defined_outside_the_jax_domain(jax_kernels, name, scalars):
    """Past the TPU kernels' domain the port is numpy's model: 0 outside
    an input, the fori closed form at 2^31 - 1 iterations, and the flat
    rotate for every shift.

    JAX's ``t_flat_rotate`` at delta = -1 gives row 0 starting [4095,
    3968, 3969, 3970] on the arange tile, where flat[(u - 1) mod 4096]
    starts [4095, 0, 1, 2]; at -129 [3967, 3840, ...] against [3967, 3968,
    ...]: it pairs delta // 128 (a floor) with rem(delta, 128) (a
    truncation)."""
    args = _inputs(name, jax_kernels[name][1], scalars)
    np.testing.assert_array_equal(_port(name, args), _model(name, args))


@pytest.mark.parametrize("delta", [-1, -129])
def test_flat_rotate_negative_on_the_arange_tile(delta):
    x = np.arange(4096, dtype=np.int32).reshape(32, 128)
    got = mosaic3.flat_rotate(torch.from_numpy(x),
                              torch.tensor([delta], dtype=torch.int32))
    want = x.reshape(-1)[(np.arange(1024) + delta) % 4096].reshape(8, 128)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0, 1] == (0 if delta == -1 else 3968)


def _bad_inputs(name):
    """Inputs the wrapper must refuse: a wrong shape, a wrong dtype, a
    strided input, a device that is neither the CPU nor CUDA."""
    fn_shapes = {"roll": [(1, 1024), (1,)], "smem_dyn": [(5,)],
                 "vmem_dyn": [(1, 1024), (1,)], "fori": [(1, 128), (1,)],
                 "smem_block": [(4096,), (1,)],
                 "hbm_to_smem": [(8192,), (2,)],
                 "dyn_vec_load": [(1, 4096), (1,)],
                 "sublane_roll": [(32, 128), (1,)],
                 "2d_row_dma": [(256, 128), (1,)],
                 "flat_rotate": [(32, 128), (1,)]}[name]
    good = [torch.zeros(s, dtype=torch.int32) for s in fn_shapes]
    for i, t in enumerate(good):
        yield good[:i] + [torch.zeros(t.numel() + 1, dtype=torch.int32)
                          ] + good[i + 1:]
        yield good[:i] + [t.long()] + good[i + 1:]
        if t.shape[-1] > 1:     # a step over one word is contiguous
            strided = torch.zeros(*t.shape[:-1], 2 * t.shape[-1],
                                  dtype=torch.int32)[..., ::2]
            yield good[:i] + [strided] + good[i + 1:]
    yield [torch.empty(t.shape, dtype=torch.int32, device="meta")
           for t in good]


@pytest.mark.parametrize("name", list(PORT))
def test_wrapper_refuses_bad_input(name):
    mod, fn = PORT[name]
    for args in _bad_inputs(name):
        with pytest.raises(ValueError):
            getattr(mod, fn)(*args)


PROBES = {"probe_mosaic": (probe_mosaic, ["--scale", "0.0001"],
                           ["roll_dynamic", "smem_dynamic_scalar",
                            "vmem_dynamic_scalar", "fori_traced_bound",
                            "smem_blockspec_scalar_indexmap", "cumsum_1B",
                            "take_100M"]),
          "probe_mosaic2": (probe_mosaic2, [],
                            ["hbm_to_smem_dma", "dyn_start_vmem_load"]),
          "probe_mosaic3": (probe_mosaic3, [],
                            ["sublane_roll_dynamic", "2d_row_dma",
                             "flat_rotate_2phase"])}


@pytest.mark.parametrize("program", list(PROBES))
def test_program_runs_on_cpu(program, capsys):
    mod, argv, names = PROBES[program]
    before = _launches()
    assert mod.main(["--device", "cpu", *argv]) == 0
    out = capsys.readouterr()
    lines = [json.loads(line) for line in out.out.splitlines()]
    assert [x["probe"] for x in lines] == names
    assert all(x["ok"] is True and x["device"] == "cpu" for x in lines)
    for x in lines:
        assert f"[OK] {x['probe']}: {x['result']}" in out.err
    assert "[FAIL]" not in out.err and out.err.rstrip().endswith("DONE")
    assert _launches() == before
    if program == "probe_mosaic":
        assert lines[-2]["rows"] == int(probe_mosaic.CUMSUM_N * 0.0001)
        assert lines[-1]["idx_per_sec"] > 0


WRONG = [("probe_mosaic", mosaic, "roll", "roll_dynamic"),
         ("probe_mosaic", mosaic, "smem_dyn", "smem_dynamic_scalar"),
         ("probe_mosaic", mosaic, "vmem_dyn", "vmem_dynamic_scalar"),
         ("probe_mosaic", mosaic, "fori", "fori_traced_bound"),
         ("probe_mosaic", mosaic, "smem_block",
          "smem_blockspec_scalar_indexmap"),
         ("probe_mosaic2", mosaic2, "hbm_to_smem", "hbm_to_smem_dma"),
         ("probe_mosaic2", mosaic2, "dyn_vec_load", "dyn_start_vmem_load"),
         ("probe_mosaic3", mosaic3, "sublane_roll", "sublane_roll_dynamic"),
         ("probe_mosaic3", mosaic3, "row_dma_2d", "2d_row_dma"),
         ("probe_mosaic3", mosaic3, "flat_rotate", "flat_rotate_2phase")]


@pytest.mark.parametrize("program,mod,fn,probe", WRONG,
                         ids=[w[2] for w in WRONG])
def test_program_fails_on_a_wrong_kernel(monkeypatch, capsys, program, mod,
                                         fn, probe):
    """One plain version off by one in its last word: the program prints
    that probe's FAIL line and raises, where JAX's ``report`` would print
    and go on."""
    plain = getattr(mod, f"{fn}_plain")

    def wrong(*args):
        out = plain(*args)
        out.view(-1)[-1] += 1
        return out

    monkeypatch.setattr(mod, f"{fn}_plain", wrong)
    pmod, argv, _ = PROBES[program]
    with pytest.raises(AssertionError, match=probe):
        pmod.main(["--device", "cpu", *argv])
    assert f"[FAIL] {probe}:" in capsys.readouterr().err
