"""op_chain against the JAX program it ports: exp/roll_cost.py, loaded from
its file unchanged, its pallas_call run in interpret mode, bitwise on
full-range i32 tiles with the extremes (adds wrap).

With OPS = 64 and the program's shift 5, the three row kinds give the tile
back unchanged at R = 16 and 64: 64 * 5, 64 * 3 and 64 rows are multiples
of both. So they are held at R = 256, where they move, and at R = 16 with
OPS = 5 set on a module loaded for it (``run`` traces each (kind, R) once,
reading OPS then). NSTEP = 2 keeps each interpret call short; the grid's
repetitions do not change the output. Then the program end to end on the
CPU, and its check raising on a wrong kernel.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_probes import load_exp

from tpujoin_torch.kernels import op_chain as oc
from tpujoin_torch.probes import roll_cost
from tpujoin_torch.trace import launches

IMIN, IMAX = np.iinfo(np.int32).min, np.iinfo(np.int32).max
SH = 5


def _load(ops: int):
    mod = load_exp("roll_cost", interpret=True)
    mod.OPS, mod.NSTEP = ops, 2
    return mod


@pytest.fixture(scope="module")
def jax_rc64():
    return _load(64)


@pytest.fixture(scope="module")
def jax_rc5():
    return _load(5)


def _tile(rows: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.integers(IMIN, IMAX, (rows, oc.LANES), endpoint=True)
    x[0, :4] = [IMAX, IMIN, -1, IMAX]
    x[-1, -3:] = [IMAX, IMAX - 1, IMIN]
    return x.astype(np.int32)


def _check(mod, kind: str, rows: int, ops: int) -> np.ndarray:
    x = _tile(rows, rows + ops)
    want = np.asarray(mod.run(jnp.asarray(x), jnp.array([SH], jnp.int32),
                              kind, rows))
    before = launches["tj_op_chain"]
    got = oc.op_chain(torch.from_numpy(x), SH, kind, ops)
    assert launches["tj_op_chain"] == before
    assert got.shape == x.shape and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    return x, want


@pytest.mark.parametrize("kind", oc.KINDS)
def test_matches_run_at_r256(jax_rc64, kind):
    x, want = _check(jax_rc64, kind, 256, 64)
    assert not np.array_equal(want, x)


@pytest.mark.parametrize("kind", oc.KINDS)
def test_matches_run_at_r16_ops5(jax_rc5, kind):
    x, want = _check(jax_rc5, kind, 16, 5)
    assert not np.array_equal(want, x)
    if kind == "roll_sub":
        np.testing.assert_array_equal(want, np.roll(x, 25, 0))


# the kernel's layout seams: lane offsets 0, 1 and 31, register offsets of
# one and more, whole turns of 32, 128, 256 and 512, negative, i32 extremes
SEAMS = (0, 1, 31, 32, 33, 127, 128, 255, 256, 511, -1, IMIN, IMAX)


@pytest.mark.parametrize("kind", ["roll_sub", "roll_lane"])
@pytest.mark.parametrize("sh", SEAMS)
def test_matches_run_at_seam_shifts(jax_rc5, kind, sh):
    x = _tile(16, 77)
    want = np.asarray(jax_rc5.run(jnp.asarray(x),
                                  jnp.array([sh], jnp.int32), kind, 16))
    got = oc.op_chain(torch.from_numpy(x), int(sh), kind, 5)
    np.testing.assert_array_equal(got.numpy(), want)
    axis = 0 if kind == "roll_sub" else 1
    np.testing.assert_array_equal(want, np.roll(x, 5 * int(sh), axis))


@pytest.mark.parametrize("kind", oc.ROW_KINDS)
def test_row_kinds_are_the_identity_at_64_ops(kind):
    """The parity trap above, on the plain version: at R = 16 and 64 the
    row kinds' 64 ops come back to the tile for every shift."""
    for rows in (16, 64):
        x = torch.from_numpy(_tile(rows, 1))
        for sh in (1, 5, 7, -3):
            assert torch.equal(oc.op_chain(x, sh, kind), x)


@pytest.mark.parametrize("kind", oc.KINDS)
def test_plain_matches_closed_form(kind):
    """Every R, a negative and an i32-extreme shift, and ops = 0."""
    for rows in oc.ROWS:
        x = torch.from_numpy(_tile(rows, rows))
        for sh, ops in ((-3, 7), (IMAX, 3), (5, 0)):
            np.testing.assert_array_equal(
                oc.op_chain(x, sh, kind, ops).numpy(),
                roll_cost.closed_form(x, sh, kind, ops).numpy())


def test_wrapper_refuses_bad_input():
    x = torch.zeros(16, oc.LANES, dtype=torch.int32)
    for bad in (torch.zeros(24, oc.LANES, dtype=torch.int32),
                torch.zeros(16, 64, dtype=torch.int32),
                torch.zeros(16 * oc.LANES, dtype=torch.int32),
                x.long()):
        with pytest.raises(ValueError):
            oc.op_chain(bad, 5, "select")
    with pytest.raises(ValueError, match="kind"):
        oc.op_chain(x, 5, "roll_diag")
    with pytest.raises(ValueError):
        oc.op_chain(x, 5, "select", -1)
    with pytest.raises(ValueError):
        oc.op_chain(x, 5, "select", 4, 0)
    with pytest.raises(ValueError, match="i32"):
        oc.op_chain(x, IMAX + 1, "roll_lane")


def test_roll_cost_runs_small_on_cpu(capsys):
    before = launches["tj_op_chain"]
    assert roll_cost.main(["--device", "cpu", "--rows", "16", "256",
                           "--ops", "9"]) == 0
    out = capsys.readouterr()
    lines = [json.loads(line) for line in out.out.splitlines()]
    assert [(x["rows"], x["kind"]) for x in lines] == [
        (r, k) for r in (16, 256) for k in oc.KINDS]
    assert all(x["device"] == "cpu" and x["repetitions"] == 1
               and x["ops"] == 9 and x["steps"] == oc.STEPS for x in lines)
    assert "R= 256 iota_add" in out.err
    assert out.err.rstrip().endswith("DONE")
    assert launches["tj_op_chain"] == before


def test_roll_cost_check_raises(monkeypatch):
    def wrong(x, sh, kind, ops, steps):
        out = oc.op_chain(x, sh, kind, ops, steps)
        out[3, 7] += 1
        return out

    monkeypatch.setattr(roll_cost, "op_chain", wrong)
    with pytest.raises(AssertionError, match="closed form"):
        roll_cost.main(["--device", "cpu", "--rows", "16", "--ops", "2"])
