"""expand_fill_v, the phase ablation of K5 expand_fill, against the JAX
program it ports: exp/fill_variants.py, loaded from its file unchanged,
its pallas_call run in interpret mode. The program's synthetic layout at
G = 4 groups (39,964 slots, three steps of 16384): full, guardv2, guardv3
and roll2 bitwise against JAX and against the analytic columns; each
ablation's kept column bitwise against JAX, its other column against the
formula it states; then the program end to end on the CPU.

exp/fill_variants.py imports ``_flat_roll`` from
tpujoin/kernels/expand_fill.py, where that name no longer exists (the
two-roll form lives in expand_groups.py, and expand_fill.py has
``_flat_roll2``): the JAX program stops at that ImportError. The fixture
sets the name while the file loads and removes it after; no file changes.
The JAX kernel runs with ``gw=4`` covering groups a step, enough here
(at most three groups meet a step), where its default 24 only lengthens
the interpret-mode trace.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_probes import load_exp

from tpujoin.kernels import expand_fill as jax_ef
from tpujoin.kernels import expand_groups as jax_eg
from tpujoin_torch.kernels import fill_phases as fp
from tpujoin_torch.probes import fill_variants
from tpujoin_torch.trace import launches

G = 4
STEP = 16384
GW = 4


@pytest.fixture(scope="module")
def jax_fv():
    """exp/fill_variants.py, loaded with expand_fill._flat_roll set to
    expand_groups._flat_roll and the name removed again after."""
    assert not hasattr(jax_ef, "_flat_roll")
    jax_ef._flat_roll = jax_eg._flat_roll
    try:
        mod = load_exp("fill_variants", interpret=True)
    finally:
        del jax_ef._flat_roll
    assert mod.ef is jax_ef and mod._flat_roll is jax_eg._flat_roll
    return mod


@pytest.fixture(scope="module")
def state():
    """The program's layout at G groups, at a capacity of three steps
    (the program's own rounds up to 2^20 slots)."""
    *cols, _ = fill_variants.inputs(G, torch.device("cpu"))
    return cols, -(-cols[-1] // STEP) * STEP


def _jax(jax_fv, cols, cap, variant):
    args = [jnp.asarray(c.numpy()) for c in cols[:6]]
    args += [jnp.int32(x) for x in cols[6:]]
    r, s = jax_fv.expand_fill_v(*args, cap, step=STEP, gw=GW,
                                variant=variant, ret_rows=(0, cap // 128))
    return np.asarray(r).reshape(-1), np.asarray(s).reshape(-1)


@pytest.mark.parametrize("variant", ["full", "guardv2", "guardv3", "roll2"])
def test_pair_variants_match_expand_fill_v(jax_fv, state, variant):
    cols, cap = state
    total = cols[-1]
    assert total == 39_964 and cap == 3 * STEP
    jr, js = _jax(jax_fv, cols, cap, variant)
    before = launches["tj_expand_fill_v"]
    r, s = fp.expand_fill_v(*cols, cap, STEP, variant)
    assert launches["tj_expand_fill_v"] == before and r.shape == (cap,)
    np.testing.assert_array_equal(r.numpy(), jr)
    np.testing.assert_array_equal(s.numpy(), js)
    assert fill_variants.check_analytic(r, s, total)


@pytest.mark.parametrize("variant,kept", [("no_fill", "r"),
                                          ("no_groups", "s"),
                                          ("no_double", "s")])
def test_ablations_match_their_kept_column(jax_fv, state, variant, kept):
    cols, cap = state
    total = cols[-1]
    jr, js = _jax(jax_fv, cols, cap, variant)
    r, s = (x.numpy() for x in fp.expand_fill_v(*cols, cap, STEP, variant))
    full_r, full_s = (x.numpy() for x in
                      fp.expand_fill_v(*cols, cap, STEP, "full"))
    if kept == "r":
        np.testing.assert_array_equal(r, jr)
        np.testing.assert_array_equal(r, full_r)
    else:
        np.testing.assert_array_equal(s, js)
        np.testing.assert_array_equal(s, full_s)
    # the ablated column: the H100 phase it drops, by its formula
    t = np.arange(cap)
    g = t // (fill_variants.NB * fill_variants.NP)
    phase = (t - g * fill_variants.NB * fill_variants.NP) % fill_variants.NB
    want = {"no_fill": np.full(cap, -1),
            "no_groups": np.full(cap, -1),
            "no_double": np.where(t < total, g * fill_variants.NB + phase,
                                  -1)}[variant]
    np.testing.assert_array_equal(s if variant == "no_fill" else r, want)


def test_no_double_on_a_ragged_state():
    """no_double's build positions where the source is not an arange:
    glo[g] + (t - goff[g]) mod gnb[g] of groups of several widths."""
    gnb = np.array([5, 1, 300, 17], np.int32)
    gnp = np.array([3, 7, 2, 11])
    glo = np.array([0, 9, 10, 400], np.int32)
    cnt = np.repeat(gnb, gnp)
    roff = (np.cumsum(cnt) - cnt).astype(np.int32)
    goff = roff[np.concatenate([[0], np.cumsum(gnp)[:-1]])]
    total = int(cnt.sum())
    src = np.random.default_rng(2).permutation(500).astype(np.int32)
    cols = [torch.from_numpy(c) for c in (roff, np.arange(len(cnt),
                                                          dtype=np.int32),
                                          goff, glo, gnb, src)]
    args = (*cols, len(cnt), len(gnb), total, 3000)
    r, s = fp.expand_fill_v(*args, 2048, "no_double")
    full_r, full_s = fp.expand_fill_v(*args, 2048, "full")
    assert r.shape == (4096,)
    np.testing.assert_array_equal(s.numpy(), full_s.numpy())
    t = np.arange(total)
    g = np.searchsorted(goff, t, "right") - 1
    pos = glo[g] + (t - goff[g]) % gnb[g]
    np.testing.assert_array_equal(r.numpy()[:total], pos)
    np.testing.assert_array_equal(full_r.numpy()[:total], src[pos])
    assert (r.numpy()[total:] == -1).all()


def test_wrapper_refuses_bad_input(state):
    cols, cap = state
    with pytest.raises(ValueError, match="variant"):
        fp.expand_fill_v(*cols, cap, STEP, "no_roll")
    with pytest.raises(ValueError, match="step"):
        fp.expand_fill_v(*cols, cap, 1000, "full")


def test_fill_variants_runs_small_on_cpu(capsys):
    before = launches["tj_expand_fill_v"]
    assert fill_variants.main(["--device", "cpu", "--groups", str(G)]) == 0
    out = capsys.readouterr()
    lines = [json.loads(line) for line in out.out.splitlines()]
    timed = [(x["step"], x["variant"]) for x in lines
             if x["bench"] == "expand_fill_v"]
    assert timed == [(s, v) for s in fill_variants.STEPS
                     for v in fill_variants.VARIANTS]
    checks = [x for x in lines if x["bench"] == "expand_fill_v_parity"]
    assert [x["step"] for x in checks] == [16384, 32768]
    assert all(x["guardv3_equals_full"] and x["analytic"] for x in checks)
    assert all(x["device"] == "cpu" for x in lines)
    assert out.err.rstrip().endswith("DONE")
    assert launches["tj_expand_fill_v"] == before


def test_fill_variants_check_raises(monkeypatch):
    def wrong(*args):
        r, s = fp.expand_fill_v(*args)
        return r, s.roll(1)

    monkeypatch.setattr(fill_variants, "expand_fill_v", wrong)
    with pytest.raises(AssertionError, match="analytic"):
        fill_variants.main(["--device", "cpu", "--groups", "2"])
