"""merge_count_v, the dense-compare design probe of K2, against the JAX
program it ports: exp/count_variants.py, loaded from its file unchanged,
its pallas_call run in interpret mode. lo and cnt bitwise for every
strategy, on one shape so that each strategy compiles once; then the
program end to end on the CPU at a small scale.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_probes import load_exp

from tpujoin_torch.kernels import slab_count as sc
from tpujoin_torch.probes import count_variants
from tpujoin_torch.trace import launches

STRATEGIES = ["fat512", "fatc512", "fatc256", "fatc128", "diag128",
              "quad256"]


@pytest.fixture(scope="module")
def jax_cv():
    return load_exp("count_variants", interpret=True)


def _keys():
    """2500 build and 3100 probe keys (four 1024-key tiles, the last
    ragged) with ~1 duplicate a key, probe keys below and above the build
    keys; fewer than 1024 probe keys lie above them (see
    test_lo_is_n_above_every_build_key)."""
    rng = np.random.default_rng(5)
    b = np.sort(rng.integers(100, 2600, 2500)).astype(np.int32)
    p = np.sort(rng.integers(1, 2800, 3100)).astype(np.int32)
    return b, p


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_matches_merge_count_v(jax_cv, strategy):
    b, p = _keys()
    jlo, jcnt = jax_cv.merge_count_v(jnp.asarray(b), jnp.asarray(p),
                                     strategy=strategy)
    before = launches["tj_slab_count"]
    lo, cnt = sc.merge_count_v(torch.from_numpy(b), torch.from_numpy(p),
                               strategy)
    assert launches["tj_slab_count"] == before
    assert lo.dtype == cnt.dtype == torch.int32
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))
    np.testing.assert_array_equal(lo.numpy(), np.searchsorted(b, p))
    assert cnt.numpy().sum() > 0 and (cnt.numpy() > 1).any()


def _dup_run_keys():
    """4,000 build keys holding a 2,500-key run of 5000 from index 1,100,
    so the run spans chunks 1-3 and every slab seam in them, and 3,100
    probe keys holding 1,200 copies of 5000 from index 600, so they span
    probe tiles 0 and 1."""
    rng = np.random.default_rng(11)
    b = np.concatenate([np.sort(rng.integers(100, 5000, 1100)),
                        np.full(2500, 5000),
                        np.sort(rng.integers(5001, 9000, 400))])
    p = np.concatenate([np.sort(rng.integers(50, 5000, 600)),
                        np.full(1200, 5000),
                        np.sort(rng.integers(5001, 9500, 1300))])
    return b.astype(np.int32), p.astype(np.int32)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_matches_merge_count_v_on_a_run_across_chunks(jax_cv, strategy):
    b, p = _dup_run_keys()
    jlo, jcnt = jax_cv.merge_count_v(jnp.asarray(b), jnp.asarray(p),
                                     strategy=strategy)
    lo, cnt = sc.merge_count_v(torch.from_numpy(b), torch.from_numpy(p),
                               strategy)
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))
    run = p == 5000
    assert (cnt.numpy()[run] == 2500).all() and (lo.numpy()[run] == 1100).all()


def test_lo_is_n_above_every_build_key(jax_cv):
    """A whole 1024-key probe tile above every build key, n a multiple of
    1024: the JAX kernel clamps its window start to n_pad - 1024 and
    returns lo = 0 here; the port returns the lower bound n."""
    b = np.ones(1024, np.int32)
    p = np.full(1024, 2, np.int32)
    jlo, jcnt = jax_cv.merge_count_v(jnp.asarray(b), jnp.asarray(p),
                                     strategy="fat512")
    assert (np.asarray(jlo) == 0).all() and not np.asarray(jcnt).any()
    lo, cnt = sc.merge_count_v(torch.from_numpy(b), torch.from_numpy(p),
                               "fat512")
    assert (lo.numpy() == 1024).all() and not cnt.numpy().any()


def test_strategy_names():
    assert sc.parse_strategy("fat512") == (1024, 512, False)
    assert sc.parse_strategy("fatc128") == (1024, 128, True)
    assert sc.parse_strategy("diag128") == (128, 128, True)
    assert sc.parse_strategy("quad256") == (128, 256, True)
    x = torch.arange(8, dtype=torch.int32)
    for bad in ("fat256", "fatc", "diag", "fat5120", "fatc384", "fatc2048",
                "fatc2", "slab128", ""):
        with pytest.raises(ValueError):
            sc.merge_count_v(x, x, bad)


def test_plain_on_empty_and_ragged_widths():
    for n, m in ((0, 5), (7, 0), (1, 1), (1025, 3000)):
        rng = np.random.default_rng(n + m)
        b = np.sort(rng.integers(0, 50, n)).astype(np.int32)
        p = np.sort(rng.integers(-5, 60, m)).astype(np.int32)
        lo, cnt = sc.merge_count_v(torch.from_numpy(b), torch.from_numpy(p),
                                   "diag128")
        np.testing.assert_array_equal(lo.numpy(), np.searchsorted(b, p))
        np.testing.assert_array_equal(
            cnt.numpy(), np.searchsorted(b, p, "right")
            - np.searchsorted(b, p))


def test_count_variants_runs_small_on_cpu(capsys):
    before = launches["tj_slab_count"]
    assert count_variants.main(["--device", "cpu", "--scale", "0.0002"]) == 0
    out = capsys.readouterr()
    lines = [json.loads(line) for line in out.out.splitlines()]
    assert [(x["workload"], x["strategy"]) for x in lines] == [
        (w, s) for w in ("ref_low", "ref_high")
        for s in ("fat512", "fatc512", "fatc256", "fatc128")]
    assert all(x["bench"] == "merge_count_v" and x["parity"] is True
               and x["device"] == "cpu" and x["seconds"] > 0
               and x["tile"] == 1024 for x in lines)
    assert [x["rows"] for x in lines] == [20000] * 4 + [2000] * 4
    high = {x["total"] for x in lines if x["workload"] == "ref_high"}
    assert len(high) == 1 and high.pop() > 0
    assert launches["tj_slab_count"] == before
    assert out.err.rstrip().endswith("DONE")


def test_count_variants_parity_failure_raises(monkeypatch):
    def wrong(b, p, strategy):
        lo, cnt = sc.merge_count_v_plain(b, p)
        return lo, cnt + 1

    monkeypatch.setattr(count_variants, "merge_count_v", wrong)
    with pytest.raises(AssertionError, match="merge_count_v"):
        count_variants.main(["--device", "cpu", "--scale", "0.00002"])
