"""The port's CLI against the JAX package's (tpujoin.cli), the counterpart
of tests/test_cli.py: every subcommand of tpujoin/cli.py runs with
``--device cpu --verify``, and its ``result rows:`` (or ``groups:``) line
equals the JAX CLI's on the same arguments.

The two CLIs draw their keys from different generators (jax.random and a
torch.Generator), so both key sources are replaced here by one seeded
numpy draw: the same arguments then give both CLIs the same keys.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpujoin import cli as jax_cli
from tpujoin_torch import cli


def _draw(n, key_min, key_max, seed, distribution):
    rng = np.random.default_rng(seed)
    u = rng.random(n)
    if distribution == "zipf":       # skewed toward key_min
        u = u ** 4
    return (key_min + (u * (key_max - key_min + 1)).astype(np.int64)).astype(
        np.int32)


@pytest.fixture
def same_keys(monkeypatch):
    monkeypatch.setattr(
        jax_cli, "_gen_keys",
        lambda n, lo, hi, seed, distribution="uniform": jnp.asarray(
            _draw(n, lo, hi, seed, distribution)))
    monkeypatch.setattr(
        cli, "_gen_keys",
        lambda n, lo, hi, seed, distribution, device: torch.from_numpy(
            _draw(n, lo, hi, seed, distribution)).to(device))
    values = lambda n, seed: (np.random.default_rng(seed).random(n)
                              * 160.0).astype(np.float32)
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape, *a, **kw: jnp.asarray(
                            values(shape[0], 0)))
    monkeypatch.setattr(cli, "_gen_values",
                        lambda n, seed, device: torch.from_numpy(
                            values(n, seed)).to(device))


def _lines(out: str) -> list:
    return re.findall(r"^(?:result rows|groups): .*$", out, re.M)


def _both(capsys, argv):
    assert jax_cli.main(argv) == 0
    want = capsys.readouterr().out
    assert cli.main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert _lines(got) and _lines(got) == _lines(want), (got, want)
    return got


@pytest.mark.parametrize("argv", [
    ["join_v1", "--build-rows", "2000", "--probe-rows", "2000",
     "--key-max", "500", "--verify"],
    ["join_v2", "--build-rows", "3000", "--probe-rows", "3000",
     "--key-max", "400", "--verify"],
    ["join_v1", "--build-rows", "2000", "--probe-rows", "2000",
     "--key-max", "1000", "--distribution", "zipf", "--verify"],
    ["join_v1", "--build-rows", "1000", "--probe-rows", "1500",
     "--key-max", "200", "--how", "semi"],
    ["join_v2", "--build-rows", "1000", "--probe-rows", "1500",
     "--key-max", "200", "--how", "left"],
    ["join_v1", "--build-rows", "1000", "--probe-rows", "1500",
     "--key-max", "200", "--how", "anti"],
    ["selection", "--rows", "4096", "--verify"],
    ["nested_loop", "--build-rows", "300", "--probe-rows", "200",
     "--key-max", "50", "--verify"],
    ["aggregate", "--rows", "4096", "--key-max", "100", "--verify"],
    ["distributed", "--build-rows", "2048", "--probe-rows", "2048",
     "--key-max", "300", "--devices", "8", "--verify"],
], ids=lambda a: "-".join(x.lstrip("-") for x in a[:1] + a[-2:]))
def test_subcommand_matches_jax(capsys, same_keys, argv):
    out = _both(capsys, argv)
    if "--verify" in argv:
        assert "success: 1" in out
    if argv[0].startswith("join") and "--how" not in argv:
        assert "[build]" in out and "[count]" in out and "[probe]" in out
    if argv[0] == "distributed":
        assert "devices: 8" in out


def test_distributed_zipf_takes_the_skew_split(capsys, same_keys):
    argv = ["distributed", "--build-rows", "2048", "--probe-rows", "2048",
            "--key-max", "300", "--devices", "4", "--distribution", "zipf",
            "--verify", "--device", "cpu"]
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    assert "devices: 4" in out and "success: 1" in out


@pytest.mark.skipif("torch.cuda.is_available()",
                    reason="checks the refusal without a CUDA device")
def test_cli_defaults_to_the_card():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["join_v2", "--build-rows", "10", "--probe-rows", "10"])
