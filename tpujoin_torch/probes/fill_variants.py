"""Attribute K5 expand_fill's time to its phases, on synthetic data of the
ref_high_selectivity shape.

The port of exp/fill_variants.py (its ``main()``, :266): G = 100,000
groups, each NB = 103 build ids wide and NP = 97 runs deep, so 999,100,000
slots and 8 GB of pair columns. At STEP 16K, 32K and 64K slots a block it
times the variants full, no_fill, no_groups and no_double of expand_fill_v
(kernels/fill_phases.py): each ablation drops one phase of K5's kernel.
The JAX program times guardv2 and guardv3 instead: those differ from full
only in the TPU's rolls and run full's kernel here.

The check (the JAX program's, :299-316, on every slot instead of 1024):
at STEP 16K and 32K, guardv3 must equal full, and full must equal the
analytic columns of this layout, r = g NB + (t - g NB NP) mod NB and
s = g NP + (t - g NB NP) div NB for slot t in group g = t div (NB NP),
-1 from the total on; a failure raises. The human lines go to stderr and
one JSON line per measurement to stdout. Each time is the minimum of 3
synchronized runs after a warm-up.

Usage: python -m tpujoin_torch.probes.fill_variants [--groups G]
           [--device cpu]
It runs on CUDA unless given ``--device cpu``.
"""
from __future__ import annotations

import argparse
import sys

import torch

from tpujoin_torch.kernels.fill_phases import expand_fill_v
from tpujoin_torch.probes.bench_mat2 import emit, ep
from tpujoin_torch.utils.shapes import round_up
from tpujoin_torch.utils.timing import sync, time_fn

GROUPS = 100_000
NB = 103
NP = 97
STEPS = (16384, 32768, 65536)
VARIANTS = ("full", "no_fill", "no_groups", "no_double")
CHECK_STEPS = (16384, 32768)
CHECK_CHUNK = 1 << 26


def inputs(groups: int, device: torch.device):
    """The synthetic RLE state on ``device``: (roff, rsid, goff, glo, gnb,
    src, nruns, ngroups, total, capacity), capacity the total rounded up to
    2^20."""
    def col(values):
        return values.to(torch.int32)

    nruns, total = groups * NP, groups * NP * NB
    g = torch.arange(groups, device=device)
    return (col(torch.arange(nruns, device=device) * NB),     # roff
            col(torch.arange(nruns, device=device)),          # rsid
            col(g * (NB * NP)), col(g * NB),                  # goff, glo
            torch.full((groups,), NB, dtype=torch.int32, device=device),
            col(torch.arange(groups * NB, device=device)),    # src
            nruns, groups, total, round_up(total, 1 << 20))


def analytic(t: torch.Tensor):
    """The (r, s) pair of slots ``t`` in this layout."""
    g = t // (NB * NP)
    within = t - g * (NB * NP)
    return g * NB + within % NB, g * NP + within // NB


def check_analytic(r, s, total: int) -> bool:
    """Whether r and s hold the analytic pairs below ``total`` and -1 from
    it on, CHECK_CHUNK slots at a time."""
    if not (bool((r[total:] == -1).all()) and bool((s[total:] == -1).all())):
        return False
    for a in range(0, total, CHECK_CHUNK):
        t = torch.arange(a, min(a + CHECK_CHUNK, total), device=r.device)
        rexp, sexp = analytic(t)
        if not (torch.equal(r[a:a + t.shape[0]].long(), rexp)
                and torch.equal(s[a:a + t.shape[0]].long(), sexp)):
            return False
    return True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--groups", type=int, default=GROUPS,
                    help="groups of NB x NP slots")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        ep("tpujoin_torch.probes.fill_variants: no CUDA device")
        return 1
    dev = torch.device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    *state, cap = inputs(args.groups, dev)
    total = state[-1]
    ep(f"groups {args.groups}  runs {state[6]}  total {total}")
    sync(dev)
    for step in STEPS:
        for variant in VARIANTS:
            st = time_fn(expand_fill_v, *state, cap, step, variant,
                         device=dev, name=variant, rows=total)
            ep(f"step={step} {variant:10s} {st.seconds:.3f}s  "
               f"{total / st.seconds / 1e6:.0f}M pairs/s")
            emit("expand_fill_v", st.seconds, name, step=step,
                 variant=variant, pairs=total,
                 pairs_per_sec=total / st.seconds)
    for step in CHECK_STEPS:
        rf, sf = expand_fill_v(*state, cap, step, "full")
        rg, sg = expand_fill_v(*state, cap, step, "guardv3")
        same = bool(torch.equal(rf, rg) and torch.equal(sf, sg))
        del rg, sg
        ok = check_analytic(rf, sf, total)
        del rf, sf
        ep(f"step={step} parity guardv3==full: {same}  analytic: {ok}")
        emit("expand_fill_v_parity", 0.0, name, step=step,
             guardv3_equals_full=same, analytic=ok, slots=total)
        if not (same and ok):
            raise AssertionError(f"expand_fill_v at step {step}: guardv3 == "
                                 f"full {same}, analytic {ok}")
    ep("DONE")
    return 0


if __name__ == "__main__":
    sys.exit(main())
