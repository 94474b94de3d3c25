"""Phase ablation of K5 expand_fill (csrc/expand_pairs.cu).

The port of exp/fill_variants.py:186 ``expand_fill_v``. ``full``,
``guardv2``, ``guardv3`` and ``roll2`` are the pair columns of
:func:`tpujoin_torch.kernels.expand_fill.expand_fill`, (src[glo[g] +
(t - goff[g]) mod gnb[g]], rsid[r]) for slot t in run r and group g, -1 from
the total on; they differ on the TPU only in how its kernel rolls, and run
one kernel here. Each ablation drops one phase of K5's kernel, keeps the
column that the JAX variant also leaves whole, and writes the other as:

  no_fill    s = -1: no run walk (r kept)
  no_groups  r = -1: no group walk, no gather (s kept)
  no_double  r = glo[g] + phase: the group walk and the phase without the
             gather (s kept); the gather is what the TPU kernel's doubling
             stood in for

In JAX that other column is unwritten VMEM (no_groups, no_double) or the
raw marker column behind a carry that exists only because the TPU runs its
grid in order (no_fill), so it has no JAX counterpart to be held against;
it is held against the formula above. ``step`` is the slots a block takes
(a multiple of 1024; the kernel's windows then cover gcd(step,
``expand_fill.TILE``) slots each); the JAX knobs ``src_slab`` and ``gw``
size the TPU's VMEM slab and unroll and have no counterpart. The columns
have round_up(capacity, step) slots, as the JAX kernel's grid. A CUDA tensor
goes through the kernel, a CPU tensor through :func:`expand_fill_v_plain`;
anything else raises, as does an unknown variant.
"""
from __future__ import annotations

import torch

from tpujoin_torch.kernels import _build
from tpujoin_torch.kernels.expand_fill import (PLAIN_CHUNK, check_sizes,
                                               expand_fill_plain,
                                               partition_scratch)
from tpujoin_torch.utils.shapes import round_up

SLOTS = 1024                # slots a block of K5 takes at a time
# variant name -> the kernel's phases (0 all, 1 no run walk, 2 no group
# walk nor gather, 3 no gather)
VARIANTS = {"full": 0, "guardv2": 0, "guardv3": 0, "roll2": 0, "no_fill": 1,
            "no_groups": 2, "no_double": 3}


def _phases(variant: str, step: int) -> int:
    if variant not in VARIANTS:
        raise ValueError(f"expand_fill_v: unknown variant {variant!r}")
    if step <= 0 or step % SLOTS:
        raise ValueError(f"expand_fill_v: step {step} is not a positive "
                         f"multiple of {SLOTS}")
    return VARIANTS[variant]


def expand_fill_v_plain(roff, rsid, goff, glo, gnb, src, nruns: int,
                        ngroups: int, total: int, capacity: int, step: int,
                        variant: str):
    """K5's plain version without the dropped phase, the column it wrote
    then rewritten by its formula, PLAIN_CHUNK slots at a time."""
    phases = _phases(variant, step)
    cap = round_up(capacity, step)
    r_out, s_out = expand_fill_plain(roff, rsid, goff, glo, gnb, src,
                                     0 if phases == 1 else nruns,
                                     ngroups if phases <= 1 else 0, total,
                                     cap)
    if phases == 3 and ngroups:
        heads = goff[:ngroups].long()
        for a in range(0, min(total, cap), PLAIN_CHUNK):
            t = torch.arange(a, min(a + PLAIN_CHUNK, total, cap),
                             device=roff.device)
            g = (torch.searchsorted(heads, t, right=True) - 1).clamp_(min=0)
            phase = torch.remainder(t - heads[g], gnb[g].clamp(min=1))
            r_out[a:a + t.shape[0]] = (glo[g].long() + phase).to(torch.int32)
    return r_out, s_out


def expand_fill_v(roff: torch.Tensor, rsid: torch.Tensor, goff: torch.Tensor,
                  glo: torch.Tensor, gnb: torch.Tensor, src: torch.Tensor,
                  nruns: int, ngroups: int, total: int, capacity: int,
                  step: int, variant: str):
    """(r, s), each [round_up(capacity, step)] int32, of ``variant``; the
    inputs as :func:`~tpujoin_torch.kernels.expand_fill.expand_fill`
    takes them."""
    phases = _phases(variant, step)
    nruns, ngroups, total = int(nruns), int(ngroups), int(total)
    cap = round_up(capacity, step)
    check_sizes("expand_fill_v", ((nruns, roff.shape[0]),
                                  (nruns, rsid.shape[0]),
                                  (ngroups, goff.shape[0]),
                                  (ngroups, glo.shape[0]),
                                  (ngroups, gnb.shape[0])), total, cap)
    if _build.on_cpu(roff, rsid, goff, glo, gnb, src):
        return expand_fill_v_plain(roff, rsid, goff, glo, gnb, src, nruns,
                                   ngroups, total, capacity, step, variant)
    r_out = torch.empty(cap, dtype=torch.int32, device=roff.device)
    s_out = torch.empty_like(r_out)
    _build.check_cuda_i32(roff, rsid, goff, glo, gnb, src, r_out, s_out)
    if cap:
        parts, rows = partition_scratch(total, cap, r_out.device, step)
        _build.call("tj_expand_fill_v", r_out.device, roff.data_ptr(),
                    rsid.data_ptr(), nruns, goff.data_ptr(), glo.data_ptr(),
                    gnb.data_ptr(), ngroups, src.data_ptr(), src.shape[0],
                    total, r_out.data_ptr(), s_out.data_ptr(), cap, step,
                    phases, parts.data_ptr(), rows)
    return r_out, s_out
