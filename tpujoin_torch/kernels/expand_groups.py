"""Group expansion: K7 (csrc/expand_pairs.cu, K5's kernel).

The port of tpujoin/kernels/expand_groups.py. It computes the same function
as :mod:`tpujoin_torch.kernels.expand_fill` on the same inputs (the two TPU
kernels differ only in how they cover a grid step), so it launches the same
CUDA kernel, through its own wrapper and launch counter. The TPU envelope
knobs (``batch``, ``w``, ``gw``, ``src_slab``) and the ``fits`` flag are
gone. A CUDA tensor goes through the kernel, a CPU tensor through
:func:`expand_groups_plain`; anything else raises.
"""
from __future__ import annotations

import torch

from tpujoin_torch.kernels import expand_fill as _fill



def expand_groups_plain(roff, rsid, goff, glo, gnb, src, nruns: int,
                        ngroups: int, total: int, capacity: int):
    """expand_fill's plain version: the same function."""
    return _fill.expand_fill_plain(roff, rsid, goff, glo, gnb, src, nruns,
                                   ngroups, total, capacity)


def expand_groups(roff: torch.Tensor, rsid: torch.Tensor, goff: torch.Tensor,
                  glo: torch.Tensor, gnb: torch.Tensor, src: torch.Tensor,
                  nruns: int, ngroups: int, total: int, capacity: int):
    """(r_vals, s_ids), each [capacity] int32: slot t in run r and group g
    holds (src[glo[g] + (t - goff[g]) mod gnb[g]], rsid[r]), -1 from the
    total on."""
    return _fill.launch("expand_groups", roff, rsid, goff, glo, gnb, src,
                        nruns, ngroups, total, capacity)
