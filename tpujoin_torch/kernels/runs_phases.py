"""Run-variant ablation of K7 expand_runs (csrc/profile_expand_runs.cu).

The port of exp/profile_expand_runs.py:102 ``run_variant``. Runs are given
by their output offsets ``off``, build starts ``lo`` and probe ids ``sid``
(padded past the ``nonzero`` real runs, offsets with INT32_MAX), the source
by ``src``. Step i of STEP slots (BATCH tiles of TILE) reads the META runs
from ``meta_base[i]`` and the SRC source slots from ``src_base[i]``. Per
slot u of the tile at t0:

  r0, r1   #(off[mb:mb+META] <= t0) - 1 and #(... < t0 + TILE) - 1,
           r0 clipped to [0, rel_max], r1 to [r0, rel_max],
           rel_max = min(nonzero - 1 - mb, META - 1)
  d        the last of 0..r1-r0 with off[mb+r0+d] <= t0 + u; with none,
           both columns are 0
  delta    rem(rem(t0 - off_d + lo_d - sb, SRC) + SRC, SRC), i32, rem
           truncating as jax.lax.rem does
  r, s     src[sb + (u + delta) mod SRC], sid_d

and both columns are -1 at t0 + u >= total. The variants drop phases
(``VARIANTS``); each output is the JAX kernel's, bitwise. The offsets in
each slab must ascend (the kernel counts r0 and r1 by ballots and finds d
by a walk over the offsets, where the JAX kernel counts and loops over
every d). ``lim`` of the JAX function is the pair
(``nonzero``, ``total``). A CUDA tensor goes through the kernel, a CPU
tensor through :func:`run_variant_plain`; anything else raises, as does an
unknown variant.
"""
from __future__ import annotations

import torch

from tpujoin_torch.kernels import _build
from tpujoin_torch.utils.shapes import cdiv

TILE = 1024
BATCH = 8
STEP = TILE * BATCH
META = 2048
SRC = 4096
VARIANTS = ("full", "noroll", "noscalar", "norank", "empty")
PLAIN_TILES = 2048          # tiles a step of the plain version


def _variant(variant: str) -> int:
    if variant not in VARIANTS:
        raise ValueError(f"run_variant: unknown variant {variant!r}")
    return VARIANTS.index(variant)


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """The low 32 bits of int64 ``x`` as a signed int32 value."""
    return ((x + 2**31) & (2**32 - 1)) - 2**31


def check_bases(off, src, meta_base, src_base, nonzero: int,
                capacity: int) -> None:
    """Raise unless the per-step bases keep every read inside its column,
    as the kernel's caller must (this reads the bases on the host)."""
    steps = cdiv(capacity, STEP)
    mb = meta_base[:steps].long()
    sb = src_base[:steps].long()
    if steps and not (int(mb.min()) >= 0 and int(mb.max()) <= nonzero - 1
                      and int(mb.max()) + META <= off.shape[0]
                      and int(sb.min()) >= 0
                      and int(sb.max()) + SRC <= src.shape[0]):
        raise ValueError("run_variant: a meta or source base reads outside "
                         "its column")


def run_variant_plain(off, lo, sid, src, meta_base, src_base, nonzero: int,
                      total: int, capacity: int, variant: str):
    """The same columns from batched searches and gathers, PLAIN_TILES
    tiles at a time, in int64 and wrapped to i32 where the kernel wraps."""
    v = VARIANTS[_variant(variant)]
    dev = off.device
    steps = cdiv(capacity, STEP)
    cap = steps * STEP
    r_out = torch.empty(cap, dtype=torch.int32, device=dev)
    s_out = torch.empty_like(r_out)
    u = torch.arange(TILE, device=dev)
    meta = torch.arange(META, device=dev)
    for a in range(0, steps * BATCH, PLAIN_TILES):
        tiles = torch.arange(a, min(a + PLAIN_TILES, steps * BATCH),
                             device=dev)
        t0 = (tiles * TILE)[:, None]
        mb = meta_base[tiles // BATCH].long()[:, None]
        sb = src_base[tiles // BATCH].long()[:, None]
        rel_max = torch.clamp(nonzero - 1 - mb, max=META - 1)
        slab_off = off[mb + meta]
        if v == "norank":
            r0 = torch.zeros_like(mb)
            r1 = torch.clamp(rel_max, max=12)
        else:
            r0 = (slab_off <= t0).sum(1, keepdim=True) - 1
            r1 = (slab_off < t0 + TILE).sum(1, keepdim=True) - 1
            r0 = torch.minimum(torch.clamp(r0, min=0), rel_max)
            r1 = torch.minimum(torch.maximum(r1, r0), rel_max)
        span = r1 - r0
        t = t0 + u
        if v == "empty":
            r = s = (span * (span + 1) // 2).expand(-1, TILE)
        else:
            if v == "noscalar":
                d = torch.minimum(u, span)
                off_d, lo_d, sid_d = t0 + d, 7 * d, d
            else:
                # runs r0 + 0..span whose offset is <= t: a prefix
                ub = torch.searchsorted(slab_off, t.to(off.dtype),
                                        right=True)
                d = torch.minimum(ub - r0, span + 1) - 1
                m = mb + r0 + d.clamp(min=0)
                off_d, lo_d, sid_d = (c[m].long() for c in (off, lo, sid))
            raw = wrap_i32(t0 - off_d + lo_d - sb)
            delta = torch.fmod(torch.fmod(raw, SRC) + SRC, SRC)
            if v == "noroll":
                r = wrap_i32(src[sb + u].long() + delta)
            else:
                r = src[sb + torch.remainder(u + delta, SRC)].long()
            r = torch.where(d >= 0, r, 0)
            s = torch.where(d >= 0, sid_d, 0)
        valid = t < total
        rows = slice(a * TILE, a * TILE + t.numel())
        r_out[rows] = torch.where(valid, r, -1).reshape(-1).to(torch.int32)
        s_out[rows] = torch.where(valid, s, -1).reshape(-1).to(torch.int32)
    return r_out, s_out


def run_variant(off: torch.Tensor, lo: torch.Tensor, sid: torch.Tensor,
                src: torch.Tensor, meta_base: torch.Tensor,
                src_base: torch.Tensor, nonzero: int, total: int,
                capacity: int, variant: str):
    """(r, s), each [round_up(capacity, STEP)] int32, of ``variant``. The
    bases must keep every read inside its column (:func:`check_bases`)."""
    code = _variant(variant)
    nonzero, total = int(nonzero), int(total)
    steps = cdiv(capacity, STEP)
    if nonzero < 1 or not 0 <= total < 2**31 or steps * STEP >= 2**31:
        raise ValueError(f"run_variant: nonzero {nonzero}, total {total}, "
                         f"capacity {capacity}")
    if (min(off.shape[0], lo.shape[0], sid.shape[0]) < META
            or src.shape[0] < SRC
            or min(meta_base.shape[0], src_base.shape[0]) < steps):
        raise ValueError("run_variant: a column is shorter than its slab or "
                         "a base column than the steps")
    if _build.on_cpu(off, lo, sid, src, meta_base, src_base):
        return run_variant_plain(off, lo, sid, src, meta_base, src_base,
                                 nonzero, total, capacity, variant)
    r_out = torch.empty(steps * STEP, dtype=torch.int32, device=off.device)
    s_out = torch.empty_like(r_out)
    _build.check_cuda_i32(off, lo, sid, src, meta_base, src_base, r_out,
                          s_out)
    if steps:
        _build.call("tj_run_variant", off.device, off.data_ptr(),
                    lo.data_ptr(), sid.data_ptr(), src.data_ptr(),
                    meta_base.data_ptr(), src_base.data_ptr(), steps,
                    nonzero, total, code, r_out.data_ptr(), s_out.data_ptr())
    return r_out, s_out
