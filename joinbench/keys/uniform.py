"""Uniform keys: i32 drawn uniformly from [key_min, key_max] of the
configuration (a copy of the port's ``core/datagen.py:uniform_keys``, so
that a change there cannot move the benchmark). An op's inputs are the
join's two key columns, ``build_rows`` and ``probe_rows`` long."""
from __future__ import annotations

import torch


def make(gen: torch.Generator, n: int, cfg: dict) -> torch.Tensor:
    """``n`` keys on ``gen``'s device."""
    return torch.randint(cfg["key_min"], cfg["key_max"] + 1, (n,),
                         generator=gen, device=gen.device, dtype=torch.int32)


def inputs(gen: torch.Generator, cfg: dict) -> dict:
    """One op's named input columns: the build keys, then the probe keys,
    drawn in that order."""
    return {"build_keys": make(gen, cfg["build_rows"], cfg),
            "probe_keys": make(gen, cfg["probe_rows"], cfg)}


def rows(cfg: dict) -> int:
    """The table rows one op reads: both sides of the join."""
    return cfg["build_rows"] + cfg["probe_rows"]
