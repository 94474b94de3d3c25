"""Uniform keys: i32 drawn uniformly from [key_min, key_max] of the
configuration (a copy of the port's ``core/datagen.py:uniform_keys``, so
that a change there cannot move the benchmark)."""
from __future__ import annotations

import torch


def make(gen: torch.Generator, n: int, cfg: dict) -> torch.Tensor:
    """``n`` keys on ``gen``'s device."""
    return torch.randint(cfg["key_min"], cfg["key_max"] + 1, (n,),
                         generator=gen, device=gen.device, dtype=torch.int32)
