"""Where an entry point runs: on the card unless the caller asks for the
CPU."""
from __future__ import annotations

import torch


def resolve_device(*inputs, device: torch.device | str | None = None
                   ) -> torch.device:
    """``device``, else the device of the first tensor among ``inputs``,
    else CUDA, which must then be present: numpy input never falls back to
    the CPU."""
    if device is None:
        device = next((x.device for x in inputs
                       if isinstance(x, torch.Tensor)), "cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("tpujoin_torch: no CUDA device; pass "
                           "device='cpu' to run the plain versions")
    return device


def i32_columns(*cols, device: torch.device | str | None = None):
    """``cols`` (numpy arrays or tensors) as int32 tensors on the device
    :func:`resolve_device` picks for them."""
    dev = resolve_device(*cols, device=device)
    return tuple(torch.as_tensor(c, dtype=torch.int32, device=dev)
                 for c in cols)
