"""The streaming probe (csrc/primitives.cu): ``2 * x`` over i32.

The port of bench/primitives.py's E7 kernel (``stream``), the probe of the
card's achievable HBM bandwidth: every row is read once and written once,
and the doubling wraps like two's complement. The TPU kernel took n as a
multiple of its 512K-row block; this one takes any n. A CUDA tensor goes
through the kernel, a CPU tensor through :func:`stream_scale_plain`;
anything else raises.
"""
from __future__ import annotations

import torch

from tpujoin_torch.kernels import _build

LAUNCHES = 0


def stream_scale_plain(x: torch.Tensor) -> torch.Tensor:
    """``x * 2``: PyTorch's i32 product wraps as the kernel's does."""
    return x * 2


def stream_scale(x: torch.Tensor) -> torch.Tensor:
    """``2 * x`` of a 1-D int32 tensor, mod 2^32."""
    global LAUNCHES
    if _build.on_cpu(x):
        return stream_scale_plain(x)
    _build.check_cuda_i32(x)
    out = torch.empty_like(x)
    if x.shape[0]:
        _build.call("tj_stream_scale", x.device, x.data_ptr(), out.data_ptr(),
                    x.shape[0])
        LAUNCHES += 1
    return out
