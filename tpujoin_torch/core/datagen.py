"""Key generation on the device (the port of tpujoin/core/datagen.py).

Keys come from a seeded ``torch.Generator`` on the target device, so the
bulk data never crosses from the host. The values differ from the JAX
package's ``jax.random`` keys for the same seed; results are verified by
the oracle, and the parity tests hand both packages the same numpy arrays.
"""
from __future__ import annotations

import torch


def generator(seed: int, device: torch.device | str) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def uniform_keys(gen: torch.Generator, n: int, key_min: int,
                 key_max: int) -> torch.Tensor:
    """Uniform i32 keys in [key_min, key_max] on ``gen``'s device."""
    return torch.randint(key_min, key_max + 1, (n,), generator=gen,
                         device=gen.device, dtype=torch.int32)


def zipf_keys(gen: torch.Generator, n: int, key_min: int, key_max: int,
              s: float = 1.0) -> torch.Tensor:
    """Approximately Zipf(s) keys over [key_min, key_max], key_min the most
    frequent: the same f32 inverse-CDF sampling and one-bucket integer
    jitter as tpujoin/core/datagen.py:zipf_keys."""
    domain = key_max - key_min + 1
    u = torch.rand(n, generator=gen, device=gen.device, dtype=torch.float32)
    if abs(s - 1.0) < 1e-6:
        k = torch.exp(u * torch.log(torch.tensor(float(domain))))
    else:
        a = float(domain) ** (1.0 - s) - 1.0
        k = (a * u + 1.0) ** (1.0 / (1.0 - s))
    ki = k.clamp(1.0, float(domain)).to(torch.int32)
    ulp = (k * 2.0 ** -22).to(torch.int32).clamp_min(1)
    jitter = (torch.rand(n, generator=gen, device=gen.device,
                         dtype=torch.float32) * ulp.float()).to(torch.int32)
    ki = (ki + jitter).clamp(1, domain)
    return (ki - 1 + key_min).to(torch.int32)


def make_keys(gen: torch.Generator, n: int, key_min: int, key_max: int,
              distribution: str = "uniform",
              zipf_s: float = 1.0) -> torch.Tensor:
    if distribution == "uniform":
        return uniform_keys(gen, n, key_min, key_max)
    if distribution == "zipf":
        return zipf_keys(gen, n, key_min, key_max, zipf_s)
    raise ValueError(f"unknown distribution {distribution!r}")
