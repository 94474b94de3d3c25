"""TPC-H order keys (TPC Benchmark H Standard Specification 3.0.1,
§4.2.3, and its dbgen): ``O_ORDERKEY`` is unique and sparse, only the
first 8 of every 32 key values used, and each order has 1 to 7
``LINEITEM`` rows, drawn uniformly, each carrying its ``L_ORDERKEY``.

An op's inputs (:func:`inputs`) are the join's two key columns: the build
side is the orders table and the probe side the lineitem table. :func:`make`
draws one of them, which it tells apart by ``n`` against the configuration's
``build_rows`` (orders) and ``probe_rows`` (lineitems):

- orders: order i's key is (i // 8) * 32 + i % 8 + 1, the rows in a
  seeded random order;
- lineitems: each order's row count drawn from 1 to 7, its key repeated
  that many times in order of i; the tail cut or extended to exactly
  ``probe_rows`` rows, the extension repeating the keys of the first
  orders once more; then the rows in a seeded random order, as after a
  load or an upstream operator (dbgen writes them clustered by order key,
  which would flatter the sort).

Every lineitem key is an order key, so each probe row matches exactly one
build row. Like ``uniform.py`` this imports nothing of the program under
test.
"""
from __future__ import annotations

import torch

LINES_MIN, LINES_MAX = 1, 7   # lineitem rows of one order


def order_keys(i: torch.Tensor) -> torch.Tensor:
    """The key of order ``i`` (int64 indices), as i32."""
    return ((i // 8) * 32 + i % 8 + 1).to(torch.int32)


def lineitem_keys(gen: torch.Generator, orders: int, n: int) -> torch.Tensor:
    """The lineitems' keys in order-key order, before the shuffle: each
    order's key 1 to 7 times, cut or extended to ``n`` rows."""
    dev = gen.device
    lines = torch.randint(LINES_MIN, LINES_MAX + 1, (orders,), generator=gen,
                          device=dev)
    keys = torch.repeat_interleave(
        order_keys(torch.arange(orders, device=dev)), lines)
    if keys.numel() >= n:
        return keys[:n]
    more = torch.arange(n - keys.numel(), device=dev) % orders
    return torch.cat([keys, order_keys(more)])


def make(gen: torch.Generator, n: int, cfg: dict) -> torch.Tensor:
    """``n`` keys on ``gen``'s device: the orders' when ``n`` is
    ``build_rows``, the lineitems' when it is ``probe_rows``."""
    orders, lineitems = cfg["build_rows"], cfg["probe_rows"]
    if orders == lineitems or n not in (orders, lineitems):
        raise ValueError(f"{n} rows are neither the {orders} orders nor the "
                         f"{lineitems} lineitems")
    if n == orders:
        return order_keys(torch.randperm(n, generator=gen, device=gen.device))
    keys = lineitem_keys(gen, orders, n)
    return keys[torch.randperm(n, generator=gen, device=gen.device)]


def inputs(gen: torch.Generator, cfg: dict) -> dict:
    """One op's named input columns: the orders' keys, then the
    lineitems', drawn in that order."""
    return {"build_keys": make(gen, cfg["build_rows"], cfg),
            "probe_keys": make(gen, cfg["probe_rows"], cfg)}


def rows(cfg: dict) -> int:
    """The table rows one op reads: both sides of the join."""
    return cfg["build_rows"] + cfg["probe_rows"]
