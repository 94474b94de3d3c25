"""Table persistence (the port of tpujoin/core/io.py), in the JAX
package's two on-disk formats, so a table written by either package loads
in the other:

- ``.npz``: one compressed archive per table;
- a raw column directory: one little-endian binary file per column and a
  ``schema.json`` of each column's dtype and rows, the layout to map
  large tables from.

Loading returns a Table on ``device``: CUDA unless the caller asks for the
CPU (``device="cpu"``), as for every entry point of the port.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from tpujoin_torch.core.table import Table
from tpujoin_torch.utils.device import resolve_device


def save_table_npz(table: Table, path) -> None:
    np.savez_compressed(path, **table.to_numpy())


def load_table_npz(path, *, device: torch.device | str | None = None
                   ) -> Table:
    dev = resolve_device(device=device)
    with np.load(path) as z:
        return Table.from_numpy({k: z[k] for k in z.files}, dev)


def save_table_dir(table: Table, path) -> None:
    """One raw binary file per column and schema.json."""
    p = Path(path)
    p.mkdir(parents=True, exist_ok=True)
    schema = {}
    for name, col in table.to_numpy().items():
        arr = np.ascontiguousarray(col)
        arr.tofile(p / f"{name}.bin")
        schema[name] = {"dtype": str(arr.dtype), "rows": int(arr.shape[0])}
    (p / "schema.json").write_text(json.dumps(schema, indent=2))


def load_table_dir(path, *, mmap: bool = True,
                   device: torch.device | str | None = None) -> Table:
    """Load a raw column directory. With ``mmap`` each column file is
    mapped copy-on-write, so it is writable as a tensor must be while the
    file stays unchanged: on the CPU the columns are views of the mapped
    files, read only where used (a write to one stays in memory); a load to
    the card copies each column there. Without ``mmap`` the files are read
    whole."""
    dev = resolve_device(device=device)
    p = Path(path)
    schema = json.loads((p / "schema.json").read_text())
    cols = {}
    for name, meta in schema.items():
        dtype = np.dtype(meta["dtype"])
        f = p / f"{name}.bin"
        if mmap:
            cols[name] = np.memmap(f, dtype=dtype, mode="c",
                                   shape=(meta["rows"],))
        else:
            cols[name] = np.fromfile(f, dtype=dtype, count=meta["rows"])
    return Table.from_numpy(cols, dev)
