#!/usr/bin/env python3
"""The benchmark of tpujoin_torch: one run of one cell of BENCHMARK.json.

Usage, from the root of a checkout:

    python3 joinbench/run.py --workload low.pairs --seed 7 --seconds 10 \\
        --trace 0

It needs as many CUDA cards as the cell asks for. stdout's last line is
the result, one JSON object; each number compared for ``correct`` is
printed beside its limit as the last lines of stderr. With ``--trace 0``
the metrics are the cell's end-to-end metrics, with ``--trace 1`` its
per-layer ones. The run exits with another code than 0, and prints no
result, when the cards are missing, when the program cannot be imported,
or when JAX or the JAX package was loaded.
"""
import argparse
import json
import os
import sys
import time
from pathlib import Path

T0 = time.perf_counter()   # set-up counts from here, before torch loads

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".joinbench_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "tpujoin")


def forbidden_modules() -> list:
    """The loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # kernel caches at fixed paths inside the checkout
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)
    sys.path.insert(0, str(ROOT))

    import torch

    from joinbench import harness

    cell = harness.load_cell(ROOT, args.workload)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < cell.chips:
        print(f"joinbench: {args.workload} needs {cell.chips} CUDA "
              f"card(s); found {cards}", file=sys.stderr)
        return 2
    try:
        import tpujoin_torch  # noqa: F401
    except ImportError as exc:
        print(f"joinbench: the program does not import: {exc}",
              file=sys.stderr)
        return 2
    out = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                           bool(args.trace), torch.device("cuda", 0), T0)
    found = forbidden_modules()
    if found:
        print(f"joinbench: loaded {', '.join(found)}; the benchmark runs "
              "the port alone", file=sys.stderr)
        return 3
    harness.print_checks(out["checks"])
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
