#!/usr/bin/env python3
"""The control of ``correct``, and the program's readings beside it.

The control is the reference put in the program's place with one
guarantee of the configuration broken: a hash table of one slot a key, as
a join that assumes unique build keys keeps, so each probe row meets only
the first build row of its key, and pairs of repeated build keys go
missing. It runs through the harness's window and comparison as the
program does, and has to come out not correct.

Usage, from the root of a checkout, on a CUDA card at the cell's size:

    python3 joinbench/control.py --workload low.pairs --seconds 3 \\
        --seeds 11 12 13 [--program]

One JSON line a seed: the seed, which side ran, ``correct`` and each
number compared. ``--program`` runs the program's own calls instead (its
readings on many seeds in one process). The benchmark's runs never run
this file.
"""
import argparse
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent.parent


def control_calls(calls_dir: Path, load_module):
    """The control's build, count and materialize, each judged by the
    program's call of the same layer (its KEEP, LIMITS and check)."""
    import torch

    def build(join, cfg):
        sorted_keys, order = torch.sort(join["build_keys"], stable=True)
        first = torch.ones_like(sorted_keys, dtype=torch.bool)
        first[1:] = sorted_keys[1:] != sorted_keys[:-1]
        join["table"] = (sorted_keys[first], order[first])

    def count(join, cfg):
        keys, _ = join["table"]
        probe = join["probe_keys"]
        pos = torch.searchsorted(keys, probe).clamp(max=max(keys.numel() - 1,
                                                            0))
        hit = (keys[pos] == probe) if keys.numel() else \
            torch.zeros_like(probe, dtype=torch.bool)
        ids = torch.arange(probe.numel(), device=probe.device)
        total = int(hit.sum())
        join.update(state=SimpleNamespace(probe_ids=ids, counts=hit.int()),
                    total=total, nonzero=total, pos=pos, hit=hit)

    def materialize(join, cfg):
        _, order = join["table"]
        s = torch.nonzero(join["hit"]).squeeze(1)
        r = order[join["pos"][s]]
        join.update(pairs=(r.int(), s.int()), pair_total=join["total"])

    out = []
    for name, run in (("build", build), ("probe_count", count),
                      ("plan_materialize", materialize)):
        program = load_module(calls_dir / f"{name}.py")
        out.append(SimpleNamespace(
            LAYER=program.LAYER, KEEP=program.KEEP, run=run,
            **({"LIMITS": program.LIMITS, "check": program.check}
               if hasattr(program, "check") else {})))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--program", action="store_true",
                    help="run the program's calls, not the control's")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    import torch

    from joinbench import harness

    if not torch.cuda.is_available():
        print("joinbench.control: no CUDA card", file=sys.stderr)
        return 2
    calls = None if args.program else control_calls(
        harness.HERE / "calls", harness.load_module)
    for seed in args.seeds:
        out = harness.run_cell(ROOT, args.workload, seed, args.seconds,
                               False, torch.device("cuda", 0),
                               time.perf_counter(), calls=calls)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "side": "program" if args.program else "control",
                          "correct": out["correct"],
                          "attempted": out["attempted"],
                          "checks": {k: v["value"]
                                     for k, v in out["checks"].items()}}),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
