"""The control of a cell's output check, on the card at the cell's own
size: the plain reference put in the program's place and computed in the
precision below the configuration's, judged against the reference by the
check's numbers.  It has to fail: each number it reads is printed beside
the cell's limit.

    python3 port_bench/control.py --workload <name> --seeds <n>[,<n>...]

The benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from port_bench.harness import Cell  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("control.py: no CUDA device", file=sys.stderr)
        return 2
    cell = Cell(args.workload)
    drv = importlib.import_module(f"port_bench.drivers.{cell.traffic['kind']}")
    failed_all = True
    for seed in (int(s) for s in args.seeds.split(",")):
        g = drv.control(cell, seed % 2 ** 63, torch.device("cuda", 0))
        fails = [k for k, v in g.items() if not v <= cell.limits[k]]
        failed_all &= bool(fails)
        print(json.dumps(dict(workload=args.workload, seed=seed, control=g,
                              limits=cell.limits, failed=fails)), flush=True)
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
