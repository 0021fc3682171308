"""The control of the correctness check: a cell run with the program's own
lower-precision path switched on (`IndexConfig(dtype="float32")`, the
f32/i64 kernel instance, in place of the f64/i64 one the configurations
state), which the check has to find not correct.  The benchmark's own runs
never run it.

    python dilibench/control.py --workload <cell> --seeds 1,2,3 \
        --seconds <s> [--dtype float32|as-configured]

runs the cell once per seed in one process, on the CUDA device, and prints
one JSON line per seed with the numbers compared and the verdict.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from dilibench import faults  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--dtype", default="float32")
    p.add_argument("--fault", choices=sorted(faults.FAULTS))
    args = p.parse_args(argv)
    import torch
    from dilibench import harness, manifest
    if not torch.cuda.is_available():
        print("the control runs on a CUDA device", file=sys.stderr)
        return 2
    cell = manifest.cell(args.workload)
    over = None if args.dtype == "as-configured" else {"dtype": args.dtype}
    if args.fault:
        faults.plant(args.fault)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        r = harness.run_cell(cell, seed, args.seconds, False, "cuda:0", t0,
                             overrides=over)
        print(json.dumps(dict(workload=args.workload, seed=seed,
                              dtype=args.dtype, fault=args.fault,
                              correct=r["correct"],
                              attempted=r["attempted"], failed=r["failed"],
                              check=r["check"],
                              run_s=time.perf_counter() - t0)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
