"""Readings for the limits of ``correct``: the program's numbers over many
seeds and the control's (the reference one precision below the
configuration's, in the program's place) on the same checked steps.

    python3 abm_bench/calibrate.py --workload <cell> --seeds 1,2,3 [--seconds 5]
        [--out calibrate-<cell>.jsonl]

Every seed is one short run of the cell in this process (the kernels are
built once), at the cell's own sizes and load.  The benchmark's own runs
never run the control.
"""

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from abm_bench.harness import cli  # noqa: E402

# The control: the configurations state float32, and the step below it that
# would tempt a later change is bfloat16.
CONTROL = torch.bfloat16


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    out = open(args.out, "a") if args.out else None
    for seed in (int(s) for s in args.seeds.split(",")):
        res = cli.run_cell(args.workload, seed, args.seconds, False, control=CONTROL)
        line = json.dumps({"workload": args.workload, "seed": seed,
                           "program": res["checked"]["numbers"], "control": res["control"],
                           "correct": res["correct"], "metrics": res["metrics"]})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
