"""The benchmark of the PyTorch and CUDA port on one H100.

    python3 abm_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  The program's kernel builds stay in the
checkout (``build/repro_torch/``), and so does any Triton cache
(``build/triton/``), each at a fixed path.
"""

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from abm_bench.harness import cli  # noqa: E402

if __name__ == "__main__":
    sys.exit(cli.main())
