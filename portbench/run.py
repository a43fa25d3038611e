"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cells, their configurations, traffic and metrics are named in
``BENCHMARK.json`` at the root of the checkout; see ``portbench/harness/core.py``.
"""
import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from portbench.harness.core import main
    sys.exit(main(sys.argv[1:], T_START))
