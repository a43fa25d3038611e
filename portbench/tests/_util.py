"""Helpers of the benchmark's own tests: a run of a cell on the CPU at
the configuration's tiny preset, in this process, its last line parsed."""
from __future__ import annotations

import contextlib
import io
import json
import time



def run_cell(workload: str, seed: int = 3000000011, seconds: float = 1.0,
             trace: int = 0) -> dict:
    from portbench.harness import core
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = core.main(["--workload", workload, "--seed", str(seed),
                        "--seconds", str(seconds), "--trace", str(trace),
                        "--cpu-tiny"], time.perf_counter())
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])
