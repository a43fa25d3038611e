"""Readings for the limits of ``correct``: the numbers each check compares,
for the program and for its control, over several seeds in one process
(set-up is long).  Not part of a benchmark run.

    python3 portbench/calibrate.py --workload <cell> --seeds 11,12,13 --seconds 3 [--control]

Prints one JSON line a seed: ``{"seed", "images", "program": {...},
"control": {...}}``.
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench.harness import core  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--cpu-tiny", action="store_true")
    a = ap.parse_args(argv)
    bench = core.load_benchmark()
    cell, config, traffic = core.find_cell(bench, a.workload)
    core.prepare_environment()
    import importlib
    import torch
    from portbench.drivers._codec import free_cuda
    device = torch.device("cpu") if a.cpu_tiny else torch.device("cuda", 0)
    driver = importlib.import_module(f"portbench.drivers.{traffic['kind']}")
    for seed in [int(s) for s in a.seeds.split(",")]:
        args = argparse.Namespace(seed=seed, seconds=a.seconds, trace=0,
                                  cpu_tiny=a.cpu_tiny)
        run = core.Run(args, cell, config, traffic, device)
        t0 = time.perf_counter()
        drv = driver.Driver(run)
        setup = time.perf_counter() - t0
        n, t0 = 0, time.perf_counter()
        while time.perf_counter() - t0 < a.seconds:
            n += drv.step()
        drv.release()
        rec = {"seed": seed, "images": n, "setup_s": setup,
               "program": drv.check()}
        if a.control:
            rec["control"] = drv.control_check()
        print(json.dumps(rec), flush=True)
        del drv
        free_cuda()


if __name__ == "__main__":
    main()
