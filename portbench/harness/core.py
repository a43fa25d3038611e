"""One run of one cell: find the cell's configuration, traffic and metrics
by the names in ``BENCHMARK.json``; set the program up through the cell's
driver (``portbench/drivers/<kind>.py``, the kind named by the traffic
file); measure a closed-loop window on the host's clock, or, with
``--trace 1``, trace one; check the window's outputs against the plain
reference; print the result as the last line of standard output.

A driver is a class ``Driver(run)`` with:
- ``step() -> int``: one unit of the closed loop, waited for; returns the
  images it completed;
- ``release()``: free the program's state once the window has closed;
- ``check() -> dict``: ``{name: value}`` of the numbers the reference
  reads; those the traffic file's ``limits`` name are compared (a value at
  or under its limit passes);
- ``counts() -> (flops per image, attention records per image, dtype)``
  for the traced run's per-layer metrics;
- ``counters() -> dict``: the program's counters after the window.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

PORTBENCH = Path(__file__).resolve().parent.parent
ROOT = PORTBENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "sic_tpu")
SEED_MAX = 1 << 63


def parse_args(argv):
    ap = argparse.ArgumentParser(description="run one cell of BENCHMARK.json once")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--cpu-tiny", action="store_true",
                    help="rehearsal: the configuration's tiny preset on the CPU "
                         "(a result that names the CPU, never a measurement)")
    args = ap.parse_args(argv)
    if not 0 <= args.seed < SEED_MAX:
        ap.error(f"--seed must lie in [0, 2**63), got {args.seed}")
    return args


def fail(msg: str, code: int = 2):
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def load_benchmark(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        fail(f"{path} is missing")
    with open(path) as f:
        return json.load(f)


def find_cell(bench: dict, name: str, root: Path = ROOT):
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        fail(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(root / configs[cell["config"]]["file"]) as f:
        config = json.load(f)
    tpath = PORTBENCH / "traffic" / f"{cell['traffic']}.json"
    if not tpath.is_file():
        fail(f"no traffic file {tpath}")
    with open(tpath) as f:
        traffic = json.load(f)
    return cell, config, traffic


def cell_metrics(bench: dict, cell_name: str):
    """The end-to-end and per-layer metrics this cell reports."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell_name in m["workloads"]]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (cell_name in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return e2e, layer


def load_reader(name: str):
    """``portbench/metrics/<name>.py``'s ``read``."""
    path = PORTBENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules():
    return sorted({n.split(".")[0] for n in list(sys.modules)} & set(FORBIDDEN))


def refuse_forbidden() -> None:
    """Exit with code 3, before any result is printed, if JAX, flax or the
    JAX package is loaded in this process."""
    bad = forbidden_modules()
    if bad:
        fail(f"modules of {', '.join(bad)} are loaded in the benchmark's process", 3)


class Run:
    """What a driver and the metric readers see of the run."""

    def __init__(self, args, cell, config, traffic, device):
        self.args, self.cell, self.config, self.traffic = args, cell, config, traffic
        self.seed = args.seed
        self.device = device
        self.tiny = args.cpu_tiny
        # filled after the window
        self.trace = None
        self.images = 0
        self.window_s = 0.0
        self.counters = {}
        self.flops_per_image = None
        self.attention_per_image = None
        self.dtype = None


def prepare_environment():
    """Fixed cache directories inside the checkout, and no JAX behind
    ``transformers``; set before torch is imported."""
    cache = ROOT / ".portbench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def main(argv, t_start: float) -> int:
    args = parse_args(argv)
    bench = load_benchmark()
    cell, config, traffic = find_cell(bench, args.workload)
    e2e, layer = cell_metrics(bench, cell["name"])
    prepare_environment()
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import torch
    if args.cpu_tiny:
        device = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            fail("no CUDA device is available")
        if torch.cuda.device_count() < int(cell["chips"]):
            fail(f"the cell needs {cell['chips']} cards, "
                 f"{torch.cuda.device_count()} are visible")
        device = torch.device("cuda", 0)
        torch.cuda.init()
    run = Run(args, cell, config, traffic, device)
    driver = importlib.import_module(f"portbench.drivers.{traffic['kind']}")
    print(f"setup imports and device: {time.perf_counter() - t_start:.3f} s",
          file=sys.stderr, flush=True)
    drv = driver.Driver(run)
    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (lambda: None)
    sync()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start

    prof = None
    if args.trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        prof = profile(activities=acts)
        prof.__enter__()
        win = record_function("portbench.window")
        win.__enter__()
    # a traced run profiles the first ``trace_seconds`` of its window: a
    # steady part, and a trace that stays some tens of MB
    seconds = args.seconds if not args.trace else min(
        args.seconds, float(traffic.get("trace_seconds", args.seconds)))
    images = 0
    t0 = time.perf_counter()
    while True:
        images += drv.step()
        if time.perf_counter() - t0 >= seconds:
            break
    sync()
    window_s = time.perf_counter() - t0
    values = {"img_per_s": images / window_s}
    if prof is not None:
        win.__exit__(None, None, None)
        prof.__exit__(None, None, None)
    mem_peak = int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0
    run.images, run.window_s = images, window_s
    run.counters = drv.counters()
    drv.release()
    refuse_forbidden()

    metrics = {}
    breakdown = None
    busy_s = None
    if not args.trace:
        values["setup_s"] = setup_s
        for m in e2e:
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        from .trace import Trace
        if device.type == "cuda":
            run.trace = Trace.from_profiler(prof)
            busy_s = run.trace.busy_s
            breakdown = {"device_ops": run.trace.top_device_ops(),
                         "idle_gaps": run.trace.idle_gaps()}
        run.flops_per_image, run.attention_per_image, run.dtype = drv.counts()
        for m in layer:
            v = load_reader(m["name"])(run)
            if v is not None and math.isfinite(v):
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    del prof
    limits = traffic["limits"]
    numbers = drv.check()
    missing = set(limits) - set(numbers)
    if missing:
        fail(f"the check read no {', '.join(sorted(missing))}")
    checks = {k: (float(numbers[k]), float(limits[k])) for k in limits}
    correct = all(v <= lim for v, lim in checks.values()) and bool(checks)
    for name, (v, lim) in checks.items():
        print(f"check {name}: {v!r} (limit {lim!r}) {'ok' if v <= lim else 'FAILED'}",
              file=sys.stderr)
    if device.type == "cuda":
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
               "count": int(cell["chips"]), "memory_peak_bytes": mem_peak}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    if args.trace:
        dev["busy_s"] = busy_s if busy_s is not None else 0.0
        dev["window_s"] = run.trace.window_s if run.trace is not None else window_s
    out = {"correct": correct, "attempted": images, "failed": 0,
           "metrics": metrics, "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    refuse_forbidden()                  # the reference has run too
    sys.stdout.flush()
    print(json.dumps(out), flush=True)
    return 0
