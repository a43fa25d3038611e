"""The profiler's trace, reduced: device busy time in a window, device
time by kernel name and by the host ranges (``record_function``) that
launched it, and the longest idle gaps, named by what the host was doing.

A kernel belongs to a range when the runtime call that launched it lies
inside the range on the same host thread (the profiler's correlation ids
tie the two)."""
from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
WINDOW = "portbench.window"


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Trace:
    def __init__(self, events):
        self.ranges = [e for e in events if e.get("cat") == "user_annotation"
                       and "dur" in e]
        win = [e for e in self.ranges if e["name"] == WINDOW]
        if not win:
            raise ValueError("the trace holds no window range")
        w = max(win, key=lambda e: e["dur"])
        self.t0, self.t1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
        self.main_tid = w["tid"]
        launches = {e["args"]["correlation"]: e for e in events
                    if e.get("cat") in LAUNCH_CATS and "args" in e
                    and "correlation" in e["args"]}
        self.device = []          # (start, end, name, launch ts, launch tid)
        for e in events:
            if e.get("cat") not in DEVICE_CATS or "dur" not in e:
                continue
            a = float(e["ts"])
            b = a + float(e["dur"])
            if b <= self.t0 or a >= self.t1:
                continue
            lz = launches.get(e.get("args", {}).get("correlation"))
            self.device.append((max(a, self.t0), min(b, self.t1), e["name"],
                                None if lz is None else float(lz["ts"]),
                                None if lz is None else lz["tid"]))
        self.cpu_ops = [e for e in events if e.get("cat") == "cpu_op" and "dur" in e]

    @classmethod
    def from_profiler(cls, prof) -> "Trace":
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        return cls(events)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def busy(self):
        return _merge([(a, b) for a, b, *_ in self.device])

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy()) * 1e-6

    def kernel_s(self, match) -> float:
        """Device seconds of the operations whose name ``match`` accepts."""
        return sum(b - a for a, b, name, *_ in self.device if match(name)) * 1e-6

    def range_device_s(self, names) -> float:
        """Device seconds of the operations launched inside a host range
        named in ``names`` (each operation counted once)."""
        by_tid = defaultdict(list)
        for e in self.ranges:
            if e["name"] in names:
                by_tid[e["tid"]].append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
        merged = {t: _merge(v) for t, v in by_tid.items()}
        starts = {t: [a for a, _ in v] for t, v in merged.items()}
        total = 0.0
        for a, b, _name, lts, ltid in self.device:
            if lts is None or ltid not in merged:
                continue
            i = bisect.bisect_right(starts[ltid], lts) - 1
            if i >= 0 and merged[ltid][i][1] >= lts:
                total += b - a
        return total * 1e-6

    def range_host_s(self, name: str) -> float:
        """Host seconds inside the ranges named ``name`` within the window."""
        return sum(min(float(e["ts"]) + float(e["dur"]), self.t1) - max(float(e["ts"]), self.t0)
                   for e in self.ranges if e["name"] == name
                   and float(e["ts"]) < self.t1 and float(e["ts"]) + float(e["dur"]) > self.t0) * 1e-6

    def top_device_ops(self, n: int = 10):
        by = defaultdict(float)
        for a, b, name, *_ in self.device:
            by[name[:160]] += (b - a) * 1e-6
        return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:n]

    def _host_at(self, t: float) -> str:
        """What the host was doing at ``t``: the innermost range covering
        it (the window's own thread first), else the innermost operator."""
        for pool in (self.ranges, self.cpu_ops):
            cover = [e for e in pool if e["name"] != WINDOW
                     and float(e["ts"]) <= t <= float(e["ts"]) + float(e["dur"])]
            if cover:
                cover.sort(key=lambda e: (e["tid"] != self.main_tid, float(e["dur"])))
                return cover[0]["name"][:160]
        return "host"

    def idle_gaps(self, n: int = 10):
        busy = self.busy()
        edges = [self.t0] + [x for ab in busy for x in ab] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        return [[self._host_at(0.5 * (a + b)), (b - a) * 1e-6] for a, b in gaps[:n]]
