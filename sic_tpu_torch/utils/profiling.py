"""Stage timing and device traces.

The port's counterpart of the JAX package's ``utils/profiling.py``:

- :class:`StageTimer`: named wall-clock stages, exported in the reference's
  ``X-SIC-*`` header format (reference: webapp.py:41-48), as the JAX
  package's;
- :func:`profile_trace`: a ``torch.profiler`` trace of the CPU and the
  card into a directory, in the TensorBoard profiler plugin's layout;
- :func:`timed_stage`: a region timed by a StageTimer and annotated in that
  trace (``torch.profiler.record_function``).
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import torch


class StageTimer:
    """Accumulates named stage durations (ms)."""

    def __init__(self):
        self.stages: Dict[str, float] = {}
        self._order = []

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            ms = (time.perf_counter() - t0) * 1000.0
            if name not in self.stages:
                self._order.append(name)
            self.stages[name] = self.stages.get(name, 0.0) + ms

    @property
    def total_ms(self) -> float:
        return sum(self.stages.values())

    def headers(self, stage: Optional[str] = None) -> Dict[str, str]:
        """X-SIC-* header dict (reference format: webapp.py:41-48), plus a
        per-stage breakdown header."""
        name = stage or "+".join(self._order)
        return {
            "X-SIC-Stage": name,
            "X-SIC-Elapsed-MS": str(int(self.total_ms)),
            "X-SIC-Elapsed-S": f"{self.total_ms / 1000.0:.3f}",
            "X-SIC-Stage-Breakdown": ";".join(
                f"{k}={self.stages[k]:.1f}ms" for k in self._order),
        }


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Trace the CPU and, where there is one, the card into ``log_dir``
    (a ``*.pt.trace.json`` that TensorBoard's profiler plugin and Chrome's
    trace viewer open)."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(str(log_dir))):
        yield


@contextlib.contextmanager
def timed_stage(timer: Optional[StageTimer], name: str):
    """StageTimer + trace annotation in one context.  The timer reads the
    host's clock: a stage that ends with work still queued on the card
    counts only its enqueue, unless the code inside waits for it."""
    ctx = timer.stage(name) if timer is not None else contextlib.nullcontext()
    with ctx, torch.profiler.record_function(name):
        yield
