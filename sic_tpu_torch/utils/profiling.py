"""Stage timing and device traces.

The port's counterpart of the JAX package's ``utils/profiling.py``:

- :class:`StageTimer`: named wall-clock stages, exported in the reference's
  ``X-SIC-*`` header format (reference: webapp.py:41-48), as the JAX
  package's;
- :func:`profile_trace`: a ``torch.profiler`` trace of the CPU (every
  thread) and the card into a directory, in the TensorBoard profiler
  plugin's layout;
- :func:`timed_stage`: a region timed by a StageTimer and, while a
  profiler runs, annotated in its trace (``record_function``).

The module imports torch only once a profiler is asked for, so the
numpy-only modules that annotate their work (``container/c2df.py``) stay
numpy-only.
"""
from __future__ import annotations

import contextlib
import sys
import time
from typing import Dict, Optional


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


def _all_threads_config():
    """The profiler setting that records ranges entered on every thread
    (pool threads too), or None where the installed torch lacks it."""
    try:
        from torch._C._profiler import _ExperimentalConfig
        return _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        return None


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Trace the CPU and, where there is one, the card into ``log_dir``
    (a ``*.pt.trace.json`` that TensorBoard's profiler plugin and Chrome's
    trace viewer open).  Ranges entered on worker threads are recorded
    too, where the installed torch can (``profile_all_threads``), and so
    are the call numbers the runtime's spans carry (``record_shapes``)."""
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    config = _all_threads_config()
    extra = {} if config is None else {"experimental_config": config}
    with profile(activities=activities, record_shapes=True,
                 on_trace_ready=tensorboard_trace_handler(str(log_dir)),
                 **extra):
        yield


def tracing() -> bool:
    """True while a ``torch.profiler`` runs in this process.  The flag is
    process-wide: it reads True on worker threads too, where the
    profiler's thread-local state does not."""
    prof = sys.modules.get("torch.autograd.profiler")
    return prof is not None and prof._is_profiler_enabled


_UNTRACED = contextlib.nullcontext()


def timed_stage(timer: Optional[StageTimer], name: str, args: Optional[int] = None):
    """StageTimer + trace annotation in one context.  The timer reads the
    host's clock: a stage that ends with work still queued on the card
    counts only its enqueue, unless the code inside waits for it.

    The annotation is entered only while a profiler runs; otherwise a
    stage without a timer costs a flag read and an empty context.
    ``args`` (an int, such as the runtime's call number) is recorded as
    the range's input when the profiler records shapes, so that spans on
    worker threads can be tied to the call that caused them."""
    if not tracing():
        return timer.stage(name) if timer is not None else _UNTRACED
    return _traced_stage(timer, name, args)


@contextlib.contextmanager
def _traced_stage(timer: Optional[StageTimer], name: str, args: Optional[int]):
    import torch
    ctx = timer.stage(name) if timer is not None else contextlib.nullcontext()
    if args is None:
        with ctx, torch.profiler.record_function(name):
            yield
        return
    autograd = torch._C._autograd
    with ctx:
        handle = autograd._record_function_with_args_enter(name, int(args))
        try:
            yield
        finally:
            autograd._record_function_with_args_exit(handle)
