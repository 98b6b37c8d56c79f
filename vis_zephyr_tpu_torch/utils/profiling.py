"""Profiling and tracing as a module of their own.

Port of `vis_zephyr_tpu/utils/profiling.py` on `torch.profiler` in place of
`jax.profiler`:

- `profile_to(dir)` records the enclosed region with `torch.profiler.profile`
  and writes one Chrome trace file into `dir` (viewable in Perfetto or
  `chrome://tracing`; the JAX package writes an XLA trace for TensorBoard):
  the card's kernels, process-wide, where CUDA is available, and the host
  operators of the thread that entered it (the profiler records no other
  thread's); `init_tracing()` must have run on the main thread first,
- `trace_region(name)` names a region in such a trace
  (`torch.profiler.record_function`),
- `device_sync(x)` waits for the card that holds `x` (a no-op on the CPU),
- `StepTimer` measures steady-state step times with the warm-up discarded.
"""

from __future__ import annotations

import contextlib
import os
import statistics
import time
from typing import Dict, List, Optional

import torch


def device_sync(x) -> None:
    """Block until the work producing `x` is done: `torch.cuda.synchronize`
    on the device of `x` (a tensor, or a list, tuple or dict whose last leaf
    is one); nothing on the CPU, where operations run synchronously."""
    while isinstance(x, (list, tuple, dict)):
        leaves = list(x.values()) if isinstance(x, dict) else list(x)
        if not leaves:
            return
        x = leaves[-1]
    if isinstance(x, torch.Tensor) and x.device.type == "cuda":
        torch.cuda.synchronize(x.device)


def _activities() -> list:
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return activities


def init_tracing() -> None:
    """Start and stop the profiler once on the calling thread. Its tracing
    library initialises on its first start, and must do so on the thread
    that loaded torch: started first from another thread (an HTTP
    handler's), it traces none of the card's kernels."""
    with torch.profiler.profile(activities=_activities()):
        pass


@contextlib.contextmanager
def profile_to(log_dir: str):
    """Record the enclosed region and write its trace into `log_dir` as
    `trace_<pid>_<ns>.json`. Yields a dict whose "path" is set to that file
    once the region ends."""
    os.makedirs(log_dir, exist_ok=True)
    out: Dict[str, Optional[str]] = {"path": None}
    with torch.profiler.profile(activities=_activities()) as prof:
        yield out
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    out["path"] = path


@contextlib.contextmanager
def trace_region(name: str):
    """Annotate a region in profiler traces."""
    with torch.profiler.record_function(name):
        yield


class StepTimer:
    """Accumulates per-step wall times; first `warmup` steps are discarded
    (compile + cache effects)."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.times: List[float] = []
        self._seen = 0
        self._t0: Optional[float] = None

    @contextlib.contextmanager
    def step(self, sync_on=None):
        t0 = time.perf_counter()
        yield
        if sync_on is not None:
            device_sync(sync_on)
        dt = time.perf_counter() - t0
        self._seen += 1
        if self._seen > self.warmup:
            self.times.append(dt)

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {}
        ts = sorted(self.times)
        return {
            "steps": len(ts),
            "mean_s": statistics.fmean(ts),
            "p50_s": ts[len(ts) // 2],
            "p90_s": ts[int(len(ts) * 0.9)],
            "min_s": ts[0],
            "max_s": ts[-1],
        }
