"""Profiling and timing hooks (port of `lemo_tpu/utils/profiling.py`).

The reference's only instrumentation is wall-clock timing around the fits
(fit_temp_loadprox_slide.py:549-573, with `torch.cuda.synchronize`).
Here: the same wall-clock helper, a `torch.profiler` trace of the CPU and
the card written as a Chrome trace, and named regions in it.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


def _sync(device) -> None:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def wallclock(label: str, sink=print, device=None):
    """Device-synchronized wall-clock timing (the reference's
    `torch.cuda.synchronize(); time.time()` pattern) of the work on
    `device` (None: the CUDA card; a CPU device needs no sync)."""
    _sync(device)
    t0 = time.perf_counter()
    yield
    _sync(device)
    sink(f"[{label}] {time.perf_counter() - t0:.4f} s")


@contextlib.contextmanager
def profile_trace(logdir: str):
    """Profile the CPU and, where there is one, the card, and write a
    Chrome trace (open in Perfetto or chrome://tracing) into `logdir` as
    trace.json. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    """Named trace region for profiler timelines."""
    return torch.profiler.record_function(name)
