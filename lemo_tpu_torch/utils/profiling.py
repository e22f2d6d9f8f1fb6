"""Profiling and timing hooks (port of `lemo_tpu/utils/profiling.py`).

The reference's only instrumentation is wall-clock timing around the fits
(fit_temp_loadprox_slide.py:549-573, with `torch.cuda.synchronize`).
Here: the same wall-clock helper, a `torch.profiler` trace of the CPU and
the card written as a Chrome trace, and the program's spans.

A span (`annotate`) names a stretch of the program's host work, with
counts of the work it covers. Every span's name starts with `lemo.`. A
span is recorded only where a caller turns recording on:

- while `torch.profiler` runs, as a record-function region on the
  host's row of the trace, on the same clock (Kineto's) as the card's
  kernels. The region has function scope (`_RecordFunctionFast`): a
  user-scope one (`torch.profiler.record_function`) is also drawn on the
  card's row as an annotation over the work it launched, which a reader
  of the trace's device events would take for a device operation;
- inside `record_spans()`, as a row of an in-memory log on
  `time.perf_counter_ns()`'s clock, read once the run ends.

Otherwise a span costs two flag checks and nothing else. `timed` is the
span that also hands its seconds to its caller whatever the recording
(the PROX driver's stage seconds).
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import time

import torch

PREFIX = "lemo."

# the log of the innermost `record_spans()` of this thread (a new thread
# starts with none, so a worker thread's spans never enter another's log)
_LOG: contextvars.ContextVar = contextvars.ContextVar("lemo_span_log",
                                                      default=None)
_profiler_enabled = torch.autograd._profiler_enabled
_region = torch._C._profiler._RecordFunctionFast


class _Off:
    """A span that nothing records: enters and exits doing nothing (and
    is cheaper than `contextlib.nullcontext`, whose exit takes *args)."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return None


_OFF = _Off()


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


class SpanLog(list):
    """The spans recorded inside one `record_spans()`, in the order they
    opened: rows (name, start_ns, end_ns, parent, counts), `parent` the
    row of the span open around it (None at the top), `counts` the
    span's counts ({} without). A row's end_ns is None while its span is
    open."""

    def __init__(self):
        super().__init__()
        self.open: list[int] = []    # the open spans' rows, innermost last


@contextlib.contextmanager
def record_spans():
    """Record every span this thread opens into a `SpanLog` (yielded),
    kept in memory; nothing is written while it records."""
    log = SpanLog()
    token = _LOG.set(log)
    try:
        yield log
    finally:
        _LOG.reset(token)


class _Span:
    """An open span: a function-scope region under the profiler, a row of
    `log` when there is one, and its seconds when `timed`."""

    __slots__ = ("name", "counts", "log", "region", "timed", "row",
                 "parent", "t0", "seconds")

    def __init__(self, name: str, counts: dict, log, profiled: bool,
                 timed: bool):
        self.name, self.counts, self.log, self.timed = name, counts, log, \
            timed
        self.region = _region(name) if profiled else None
        self.seconds = None

    def __enter__(self):
        if self.region is not None:
            self.region.__enter__()
        log = self.log
        if log is not None or self.timed:
            self.t0 = time.perf_counter_ns()
        if log is not None:
            self.row = len(log)
            self.parent = log.open[-1] if log.open else None
            log.append((self.name, self.t0, None, self.parent, self.counts))
            log.open.append(self.row)
        return self

    def __exit__(self, *exc):
        log = self.log
        if log is not None or self.timed:
            t1 = time.perf_counter_ns()
            self.seconds = (t1 - self.t0) / 1e9
        if log is not None:
            log[self.row] = (self.name, self.t0, t1, self.parent,
                             self.counts)
            log.open.pop()
        if self.region is not None:
            self.region.__exit__(*exc)
        return False


def annotate(name: str, **counts):
    """The span `lemo.<name>` with `counts` (numbers of the work it
    covers, which a reader divides by: `steps` and `replayed` on
    `lemo.fit`), as a context manager. The counts reach
    `record_spans()`'s log only: a profiler's region carries the name
    alone. Off (no profiler, no `record_spans()`) it is a shared one
    that does nothing."""
    log, profiled = _LOG.get(), _profiler_enabled()
    if log is None and not profiled:
        return _OFF
    return _Span(PREFIX + name, counts, log, profiled, False)


def timed(name: str):
    """`annotate` that always reads the clock: the context manager it
    enters has `seconds` once it exits."""
    return _Span(PREFIX + name, {}, _LOG.get(), _profiler_enabled(), True)
