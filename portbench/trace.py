"""Reduction of a `torch.profiler` trace to what the per-layer metrics
read (the pattern of `scripts/profile_torch_s2.py`, frozen here): the
device's busy time as the union of its operation intervals, the device
operations by name, and the idle gaps between them labelled by the
benchmark's own spans around its calls into the program."""

from __future__ import annotations

import contextlib
import dataclasses
import time

# the benchmark's own spans (torch.autograd.profiler.record_function
# names); an idle gap is labelled by the innermost one open at its start
SPAN_PREFIX = "portbench."


def union_us(intervals) -> float:
    """The length of the union of (start, end) intervals."""
    total, end = 0.0, -1.0
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


@dataclasses.dataclass
class DeviceTrace:
    """One profiled stretch: its wall (host clock, microseconds), the
    device operations [(name, start_us, end_us)], the benchmark's spans
    [(name, start_us, end_us)], the steps it holds and the program's
    launch counters over it."""

    wall_us: float
    ops: list
    spans: list
    steps: int
    counters: dict = dataclasses.field(default_factory=dict)

    @property
    def busy_us(self) -> float:
        return union_us([(s, e) for _, s, e in self.ops])

    def us_by_name(self) -> dict[str, float]:
        out: dict[str, float] = {}
        for name, s, e in self.ops:
            out[name] = out.get(name, 0.0) + (e - s)
        return out

    def launches(self) -> int:
        return len(self.ops)

    def idle_gaps(self) -> list[tuple[str, float]]:
        """Gaps between device operations, each [label, microseconds],
        the label the innermost span open on the host at the gap's start
        ("none" outside every span)."""
        ivs = sorted((s, e) for _, s, e in self.ops)
        gaps, end = [], None
        for s, e in ivs:
            if end is not None and s > end:
                gaps.append((end, s))
            end = e if end is None else max(end, e)
        out = []
        for g0, g1 in gaps:
            open_ = [(s, name) for name, s, e in self.spans if s <= g0 < e]
            label = max(open_)[1] if open_ else "none"
            out.append((label, g1 - g0))
        return out

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time and the longest idle
        gaps by label, in seconds."""
        return breakdown([self], top)


def breakdown(traces, top: int = 10) -> dict:
    """`DeviceTrace.breakdown` over several stretches together."""
    ops: dict[str, float] = {}
    gaps: dict[str, float] = {}
    for t in traces:
        for name, us in t.us_by_name().items():
            ops[name] = ops.get(name, 0.0) + us
        for label, us in t.idle_gaps():
            gaps[label] = gaps.get(label, 0.0) + us
    ops_top = sorted(ops.items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:160], us / 1e6] for n, us in ops_top],
            "idle_gaps": [[n, us / 1e6] for n, us in idle]}


@dataclasses.dataclass
class PerStep:
    """Two profiled calls of the timed fitter's factory, at n1 < n2 steps,
    read as one step of the timed call of `steps` steps: a quantity's
    per-step part (the difference of the two calls over n2 - n1 steps)
    plus its per-call part (the shorter call less its steps) spread over
    `steps`, so that a step means what it means in the window."""

    short: DeviceTrace
    long: DeviceTrace
    steps: int

    def __post_init__(self):
        if not self.short.steps < self.long.steps:
            raise ValueError("PerStep: the short call must hold fewer steps")

    def __call__(self, quantity) -> float:
        a, b = quantity(self.short), quantity(self.long)
        per = (b - a) / (self.long.steps - self.short.steps)
        return per + (a - self.short.steps * per) / self.steps

    @property
    def traces(self) -> tuple:
        return (self.short, self.long)


def _is_device_event(e) -> bool:
    from torch.autograd import DeviceType

    return e.device_type == DeviceType.CUDA


def profile_stretch(fn, steps: int) -> DeviceTrace:
    """Run `fn()` (which must end in a synchronize) once under
    torch.profiler with CPU and CUDA activities; returns its DeviceTrace.
    Device operations are the trace's CUDA events: kernels, copies and
    fills."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.events()
    # a span shows on the device's timeline too (as an annotation over
    # the work it launched): not a device operation
    ops = [(e.name, e.time_range.start, e.time_range.end)
           for e in events if _is_device_event(e)
           and not e.name.startswith(SPAN_PREFIX)]
    spans = [(e.name, e.time_range.start, e.time_range.end)
             for e in events if e.name.startswith(SPAN_PREFIX)
             and not _is_device_event(e)]
    return DeviceTrace(wall_us=wall_us, ops=ops, spans=spans, steps=steps)


@contextlib.contextmanager
def span(name: str):
    """A benchmark span (recorded only while a profiler runs)."""
    import torch

    with torch.autograd.profiler.record_function(SPAN_PREFIX + name):
        yield
