"""The `program_span` readers (`portbench.program_spans`): host ms a step
from a hand-made span log, nothing from an empty or missing one, a real
span stretch of the cell at tiny sizes in a child process on the CPU,
nothing from a program without spans; and on the card (marked `cuda`), that the
program's spans add no device operation to a profiled call."""

import importlib

import pytest

from portbench import program_spans, run
from portbench.tests.conftest import AMASS_SMALL

READERS = {"host_forward_ms_per_step": "lemo.step.forward",
           "host_backward_ms_per_step": "lemo.step.backward",
           "host_update_ms_per_step": "lemo.step.update",
           "prior_host_ms_per_step": "lemo.term.smooth_prior"}


def _log():
    """Two fits of 2 and 3 steps: each step's forward 1 ms (its prior 0.25
    ms inside it), backward 2 ms, update 0.5 ms; one span never closed."""
    rows, t = [], 0
    for steps in (2, 3):
        fit = len(rows)
        rows.append(["lemo.fit", t, None, None, {"steps": steps}])
        for _ in range(steps):
            fwd = len(rows)
            rows.append(("lemo.step.forward", t, t + 1_000_000, fit, {}))
            rows.append(("lemo.term.smooth_prior", t + 500_000,
                         t + 750_000, fwd, {}))
            rows.append(("lemo.step.backward", t + 1_000_000,
                         t + 3_000_000, fit, {}))
            rows.append(("lemo.step.update", t + 3_000_000, t + 3_500_000,
                         fit, {}))
            t += 4_000_000
        rows[fit][2] = t
        rows[fit] = tuple(rows[fit])
    rows.append(("lemo.step.forward", t, None, None, {}))
    return rows


@pytest.mark.parametrize("name,want", [
    ("host_forward_ms_per_step", 1.0), ("host_backward_ms_per_step", 2.0),
    ("host_update_ms_per_step", 0.5), ("prior_host_ms_per_step", 0.25)])
def test_each_reader_reads_a_hand_made_log(monkeypatch, name, want):
    mod = importlib.import_module(f"portbench.metrics.{name}")
    for log, expect in ((_log(), want), ([], None), (None, None),
                        ([r for r in _log() if r[0] != READERS[name]], None),
                        ([r for r in _log() if r[0] != "lemo.fit"], None)):
        monkeypatch.setattr(program_spans, "window_log", lambda ctx: log)
        got = mod.read(object())
        assert got == (pytest.approx(expect) if expect else None), log


def _runner(device="cpu", seed=2**31 + 11):
    _, entry, cell, config = run.load_cell("amass_s2.c16")
    for k, v in AMASS_SMALL.items():
        (cell if k in cell else config)[k] = v
    mod = importlib.import_module(f"portbench.runners.{entry['config']}")
    return mod.Runner(config, cell, seed, device)


def test_the_span_stretch_of_the_cells_runner():
    """The stretch runs in a child process and leaves the run's runner as
    it was."""
    runner = _runner()
    got = program_spans.record(runner)
    assert runner.fit is None and runner.records == []   # never set up
    log, steps = got["log"], AMASS_SMALL["num_fit_steps"]
    assert got["steps"] == program_spans.CALLS * steps
    assert len(got["wall_s"]) == program_spans.CALLS
    fits = [r for r in log if r[0] == "lemo.fit"]
    assert [r[4] for r in fits] == [{"steps": steps}] * program_spans.CALLS
    for name in READERS.values():
        assert sum(r[0] == name for r in log) == program_spans.CALLS * steps
        got_ms = program_spans.span_ms_per_step(log, name)
        assert got_ms is not None and got_ms > 0
    total = sum(program_spans.span_ms_per_step(log, n)
                for n in READERS.values() if n.startswith("lemo.step."))
    fit_ms = sum(r[2] - r[1] for r in fits) / 1e6 / (
        program_spans.CALLS * steps)
    assert total <= fit_ms <= 1e3 * sum(got["wall_s"]) / got["steps"]


def test_the_cpu_and_a_program_without_spans_read_nothing(monkeypatch):
    class Ctx:
        runner = _runner()

    assert program_spans.window_log(Ctx()) is None      # on the CPU

    from lemo_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "record_spans")
    assert program_spans.record(object()) is None      # no child started


@pytest.mark.cuda
def test_spans_add_no_device_operation(card, monkeypatch):
    """A profiled call of the cell's fitter with the program's spans on
    (a profiler runs) has the launches of one with them off, and its
    spans are on the host's row only."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from lemo_tpu_torch.utils import profiling
    from portbench.trace import profile_stretch

    runner = _runner("cuda")
    runner.setup()
    runner.prepare_profile()
    n = runner.profile_steps[0]
    on = profile_stretch(lambda: runner.profiled_call(n), n)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        runner.profiled_call(n)
    names = {(e.name, e.device_type == torch.autograd.DeviceType.CUDA)
             for e in prof.events() if e.name.startswith("lemo.")}
    with monkeypatch.context() as m:
        m.setattr(profiling, "_profiler_enabled", lambda: False)
        off = profile_stretch(lambda: runner.profiled_call(n), n)
    runner.release()
    assert on.launches() == off.launches() > 0
    assert not any(name.startswith("lemo.") for name, _, _ in on.ops)
    assert ("lemo.step.backward", False) in names
    assert not any(on_card for _, on_card in names)
