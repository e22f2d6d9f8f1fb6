"""The program's host time by span, for the `program_span` readers.

The program opens spans named `lemo.*` at its layer boundaries
(`lemo_tpu_torch.utils.profiling.annotate`: `lemo.fit` with its `steps`,
and a step's `lemo.step.forward`, `.backward`, `.update` and the loss
terms' `lemo.term.*`) and records them into an in-memory log inside
`record_spans()`. The harness's timed window runs outside such a log, so
a traced run's readers take their own unprofiled stretch: a child
process (`python3 -m portbench.program_spans`, the job on its standard
input) sets the cell up afresh from the run's configuration, cell and
seed, runs `CALLS` timed calls inside `record_spans()` and prints the
log as JSON. The child has never run the profiler that the traced run's
process has run, as the `--trace 0` run has not, and the run's own
runner is left as its check left it, for the readers after these.
`window_log` prints the stretch's ms a step beside the timed window's on
standard error. The log is read once per run and shared by the readers.

A reader reads nothing (None) where the program records no spans (it has
no `record_spans`) or the cell runs on the CPU, where the host computes
the step itself and a span is no dispatch time.

This is a stand-in: once `run.py` records the timed window itself and
hands its log to the readers, `record`, `window_log` and `main` go."""

from __future__ import annotations

import importlib
import json
import os
import subprocess
import sys
import time
import weakref

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# timed calls in the span stretch: 200 steps of the 100-step call
CALLS = 2
# the child's set-up (its warm-up call included) and calls, in seconds
CHILD_TIMEOUT_S = 900

_LOGS: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def stretch(job: dict) -> dict:
    """Set up `job`'s cell afresh and run `CALLS` timed calls inside
    `record_spans()`: {"log": rows (name, start_ns, end_ns, parent,
    counts), "wall_s": each call's seconds, "steps": the calls' steps}.
    """
    import torch

    from lemo_tpu_torch.utils.profiling import record_spans

    mod = importlib.import_module(job["runner"])
    runner = mod.Runner(job["config"], job["cell"], job["seed"],
                        job["device"])
    runner.setup()
    walls = []
    with record_spans() as rows:
        for k in range(CALLS):
            t0 = time.perf_counter()
            runner.call(k)
            if runner.dev.type == "cuda":
                torch.cuda.synchronize(runner.dev)
            walls.append(time.perf_counter() - t0)
    runner.release()
    return {"log": [list(r) for r in rows], "wall_s": walls,
            "steps": CALLS * runner.steps_per_call}


def record(runner) -> dict | None:
    """`stretch` of `runner`'s cell in a child process, or None where the
    program has no `record_spans` or the child fails (its standard error's
    end is logged)."""
    try:
        from lemo_tpu_torch.utils.profiling import record_spans  # noqa: F401
    except ImportError:
        return None
    job = {"runner": type(runner).__module__, "config": runner.cfg,
           "cell": runner.cell, "seed": runner.seed,
           "device": str(runner.dev)}
    out = subprocess.run([sys.executable, "-m", "portbench.program_spans"],
                         input=json.dumps(job), capture_output=True,
                         text=True, cwd=ROOT, timeout=CHILD_TIMEOUT_S)
    if out.returncode != 0:
        log(f"program_spans: the span stretch failed ({out.returncode}): "
            f"{out.stderr[-2000:]}")
        return None
    return json.loads(out.stdout.strip().splitlines()[-1])


def window_log(ctx):
    """The span log of the run `ctx` reads (`record`, once a run), None on
    the CPU."""
    runner = ctx.runner
    if runner.dev.type != "cuda":
        return None
    if runner not in _LOGS:
        got = record(runner)
        _LOGS[runner] = got and got["log"]
        if got:
            ms = 1e3 * sum(got["wall_s"]) / got["steps"]
            log(f"program_spans: stretch {ms!r} ms a step (unprofiled "
                f"child, spans recorded), timed window "
                f"{1e3 * ctx.wall_s_per_step!r} ms a step")
    return _LOGS[runner]


def span_ms_per_step(rows, name: str) -> float | None:
    """Host ms a step in the span `name`: its rows' summed duration over
    the steps that the log's `lemo.fit` rows counted; None where the log
    is missing or holds no such span or step."""
    if not rows:
        return None
    ns = sum(e - s for n, s, e, _, _ in rows if n == name and e is not None)
    steps = sum(c.get("steps", 0) for n, _, _, _, c in rows
                if n == "lemo.fit")
    if ns <= 0 or steps <= 0:
        return None
    return ns / 1e6 / steps


def read(ctx, name: str) -> float | None:
    """`span_ms_per_step` of span `name` over the run's span stretch."""
    return span_ms_per_step(window_log(ctx), name)


def main() -> int:
    print(json.dumps(stretch(json.load(sys.stdin))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
