"""Run one cell of `BENCHMARK.json` once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout, on a machine with the CUDA cards the cell
asks for. The run

1. names the card and its power limit on standard error;
2. sets up the cell (`runners/<config>.py`: inputs and weights from the
   seed on the card, the program's fitter, one warm-up call of the timed
   shapes): `setup_s`, from the process's start;
3. with `--trace 1`, profiles two short calls of the same fitter factory
   (n1 < n2 steps) and reads them as one step of the timed call (the
   per-layer metrics' device numbers, `trace.PerStep`);
4. runs whole timed calls, one after another, until `--seconds` have
   passed, and ends at that call's boundary: `frame_iters_per_s` is all
   the frames times steps over all the window's time;
5. reads the peak device memory, frees the program's state, and checks
   a seeded sample of the window's outputs against the plain reference
   (`correct`);
6. fails if a banned module was loaded (`guard.py`), and prints each
   compared number beside its limit as the last lines of standard error
   and one JSON object as the last line of standard output.

Exit codes: 0 a result was printed (correct or not), 2 no card or fewer
cards than the cell asks for, 3 a banned module was loaded, 4 the
benchmark's files are missing.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_cell(name: str, root: str = ROOT) -> tuple[dict, dict, dict, dict]:
    """(BENCHMARK.json, its workload entry, the cell's file, the
    configuration's file), found by the cell's name."""
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    with open(os.path.join(HERE, "workloads", f"{name}.json")) as fh:
        cell = json.load(fh)
    with open(os.path.join(root, conf["file"])) as fh:
        config = json.load(fh)
    if cell["config"] != entry["config"]:
        raise ValueError(f"{name}: the cell's file names config "
                         f"{cell['config']!r}, BENCHMARK.json "
                         f"{entry['config']!r}")
    return bench, entry, cell, config


def cell_metrics(bench: dict, name: str, kind: str) -> list[dict]:
    """The cell's end-to-end or per-layer metric entries."""
    return [m for m in bench[kind]
            if "workloads" not in m or name in m["workloads"]]


def card_line() -> str:
    """`name, power limit` of the card, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unreadable ({e!r})"


@dataclasses.dataclass
class Context:
    """What a per-layer reader gets (`metrics/<name>.py:read(ctx)`)."""

    per_step: object              # trace.PerStep of the profiled calls
    wall_s_per_step: float        # unprofiled, from the timed window
    peak_bytes: int
    runner: object


def read_per_layer(bench: dict, name: str, ctx: Context) -> dict:
    out = {}
    for m in cell_metrics(bench, name, "per_layer"):
        mod = importlib.import_module(f"portbench.metrics.{m['name']}")
        value = mod.read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", root: str = ROOT,
             overrides: dict | None = None) -> tuple[dict, dict]:
    """Set up, (profile,) time and check one cell. Returns (the result
    line's object without `correct`'s verdict keys, {number: (value,
    limit)}). `overrides` replaces entries of the cell's and the
    configuration's files (the CPU tests' small sizes)."""
    import torch

    bench, entry, cell, config = load_cell(name, root)
    for k, v in (overrides or {}).items():
        (cell if k in cell else config)[k] = v
    runner_mod = importlib.import_module(
        f"portbench.runners.{entry['config']}")
    dev = torch.device(device)
    runner = runner_mod.Runner(config, cell, seed, dev)
    runner.setup()
    setup_s = time.perf_counter() - T_START

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    per_step = None
    if trace:
        from portbench.trace import PerStep, profile_stretch

        runner.prepare_profile()
        stretches = []
        for n in runner.profile_steps:
            before = runner.launch_counters()
            t = profile_stretch(lambda: runner.profiled_call(n), n)
            after = runner.launch_counters()
            t.counters = {k: after[k] - before.get(k, 0) for k in after}
            stretches.append(t)
        per_step = PerStep(*stretches, steps=runner.steps_per_call)

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    sync()
    t0 = time.perf_counter()
    ends = []
    while True:
        runner.call(len(ends))
        sync()
        ends.append(time.perf_counter() - t0)
        if ends[-1] >= seconds:
            break
    window_s = ends[-1]
    calls = len(ends)
    peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" \
        else 0
    attempted, failed = runner.attempted_failed()
    steps = calls * runner.steps_per_call

    runner.release()
    numbers = runner.check()
    limits = cell["limits"]
    checks = {k: (numbers[k], float(limits[k])) for k in limits}

    result = {"attempted": attempted, "failed": failed, "metrics": {},
              "call_s": [b - a for a, b in zip([0.0] + ends, ends)]}
    if trace:
        ctx = Context(per_step=per_step, wall_s_per_step=window_s / steps,
                      peak_bytes=peak, runner=runner)
        result["metrics"] = read_per_layer(bench, name, ctx)
    else:
        values = {"frame_iters_per_s":
                  runner.frames_per_step * steps / window_s,
                  "setup_s": setup_s}
        for m in cell_metrics(bench, name, "end_to_end"):
            result["metrics"][m["name"]] = {"value": values[m["name"]],
                                            "unit": m["unit"]}
    result["device"] = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda"
        else "cpu",
        "count": 1, "memory_peak_bytes": peak}
    if trace:
        from portbench.trace import breakdown

        result["device"]["busy_s"] = sum(
            t.busy_us for t in per_step.traces) / 1e6
        result["device"]["window_s"] = sum(
            t.wall_us for t in per_step.traces) / 1e6
        result["breakdown"] = breakdown(per_step.traces)
    return result, checks


def verdict(result: dict, checks: dict) -> dict:
    """The result line: `correct` when every compared number is finite and
    within its limit and no fit failed; the numbers with their limits
    last."""
    ok = result["failed"] == 0 and all(
        v == v and v <= lim for v, lim in checks.values())
    line = {"correct": bool(ok), **result}
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in checks.items()}
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(ROOT, "lemo_tpu_torch")):
        log("portbench: the program (lemo_tpu_torch/) is not in this "
            "checkout")
        return 4
    import torch

    bench, entry, _, _ = load_cell(a.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(entry["chips"]):
        log(f"portbench: {a.workload} needs {entry['chips']} CUDA card(s); "
            f"available: {torch.cuda.device_count()}")
        return 2
    log(f"portbench: {a.workload} seed {a.seed} on {card_line()}")
    result, checks = run_cell(a.workload, a.seed, a.seconds, bool(a.trace))
    from portbench.guard import banned_loaded

    banned = banned_loaded()
    if banned:
        log(f"portbench: banned modules loaded: {', '.join(banned)}")
        return 3
    line = verdict(result, checks)
    for k, c in line["checks"].items():
        log(f"check {k} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
