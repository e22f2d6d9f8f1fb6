"""The readings a cell's limits are set from, on the card, in one process:

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--faults 1,2,3] [--clips N] [--look] \
        [--out FILE]

For each seed: the cell's set-up, as many timed calls as one run's check
samples from, the program's state freed, and the compared numbers of the
program against the plain reference (the lower readings). For each
control seed also the control: the reference computed in the precision
below the configuration's (TF32 for float32 with TF32 off) put in the
program's place, against the float32 reference (the upper readings). For
each fault seed, the faults a run can have (the runner's `FAULTS`), planted in the
program. `--clips` samples that many clips a seed where a run samples the
cell's `check_clips` (a wider look at the tail of the per-clip numbers);
`--look` adds, per clip, where the numbers come from (the runner's
`look`). Prints one JSON line a seed and a summary; `--out` keeps them.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from portbench import run as prun


def readings(name: str, seed: int, control: bool, faults: bool,
             device: str = "cuda", overrides: dict | None = None,
             look: bool = False) -> dict:
    """One seed's compared numbers: {'program': {...}, 'control': {...}
    (with `control`), 'faults': {fault: {...}} (with `faults`), 'look':
    {'program': ..., 'control': ...} (with `look`)}."""
    import importlib

    import torch

    _, entry, cell, config = prun.load_cell(name)
    for k, v in (overrides or {}).items():
        (cell if k in cell else config)[k] = v
    mod = importlib.import_module(f"portbench.runners.{entry['config']}")
    runner = mod.Runner(config, cell, seed, torch.device(device))
    t0 = time.perf_counter()
    runner.setup()
    out: dict = {"seed": seed, "setup_s": time.perf_counter() - t0}
    k = 0
    while sum(int(r[0].numel()) for r in runner.records) < \
            int(cell["check_clips"]):
        runner.call(k)
        k += 1
    ids, x72, losses = runner.sample()
    if faults:
        out["faults"] = {f: runner.fault_fit(f, ids) for f in mod.FAULTS}
    runner.release()
    x_ref, l_ref = runner.reference_fit(ids)
    out["program"] = runner.numbers(ids, x72, losses, x_ref, l_ref)
    if look:
        out["look"] = {"program": runner.look(ids, x72, losses, x_ref,
                                              l_ref)}
    if control:
        x_c, l_c = runner.reference_fit(ids, tf32=True)
        out["control"] = runner.numbers(ids, x_c, l_c, x_ref, l_ref)
        if look:
            out["look"]["control"] = runner.look(ids, x_c, l_c, x_ref,
                                                 l_ref)
    if faults:
        out["faults"] = {f: runner.numbers(ids, x, l, x_ref, l_ref)
                         for f, (x, l) in out["faults"].items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--clips", type=int, default=None)
    ap.add_argument("--look", action="store_true")
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        prun.log("calibrate: no CUDA card")
        return 2
    prun.log(f"calibrate: {a.workload} on {prun.card_line()}")
    ctl = {int(s) for s in a.control_seeds.split(",") if s}
    flt = {int(s) for s in a.faults.split(",") if s}
    rows = []
    for s in [int(s) for s in a.seeds.split(",") if s]:
        row = readings(a.workload, s, s in ctl, s in flt, look=a.look,
                       overrides=None if a.clips is None
                       else {"check_clips": a.clips})
        rows.append(row)
        print(json.dumps({k: v for k, v in row.items() if k != "look"}),
              flush=True)
    summary = {"program_max": {}, "control_min": {}}
    for kind, pick, dst in (("program", max, "program_max"),
                            ("control", min, "control_min")):
        got = [r[kind] for r in rows if kind in r]
        if got:
            summary[dst] = {k: pick(g[k] for g in got) for k in got[0]}
    print(json.dumps(summary), flush=True)
    if a.out:
        os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
        with open(a.out, "w") as fh:
            json.dump({"card": prun.card_line(), "rows": rows,
                       "summary": summary}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
