"""On the card (marked `cuda`; each skips without one): a run of the cell
is correct, and the control, the plain reference in TF32 put in the
program's place, is not. At the cell's own size, one seed each; the
limits' readings over a dozen seeds come from `portbench.calibrate`."""

import json
import os
import subprocess
import sys

import pytest

from portbench import calibrate, run

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@pytest.mark.cuda
def test_a_run_on_the_card_is_correct(card):
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", "amass_s2.c16",
         "--seed", str(2**31 + 99), "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert set(line["metrics"]) == {"frame_iters_per_s", "setup_s"}
    assert "power" in out.stderr.lower() or " W" in out.stderr


@pytest.mark.cuda
def test_the_control_fails_a_limit(card):
    _, _, cell, _ = run.load_cell("amass_s2.c16")
    got = calibrate.readings("amass_s2.c16", 2**31 + 7, control=True,
                             faults=False)
    lim = cell["limits"]
    assert all(got["program"][k] <= lim[k] for k in lim), got
    assert any(got["control"][k] > lim[k] for k in lim), got
