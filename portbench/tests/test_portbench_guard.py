"""The import guard: whole top-level names, the run's check, the
reference's independence from the program, and the harness's refusal to
run without a card or without the program."""

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import guard

PB = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PB)


@pytest.mark.parametrize("mods,banned", [
    ({"lemo_tpu_torch": 1, "lemo_tpu_torch.fitting": 1, "torch": 1}, []),
    ({"lemo_tpu": 1}, ["lemo_tpu"]),
    ({"lemo_tpu.fitting.adam": 1, "jaxlib.xla": 1}, ["jaxlib", "lemo_tpu"]),
    ({"jax_like": 1, "flaxen": 1}, []),
    ({"flax.linen": 1, "jax": 1}, ["flax", "jax"])])
def test_names_are_compared_whole(mods, banned):
    assert guard.banned_loaded(mods) == banned


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _py_files(d):
    for dirpath, _, files in os.walk(d):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in _py_files(PB):
        for name in _imports(path):
            assert name.split(".")[0] not in guard.BANNED, (path, name)


def test_the_reference_imports_nothing_of_the_program():
    for path in _py_files(os.path.join(PB, "reference")):
        for name in _imports(path):
            top = name.split(".")[0]
            assert top != guard.PROGRAM, (path, name)
            if top == "portbench":
                assert name.startswith("portbench.reference"), (path, name)
    code = ("import sys; import portbench.reference.smplx, "
            "portbench.reference.amass_stage2; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    loaded = set(json.loads(out.stdout.replace("'", '"')))
    assert not loaded & set(guard.BANNED + (guard.PROGRAM,))


def test_a_run_loads_nothing_banned_up_to_its_check():
    """A run's set-up, window and check at tiny sizes on the CPU, then the
    guard, in a fresh process (the run's own check is after this)."""
    code = (
        "import json, sys\n"
        "from portbench import run, guard\n"
        "from portbench.tests.conftest import AMASS_SMALL\n"
        "run.run_cell('amass_s2.c16', 9, 0.0, False, device='cpu', "
        "overrides=AMASS_SMALL)\n"
        "print(json.dumps(guard.banned_loaded()))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_without_a_card_the_run_fails_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: this test is of a machine without")
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", "amass_s2.c16",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 2
    assert out.stdout == ""


def test_without_the_program_the_run_fails_and_prints_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(PB, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", "amass_s2.c16",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
        capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout == ""
