"""The intersection kernel (csrc/intersection.cu) against other builds of
the same C entry point, in one process on one CUDA card.

    python3 scripts/bench_torch_intersection.py \
        --operands lemo_tpu_torch/_build/prox_smoke/isect_operands.pt \
        --compare NAME=SOURCE.cu:RUN [--compare ...]

`--operands` is the file chip_smoke.py phase 7 saves: the
self-intersection calls of its run (the [100, K] candidate subsets of
each PROX window and all faces of 4 frames). Each `--compare` source
defines `lemo_cone_energy` with the signature of csrc/intersection.cu and
culls with the bounding spheres of RUN-face runs (128 for the kernel's
first design, `git show bd366c5:lemo_tpu_torch/csrc/intersection.cu`,
written into a git-ignored file). The script builds the port's library
and each compared source with `nvcc -Xptxas -v` into lemo_tpu_torch/
_build/ (printing the registers, shared memory and spills of every
build), then, for each operand set:

- holds the port's kernel and every compared build against the plain
  version and against a second launch of itself, with phase 7's check
  (`chip_smoke.check_cone_energy`);
- times, in turns, plain, then for each compared build: it, the port's
  kernel, the port's kernel, it (CUDA events, median of chip_smoke.REPS;
  the plain version 3 reps).

Prints one line per measurement and, last, one JSON object.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _build_compared(name: str, src: str) -> ctypes.CDLL:
    from lemo_tpu_torch import _build

    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    out = os.path.join(_build.BUILD_DIR, f"libcompare_{name}.so")
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas=-v",
                           "-shared", src, "-o", out], capture_output=True,
                          text=True)
    print(f"[nvcc {name}: {os.path.relpath(src, ROOT)}]\n{proc.stdout}"
          f"{proc.stderr}", flush=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {src}")
    lib = ctypes.CDLL(out)
    lib.lemo_cone_energy.argtypes = _build.SIGNATURES["lemo_cone_energy"]
    lib.lemo_cone_energy.restype = ctypes.c_int
    return lib


def _launcher(lib, run: int, pack, ipack, ign):
    """A build's entry point bound to the port's operands: the run spheres
    are made at `run` faces once, outside the timed launches; the outputs
    are allocated at each launch, as the port's wrapper does."""
    import torch

    from lemo_tpu_torch.ops import intersection as ti

    T, Kp = pack.shape[:2]
    spheres = ti.tile_spheres(pack, run)
    P = 0 if ign is None else ign.shape[0]
    ign8 = None if ign is None else ign.to(torch.uint8).contiguous()
    dev = pack.device

    def call():
        e = torch.empty((T, Kp), dtype=torch.float64, device=dev)
        rowgrad = torch.empty((T, Kp, 4), dtype=torch.float32, device=dev)
        dtri = torch.empty((T, Kp, 9), dtype=torch.float32, device=dev)
        active = torch.empty((T, Kp), dtype=torch.int32, device=dev)
        rc = lib.lemo_cone_energy(
            pack.data_ptr(), ipack.data_ptr(), spheres.data_ptr(),
            None if ign8 is None else ign8.data_ptr(), P, e.data_ptr(),
            rowgrad.data_ptr(), dtri.data_ptr(), active.data_ptr(), T, Kp,
            int(ipack.shape[0] == T and T > 1),
            torch.cuda.current_stream(dev).cuda_stream)
        if rc:
            raise RuntimeError(f"launch failed: CUDA error {rc}")
        return e, rowgrad, dtri, active

    return call


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--operands", required=True)
    ap.add_argument("--compare", action="append", default=[],
                    help="NAME=SOURCE.cu:RUN, a build to time against")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_torch_intersection: CUDA is not available",
              file=sys.stderr)
        return 1
    import chip_smoke as cs
    from lemo_tpu_torch import _build
    from lemo_tpu_torch.ops import intersection as ti
    from lemo_tpu_torch.ops import intersection_cuda as ic

    card = cs._card_line()
    print(card, flush=True)
    _build.build_library(verbose=True)
    compared = []
    for spec in a.compare:
        name, rest = spec.split("=", 1)
        src, run = rest.rsplit(":", 1)
        compared.append((name, _build_compared(name, src), int(run)))
    result = {"card": card, "shapes": []}
    saved = torch.load(a.operands, weights_only=False)
    for name, (v, faces, kw) in saved.items():
        ops = ti.kernel_operands(v.cuda(), faces, **{
            k: (x.cuda() if torch.is_tensor(x) else x) for k, x in kw.items()})
        T, Kp = ops[0].shape[:2]
        ref = ti.cone_energy_plain(*ops)
        row = {"name": name, "T": T, "Kp": Kp, "ms": {"kernel": []}}
        row["check"] = cs.check_cone_energy(
            f"{name} kernel", ic.cone_energy_kernel(*ops),
            ic.cone_energy_kernel(*ops), ref)
        builds = [(cname, _launcher(lib, run, ops[0], ops[1], ops[3]))
                  for cname, lib, run in compared]
        for cname, fn in builds:
            row[f"check_{cname}"] = cs.check_cone_energy(
                f"{name} {cname}", fn(), fn(), ref)
        row["ms"]["plain"] = cs._time_ms(lambda: ti.cone_energy_plain(*ops),
                                         3)
        for cname, fn in builds:
            turns = [cs._time_ms(fn),
                     cs._time_ms(lambda: ic.cone_energy_kernel(*ops)),
                     cs._time_ms(lambda: ic.cone_energy_kernel(*ops)),
                     cs._time_ms(fn)]
            row["ms"][cname] = [turns[0], turns[3]]
            row["ms"]["kernel"].extend(turns[1:3])
            print(f"[time] {name} [{T}, {Kp}]: plain "
                  f"{row['ms']['plain']:.3f} ms; {cname} {turns[0]:.4f}, "
                  f"kernel {turns[1]:.4f}, kernel {turns[2]:.4f}, {cname} "
                  f"{turns[3]:.4f} ms (speed-up "
                  f"{(turns[0] + turns[3]) / (turns[1] + turns[2]):.2f}x) "
                  f"on {card}", flush=True)
        result["shapes"].append(row)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
