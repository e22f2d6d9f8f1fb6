"""The vertex backward (csrc/vertex.cu) against other builds of it, in one
process on one CUDA card.

    python3 scripts/bench_torch_vertex.py \
        [--baseline lemo_tpu_torch/_build/first_vertex.cu] \
        [--compare NAME=SOURCE.cu ...]

`--baseline` is the first design's source, whose `lemo_vertex_bwd` takes
per-64-vertex-tile partial slabs sized by `lemo_vertex_bwd_tiles`. Write
it from git into the git-ignored build directory before the run:

    git show 43d2516:lemo_tpu_torch/csrc/vertex.cu \
        > lemo_tpu_torch/_build/first_vertex.cu

Each `--compare` source defines the current interface
(`lemo_vertex_bwd` with `lemo_vertex_bwd_slices`), e.g. a variant of
csrc/vertex.cu. The script compiles csrc/vertex.cu, the baseline and each
compared source on its own with `nvcc -Xptxas -v` into lemo_tpu_torch/
_build/ (all at once) and prints every kernel's registers, shared memory
and spills. On phase 2's operands (`chip_smoke.body_operands`: the
full-size synthetic SMPL-X at B=100) it holds the port's backward
(`vertex_cuda.vertex_bwd_kernel`), each of its stages and every other
build against the plain version (rel 5e-5) and against a second launch of
itself (bit-identical; a compared build that fails is reported and not
timed, the port's kernel failing stops the script), then times in turns: the plain version, then for
each other build: it, the port's kernel, the port's kernel, it (CUDA
events, median of chip_smoke.REPS), and takes each build's device time
by kernel from a torch.profiler trace of 20 calls. Prints one line per
measurement and, last, one JSON object.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

BASELINE = os.path.join(ROOT, "lemo_tpu_torch", "_build", "first_vertex.cu")
TOL = 5e-5


def _kernel_name(mangled: str) -> str:
    """The readable kernel name in a mangled symbol (the length-prefixed
    identifier that ends in `_kernel`, with its problem type if any)."""
    for m in re.finditer(r"\d+", mangled):
        name = mangled[m.end():m.end() + int(m.group())]
        if name.endswith("_kernel"):
            prob = re.search(r"[A-Z][a-z0-9]*Problem", mangled)
            return name + (f"<{prob.group()}>" if prob else "")
    return mangled


def ptxas_summary(text: str) -> list[dict]:
    """Per kernel of an `nvcc -Xptxas -v` log: registers, static shared
    memory bytes, spill stores and loads."""
    rows, cur = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = {"kernel": _kernel_name(m.group(1)), "registers": None,
                   "smem": 0, "spill_stores": 0, "spill_loads": 0}
            rows.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(sm.group(1)) if sm else 0
    return rows


def build_all(sources: dict[str, str]) -> dict[str, tuple[str, list]]:
    """Compile every source into its own shared library, all at once;
    returns {name: (library path, ptxas summary)}."""
    from lemo_tpu_torch import _build

    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        out = os.path.join(_build.BUILD_DIR, f"libbench_vertex_{name}.so")
        procs[name] = (out, src, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas=-v", "-shared",
             src, "-o", out], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (out, src, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(log, flush=True)
            if name == "port":
                raise RuntimeError(f"nvcc failed on {src}")
            continue    # a compared build that does not build is left out
        summary = ptxas_summary(log)
        for row in summary:
            print(f"[ptxas {name}: {os.path.relpath(src, ROOT)}] "
                  f"{row['kernel']}: {row['registers']} registers, "
                  f"{row['smem']} B static smem, spills "
                  f"{row['spill_stores']}/{row['spill_loads']} B "
                  f"(stores/loads)", flush=True)
        built[name] = (out, summary)
    return built


def baseline_launcher(path: str, catT, A2, dirs, w, dout):
    """The first design's entry point on the port's operands; scratch and
    outputs are allocated at each launch, as the port's wrapper does."""
    import torch

    lib = ctypes.CDLL(path)
    lib.lemo_vertex_bwd.argtypes = [ctypes.c_void_p] * 9 + \
        [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.lemo_vertex_bwd.restype = ctypes.c_int
    lib.lemo_vertex_bwd_tiles.argtypes = [ctypes.c_int]
    lib.lemo_vertex_bwd_tiles.restype = ctypes.c_int
    D, Bp = catT.shape
    Jp, Vp = A2.shape[1], dirs.shape[1]
    tiles = lib.lemo_vertex_bwd_tiles(Vp)
    dev = catT.device

    def call():
        dcat = torch.empty((D, Bp), dtype=torch.float32, device=dev)
        da2 = torch.empty((12, Jp, Bp), dtype=torch.float32, device=dev)
        pd = torch.empty((tiles, D, Bp), dtype=torch.float32, device=dev)
        pa = torch.empty((tiles, 12, Jp, Bp), dtype=torch.float32,
                         device=dev)
        rc = lib.lemo_vertex_bwd(
            catT.data_ptr(), A2.data_ptr(), dirs.data_ptr(), w.data_ptr(),
            dout.data_ptr(), dcat.data_ptr(), da2.data_ptr(), pd.data_ptr(),
            pa.data_ptr(), D, Jp, Vp, Bp,
            torch.cuda.current_stream(dev).cuda_stream)
        if rc:
            raise RuntimeError(f"baseline launch failed: CUDA error {rc}")
        return dcat, da2

    return call


def current_launcher(path: str, catT, A2, dirs, w, dout):
    """Another build of the current entry point on the port's operands."""
    import torch

    from lemo_tpu_torch import _build

    lib = ctypes.CDLL(path)
    for fn in ("lemo_vertex_bwd", "lemo_vertex_bwd_slices"):
        getattr(lib, fn).argtypes = _build.SIGNATURES[fn]
        getattr(lib, fn).restype = ctypes.c_int
    D, Bp = catT.shape
    Jp, Vp = A2.shape[1], dirs.shape[1]
    slices = (ctypes.c_int * 2)()
    if lib.lemo_vertex_bwd_slices(D, Jp, Vp, Bp, slices):
        raise RuntimeError("compared build refuses the shapes")
    dev = catT.device

    def call():
        vs, dvs = (torch.empty((3, Vp, Bp), dtype=torch.float32, device=dev)
                   for _ in range(2))
        pd = torch.empty((slices[0], D, Bp), dtype=torch.float32, device=dev)
        pa = torch.empty((slices[1], 12, Jp, Bp), dtype=torch.float32,
                         device=dev)
        dcat = torch.empty((D, Bp), dtype=torch.float32, device=dev)
        da2 = torch.empty((12, Jp, Bp), dtype=torch.float32, device=dev)
        rc = lib.lemo_vertex_bwd(
            catT.data_ptr(), A2.data_ptr(), dirs.data_ptr(), w.data_ptr(),
            dout.data_ptr(), dcat.data_ptr(), da2.data_ptr(), vs.data_ptr(),
            dvs.data_ptr(), pd.data_ptr(), pa.data_ptr(), D, Jp, Vp, Bp,
            torch.cuda.current_stream(dev).cuda_stream)
        if rc:
            raise RuntimeError(f"compared launch failed: CUDA error {rc}")
        return dcat, da2

    return call


def _short(key: str) -> str:
    """A profiler kernel name, mangled or demangled, cut to its kernel
    and problem type."""
    if key.startswith("_Z"):
        return _kernel_name(key)
    m = re.search(r"(\w+_kernel)", key)
    prob = re.search(r"(\w+Problem)", key)
    return (m.group(1) if m else key) + (f"<{prob.group(1)}>" if prob
                                         else "")


def profile_kernels(fn, calls: int = 20) -> dict[str, float]:
    """Device ms per call of each kernel `fn` launches, from a
    torch.profiler trace of `calls` calls after a warm-up."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out: dict[str, float] = {}
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA"):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        name = _short(e.key)
        out[name] = out.get(name, 0.0) + us / 1e3 / calls
    return out


def check(name: str, fn, ref) -> dict:
    """Hold a backward's (dcat, dA2) against the plain version's, relative
    to each output's largest magnitude, and against a second launch."""
    import torch

    import chip_smoke as cs

    got, again = fn(), fn()
    torch.cuda.synchronize()
    rel = max(cs._max_rel(g, r) for g, r in zip(got, ref))
    repeat = all(torch.equal(a, b) for a, b in zip(got, again))
    print(f"[check] {name}: max rel err {rel:.3e} (tol {TOL:g}), repeat "
          f"launch bit-identical {repeat}", flush=True)
    ok = rel <= TOL and repeat
    if not ok and name == "port":
        raise AssertionError(f"{name}: disagrees with plain or itself")
    return {"max_rel_err": rel, "bit_identical_repeat": repeat, "ok": ok}


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", default=BASELINE,
                    help="the first design's source (lemo_vertex_bwd_tiles)")
    ap.add_argument("--compare", action="append", default=[],
                    help="NAME=SOURCE.cu, a build of the current interface")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_torch_vertex: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from lemo_tpu_torch import exact_f32_matmuls
    from lemo_tpu_torch.body_model import load_model
    from lemo_tpu_torch.body_model import vertex_cuda as vc

    exact_f32_matmuls()
    card = cs._card_line()
    print(card, flush=True)
    sources = {"port": os.path.join(ROOT, "lemo_tpu_torch", "csrc",
                                    "vertex.cu"),
               "first": a.baseline}
    for spec in a.compare:
        name, src = spec.split("=", 1)
        sources[name] = src
    built = build_all(sources)
    sources = {n: s for n, s in sources.items() if n in built}

    model = load_model(cs.smoke_model_dict(), use_pca=True, num_pca_comps=12,
                       device="cuda")
    ops = cs.body_operands(model)
    catT, A2, dirs, w = ops["vertex_fwd_kernel"]
    dout = ops["vertex_bwd_kernel"][4]
    print(f"[operands] catT {tuple(catT.shape)}, A2 {tuple(A2.shape)}, dirs "
          f"{tuple(dirs.shape)}, w {tuple(w.shape)}, dout "
          f"{tuple(dout.shape)}", flush=True)

    def port():
        return vc.vertex_bwd_kernel(catT, A2, dirs, w, dout)

    def plain():
        return vc.vertex_plain_bwd(catT, A2, dirs, w, dout)

    ref = plain()
    others = [("first", baseline_launcher(built["first"][0], catT, A2, dirs, w,
                                        dout))]
    others += [(name, current_launcher(built[name][0], catT, A2, dirs, w,
                                       dout)) for name in sources
               if name not in ("port", "first")]
    result = {"card": card, "slices": list(vc.bwd_slices(
        catT.shape[0], A2.shape[1], dirs.shape[1], catT.shape[1])),
        "ptxas": {n: s for n, (_, s) in built.items()},
        "check": {"port": check("port", port, ref)},
        "stages": cs.vertex_bwd_stages(catT, A2, dirs, w, dout, card, TOL),
        "ms": {"plain": cs._time_ms(plain), "port": []}}
    for name, fn in others:
        result["check"][name] = check(name, fn, ref)
    # a compared build that disagrees is reported, not timed
    others = [(n, fn) for n, fn in others if result["check"][n]["ok"]]
    print(f"[time] plain {result['ms']['plain']:.4f} ms on {card}",
          flush=True)
    for name, fn in others:
        turns = [cs._time_ms(fn), cs._time_ms(port), cs._time_ms(port),
                 cs._time_ms(fn)]
        result["ms"][name] = [turns[0], turns[3]]
        result["ms"]["port"].extend(turns[1:3])
        print(f"[time] {name} {turns[0]:.4f}, port {turns[1]:.4f}, port "
              f"{turns[2]:.4f}, {name} {turns[3]:.4f} ms (speed-up "
              f"{(turns[0] + turns[3]) / (turns[1] + turns[2]):.2f}x) on "
              f"{card}", flush=True)
    result["profile"] = {}
    for name, fn in [("port", port)] + others:
        prof = profile_kernels(fn)
        result["profile"][name] = prof
        print(f"[profile] {name}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in sorted(prof.items(),
                                              key=lambda kv: -kv[1]))
              + f" ms a call (sum {sum(prof.values()):.4f}) on {card}",
              flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
