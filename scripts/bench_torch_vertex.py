"""The vertex kernels (csrc/vertex.cu) against other builds of them, in one
process on one CUDA card.

    python3 scripts/bench_torch_vertex.py \
        [--baseline lemo_tpu_torch/_build/base_vertex.cu] \
        [--compare NAME=SOURCE.cu ...]

`--baseline` is the previous design's source (commit eff8b05): its forward
is one kernel with no blend scratch, bound by its own argument list, and
its backward has the current interface. Write it from git into the
git-ignored build directory before the run:

    git show eff8b05:lemo_tpu_torch/csrc/vertex.cu \
        > lemo_tpu_torch/_build/base_vertex.cu

Each `--compare` source defines the current interface (`lemo_vertex_fwd`
with its blend scratch, `lemo_vertex_bwd`, `lemo_vertex_bwd_from_vs` and
`lemo_vertex_bwd_slices`), e.g. a variant of csrc/vertex.cu; `--f2
NAME=PLANES,BLOCKS` compares csrc/vertex.cu with the forward's apply
kernel at another F2_PLANES and F2_MIN_BLOCKS (written into
lemo_tpu_torch/_build/). The script
compiles csrc/vertex.cu, the baseline and each compared source on its own
with `nvcc -Xptxas -v` into lemo_tpu_torch/_build/ (all at once) and
prints every kernel's registers, shared memory and spills. On phase 2's
operands (`chip_smoke.body_operands`: the full-size synthetic SMPL-X at
B=100, or `--frames B`) it holds every build's forward (1e-5 m abs) and backward (rel
5e-5) against the plain versions and against a second launch of itself
(bit-identical; a compared build that fails is reported and not timed,
the port failing stops the script), and each stage of the port's kernels
against its own plain version. Then it times in turns, for the forward,
the backward, and the forward then the backward (the port's backward
from its forward's kept blend; `recompute` is the port with the backward
forming the blend again, any other build as it comes): the plain version,
then for each other build: it, the port, the port, it (CUDA events,
median of chip_smoke.REPS); and takes each build's device time by kernel
from a torch.profiler trace of 20 calls (and cuBLAS's, for the blend
alone: the yardstick of the SGEMM tile). Prints one line per measurement
and, last, one JSON object.
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

BASELINE = os.path.join(ROOT, "lemo_tpu_torch", "_build", "base_vertex.cu")
TOL = 5e-5        # backward, relative to each output's largest magnitude
FWD_TOL = 1e-5    # forward, m


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


def build_all(sources: dict[str, str], prefix: str = "vertex",
              required: tuple = ("port",)) -> dict[str, tuple[str, list]]:
    """Compile every source into its own shared library
    (`libbench_<prefix>_<name>.so`), all at once; returns {name: (library
    path, ptxas summary)}. A build in `required` that fails raises; any
    other is left out."""
    from lemo_tpu_torch import _build

    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        out = os.path.join(_build.BUILD_DIR, f"libbench_{prefix}_{name}.so")
        procs[name] = (out, src, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas=-v", "-shared",
             src, "-o", out], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (out, src, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(log, flush=True)
            if name in required:
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


def f2_variant(src: str, name: str, planes: int, blocks: int) -> str:
    """`src` with the apply kernel's F2_PLANES and F2_MIN_BLOCKS replaced,
    written into the build directory; returns its path."""
    from lemo_tpu_torch import _build

    with open(src) as fh:
        text = fh.read()
    for const, value in (("F2_PLANES", planes), ("F2_MIN_BLOCKS", blocks)):
        text, n = re.subn(rf"constexpr int {const} = \d+;",
                          f"constexpr int {const} = {value};", text)
        if n != 1:
            raise ValueError(f"{src} does not define {const} once")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    path = os.path.join(_build.BUILD_DIR, f"bench_vertex_{name}.cu")
    with open(path, "w") as fh:
        fh.write(text)
    return path


def _bind(lib, fn: str, argtypes) -> None:
    getattr(lib, fn).argtypes = argtypes
    getattr(lib, fn).restype = ctypes.c_int


def build_ops(path: str, baseline: bool, catT, A2, dirs, w, dout) -> dict:
    """Another build's forward, backward, and forward then backward, on the
    port's operands; outputs and scratch are allocated at each launch, as
    the port's wrappers do. The baseline's forward takes no blend scratch
    (`lemo_vertex_fwd(cat, a2, dirs, w, out, D, Jp, Vp, Bp, stream)`), so
    its backward forms the blend again; any other build's backward takes
    the forward's."""
    import torch

    from lemo_tpu_torch import _build

    lib = ctypes.CDLL(path)
    for fn in ("lemo_vertex_bwd", "lemo_vertex_bwd_slices") + (
            () if baseline else ("lemo_vertex_fwd", "lemo_vertex_bwd_from_vs")):
        _bind(lib, fn, _build.SIGNATURES[fn])
    if baseline:
        _bind(lib, "lemo_vertex_fwd", [ctypes.c_void_p] * 5
              + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    D, Bp = catT.shape
    Jp, Vp = A2.shape[1], dirs.shape[1]
    slices = (ctypes.c_int * 2)()
    if lib.lemo_vertex_bwd_slices(D, Jp, Vp, Bp, slices):
        raise RuntimeError(f"{path} refuses the shapes")
    dev = catT.device

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    def stream():
        return torch.cuda.current_stream(dev).cuda_stream

    def done(rc, what):
        if rc:
            raise RuntimeError(f"{what} of {path} failed: CUDA error {rc}")

    def fwd(vs=None):
        out = empty(3, Vp, Bp)
        scratch = empty(3, Vp, Bp) if vs is None else vs
        ptrs = [catT.data_ptr(), A2.data_ptr(), dirs.data_ptr(), w.data_ptr()]
        if not baseline:
            ptrs.append(scratch.data_ptr())
        done(lib.lemo_vertex_fwd(*ptrs, out.data_ptr(), D, Jp, Vp, Bp,
                                 stream()), "forward")
        return out

    def bwd(vs=None):
        dcat, da2, dvs = empty(D, Bp), empty(12, Jp, Bp), empty(3, Vp, Bp)
        pd, pa = empty(slices[0], D, Bp), empty(slices[1], 12, Jp, Bp)
        scratch = empty(3, Vp, Bp) if vs is None else vs
        tail = (dcat.data_ptr(), da2.data_ptr(), scratch.data_ptr(),
                dvs.data_ptr(), pd.data_ptr(), pa.data_ptr(), D, Jp, Vp, Bp,
                stream())
        if vs is None:
            rc = lib.lemo_vertex_bwd(catT.data_ptr(), A2.data_ptr(),
                                     dirs.data_ptr(), w.data_ptr(),
                                     dout.data_ptr(), *tail)
        else:
            rc = lib.lemo_vertex_bwd_from_vs(A2.data_ptr(), dirs.data_ptr(),
                                             w.data_ptr(), dout.data_ptr(),
                                             *tail)
        done(rc, "backward")
        return dcat, da2

    def fwd_bwd():
        if baseline:
            return fwd(), bwd()
        vs = empty(3, Vp, Bp)
        return fwd(vs), bwd(vs)

    return {"fwd": fwd, "bwd": bwd, "fwd_bwd": fwd_bwd}


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


def check(name: str, ops: dict, ref_out, ref_grads) -> dict:
    """Hold a build's forward (abs, m) and backward (rel to each output's
    largest magnitude) against the plain versions, and each against a
    second launch of itself."""
    import torch

    import chip_smoke as cs

    out, again = ops["fwd"](), ops["fwd"]()
    grads, grads_again = ops["bwd"](), ops["bwd"]()
    torch.cuda.synchronize()
    res = {"fwd_max_abs_err": float((out - ref_out).abs().max()),
           "bwd_max_rel_err": max(cs._max_rel(g, r)
                                  for g, r in zip(grads, ref_grads)),
           "bit_identical_repeat": torch.equal(out, again) and all(
               torch.equal(a, b) for a, b in zip(grads, grads_again))}
    res["ok"] = (res["fwd_max_abs_err"] <= FWD_TOL
                 and res["bwd_max_rel_err"] <= TOL
                 and res["bit_identical_repeat"])
    print(f"[check] {name}: forward max abs err {res['fwd_max_abs_err']:.3e}"
          f" (tol {FWD_TOL:g}), backward max rel err "
          f"{res['bwd_max_rel_err']:.3e} (tol {TOL:g}), repeat launches "
          f"bit-identical {res['bit_identical_repeat']}", flush=True)
    if not res["ok"] and name == "port":
        raise AssertionError(f"{name}: disagrees with plain or itself")
    return res


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", default=BASELINE,
                    help="the previous design's source (a forward without "
                         "blend scratch)")
    ap.add_argument("--compare", action="append", default=[],
                    help="NAME=SOURCE.cu, a build of the current interface")
    ap.add_argument("--f2", action="append", default=[],
                    help="NAME=PLANES,BLOCKS: csrc/vertex.cu with F2_PLANES "
                         "and F2_MIN_BLOCKS set so")
    ap.add_argument("--frames", type=int, default=None,
                    help="the operands' frame count B (default phase 2's)")
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
               "base": a.baseline}
    for spec in a.compare:
        name, src = spec.split("=", 1)
        sources[name] = src
    for spec in a.f2:
        name, values = spec.split("=", 1)
        sources[name] = f2_variant(sources["port"], name,
                                   *map(int, values.split(",")))
    built = build_all(sources)

    model = load_model(cs.smoke_model_dict(), use_pca=True, num_pca_comps=12,
                       device="cuda")
    ops = cs.body_operands(model, frames=a.frames or cs.T_FRAMES)
    catT, A2, dirs, w = ops["vertex_fwd_kernel"][:4]
    dout = ops["vertex_bwd_kernel"][4]
    print(f"[operands] catT {tuple(catT.shape)}, A2 {tuple(A2.shape)}, dirs "
          f"{tuple(dirs.shape)}, w {tuple(w.shape)}, dout "
          f"{tuple(dout.shape)}", flush=True)

    def port_fwd_bwd(keep_vs=True):
        vs = torch.empty_like(dout) if keep_vs else None
        return (vc.vertex_fwd_kernel(catT, A2, dirs, w, vs),
                vc.vertex_bwd_kernel(catT, A2, dirs, w, dout, vs))

    builds = {"port": {
        "fwd": lambda: vc.vertex_fwd_kernel(catT, A2, dirs, w),
        "bwd": lambda: vc.vertex_bwd_kernel(catT, A2, dirs, w, dout),
        "fwd_bwd": port_fwd_bwd}}
    for name, (path, _) in built.items():
        if name != "port":
            builds[name] = build_ops(path, name == "base", catT, A2, dirs, w,
                                     dout)
    # the port with its backward forming the blend again (lever c off)
    builds["recompute"] = {"fwd_bwd": lambda: port_fwd_bwd(False)}
    plain = {"fwd": lambda: vc.vertex_plain_fwd(catT, A2, dirs, w),
             "bwd": lambda: vc.vertex_plain_bwd(catT, A2, dirs, w, dout)}
    ref_out, ref_grads = plain["fwd"](), plain["bwd"]()
    result = {"card": card, "slices": list(vc.bwd_slices(
        catT.shape[0], A2.shape[1], dirs.shape[1], catT.shape[1])),
        "ptxas": {n: s for n, (_, s) in built.items()},
        "check": {},
        "stages": {"fwd": cs.vertex_fwd_stages(catT, A2, dirs, w, card,
                                               FWD_TOL),
                   "bwd": cs.vertex_bwd_stages(catT, A2, dirs, w, dout,
                                               card, TOL)},
        "ms": {kind: {"port": []} for kind in ("fwd", "bwd", "fwd_bwd")},
        "profile": {}}
    for name, b in builds.items():
        if "fwd" in b:
            result["check"][name] = check(name, b, ref_out, ref_grads)
    # a compared build that disagrees is reported, not timed
    others = [n for n in builds if n != "port"
              and result["check"].get(n, {"ok": True})["ok"]]
    for kind in ("fwd", "bwd"):
        result["ms"][kind]["plain"] = cs._time_ms(plain[kind])
        print(f"[time] {kind} plain {result['ms'][kind]['plain']:.4f} ms on "
              f"{card}", flush=True)
    for kind in ("fwd", "bwd", "fwd_bwd"):
        port = builds["port"][kind]
        for name in others:
            if kind not in builds[name]:
                continue
            fn = builds[name][kind]
            turns = [cs._time_ms(fn), cs._time_ms(port), cs._time_ms(port),
                     cs._time_ms(fn)]
            result["ms"][kind][name] = [turns[0], turns[3]]
            result["ms"][kind]["port"].extend(turns[1:3])
            print(f"[time] {kind}: {name} {turns[0]:.4f}, port "
                  f"{turns[1]:.4f}, port {turns[2]:.4f}, {name} "
                  f"{turns[3]:.4f} ms (speed-up "
                  f"{(turns[0] + turns[3]) / (turns[1] + turns[2]):.2f}x) on "
                  f"{card}", flush=True)
    result["profile"]["blend_cublas"] = profile_kernels(
        lambda: vc.vertex_plain_blend(catT, dirs))
    print(f"[profile] blend cuBLAS (torch.matmul, TF32 off): " + ", ".join(
        f"{k[:60]} {v:.4f}" for k, v in
        result["profile"]["blend_cublas"].items()) + f" ms a call on {card}",
          flush=True)
    for kind in ("fwd", "bwd", "fwd_bwd"):
        result["profile"][kind] = {}
        for name in ["port"] + others:
            if kind not in builds[name]:
                continue
            prof = profile_kernels(builds[name][kind])
            result["profile"][kind][name] = prof
            print(f"[profile] {kind} {name}: " + ", ".join(
                f"{k} {v:.4f}" for k, v in sorted(prof.items(),
                                                  key=lambda kv: -kv[1]))
                  + f" ms a call (sum {sum(prof.values()):.4f}) on {card}",
                  flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
