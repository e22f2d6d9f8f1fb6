"""The chain kernels (csrc/chain.cu) against the first design's build and
an empty kernel, in one process on one CUDA card.

    python3 scripts/bench_torch_chain.py \
        [--baseline lemo_tpu_torch/_build/base_chain.cu] \
        [--frames NAME=F ...] [--sass DIR]

`--baseline` is the first design's source (commit 601538a: one thread
walks one frame's tree), whose entry points take the parents array and
global scratch for the backward, bound here by their own argument lists.
Write it from git into the git-ignored build directory before the run:

    git show 601538a:lemo_tpu_torch/csrc/chain.cu \
        > lemo_tpu_torch/_build/base_chain.cu

`--frames NAME=F` adds csrc/chain.cu with kFrames = F (frames a block)
as another build; `--sass DIR` writes each build's `cuobjdump -sass` and
the baseline's PTX into DIR.

The script compiles csrc/chain.cu, the baseline, each variant and an
empty kernel (the launch floor: one launch of no work, on one 32-thread
block and on the port's grid of 32 blocks of 480 threads) each on its own
with `nvcc -Xptxas -v` into lemo_tpu_torch/_build/ (all at once), and
prints every kernel's registers, shared memory and spills. On phase 2's
operands (`chip_smoke.body_operands`: the full-size synthetic SMPL-X at
B=100, padded to 128 frames) it holds every build's forward (1e-5 m abs)
and backward (rel 5e-5) against the plain twins, against a second launch
of itself (bit-identical), and against the baseline (largest difference
of any output; 0 when the bits agree), and the affine entry points
against the chain pair with eager ops around it (the same bits forward).
Then it times, with CUDA events (median of chip_smoke.REPS): the plain
twins; each other build against the port in turns (it, port, port, it);
the affine forward and backward against that eager composition in turns;
and the empty kernel. Last, each of those by device time from a
torch.profiler trace of 20 calls, with its launches a call. Prints one
line per measurement and, last, one JSON object.
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
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

BASELINE = os.path.join(ROOT, "lemo_tpu_torch", "_build", "base_chain.cu")
TOL = 5e-5        # backward, relative to each output's largest magnitude
FWD_TOL = 1e-5    # forward, m
EMPTY_SOURCE = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int lemo_empty(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
"""
# the port's grid at Bp = 128: 32 blocks of 480 threads
EMPTY_GRIDS = {"empty_1x32": (1, 32), "empty_32x480": (32, 480)}


def frames_variant(src: str, name: str, frames: int) -> str:
    """`src` with kFrames replaced, written into the build directory;
    returns its path."""
    from lemo_tpu_torch import _build

    with open(src) as fh:
        text = fh.read()
    text, n = re.subn(r"constexpr int kFrames = \d+;",
                      f"constexpr int kFrames = {frames};", text)
    if n != 1:
        raise ValueError(f"{src} does not define kFrames once")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    path = os.path.join(_build.BUILD_DIR, f"bench_chain_{name}.cu")
    with open(path, "w") as fh:
        fh.write(text)
    return path


def dump_sass(built: dict, base_src: str, out_dir: str) -> None:
    """Each build's SASS and the baseline's PTX, for reading how its
    build contracted the products into FMAs."""
    from lemo_tpu_torch import _build

    os.makedirs(out_dir, exist_ok=True)
    tools = os.path.dirname(_build._nvcc())
    for name, (path, _) in built.items():
        with open(os.path.join(out_dir, f"chain_{name}.sass"), "w") as fh:
            subprocess.run([os.path.join(tools, "cuobjdump"), "-sass", path],
                           stdout=fh, stderr=subprocess.STDOUT, check=False)
    subprocess.run([_build._nvcc(), "-std=c++17", "-O3", "-arch=sm_90a",
                    "-ptx", base_src, "-o",
                    os.path.join(out_dir, "chain_base.ptx")], check=True)
    print(f"[sass] written into {out_dir}", flush=True)


def _bind(lib, fn: str, argtypes) -> None:
    getattr(lib, fn).argtypes = argtypes
    getattr(lib, fn).restype = ctypes.c_int


def build_ops(path: str, baseline: bool, rl, tl, rg, drg, dtg, parents):
    """Another build's forward and backward on the port's operands; outputs
    and scratch are allocated at each launch, as the wrappers do. The
    baseline takes the parents and the backward's running-cotangent
    scratch; any other build the packed schedule."""
    import torch

    from lemo_tpu_torch import _build
    from lemo_tpu_torch.body_model import chain_cuda as cc

    P, I = ctypes.c_void_p, ctypes.c_int
    lib = ctypes.CDLL(path)
    if baseline:
        _bind(lib, "lemo_chain_fwd", [P] * 5 + [I, I, P])
        _bind(lib, "lemo_chain_bwd", [P] * 10 + [I, I, P])
        table = torch.tensor(parents, dtype=torch.int32, device=rl.device)
        extra = []
    else:
        for fn in ("lemo_chain_fwd", "lemo_chain_bwd"):
            _bind(lib, fn, _build.SIGNATURES[fn])
        table, nlev = cc._schedule_on(parents, rl.device)
        extra = [nlev]

    def head():     # the closures keep `table` alive
        return [table.data_ptr(), *extra]
    Jp, B = rl.shape[1], rl.shape[2]

    def stream():
        return torch.cuda.current_stream(rl.device).cuda_stream

    def done(rc, what):
        if rc:
            raise RuntimeError(f"{what} of {path} failed: CUDA error {rc}")

    def fwd():
        out = torch.empty_like(rl), torch.empty_like(tl)
        done(lib.lemo_chain_fwd(*head(), rl.data_ptr(), tl.data_ptr(),
                                out[0].data_ptr(), out[1].data_ptr(), Jp, B,
                                stream()), "forward")
        return out

    def bwd():
        out = torch.empty_like(rl), torch.empty_like(tl)
        scratch = ([torch.empty_like(rl), torch.empty_like(tl)] if baseline
                   else [])
        done(lib.lemo_chain_bwd(*head(), rl.data_ptr(), tl.data_ptr(),
                                rg.data_ptr(), drg.data_ptr(), dtg.data_ptr(),
                                out[0].data_ptr(), out[1].data_ptr(),
                                *[t.data_ptr() for t in scratch], Jp, B,
                                stream()), "backward")
        return out

    return {"fwd": fwd, "bwd": bwd}


def profile_calls(fn, calls: int = 20) -> dict[str, list]:
    """{kernel: [launches a call, device ms a call]} of `fn`, from a
    torch.profiler trace of `calls` calls after a warm-up."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import bench_torch_vertex as bv

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out: dict[str, list] = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        rec = out.setdefault(bv._short(e.name)[:60], [0.0, 0.0])
        rec[0] += 1 / calls
        rec[1] += e.time_range.elapsed_us() / 1e3 / calls
    return out


def _max_diff(got, ref) -> float:
    return max(float((g - r).abs().max()) for g, r in zip(got, ref))


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", default=BASELINE,
                    help="the first design's source (parents and scratch "
                         "in its argument lists)")
    ap.add_argument("--frames", action="append", default=[],
                    help="NAME=F: csrc/chain.cu with kFrames = F")
    ap.add_argument("--sass", default=None,
                    help="write each build's SASS and the baseline's PTX "
                         "into this directory")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_torch_chain: CUDA is not available", file=sys.stderr)
        return 1
    import bench_torch_vertex as bv
    import chip_smoke as cs
    from lemo_tpu_torch import _build, exact_f32_matmuls
    from lemo_tpu_torch.body_model import chain_cuda as cc
    from lemo_tpu_torch.body_model import load_model

    exact_f32_matmuls()
    card = cs._card_line()
    print(card, flush=True)
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    empty_src = os.path.join(_build.BUILD_DIR, "bench_chain_empty.cu")
    with open(empty_src, "w") as fh:
        fh.write(EMPTY_SOURCE)
    sources = {"port": os.path.join(_build.CSRC, "chain.cu"),
               "base": a.baseline, "empty": empty_src}
    for spec in a.frames:
        name, value = spec.split("=", 1)
        sources[name] = frames_variant(sources["port"], name, int(value))
    built = bv.build_all(sources, "chain", ("port", "base", "empty"))
    if a.sass:
        dump_sass(built, a.baseline, a.sass)

    model = load_model(cs.smoke_model_dict(), use_pca=True, num_pca_comps=12,
                       device="cuda")
    ops = cs.body_operands(model, unfused=True)
    rl, tl, pp = ops["chain_fwd_kernel"]
    _, _, rg, drg, dtg, _ = ops["chain_bwd_kernel"]
    ops = cs.body_operands(model)
    arl, jr, parents = ops["chain_affine_fwd_kernel"]
    _, _, A, dA, adtg, _ = ops["chain_affine_bwd_kernel"]
    print(f"[operands] rl {tuple(rl.shape)}, parents {len(pp)} (affine: "
          f"{len(parents)} joints)", flush=True)

    builds = {"port": {
        "fwd": lambda: cc.chain_fwd_kernel(rl, tl, pp),
        "bwd": lambda: cc.chain_bwd_kernel(rl, tl, rg, drg, dtg, pp)}}
    for name, (path, _) in built.items():
        if name not in ("port", "empty"):
            builds[name] = build_ops(path, name == "base", rl, tl, rg, drg,
                                     dtg, pp)
    plain = {"fwd": lambda: cc.chain_planes_plain_fwd(rl, tl, pp),
             "bwd": lambda: cc.chain_planes_plain_bwd(rl, tl, rg, drg, dtg,
                                                      pp)}
    ref = {kind: plain[kind]() for kind in plain}
    base_out = {kind: builds["base"][kind]() for kind in plain}
    result = {"card": card, "ptxas": {n: s for n, (_, s) in built.items()},
              "check": {}, "ms": {}, "profile": {}}

    for name, b in builds.items():
        res = {}
        for kind, tol in (("fwd", FWD_TOL), ("bwd", TOL)):
            out, again = b[kind](), b[kind]()
            torch.cuda.synchronize()
            err = (_max_diff(out, ref[kind]) if kind == "fwd" else
                   max(cs._max_rel(g, r) for g, r in zip(out, ref[kind])))
            res[kind] = {
                "err": err, "ok": err <= tol,
                "bit_identical_repeat": all(torch.equal(x, y)
                                            for x, y in zip(out, again)),
                "max_diff_from_base": _max_diff(out, base_out[kind]),
                "bit_identical_to_base": all(
                    torch.equal(x, y) for x, y in zip(out, base_out[kind]))}
            print(f"[check] {name} {kind}: err vs plain {err:.3e} (tol "
                  f"{tol:g} {'abs' if kind == 'fwd' else 'rel'}), repeat "
                  f"bit-identical {res[kind]['bit_identical_repeat']}, max "
                  f"diff from base {res[kind]['max_diff_from_base']:.3e} "
                  f"(bit-identical {res[kind]['bit_identical_to_base']})",
                  flush=True)
            if name == "port" and not (res[kind]["ok"] and
                                       res[kind]["bit_identical_repeat"]):
                raise AssertionError(f"port {kind} disagrees with plain or "
                                     f"with itself")
        result["check"][name] = res

    # the affine entry points against the eager composition around the
    # chain pair (forward under no_grad; backward: autograd through it)
    arl_g = arl.detach().requires_grad_(True)
    jr_g = jr.detach().requires_grad_(True)
    outs = cc.chain_affine_planes_unfused(arl_g, jr_g, parents)
    affine = {
        "fwd": lambda: cc.chain_affine_fwd_kernel(arl, jr, parents),
        "bwd": lambda: cc.chain_affine_bwd_kernel(arl, jr, A, dA, adtg,
                                                  parents)}

    def unfused_fwd():
        with torch.no_grad():
            return cc.chain_affine_planes_unfused(arl, jr, parents)

    unfused = {"fwd": unfused_fwd,
               "bwd": lambda: torch.autograd.grad(outs, (arl_g, jr_g),
                                                  (dA, adtg),
                                                  retain_graph=True)}
    same = all(torch.equal(x, y) for x, y in zip(affine["fwd"](),
                                                 unfused["fwd"]()))
    bwd_err = max(cs._max_rel(g, r) for g, r in zip(affine["bwd"](),
                                                    unfused["bwd"]()))
    result["check"]["affine"] = {"fwd_bit_identical_to_unfused": same,
                                 "bwd_rel_err_vs_unfused": bwd_err}
    print(f"[check] affine: forward bit-identical to the unfused path "
          f"{same}; backward max rel err vs its autograd {bwd_err:.3e} (tol "
          f"{TOL:g})", flush=True)
    if not same or bwd_err > TOL:
        raise AssertionError("affine entry points disagree with the "
                             "unfused path")

    elib = ctypes.CDLL(built["empty"][0])
    _bind(elib, "lemo_empty", [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    empty = {name: (lambda g=grid: elib.lemo_empty(
        *g, torch.cuda.current_stream().cuda_stream))
        for name, grid in EMPTY_GRIDS.items()}
    for name, fn in empty.items():
        if fn():
            raise RuntimeError(f"{name} did not launch")

    def show(key, ms):
        result["ms"][key] = ms
        print(f"[time] {key}: {ms:.4f} ms on {card}", flush=True)

    for kind in ("fwd", "bwd"):
        show(f"{kind}/plain", cs._time_ms(plain[kind]))
        port = builds["port"][kind]
        for name in builds:
            if name == "port":
                continue
            fn = builds[name][kind]
            turns = [cs._time_ms(fn), cs._time_ms(port), cs._time_ms(port),
                     cs._time_ms(fn)]
            result["ms"][f"{kind}/{name}_vs_port"] = turns
            print(f"[time] {kind}: {name} {turns[0]:.4f}, port "
                  f"{turns[1]:.4f}, port {turns[2]:.4f}, {name} "
                  f"{turns[3]:.4f} ms (port's speed-up "
                  f"{(turns[0] + turns[3]) / (turns[1] + turns[2]):.2f}x) on "
                  f"{card}", flush=True)
        turns = [cs._time_ms(unfused[kind]), cs._time_ms(affine[kind]),
                 cs._time_ms(affine[kind]), cs._time_ms(unfused[kind])]
        result["ms"][f"{kind}/unfused_vs_affine"] = turns
        print(f"[time] {kind}: unfused {turns[0]:.4f}, affine {turns[1]:.4f}"
              f", affine {turns[2]:.4f}, unfused {turns[3]:.4f} ms (affine's "
              f"speed-up {(turns[0] + turns[3]) / (turns[1] + turns[2]):.2f}"
              f"x) on {card}", flush=True)
    for name, fn in empty.items():
        show(name, cs._time_ms(fn))

    targets = {f"{kind}/{name}": b[kind] for name, b in builds.items()
               for kind in ("fwd", "bwd")}
    targets.update({f"{kind}/affine": affine[kind] for kind in affine})
    targets.update({f"{kind}/unfused": unfused[kind] for kind in unfused})
    targets.update(empty)
    for key, fn in targets.items():
        prof = profile_calls(fn)
        result["profile"][key] = prof
        if not prof:
            print(f"[profile] {key}: the trace holds no device events",
                  flush=True)
            continue
        print(f"[profile] {key}: " + ", ".join(
            f"{k} x{n:g} {ms:.4f}" for k, (n, ms) in
            sorted(prof.items(), key=lambda kv: -kv[1][1]))
              + f" ms a call (device sum {sum(v[1] for v in prof.values()):.4f}"
              f", launches {sum(v[0] for v in prof.values()):g}) on {card}",
              flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
