"""The Chamfer kernel (csrc/chamfer.cu) against the first design's build
and its own variants, in one process on one CUDA card.

    python3 scripts/bench_torch_chamfer.py \
        [--operands lemo_tpu_torch/_build/prox_smoke/chamfer_operands.pt] \
        [--baseline lemo_tpu_torch/_build/base_chamfer.cu] \
        [--variant NAME=CONST=VALUE[,CONST=VALUE] ...] \
        [--compare NAME=SOURCE.cu ...]

`--operands` is the file chip_smoke.py phase 5 saves: the operands of
each Chamfer call site of its PROX run (the two candidate passes, the
depth terms' K x K s2m and m2s, contact). `--baseline` is the first
design's source (commit 9d7c8a8: one query a thread, every point
visited), which has the same C entry point. Write it from git into the
git-ignored build directory before the run (the card's copy has no git):

    git show 9d7c8a8:lemo_tpu_torch/csrc/chamfer.cu \
        > lemo_tpu_torch/_build/base_chamfer.cu

`--variant` adds csrc/chamfer.cu with other compile-time constants
(kQueries, kThreads, kChunk, kUnroll) as another build;
without any, the variants are DEFAULT_VARIANTS. `--compare` adds
another source that defines `lemo_nn_select` with the same signature.

The script compiles csrc/chamfer.cu, the baseline and each variant each
on its own with `nvcc -Xptxas -v` into lemo_tpu_torch/_build/ (all at
once) and prints every kernel's registers, shared memory and spills. At
each site it holds every build's (idx, dmin) against the plain version,
the baseline and a second launch of itself, bit for bit (the port or the
baseline failing stops the script); times the plain version and the port
as its wrapper calls it (the frame means and outputs made at each call;
CUDA events, median of chip_smoke.REPS); then times every build's
kernel alone in interleaved rounds (each round every build once, the
order rotated: a card's clocks move under a sustained load, so builds
are compared only launch beside launch), by CUDA events around each
launch (`interleaved_ms`) and by device time from one torch.profiler
trace (`interleaved_device_ms`). At the unmasked contact site it also
times `torch.cdist` followed by `min` (TF32 off) as an informative
yardstick: two calls, and a distance rather than the expanded form, so
not the kernel table's library column. Prints one line per measurement
and, last, one JSON object.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

BASELINE = os.path.join(ROOT, "lemo_tpu_torch", "_build", "base_chamfer.cu")
# the sweep of kQueries (the port ships 2)
DEFAULT_VARIANTS = {"r4": {"kQueries": 4}, "r8": {"kQueries": 8}}


def variant_source(src: str, name: str, constants: dict[str, int]) -> str:
    """`src` with the given constants, written into the build directory;
    returns its path."""
    from lemo_tpu_torch import _build
    from lemo_tpu_torch.testing.cuda_emulation import with_constants

    with open(src) as fh:
        text = with_constants(fh.read(), constants)
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    path = os.path.join(_build.BUILD_DIR, f"bench_chamfer_{name}.cu")
    with open(path, "w") as fh:
        fh.write(text)
    return path


def parse_variant(spec: str) -> tuple[str, dict[str, int]]:
    name, rest = spec.split("=", 1)
    consts = {}
    for item in rest.split(","):
        key, value = item.split("=")
        consts[key] = int(value)
    return name, consts


def launcher(path: str, q, p, m):
    """A build's `lemo_nn_select` on contiguous operands, as (call,
    launch): `call` does what the port's wrapper does (the frame means
    and the outputs made at each call) and returns (idx, dmin); `launch`
    is the kernel alone, into outputs made once."""
    import torch

    from lemo_tpu_torch import _build

    lib = ctypes.CDLL(path)
    lib.lemo_nn_select.argtypes = _build.SIGNATURES["lemo_nn_select"]
    lib.lemo_nn_select.restype = ctypes.c_int
    T, N = q.shape[:2]
    M = p.shape[1]

    def run(center, idx, dmin):
        rc = lib.lemo_nn_select(
            q.data_ptr(), p.data_ptr(), None if m is None else m.data_ptr(),
            center.data_ptr(), idx.data_ptr(), dmin.data_ptr(), T, N, M,
            int(p.shape[0] == T), int(m is not None and m.shape[0] == T),
            torch.cuda.current_stream(q.device).cuda_stream)
        if rc:
            raise RuntimeError(f"{path}: CUDA error {rc}")
        return idx, dmin

    def outputs():
        return (q.mean(dim=1),
                torch.empty((T, N), dtype=torch.int64, device=q.device),
                torch.empty((T, N), dtype=torch.float32, device=q.device))

    kept = outputs()
    return (lambda: run(*outputs())), (lambda: run(*kept))


def _same_bits(a, b) -> bool:
    import torch

    return torch.equal(a[0], b[0]) and torch.equal(
        a[1].view(torch.int32), b[1].view(torch.int32))


def interleaved_ms(launches: dict, rounds: int = 20) -> dict[str, float]:
    """Median ms of each launch over `rounds` rounds in which every build
    launches once, in an order rotated each round: CUDA events around
    each launch, enqueued behind a device-side sleep so that the host
    runs ahead and the pair brackets the kernel alone. All builds see
    the same clocks, which a sustained load moves."""
    import statistics

    import torch

    names = list(launches)
    marks: dict[str, list] = {n: [] for n in names}
    for fn in launches.values():
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(40_000_000)
    for r in range(rounds):
        for k in range(len(names)):
            name = names[(r + k) % len(names)]
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            launches[name]()
            b.record()
            marks[name].append((a, b))
    torch.cuda.synchronize()
    return {n: statistics.median(a.elapsed_time(b) for a, b in marks[n])
            for n in names}


def interleaved_device_ms(launches: dict, rounds: int = 10
                          ) -> dict[str, float]:
    """Median device ms of each build's kernel from one torch.profiler
    trace of `rounds` rounds of every build, in a rotated order; the
    trace's nn_select kernels, in start order, are matched to the
    launches in the order they were made."""
    import statistics

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    names = list(launches)
    order = []
    for fn in launches.values():
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for r in range(rounds):
            for k in range(len(names)):
                name = names[(r + k) % len(names)]
                launches[name]()
                order.append(name)
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.events()
                      if e.device_type == DeviceType.CUDA
                      and "nn_select" in e.name),
                     key=lambda e: e.time_range.start)
    if len(kernels) != len(order):
        print(f"[profile] the trace holds {len(kernels)} nn_select kernels "
              f"of {len(order)} launches: no device times", flush=True)
        return {}
    times: dict[str, list] = {n: [] for n in names}
    for name, e in zip(order, kernels):
        times[name].append(e.time_range.elapsed_us() / 1e3)
    return {n: statistics.median(v) for n, v in times.items()}


def main() -> int:
    import torch

    import chip_smoke as cs

    ap = argparse.ArgumentParser()
    ap.add_argument("--operands", default=cs.CHAMFER_OPERANDS)
    ap.add_argument("--baseline", default=BASELINE,
                    help="the first design's source (same entry point)")
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=CONST=VALUE[,CONST=VALUE]: csrc/chamfer.cu "
                         "with other constants")
    ap.add_argument("--compare", action="append", default=[],
                    help="NAME=SOURCE.cu: another build of lemo_nn_select")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_torch_chamfer: CUDA is not available", file=sys.stderr)
        return 1
    import bench_torch_vertex as bv
    from bench_torch_chain import profile_calls

    from lemo_tpu_torch import _build, exact_f32_matmuls
    from lemo_tpu_torch.ops import chamfer as ch

    exact_f32_matmuls()
    card = cs._card_line()
    print(card, flush=True)
    port_src = os.path.join(_build.CSRC, "chamfer.cu")
    sources = {"port": port_src, "base": a.baseline}
    variants = (dict(parse_variant(s) for s in a.variant) if a.variant
                else DEFAULT_VARIANTS)
    for name, consts in variants.items():
        sources[name] = variant_source(port_src, name, consts)
    for spec in a.compare:
        name, src = spec.split("=", 1)
        sources[name] = src
    built = bv.build_all(sources, "chamfer", ("port", "base"))
    result = {"card": card, "variants": variants,
              "ptxas": {n: s for n, (_, s) in built.items()}, "sites": {}}

    saved = torch.load(a.operands, weights_only=False)
    for site, ops in saved.items():
        # contiguous, as the wrapper makes them (a mask captured from the
        # main path may be a strided view)
        q = ops["query"].cuda().contiguous()
        p = ops["points"].cuda().contiguous()
        m = (None if ops["mask"] is None
             else ops["mask"].cuda().contiguous())
        T, N = q.shape[:2]
        M = p.shape[1]
        npv = (m.expand(T, -1).sum() if m is not None
               else torch.tensor(T * M))
        visited = float(N * npv)
        row = {"shape": [list(q.shape), list(p.shape)],
               "masked": m is not None, "launches": ops["launches"],
               "pairs_all": float(T) * N * M, "pairs_visited": visited,
               "check": {}, "ms": {}, "device_ms": {}}
        print(f"[site] {site} q{list(q.shape)} p{list(p.shape)} "
              f"{'masked' if m is not None else 'unmasked'}: pairs "
              f"{row['pairs_all']:.4e}, over valid points {visited:.4e} "
              f"({visited / row['pairs_all']:.3f}); {ops['launches']} "
              f"launches on the main path ({ops['caller']})", flush=True)
        builds = {name: launcher(path, q, p, m)
                  for name, (path, _) in built.items()}
        ref = ch.nn_select_plain(q, p, m)
        base_out = builds["base"][0]()
        for name, (call, launch) in builds.items():
            out, again = call(), launch()
            torch.cuda.synchronize()
            chk = {"plain": _same_bits(out, ref),
                   "base": _same_bits(out, base_out),
                   "repeat": _same_bits(out, again)}
            row["check"][name] = chk
            print(f"[check] {site} {name}: bit-equal to plain "
                  f"{chk['plain']}, to the first design's {chk['base']}, repeat "
                  f"{chk['repeat']}", flush=True)
            if name in ("port", "base") and not all(chk.values()):
                raise AssertionError(f"{site}: {name} disagrees: {chk}")

        big = N * M > 1e8
        row["ms"]["plain"] = cs._time_ms(
            lambda: ch.nn_select_plain(q, p, m), 3 if big else cs.REPS)
        row["ms"]["port_call"] = cs._time_ms(builds["port"][0])
        print(f"[time] {site}: plain {row['ms']['plain']:.4f} ms, the "
              f"port as the wrapper calls it {row['ms']['port_call']:.4f} "
              f"ms on {card}", flush=True)
        if m is None:
            def cdist_min():
                return torch.cdist(q, p.expand(T, -1, -1)).min(-1)
            row["ms"]["cdist_min"] = cs._time_ms(cdist_min)
            prof = profile_calls(cdist_min)
            row["device_ms"]["cdist_min"] = sum(v[1] for v in prof.values())
            print(f"[time] {site}: torch.cdist + min (yardstick, TF32 off) "
                  f"{row['ms']['cdist_min']:.4f} ms, device "
                  f"{row['device_ms']['cdist_min']:.4f} ms a call on {card}",
                  flush=True)
        launches = {name: launch for name, (_, launch) in builds.items()}
        row["ms"].update(interleaved_ms(launches))
        row["device_ms"].update(interleaved_device_ms(launches))
        for name in builds:
            ev = row["ms"][name]
            dev = row["device_ms"].get(name)
            print(f"[time] {site} {name}: {ev:.4f} ms by events, "
                  + (f"{dev:.4f} ms of device time, "
                     f"{visited / dev / 1e9:.3f} visited pairs/ns; "
                     if dev else "no device time; ")
                  + f"first design / it {row['ms']['base'] / ev:.2f}x "
                  f"(interleaved launches) on {card}", flush=True)
        result["sites"][site] = row
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
