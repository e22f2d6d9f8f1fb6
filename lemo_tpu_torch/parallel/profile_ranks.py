"""Where one rank's time goes in the clip-sharded Stage 2, on one CUDA card.

    python3 -m lemo_tpu_torch.parallel.profile_ranks [--cpu-rehearsal]

Builds the Stage-2 workload of `chip_smoke.py` phase 11b (full-size
synthetic SMPL-X, C = 4 clips of T = 119 frames, 20 steps, seeded
inputs) and runs the clip-sharded fold (`parallel.clip_sharded_fit` of
`make_temporal_fitter_batched`, deterministic algorithms) on spawned
ranks (`parallel.dryrun.spawn_ranks`, gloo) in three set-ups:

1. one rank alone: the one-process fit in a fresh process;
2. two ranks on cuda:0, each with torch's default intra-op threads (as
   phase 11b spawns them);
3. two ranks on cuda:0, each with half the cores' threads.

Each rank makes three calls of the same fit, each started on all ranks
together (an all-reduce before it): the process's first (cold), a
second (warm), and a third under torch.profiler, which gives the device
busy share (union of kernel intervals over the call's wall), the kernel
launches a step, the device's idle time a step, the gaps between
kernels over 1 ms and the largest, and the host time spent in the
launch API a step. Set-up 1 then times a call of the first C/2 clips
alone (a rank's share in set-ups 2 and 3; the process's first call at
that shape).

Prints a line a rank and set-up and, last, one JSON object.
`--cpu-rehearsal` runs the same on the CPU at a 400-vertex model, C=4,
T=12, 2 steps (no device numbers).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

GAP_US = 1000.0     # a gap between kernels counted as a stall
CLIPS, FRAMES, STEPS = 4, 119, 20   # phase 11b's first Stage-2 batch


def _union(intervals) -> tuple[float, list]:
    """Busy time of the intervals' union and the gaps between them."""
    busy, end, gaps = 0.0, None, []
    for s, e in sorted(intervals):
        if end is not None and s > end:
            gaps.append(s - end)
        if end is None or e > end:
            busy += e - (s if end is None else max(s, end))
            end = e
    return busy, gaps


def _timed(fit, args, dev) -> float:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    fit(*args)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter() - t0


def _profiled(fit, args, dev, steps: int) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        wall = _timed(fit, args, dev)
    events = prof.events()
    kernels = [(e.time_range.start, e.time_range.end) for e in events
               if e.device_type == DeviceType.CUDA]
    busy, gaps = _union(kernels)
    launch_us = sum(e.time_range.elapsed_us() for e in events
                    if e.device_type == DeviceType.CPU
                    and e.name.startswith(("cudaLaunch", "cuLaunch")))
    stalls = [g for g in gaps if g > GAP_US]
    wall_us = wall * 1e6
    return {"ms_step": 1e3 * wall / steps,
            "busy_share": busy / wall_us,
            "idle_ms_step": (wall_us - busy) / steps / 1e3,
            "launches_step": len(kernels) / steps,
            "stalls_over_1ms": len(stalls),
            "stall_ms_step": sum(stalls) / steps / 1e3,
            "largest_gap_ms": max(gaps, default=0.0) / 1e3,
            "launch_api_ms_step": launch_us / steps / 1e3}


def _profile_job(mesh, fitter_args, fitter_kw, inputs, half: bool):
    """One rank's three calls (cold, warm, profiled) of the clip-sharded
    fold, each after an all-reduce across the ranks; with `half`, then a
    call of the first C/2 clips alone."""
    import torch

    from lemo_tpu_torch.fitting import amass_temp as s2
    from lemo_tpu_torch.parallel import sharding

    torch.use_deterministic_algorithms(True, warn_only=True)
    dev = mesh.device
    steps = fitter_kw["num_steps"]
    fold = s2.make_temporal_fitter_batched(*fitter_args, **fitter_kw)
    fit = sharding.clip_sharded_fit(fold, mesh)

    def together():
        sharding.all_reduce_sum(mesh, torch.zeros(1, device=dev))

    out = {"rank": mesh.rank, "ranks": mesh.size, "device": str(dev),
           "threads": torch.get_num_threads(), "cpus": os.cpu_count(),
           "affinity": len(os.sched_getaffinity(0))}
    together()
    out["cold_ms_step"] = 1e3 * _timed(fit, inputs, dev) / steps
    together()
    out["warm_ms_step"] = 1e3 * _timed(fit, inputs, dev) / steps
    together()
    out["profiled"] = _profiled(fit, inputs, dev, steps)
    if half:
        c = inputs[0].shape[0] // 2
        out["half_clips"] = c
        out["half_ms_step"] = 1e3 * _timed(
            fold, tuple(x[:c] for x in inputs), dev) / steps
    return out


def _card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi: not available"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu-rehearsal", action="store_true")
    a = ap.parse_args()

    import numpy as np
    import torch

    from lemo_tpu_torch.body_model import load_model
    from lemo_tpu_torch.body_model import vposer as vp
    from lemo_tpu_torch.data import markers, segments
    from lemo_tpu_torch.data.stats import GlobalStats
    from lemo_tpu_torch.parallel import dryrun
    from lemo_tpu_torch.priors.conv_ae import init_smooth_enc
    from lemo_tpu_torch.testing.synthetic import synthetic_smplx_npz

    if a.cpu_rehearsal:
        dev, verts = torch.device("cpu"), 400
        C, T, steps = 4, 12, 2
        card = "cpu rehearsal"
    else:
        if not torch.cuda.is_available():
            print("profile_ranks: CUDA is not available",
                  file=sys.stderr)
            return 1
        from lemo_tpu_torch import _build

        dev, verts = torch.device("cuda", 0), None
        C, T, steps = CLIPS, FRAMES, STEPS
        card = _card_line()
        # built once here; the ranks load the library
        print(f"kernels built in {_build.build_library()[1]:.1f} s",
              flush=True)
    print(card, flush=True)
    md = synthetic_smplx_npz(full_size=True) if verts is None else \
        synthetic_smplx_npz(num_verts=verts)
    nv = {} if verts is None else {"num_verts": verts}
    model = load_model(md, use_pca=True, num_pca_comps=12, device=dev)
    fitter_args = (
        model, vp.init_vposer(torch.Generator().manual_seed(0), device=dev),
        init_smooth_enc(torch.Generator().manual_seed(1), device=dev),
        GlobalStats.from_numpy(np.zeros((1, 1, 243)), np.ones(243), dev),
        markers.marker_indices(False, **nv),
        markers.marker_indices(True, **nv), segments.foot_vertex_ids(**nv))
    rng = np.random.RandomState(11)
    init72 = np.zeros((C, T, 72), np.float32)
    init72[..., 0:3] = [0, 0.4, 1.0]
    init72[..., 16:48] = rng.randn(C, T, 32) * 0.2
    inputs = tuple(torch.as_tensor(x, device=dev) for x in (
        (rng.randn(C, T, 67, 3) * 0.3 + [0, 0.4, 1.0]).astype(np.float32),
        (rng.rand(C, T, 4) > 0.5).astype(np.float32), init72))
    job = {"fitter_args": fitter_args,
           "fitter_kw": {"num_steps": steps, "device": dev},
           "inputs": inputs}
    cores = os.cpu_count() or 2
    setups = (("one rank", 1, None, True),
              ("two ranks, default threads", 2, None, False),
              (f"two ranks, {max(cores // 2, 1)} threads", 2,
               max(cores // 2, 1), False))
    result = {"card": card, "clips": C, "frames": T, "steps": steps,
              "setups": []}
    for name, n, threads, half in setups:
        t0 = time.perf_counter()
        ranks = dryrun.spawn_ranks(n, _profile_job, dict(job, half=half),
                                   device=dev, backend="gloo",
                                   threads=threads, timeout=600)
        result["setups"].append({"name": name, "wall_s":
                                 time.perf_counter() - t0, "ranks": ranks})
        for r in ranks:
            p = r["profiled"]
            half_txt = (f", {r['half_clips']} clips alone (first call "
                        f"at that shape) {r['half_ms_step']:.3f}"
                        if "half_ms_step" in r else "")
            print(f"[{name}] rank {r['rank']} ({r['threads']} threads, "
                  f"{r['affinity']} cores): cold {r['cold_ms_step']:.3f}, "
                  f"warm {r['warm_ms_step']:.3f}, profiled "
                  f"{p['ms_step']:.3f} ms/step{half_txt}; busy "
                  f"{100 * p['busy_share']:.1f}%, idle "
                  f"{p['idle_ms_step']:.3f} ms/step, "
                  f"{p['launches_step']:.0f} launches/step, launch API "
                  f"{p['launch_api_ms_step']:.3f} ms/step, "
                  f"{p['stalls_over_1ms']} gaps > 1 ms "
                  f"({p['stall_ms_step']:.3f} ms/step), largest "
                  f"{p['largest_gap_ms']:.3f} ms on {card}", flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
