"""Where the time of the port's Stage-2 step goes, on one CUDA card.

    python3 scripts/profile_torch_s2.py [--trace s2_trace.json]

Runs the workload `chip_smoke.py` drives (the AMASS Stage-2 fit of
`bench.py:main`: T=100, full-size synthetic SMPL-X, 20 Adam steps per
call) and reports, on the card named in the output:

1. wall time per step (host clock around calls that end in a
   synchronize), for the full loss and with the smoothness prior and the
   friction term switched off one at a time;
2. one call under torch.profiler: device busy share (union of kernel
   intervals over the wall time of the call), kernel launches per step,
   the kernels that take the most device time, and the device time per
   step of the vertex kernels (csrc/vertex.cu: forward and backward) by
   kernel.

Prints human-readable lines and, last, one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# the kernels of csrc/vertex.cu, by a part of their names
VERTEX_KERNELS = ("vertex_", "splitk_gemm_kernel", "sum_slices_kernel")


def _wall_per_step(fit, args, steps, calls=3) -> float:
    import torch

    fit(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fit(*args)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / (calls * steps) * 1e3


def _union_us(intervals) -> float:
    total, end = 0.0, -1.0
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def main() -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ap = argparse.ArgumentParser()
    ap.add_argument("--trace", default=None,
                    help="write a chrome trace of the profiled call here")
    ap.add_argument("--top", type=int, default=15)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_s2: CUDA is not available", file=sys.stderr)
        return 1

    import chip_smoke as cs
    from lemo_tpu_torch import exact_f32_matmuls
    from lemo_tpu_torch.body_model import load_model
    from lemo_tpu_torch.fitting.amass_temp import Stage2Weights
    from lemo_tpu_torch.testing.synthetic import synthetic_smplx_npz

    exact_f32_matmuls()
    card = cs._card_line()
    print(card, flush=True)
    model = load_model(synthetic_smplx_npz(full_size=True), use_pca=True,
                       num_pca_comps=12, device="cuda")
    steps = cs.STEPS
    result = {"card": card, "steps_per_call": steps,
              "frames": cs.T_FRAMES, "ms_per_step": {}}
    for name, w in (("full", Stage2Weights()),
                    ("no_smooth", Stage2Weights(smooth=0.0)),
                    ("no_friction", Stage2Weights(contact_vel=0.0)),
                    ("markers_priors_only",
                     Stage2Weights(smooth=0.0, contact_vel=0.0))):
        fit, args = cs.s2_workload(model, steps, weights=w)
        ms = _wall_per_step(fit, args, steps)
        result["ms_per_step"][name] = ms
        print(f"[wall] {name}: {ms:.3f} ms/step on {card}", flush=True)

    fit, args = cs.s2_workload(model, steps)
    fit(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fit(*args)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == DeviceType.CUDA]
    busy_us = _union_us([(e.time_range.start, e.time_range.end)
                         for e in kernels])
    by_name: dict[str, list] = {}
    for e in kernels:
        rec = by_name.setdefault(e.name, [0, 0.0])
        rec[0] += 1
        rec[1] += e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:a.top]
    device_us = sum(v[1] for v in by_name.values())
    vertex = {n: us / steps / 1e3 for n, (_, us) in by_name.items()
              if any(k in n for k in VERTEX_KERNELS)}
    result.update({
        "profiled_wall_ms_per_step": wall_us / steps / 1e3,
        "device_busy_ms_per_step": busy_us / steps / 1e3,
        "device_busy_share": busy_us / wall_us,
        "vertex_ms_per_step": sum(vertex.values()),
        "vertex_kernels_ms_per_step": {n[:90]: ms
                                       for n, ms in vertex.items()},
        "kernel_launches_per_step": len(kernels) / steps,
        "top_kernels": [{"name": n[:90], "launches_per_step": c / steps,
                         "ms_per_step": us / steps / 1e3,
                         "share_of_device_time": us / device_us}
                        for n, (c, us) in top],
    })
    print(f"[profile] wall {wall_us / steps / 1e3:.3f} ms/step (profiled), "
          f"device busy {busy_us / steps / 1e3:.3f} ms/step "
          f"({100 * busy_us / wall_us:.1f}%), "
          f"{len(kernels) / steps:.0f} kernel launches/step", flush=True)
    for row in result["top_kernels"]:
        print(f"[profile] {row['ms_per_step']:.4f} ms/step "
              f"x{row['launches_per_step']:.0f} "
              f"{100 * row['share_of_device_time']:.1f}%  {row['name']}",
              flush=True)
    print(f"[profile] vertex kernels {sum(vertex.values()):.4f} ms/step: "
          + ", ".join(f"{ms:.4f} {n[:60]}" for n, ms in
                      sorted(vertex.items(), key=lambda kv: -kv[1])),
          flush=True)
    if a.trace:
        os.makedirs(os.path.dirname(a.trace) or ".", exist_ok=True)
        prof.export_chrome_trace(a.trace)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
