"""Where the time of the port's Stage-2 step goes, on one CUDA card.

    python3 scripts/profile_torch_s2.py [--trace s2_trace.json] \
        [--unfused-chain]

Runs the workload `chip_smoke.py` drives (the AMASS Stage-2 fit of
`bench.py:main`: T=100, full-size synthetic SMPL-X, 20 Adam steps per
call) and reports, on the card named in the output:

1. wall time per step (host clock around calls that end in a
   synchronize), for the full loss and with the smoothness prior and the
   friction term switched off one at a time;
2. one call under torch.profiler: device busy share (union of kernel
   intervals over the wall time of the call), kernel launches per step,
   the kernels that take the most device time, and the device time per
   step of the vertex kernels (csrc/vertex.cu: forward and backward) and
   of the chain kernels (csrc/chain.cu) by kernel.

`--unfused-chain` runs the body model's chain as before the affine
kernels (the chain kernel pair with eager ops around it,
`chip_smoke.unfused_chain`), for a profile before and after that fold in
one call. `--chain-turns` adds the full fit's wall time per step with
the chain unfused and folded in turns (unfused, folded, folded, unfused,
four times) in one process.

Prints human-readable lines and, last, one JSON object.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# the kernels of csrc/vertex.cu, by a part of their names
VERTEX_KERNELS = ("vertex_", "splitk_gemm_kernel", "sum_slices_kernel")
# the kernels of csrc/chain.cu
CHAIN_KERNELS = ("chain_",)


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

    ap = argparse.ArgumentParser()
    ap.add_argument("--trace", default=None,
                    help="write a chrome trace of the profiled call here")
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--unfused-chain", action="store_true",
                    help="the chain pair with eager ops around it, as "
                         "before the affine kernels")
    ap.add_argument("--chain-turns", action="store_true",
                    help="wall time per step, the chain unfused and folded "
                         "in turns")
    a = ap.parse_args()
    if a.unfused_chain and a.chain_turns:
        ap.error("--chain-turns compares both forms itself")
    if not torch.cuda.is_available():
        print("profile_torch_s2: CUDA is not available", file=sys.stderr)
        return 1

    import chip_smoke as cs

    if not a.unfused_chain:
        return profile_s2(a)
    print("[chain] unfused: the chain pair with eager ops around it",
          flush=True)
    with cs.unfused_chain():
        return profile_s2(a)


def profile_s2(a) -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
    result = {"card": card, "unfused_chain": a.unfused_chain,
              "steps_per_call": steps,
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
    if a.chain_turns:
        turns: dict[str, list] = {"unfused": [], "folded": []}
        for form in ("unfused", "folded", "folded", "unfused") * 4:
            with (cs.unfused_chain() if form == "unfused"
                  else contextlib.nullcontext()):
                turns[form].append(_wall_per_step(fit, args, steps))
        result["chain_turns_ms_per_step"] = turns
        print("[wall] in turns, chain unfused " + ", ".join(
            f"{ms:.3f}" for ms in turns["unfused"]) + "; folded " + ", ".join(
            f"{ms:.3f}" for ms in turns["folded"]) + f" ms/step (medians "
            f"{statistics.median(turns['unfused']):.3f} / "
            f"{statistics.median(turns['folded']):.3f}) on {card}",
            flush=True)
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
    chain = {n: us / steps / 1e3 for n, (_, us) in by_name.items()
             if any(k in n for k in CHAIN_KERNELS)}
    result.update({
        "profiled_wall_ms_per_step": wall_us / steps / 1e3,
        "device_busy_ms_per_step": busy_us / steps / 1e3,
        "device_busy_share": busy_us / wall_us,
        "vertex_ms_per_step": sum(vertex.values()),
        "vertex_kernels_ms_per_step": {n[:90]: ms
                                       for n, ms in vertex.items()},
        "chain_ms_per_step": sum(chain.values()),
        "chain_kernels_ms_per_step": {n[:90]: ms for n, ms in chain.items()},
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
    print(f"[profile] chain kernels {sum(chain.values()):.4f} ms/step: "
          + ", ".join(f"{ms:.4f} {n[:60]}" for n, ms in
                      sorted(chain.items(), key=lambda kv: -kv[1])),
          flush=True)
    if a.trace:
        os.makedirs(os.path.dirname(a.trace) or ".", exist_ok=True)
        prof.export_chrome_trace(a.trace)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
