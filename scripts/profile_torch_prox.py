"""Where the time of the port's PROX Stage-3 window step goes, on one
CUDA card.

    python3 scripts/profile_torch_prox.py [--steps 40] [--trace out.json]

Builds the window `chip_smoke.py` phase 6 fits (the full-size synthetic
SMPL-X on the smooth-surface tube topology, T=100 frames in mild contact,
cfg_files/PROXD_temp_S3_all_terms.yaml as shipped: depth s2m/m2s on 2048
candidates, scene contact, fp8 SDF on 2048 candidates, friction,
smoothness and infill priors, self-interpenetration on the auto-grown
8192-face candidate sets with a 27-part filter) and reports, on the card
named in the output:

1. the self-intersection candidate pre-pass (seconds, n_active,
   n_within, K);
2. wall time per Adam step (host clock around `fit_window` calls, which
   end in a read of the results), for the full loss and with one term
   family switched off at a time (`no_coll`: interpenetration off);
3. one fit under torch.profiler: device busy share (union of kernel
   intervals over the wall time), kernel launches per step, the Chamfer
   and intersection kernels' launches and time per step, and the kernels
   that take the most device time.

Prints human-readable lines and, last, one JSON object.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _union_us(intervals) -> float:
    total, end = 0.0, -1.0
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def main() -> int:
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--trace", default=None,
                    help="write a chrome trace of the profiled fit here")
    ap.add_argument("--top", type=int, default=15)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_prox: CUDA is not available", file=sys.stderr)
        return 1

    import chip_smoke as cs
    from lemo_tpu_torch import _build, exact_f32_matmuls
    from lemo_tpu_torch.body_model import load_model
    from lemo_tpu_torch.body_model.vertex_ids import smpl_to_openpose
    from lemo_tpu_torch.data.prox import ProxRecording, ProxWindowDataset
    from lemo_tpu_torch.fitting.prox import driver
    from lemo_tpu_torch.fitting.prox.infill_prepass import \
        run_infill_prepass
    from lemo_tpu_torch.fitting.prox.window import fit_window, \
        make_window_fitter
    from lemo_tpu_torch.ops import chamfer_cuda, intersection_cuda

    exact_f32_matmuls()
    card = cs._card_line()
    print(card, flush=True)
    _build.build_library()
    md = cs.smoke_model_dict()
    model = load_model(md, use_pca=True, num_pca_comps=12, device="cuda")
    cs.PROX_FRAMES = 100
    cs.PROX_DIR = os.path.join(cs.ROOT, "lemo_tpu_torch", "_build",
                               "prox_profile")
    info = cs.prox_recording(md, model.device)
    cfg = cs.prox_config(info, os.path.join(cs.PROX_DIR, "out"), a.steps)
    assets = cs.prox_assets(model, info, cfg)
    rec = ProxRecording.from_recording_dir(cfg.recording_dir)
    assets = dataclasses.replace(assets, scene_verts=rec.load_scene_mesh())
    ds = ProxWindowDataset(rec, output_params_dir=cfg.output_folder,
                           batch_size=cfg.batch_size, flip=cfg.flip)
    wd = ds.load_window(0)
    jw = ds.joint_weights()
    warm = {k: torch.as_tensor(v, device=model.device)
            for k, v in wd["warm_start"].items()}
    mv, mj = driver._make_warm_world_markers(assets, rec)(warm)
    ir = run_infill_prepass(assets.infill_ae_params, mv, mj,
                            torch.as_tensor(wd["marker_mask"],
                                            device=model.device),
                            assets.infill_stats)
    st, bp = driver.build_window_static(cfg, assets, rec, wd, jw, ir)
    print(f"[prepass] self-intersection candidates: {bp['scores_s']:.3f} s, "
          f"n_active {bp['n_active']}, n_within {bp['n_within']}, K "
          f"{bp['K']} on {card}", flush=True)
    mapper = smpl_to_openpose()
    w_full = driver.weights_from_config(cfg)

    def run(weights, steps):
        fitter = make_window_fitter(model, assets.vposer_params, mapper, st,
                                    weights, maxiters=steps)
        return lambda: fit_window(model, assets.vposer_params, mapper, st,
                                  weights, warm, True, maxiters=steps,
                                  fitter=fitter)

    result = {"card": card, "frames": cfg.batch_size, "steps": a.steps,
              "coll_broad_phase": bp, "ms_per_step": {}}
    variants = {
        "full": w_full,
        "no_coll": dataclasses.replace(w_full, coll=0.0),
        "no_depth": dataclasses.replace(w_full, s2m=0.0, m2s=0.0),
        "no_contact": dataclasses.replace(w_full, contact=0.0),
        "no_smooth_prior": dataclasses.replace(w_full, motion_smooth=0.0),
        "no_infill": dataclasses.replace(w_full, motion_infill_rec=0.0),
        "no_sdf_friction": dataclasses.replace(
            w_full, sdf_penetration=0.0, friction_normal=0.0,
            friction_tangent=0.0),
    }
    for name, w in variants.items():
        fit = run(w, a.steps)
        fit()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fit()
        ms = (time.perf_counter() - t0) / a.steps * 1e3
        result["ms_per_step"][name] = ms
        print(f"[wall] {name}: {ms:.3f} ms/step (T={cfg.batch_size}) on "
              f"{card}", flush=True)

    fit = run(w_full, a.steps)
    fit()
    torch.cuda.synchronize()
    chamfer_cuda.launches["chamfer"] = 0
    intersection_cuda.launches["intersection"] = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fit()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    steps = a.steps
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us = _union_us([(e.time_range.start, e.time_range.end)
                         for e in kernels])
    by_name: dict[str, list] = {}
    for e in kernels:
        rec_ = by_name.setdefault(e.name, [0, 0.0])
        rec_[0] += 1
        rec_[1] += e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:a.top]
    device_us = max(sum(v[1] for v in by_name.values()), 1e-9)
    nn = [v for n, v in by_name.items() if "nn_select" in n]
    cone = [v for n, v in by_name.items() if "cone_energy" in n]
    result.update({
        "profiled_wall_ms_per_step": wall_us / steps / 1e3,
        "device_busy_ms_per_step": busy_us / steps / 1e3,
        "device_busy_share": busy_us / wall_us,
        "kernel_launches_per_step": len(kernels) / steps,
        "chamfer_launches_per_step": chamfer_cuda.launches["chamfer"] / steps,
        "chamfer_ms_per_step": sum(v[1] for v in nn) / steps / 1e3,
        "intersection_launches_per_step":
            intersection_cuda.launches["intersection"] / steps,
        "intersection_ms_per_step": sum(v[1] for v in cone) / steps / 1e3,
        "coll_term_wall_ms_per_step": (result["ms_per_step"]["full"]
                                       - result["ms_per_step"]["no_coll"]),
        "top_kernels": [{"name": n[:90], "launches_per_step": c / steps,
                         "ms_per_step": us / steps / 1e3,
                         "share_of_device_time": us / device_us}
                        for n, (c, us) in top],
    })
    print(f"[profile] wall {wall_us / steps / 1e3:.3f} ms/step (profiled), "
          f"device busy {busy_us / steps / 1e3:.3f} ms/step "
          f"({100 * busy_us / wall_us:.1f}%), "
          f"{len(kernels) / steps:.0f} kernel launches/step, chamfer "
          f"{result['chamfer_launches_per_step']:g} launches and "
          f"{result['chamfer_ms_per_step']:.4f} ms per step, intersection "
          f"{result['intersection_launches_per_step']:g} launches and "
          f"{result['intersection_ms_per_step']:.4f} ms per step (the coll "
          f"term adds {result['coll_term_wall_ms_per_step']:.3f} ms of wall "
          f"time a step)", flush=True)
    for row in result["top_kernels"]:
        print(f"[profile] {row['ms_per_step']:.4f} ms/step "
              f"x{row['launches_per_step']:.0f} "
              f"{100 * row['share_of_device_time']:.1f}%  {row['name']}",
              flush=True)
    if a.trace:
        os.makedirs(os.path.dirname(a.trace) or ".", exist_ok=True)
        prof.export_chrome_trace(a.trace)
    print(json.dumps(result), flush=True)
    return 0 if np.isfinite(result["profiled_wall_ms_per_step"]) else 1


if __name__ == "__main__":
    sys.exit(main())
