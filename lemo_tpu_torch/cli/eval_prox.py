"""Quantitative evaluation of fitted PROX sequences on the port (port of
`lemo_tpu/cli/eval_prox.py`):

  python -m lemo_tpu_torch.cli.eval_prox \
      --fitting_dir out/N3OpenArea_00157_01 \
      --recording_dir /path/to/PROX/recordings/N3OpenArea_00157_01 \
      --body_model_path /path/to/body_models

The reference evaluates PROX fits qualitatively (renders); this computes
the PROX protocol's physical-plausibility numbers and smoothness from a
fitted output folder:

- **non_collision**: mean fraction of body vertices with scene SDF >= 0
  (higher is better; PROX-paper protocol).
- **contact**: fraction of frames where any body vertex is within
  `contact_thresh` of the scene.
- **accel_m_s2**: mean joint acceleration magnitude (lower is smoother).
- **reproj_err_px**: confidence-weighted 2D keypoint reprojection error
  against the OpenPose detections, in pixels.

Reads the per-frame pkls the driver writes (results/<frame>/000.pkl,
the reference schema of fit_temp_loadprox_slide.py:577-594). The body
forward runs on the CUDA card in chunks of --chunk frames.
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--fitting_dir", type=str, required=True,
                   help="output folder of one recording (contains "
                        "results/<frame>/000.pkl)")
    p.add_argument("--recording_dir", type=str, required=True)
    p.add_argument("--body_model_path", type=str, required=True)
    p.add_argument("--gender", type=str, default="male")
    p.add_argument("--num_pca_comps", type=int, default=12)
    p.add_argument("--contact_thresh", type=float, default=0.02)
    p.add_argument("--chunk", type=int, default=25,
                   help="frames per forward dispatch")
    p.add_argument("--focal_length_x", type=float, default=1060.53)
    p.add_argument("--focal_length_y", type=float, default=1060.38)
    p.add_argument("--camera_center_x", type=float, default=951.30)
    p.add_argument("--camera_center_y", type=float, default=536.77)
    p.add_argument("--out", type=str, default="eval_prox.json")
    return p


def load_fitted_frames(result_folder: str):
    """(frame_names, params dict of [N, ...] numpy) from
    results/*/000.pkl."""
    from lemo_tpu_torch.data.prox import read_prox_pkl

    names = sorted(fn for fn in os.listdir(result_folder)
                   if osp.exists(osp.join(result_folder, fn, "000.pkl")))
    if not names:
        raise FileNotFoundError(f"no results/<frame>/000.pkl under "
                                f"{result_folder}")
    rows = [read_prox_pkl(osp.join(result_folder, fn, "000.pkl"))
            for fn in names]
    params = {k: np.stack([r[k] for r in rows]) for k in rows[0]}
    return names, params


def evaluate_recording(names, params, model, rec, camera,
                       contact_thresh=0.02, chunk=25,
                       keyp_folder=None, use_hands=True, use_face=True):
    """Metric dict for one fitted recording, the body forward on the
    model's device (the CLI wraps it; tests call it with synthetic
    assets)."""
    import torch

    from lemo_tpu_torch.body_model import make_forward_fn
    from lemo_tpu_torch.body_model.vertex_ids import smpl_to_openpose
    from lemo_tpu_torch.data.prox import read_keypoints
    from lemo_tpu_torch.ops.sdf import sample_sdf_world

    dev = model.device
    fwd = make_forward_fn(model)
    R, t = rec.load_cam2world()
    Rd, td = torch.as_tensor(R, device=dev), torch.as_tensor(t, device=dev)
    sdf = grid_min = grid_max = None
    try:
        sdf_np, grid_min, grid_max, _ = rec.load_sdf()
        sdf = torch.as_tensor(sdf_np, device=dev)
        grid_min = torch.as_tensor(grid_min, device=dev)
        grid_max = torch.as_tensor(grid_max, device=dev)
    except FileNotFoundError as e:
        print(f"[eval_prox] scene SDF unavailable, skipping "
              f"non_collision/contact: {e}")

    N = len(names)
    zeros = model.zero_params(min(chunk, N))
    drop = {"pose_embedding"}
    verts_w, joints_cam = [], []
    with torch.no_grad():
        for s in range(0, N, chunk):
            e = min(s + chunk, N)
            batch = {k: torch.as_tensor(v[s:e], device=dev)
                     for k, v in params.items() if k not in drop}
            if e - s < chunk:
                zeros = model.zero_params(e - s)
            for k in zeros:
                batch.setdefault(k, zeros[k])
            out = fwd(batch, model.consts)
            verts_w.append(out["vertices"] @ Rd.T + td)
            joints_cam.append(out["joints"].cpu().numpy())
        verts_w = torch.cat(verts_w)               # [N, V, 3] world
        joints_cam = np.concatenate(joints_cam)    # [N, J, 3] camera

        res = {"frames": N}
        if sdf is not None:
            # crop=None: the query set spans the whole trajectory, which
            # can exceed the fitting loss's single-window crop box
            vals = sample_sdf_world(sdf, verts_w.reshape(-1, 3), grid_min,
                                    grid_max, crop=None).reshape(N, -1)
            res["non_collision"] = float((vals >= 0).double().mean())
            res["contact"] = float((vals.min(dim=1).values
                                    < contact_thresh).double().mean())

    # smoothness: world-joint acceleration magnitude (30 fps)
    j_world = joints_cam[:, :25] @ R.T + t
    if N >= 3:
        acc = (j_world[2:] - 2 * j_world[1:-1] + j_world[:-2]) * 30.0 * 30.0
        res["accel_m_s2"] = float(np.linalg.norm(acc, axis=-1).mean())

    if keyp_folder is not None and osp.isdir(keyp_folder):
        mapper = smpl_to_openpose("smplx", use_hands, use_face, False)
        proj = camera.project(torch.as_tensor(joints_cam[:, mapper])
                              ).numpy()
        errs, confs = [], []
        for i, fn in enumerate(names):
            keyp = read_keypoints(osp.join(keyp_folder,
                                           fn + "_keypoints.json"),
                                  use_hands, use_face)
            if keyp is None:
                continue
            k = min(len(keyp), proj.shape[1])
            conf = keyp[:k, 2]
            err = np.linalg.norm(proj[i, :k] - keyp[:k, :2], axis=-1)
            errs.append((err * conf).sum())
            confs.append(conf.sum())
        if confs and sum(confs) > 0:
            res["reproj_err_px"] = float(sum(errs) / sum(confs))
            res["frames_with_detection"] = len(confs)
    return res


def main(argv=None, device=None):
    """Evaluate on `device` (None: the CUDA card; raises without it)."""
    args = build_parser().parse_args(argv)

    from lemo_tpu_torch import exact_f32_matmuls, resolve_device
    from lemo_tpu_torch.body_model import load_model
    from lemo_tpu_torch.body_model.smplx import find_smplx_npz
    from lemo_tpu_torch.data.prox import ProxRecording
    from lemo_tpu_torch.fitting.prox.camera import PerspectiveCamera

    dev = resolve_device(device)
    exact_f32_matmuls()
    rec = ProxRecording.from_recording_dir(args.recording_dir)
    result_folder = osp.join(args.fitting_dir, "results")
    names, params = load_fitted_frames(result_folder)
    model = load_model(find_smplx_npz(args.body_model_path, args.gender),
                       gender=args.gender, use_pca=True,
                       num_pca_comps=args.num_pca_comps, device=dev)
    camera = PerspectiveCamera(
        args.focal_length_x, args.focal_length_y,
        (args.camera_center_x, args.camera_center_y))
    res = evaluate_recording(names, params, model, rec, camera,
                             contact_thresh=args.contact_thresh,
                             chunk=args.chunk, keyp_folder=rec.keyp_folder)
    res["recording"] = rec.recording_name
    with open(args.out, "w") as f:
        json.dump(res, f, indent=2)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
