"""Synthetic PROX recording writer (port of
`lemo_tpu/testing/synthetic_prox.py`), on the port's own body model and
VPoser, with PNGs written by `data.png` (no cv2), and the Color frames
as PNG or, on request, as baseline JPEG (`testing.jpeg_encode`).

Writes the on-disk layout of a PROX capture (data_parser_slide.py /
main_slide.py conventions):

  <base>/recordings/<name>/{Color, Depth, BodyIndexColor}
  <base>/keypoints/<name>/<frame>_keypoints.json
  <base>/calibration/{IR, Color}.json
  <base>/cam2world/<scene>.json
  <base>/scenes/<scene>.ply
  <base>/scenes_sdf/<scene>{.json, _sdf.npy, _normals.npy}
  <base>/mask_markers/<name>/mask_markers.npy
  <base>/PROXD/<name>/results/<frame>/000.pkl

A synthetic SMPL-X body drifts in front of the camera; keypoints are its
projected joints, depth images are z-buffered splats of its vertices
(ideal pinhole, zero distortion; a solid body region, so a full-size
body gives thousands of scan points a frame), masks cover the body
region, and the PROXD
warm starts are its true parameters perturbed by noise. The numpy draws
are the JAX writer's; the VPoser weights come from a torch generator, so
the body differs from the JAX writer's for the same seed.
"""

from __future__ import annotations

import json
import os
import os.path as osp
import pickle

import numpy as np
import torch

from lemo_tpu_torch.data.png import write_png
from lemo_tpu_torch.testing.jpeg_encode import write_jpeg
from lemo_tpu_torch.data.prox import write_ply_vertices

FX, FY = 1060.53, 1060.38
CX, CY = 951.30, 536.77
DEPTH_W, DEPTH_H = 512, 424
COLOR_W, COLOR_H = 1920, 1080
DEPTH_SPLAT_RADIUS = 2      # px around each vertex's projection


def _write_calibration(calib_dir: str) -> None:
    os.makedirs(calib_dir, exist_ok=True)
    ident = {"view_mtx": [[1.0, 0.0, 0.0, 0.0], [0.0, 1.0, 0.0, 0.0],
                          [0.0, 0.0, 1.0, 0.0]],
             "R": [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]],
             "T": [0.0, 0.0, 0.0], "k": [0.0, 0.0, 0.0, 0.0, 0.0]}
    ir = {"camera_mtx": [[365.0, 0.0, 256.0], [0.0, 365.0, 212.0],
                         [0.0, 0.0, 1.0]], **ident}
    color = {"camera_mtx": [[FX, 0.0, CX], [0.0, FY, CY], [0.0, 0.0, 1.0]],
             **ident}
    for name, cam in (("IR", ir), ("Color", color)):
        with open(osp.join(calib_dir, name + ".json"), "w") as fh:
            json.dump(cam, fh)


def _render_depth(v: np.ndarray, fx: float, fy: float, cx: float,
                  cy: float) -> np.ndarray:
    """Depth image [DEPTH_H, DEPTH_W] in metres (0 = no return) of the
    vertices `v` [V, 3] (camera coords). Each vertex covers the
    (2r+1)^2 pixels around its projection (r = DEPTH_SPLAT_RADIUS) and
    the nearest one wins, so the body reads as a solid region of body
    pixels, as a depth camera sees it, instead of one pixel per vertex."""
    r = DEPTH_SPLAT_RADIUS
    z = v[:, 2]
    u = np.round(v[:, 0] / z * fx + cx).astype(int)
    w = np.round(v[:, 1] / z * fy + cy).astype(int)
    flat = np.full(DEPTH_H * DEPTH_W, np.inf)
    for du in range(-r, r + 1):
        for dw in range(-r, r + 1):
            uu, ww = u + du, w + dw
            ok = (uu >= 0) & (uu < DEPTH_W) & (ww >= 0) & (ww < DEPTH_H) & \
                (z > 0)
            np.minimum.at(flat, ww[ok] * DEPTH_W + uu[ok], z[ok])
    flat[np.isinf(flat)] = 0.0
    return flat.reshape(DEPTH_H, DEPTH_W)


def _keypoints_json(joints2d: np.ndarray) -> dict:
    """[118, 2] projected joints -> OpenPose json dict (conf = 0.9)."""
    conf = np.full((118, 1), 0.9, np.float32)
    kp = np.concatenate([joints2d, conf], axis=1)
    face70 = np.zeros((70, 3), np.float32)
    face70[17:68] = kp[67:118]
    return {"version": 1.3, "people": [{
        "pose_keypoints_2d": kp[:25].reshape(-1).tolist(),
        "hand_left_keypoints_2d": kp[25:46].reshape(-1).tolist(),
        "hand_right_keypoints_2d": kp[46:67].reshape(-1).tolist(),
        "face_keypoints_2d": face70.reshape(-1).tolist(),
    }]}


def write_synthetic_prox_recording(
    base_dir: str,
    recording_name: str = "SynthArea_00001_01",
    num_frames: int = 40,
    model_dict: dict | None = None,
    seed: int = 0,
    occlusion_frac: float = 0.15,
    write_depth: bool = True,
    pose_scale: float = 1.0,
    device="cpu",
    color_format: str = "png",
) -> dict:
    """Create the recording; returns ground-truth info (the model dict
    and VPoser parameters the body was made with, on `device`).
    `color_format` "jpg" writes the Color frames as `<frame>.jpg`
    (baseline 4:2:0 JPEG, quality 95) instead of `<frame>.png`."""
    from lemo_tpu_torch.body_model import load_model, make_forward_fn
    from lemo_tpu_torch.body_model import vposer as vp
    from lemo_tpu_torch.body_model.vertex_ids import smpl_to_openpose
    from lemo_tpu_torch.testing.synthetic import synthetic_smplx_npz, \
        synthetic_sdf_grid

    if color_format not in ("png", "jpg"):
        raise ValueError(f"color_format {color_format!r}: 'png' or 'jpg'")
    rng = np.random.RandomState(seed)
    scene_name = recording_name.split("_")[0]
    rec_dir = osp.join(base_dir, "recordings", recording_name)
    for sub in ("Color", "Depth", "BodyIndexColor"):
        os.makedirs(osp.join(rec_dir, sub), exist_ok=True)
    keyp_dir = osp.join(base_dir, "keypoints", recording_name)
    os.makedirs(keyp_dir, exist_ok=True)
    _write_calibration(osp.join(base_dir, "calibration"))

    # camera 1.2 m up; cam2world flips y/z so the world is z-up
    R_c2w = np.array([[1.0, 0, 0], [0, 0, -1.0], [0, 1.0, 0]])
    t_c2w = np.array([0.0, 2.5, 1.2])
    os.makedirs(osp.join(base_dir, "cam2world"), exist_ok=True)
    with open(osp.join(base_dir, "cam2world", scene_name + ".json"),
              "w") as fh:
        M = np.eye(4)
        M[:3, :3] = R_c2w
        M[:3, 3] = t_c2w
        json.dump(M.tolist(), fh)

    # scene mesh: a triangulated floor grid at z = 0 (the contact target)
    scenes_dir = osp.join(base_dir, "scenes")
    os.makedirs(scenes_dir, exist_ok=True)
    gx, gy = np.meshgrid(np.linspace(-2.5, 2.5, 24),
                         np.linspace(-0.5, 4.5, 24))
    floor_v = np.stack([gx.ravel(), gy.ravel(),
                        np.zeros(gx.size)], axis=1).astype(np.float32)
    ii, jj = np.meshgrid(np.arange(23), np.arange(23), indexing="ij")
    q = (ii * 24 + jj).ravel()
    floor_f = np.concatenate([
        np.stack([q, q + 1, q + 24], axis=1),
        np.stack([q + 1, q + 25, q + 24], axis=1)]).astype(np.int32)
    write_ply_vertices(osp.join(scenes_dir, scene_name + ".ply"), floor_v,
                       faces=floor_f)

    sdf = synthetic_sdf_grid(dim=48, floor_z=0.0)
    sdf_dir = osp.join(base_dir, "scenes_sdf")
    os.makedirs(sdf_dir, exist_ok=True)
    with open(osp.join(sdf_dir, scene_name + ".json"), "w") as fh:
        json.dump({"min": sdf["min"].tolist(), "max": sdf["max"].tolist(),
                   "dim": int(sdf["dim"])}, fh)
    np.save(osp.join(sdf_dir, scene_name + "_sdf.npy"),
            sdf["sdf"].reshape(-1))
    np.save(osp.join(sdf_dir, scene_name + "_normals.npy"),
            sdf["normals"].reshape(-1))

    # body motion in camera coordinates (+z forward)
    md = model_dict or synthetic_smplx_npz(num_verts=400, seed=3)
    model = load_model(md, use_pca=True, num_pca_comps=12, device=device)
    vposer_params = vp.init_vposer(torch.Generator().manual_seed(7),
                                   device=device)
    mapper = smpl_to_openpose()
    fwd = make_forward_fn(model)

    T = num_frames
    gt = model.zero_params(T)
    z = rng.randn(1, 32) * 0.3 + rng.randn(T, 32) * 0.05
    with torch.no_grad():
        body_pose = vp.decode(vposer_params, torch.as_tensor(
            z, dtype=torch.float32, device=device), "aa")
        if pose_scale != 1.0:
            body_pose = body_pose * pose_scale
        gt["body_pose"] = body_pose
        tx = 0.3 * np.sin(np.linspace(0, 2, T))
        gt["transl"] = torch.as_tensor(
            np.stack([tx, 0.3 * np.ones(T), 2.5 + 0.2 * np.cos(
                np.linspace(0, 1.5, T))], 1), dtype=torch.float32,
            device=device)
        gt["global_orient"] = torch.as_tensor(
            np.tile([[np.pi, 0, 0]], (T, 1)), dtype=torch.float32,
            device=device)                                  # face the camera
        out = fwd(gt, model.consts)
    verts = out["vertices"].cpu().numpy()                   # [T, V, 3]
    joints = out["joints"].cpu().numpy()
    body_pose = body_pose.cpu().numpy()
    gt = {k: v.cpu().numpy() for k, v in gt.items()}
    j2d = joints[:, mapper, :]
    j2d = j2d[:, :, :2] / j2d[:, :, 2:3] * np.array([FX, FY]) + \
        np.array([CX, CY])

    dfx = dfy = 365.0
    dcx, dcy = 256.0, 212.0
    tiny_color = np.zeros((8, 8, 3), np.uint8)
    marker_mask = np.ones((T, 67), np.float32)
    marker_mask[rng.rand(T, 67) < occlusion_frac] = 0.0

    frame_names = []
    for i in range(T):
        fn = f"s001_frame_{i + 1:05d}__00.00.{i:02d}.000"
        frame_names.append(fn)
        if color_format == "jpg":
            write_jpeg(osp.join(rec_dir, "Color", fn + ".jpg"), tiny_color)
        else:
            write_png(osp.join(rec_dir, "Color", fn + ".png"), tiny_color)
        if write_depth:
            v = verts[i]
            depth = _render_depth(v, dfx, dfy, dcx, dcy)
            write_png(osp.join(rec_dir, "Depth", fn + ".png"),
                      (depth / 1e-3 * 8.0).astype(np.uint16))
            uc = np.round(v[:, 0] / v[:, 2] * FX + CX).astype(int)
            wc = np.round(v[:, 1] / v[:, 2] * FY + CY).astype(int)
            okc = (uc >= 0) & (uc < COLOR_W) & (wc >= 0) & (wc < COLOR_H)
            mask = np.full((COLOR_H, COLOR_W), 255, np.uint8)
            if okc.any():
                x0, x1 = uc[okc].min(), uc[okc].max()
                y0, y1 = wc[okc].min(), wc[okc].max()
                mask[max(0, y0 - 10):y1 + 10, max(0, x0 - 10):x1 + 10] = 0
            write_png(osp.join(rec_dir, "BodyIndexColor", fn + ".png"), mask)
        with open(osp.join(keyp_dir, fn + "_keypoints.json"), "w") as fh:
            json.dump(_keypoints_json(j2d[i]), fh)

    proxd = osp.join(base_dir, "PROXD", recording_name, "results")
    for i, fn in enumerate(frame_names):
        os.makedirs(osp.join(proxd, fn), exist_ok=True)
        rec = {
            "transl": gt["transl"][i][None] + rng.randn(1, 3) * 0.03,
            "global_orient": gt["global_orient"][i][None]
            + rng.randn(1, 3) * 0.03,
            "betas": np.zeros((1, 10), np.float32),
            "body_pose": body_pose[i][None],
            "pose_embedding": z[i][None].astype(np.float32)
            + rng.randn(1, 32).astype(np.float32) * 0.05,
            "left_hand_pose": np.zeros((1, 12), np.float32),
            "right_hand_pose": np.zeros((1, 12), np.float32),
            "jaw_pose": np.zeros((1, 3), np.float32),
            "leye_pose": np.zeros((1, 3), np.float32),
            "reye_pose": np.zeros((1, 3), np.float32),
            "expression": np.zeros((1, 10), np.float32),
        }
        with open(osp.join(proxd, fn, "000.pkl"), "wb") as fh:
            pickle.dump(rec, fh, protocol=2)

    mm_dir = osp.join(base_dir, "mask_markers", recording_name)
    os.makedirs(mm_dir, exist_ok=True)
    np.save(osp.join(mm_dir, "mask_markers.npy"), marker_mask)

    return {
        "recording_dir": rec_dir,
        "recording_name": recording_name,
        "model_dict": md,
        "vposer_params": vposer_params,
        "gt_transl": gt["transl"],
        "gt_body_centroid": verts.mean(axis=1),
        "gt_pose_embedding": z.astype(np.float32),
        "gt_joints2d": j2d,
        "frame_names": frame_names,
        "R_c2w": R_c2w,
        "t_c2w": t_c2w,
    }
