"""Per-frame marker occlusion masks for a fitted PROX recording on the
port (port of `lemo_tpu/cli/get_occlusion_mask.py`; reference
utils/get_occlusion_mask.py):

  python -m lemo_tpu_torch.cli.get_occlusion_mask \
      --fitting_dir out/N3OpenArea_00157_01 \
      --recording_dir /path/to/PROX/recordings/N3OpenArea_00157_01 \
      --model_folder /path/to/body_models --out_dir masks/

Given the fitted body pkls and the scene, mark the markers whose
projected depth lies behind the scene. The reference renders scene depth
with pyrender; here the scene's point cloud (sampled from the SDF's zero
crossing, or given) is splatted into a z-buffer on the card
(`utils.occlusion_mask`), after one body forward of all frames.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--fitting_dir", type=str, required=True,
                   help="PROXD-style folder with results/<frame>/000.pkl")
    p.add_argument("--recording_dir", type=str, required=True)
    p.add_argument("--model_folder", type=str, required=True)
    p.add_argument("--gender", type=str, default="male")
    p.add_argument("--scene_points", type=str, default=None,
                   help="npy [N,3] scene points in world coords; defaults "
                        "to SDF zero-crossing samples")
    p.add_argument("--out_dir", type=str, required=True)
    p.add_argument("--margin", type=float, default=0.1)
    return p


def scene_points_from_sdf(sdf, grid_min, grid_max, thresh=0.02,
                          max_points=200000):
    """Sample near-surface points of the scene from its SDF grid."""
    D = sdf.shape[0]
    idx = np.argwhere(np.abs(sdf) < thresh)
    if len(idx) > max_points:
        pick = np.random.RandomState(0).choice(len(idx), max_points,
                                               replace=False)
        idx = idx[pick]
    cell = (grid_max - grid_min) / D
    return grid_min + (idx + 0.5) * cell


def fitted_markers(fitting_dir: str, model_folder: str, gender: str,
                   device):
    """The 67 markers of every fitted frame in camera coordinates,
    [frames, 67, 3] on `device`, from one body forward of all frames;
    and the frame names."""
    import torch

    from lemo_tpu_torch.body_model import load_model, make_forward_fn
    from lemo_tpu_torch.body_model.smplx import find_smplx_npz
    from lemo_tpu_torch.data.markers import marker_indices
    from lemo_tpu_torch.data.prox import read_prox_pkl

    model = load_model(find_smplx_npz(model_folder, gender), gender=gender,
                       use_pca=True, num_pca_comps=12, device=device)
    fwd = make_forward_fn(model)
    ids = torch.as_tensor(marker_indices(False, num_verts=model.num_verts),
                          device=model.device)
    res_dir = osp.join(fitting_dir, "results")
    frames = sorted(os.listdir(res_dir))
    records = [read_prox_pkl(osp.join(res_dir, fn, "000.pkl"))
               for fn in frames]
    params = model.zero_params(len(records))
    for k in list(params.keys()) + ["body_pose"]:
        if k in records[0]:
            params[k] = torch.as_tensor(np.stack([r[k] for r in records]),
                                        device=model.device)
    with torch.no_grad():
        out = fwd(params, model.consts)
    return out["vertices"].index_select(1, ids), frames


def main(argv=None, device=None):
    """Write <out_dir>/mask_markers.npy ([frames, 67] float32, 1 visible)
    and return the mask. `device`: None means the CUDA card."""
    import torch

    from lemo_tpu_torch import resolve_device
    from lemo_tpu_torch.data.prox import ProxRecording
    from lemo_tpu_torch.utils.occlusion_mask import marker_occlusion_mask

    args = build_parser().parse_args(argv)
    dev = resolve_device(device)
    rec = ProxRecording.from_recording_dir(args.recording_dir)
    R, t = rec.load_cam2world()
    if args.scene_points:
        pts_world = np.load(args.scene_points)
    else:
        sdf, lo, hi, _ = rec.load_sdf()
        pts_world = scene_points_from_sdf(sdf, lo, hi)
    # world -> camera: x_c = R^T (x_w - t)
    pts_cam = (pts_world - t) @ R

    markers_cam, frames = fitted_markers(args.fitting_dir,
                                         args.model_folder, args.gender, dev)
    mask = marker_occlusion_mask(
        markers_cam, torch.as_tensor(pts_cam, dtype=torch.float32,
                                     device=dev),
        fx=1060.53, fy=1060.38, cx=951.30, cy=536.77,
        margin=args.margin).cpu().numpy()
    os.makedirs(args.out_dir, exist_ok=True)
    path = osp.join(args.out_dir, "mask_markers.npy")
    np.save(path, mask)
    occluded = float(1.0 - mask.mean())
    print(f"saved {path} ({len(frames)} frames, "
          f"{occluded * 100:.1f}% marker-frames occluded)")
    return mask


if __name__ == "__main__":
    main()
