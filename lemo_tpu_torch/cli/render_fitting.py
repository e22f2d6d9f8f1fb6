"""Render PROX fitting results on the port (port of
`lemo_tpu/cli/render_fitting.py`; reference temp_prox/renderer.py +
viz/viz_fitting.py):

  python -m lemo_tpu_torch.cli.render_fitting \
      --fitting_dir out/N3OpenArea_00157_01 \
      --model_folder /path/to/body_models \
      --recording_dir /path/to/PROX/recordings/N3OpenArea_00157_01 \
      --rendering_mode both

Loads the per-frame result pkls, rebuilds the bodies on the card, and
saves (a) a marker animation sheet (`fitting_frames.png`, drawn by the
port's numpy painter, `utils.viz`), (b) body-over-Color-frame overlays,
the reference's `<frame>_output.png` (renderer.py:60-140), and (c) the
body inside the scene mesh, `<frame>_scene.png` (rendering_mode '3d'),
both through the host software rasterizer (`utils.raster`). Color
frames are read as `<frame>.jpg`, else `<frame>.png`
(`data.png.read_color_frame`: the port's own PNG and JPEG decoders,
cv2's colour mode bit for bit); a Color folder holding a JPEG that the
decoder refuses (lossless, hierarchical, arithmetic-coded, 12-bit,
4-component, or progressive with its scans incomplete) is refused before
the bodies are rebuilt. Each step is a function of its own, which `main`
calls in this order.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--fitting_dir", type=str, required=True,
                   help="output folder of main_slide (contains results/)")
    p.add_argument("--model_folder", type=str, required=True)
    p.add_argument("--recording_dir", type=str, default=None,
                   help="PROX recording dir (for Color frames); overlay "
                        "renders are skipped when absent")
    p.add_argument("--gender", type=str, default="male")
    p.add_argument("--start", type=int, default=0)
    p.add_argument("--step", type=int, default=10)
    p.add_argument("--count", type=int, default=8)
    p.add_argument("--out_dir", type=str, default=None)
    p.add_argument("--vposer_ckpt", type=str, default=None)
    p.add_argument("--flip", type=lambda x: x.lower() in ("true", "1"),
                   default=True,
                   help="flip Color frames horizontally like the "
                        "reference renderer (PROX fits mirrored frames)")
    p.add_argument("--body_color", type=str, default="pink",
                   choices=["pink", "white"])
    p.add_argument("--rendering_mode", type=str, default="body",
                   choices=["body", "3d", "both"],
                   help="'body' = body-over-Color overlays "
                        "(<frame>_output.png); '3d' = body inside the "
                        "scene mesh (<frame>_scene.png, reference "
                        "renderer.py rendering_mode='3d'); 'both' = both")
    p.add_argument("--fx", type=float, default=1060.53)
    p.add_argument("--fy", type=float, default=1060.38)
    p.add_argument("--cx", type=float, default=951.30)
    p.add_argument("--cy", type=float, default=536.77)
    return p


def rebuild_bodies(args, device):
    """The frames `--start/--step/--count` select from <fitting_dir>/
    results and their bodies, rebuilt in one forward on `device`:
    (frame names, vertices [N, V, 3] host numpy, faces [F, 3], the
    model's vertex count). No frames: ([], None, None, None)."""
    import torch

    from lemo_tpu_torch.body_model import load_model, make_forward_fn
    from lemo_tpu_torch.body_model.smplx import find_smplx_npz
    from lemo_tpu_torch.data.prox import read_prox_pkl

    res_dir = osp.join(args.fitting_dir, "results")
    frames = sorted(os.listdir(res_dir))[args.start::args.step][: args.count]
    if not frames:
        return [], None, None, None
    model = load_model(find_smplx_npz(args.model_folder, args.gender),
                       gender=args.gender, use_pca=True, num_pca_comps=12,
                       device=device)
    records = [read_prox_pkl(osp.join(res_dir, fn, "000.pkl"))
               for fn in frames]
    params = model.zero_params(len(records))
    for k in ("transl", "global_orient", "betas", "left_hand_pose",
              "right_hand_pose", "jaw_pose", "leye_pose", "reye_pose",
              "expression", "body_pose"):
        if k in records[0] and k in params or k == "body_pose":
            params[k] = torch.as_tensor(np.stack([r[k] for r in records]),
                                        device=model.device)
    with torch.no_grad():
        out = make_forward_fn(model)(params, model.consts)
    return (frames, out["vertices"].cpu().numpy(), np.asarray(model.faces),
            model.num_verts)


def draw_marker_sheet(verts, num_verts: int, frames, out_dir: str) -> str:
    """The 67 markers of each frame on one sheet (`utils.viz`)."""
    from lemo_tpu_torch.data.markers import marker_indices
    from lemo_tpu_torch.utils.viz import save_marker_animation

    ids = marker_indices(False, num_verts=num_verts)
    return save_marker_animation(verts[:, ids, :],
                                 osp.join(out_dir, "fitting_frames.png"),
                                 stride=1, max_frames=len(frames))


def _body_color(args):
    from lemo_tpu_torch.utils.raster import PINK

    return PINK if args.body_color == "pink" else (0.7, 0.7, 0.7)


def write_overlays(args, frames, verts, faces, out_dir: str) -> int:
    """Body-over-Color overlays, <out_dir>/<frame>_output.png
    (renderer.py:110-133), for each frame with a Color image; returns how
    many were written."""
    from lemo_tpu_torch.data.png import read_color_frame, write_png
    from lemo_tpu_torch.utils.raster import render_body_overlay

    color_dir = osp.join(args.recording_dir, "Color")
    n_saved = 0
    for i, fn in enumerate(frames):
        img_path = None
        for ext in (".jpg", ".png"):
            cand = osp.join(color_dir, fn + ext)
            if osp.exists(cand):
                img_path = cand
                break
        if img_path is None:
            continue
        img = read_color_frame(img_path)
        if args.flip:
            img = img[:, ::-1]
        over = render_body_overlay(verts[i], faces, img, args.fx, args.fy,
                                   args.cx, args.cy, color=_body_color(args))
        write_png(osp.join(out_dir, fn + "_output.png"), over)
        n_saved += 1
    return n_saved


def write_scene_renders(args, frames, verts, faces, out_dir: str) -> int:
    """The body inside the scene mesh from the fitting camera,
    <out_dir>/<frame>_scene.png (renderer.py:134-151: the scene mesh
    moved into camera coordinates by inv(cam2world)); returns how many
    were written (0 when the scene ply has no faces)."""
    from lemo_tpu_torch.data.png import write_png
    from lemo_tpu_torch.data.prox import ProxRecording
    from lemo_tpu_torch.utils.raster import render_body_in_scene

    rec = ProxRecording.from_recording_dir(args.recording_dir)
    scene_v, scene_f = rec.load_scene_mesh_full()
    if scene_f is None:
        print("scene ply has no faces; skipping 3d renders")
        return 0
    Rw, tw = rec.load_cam2world()
    scene_cam = (scene_v - tw) @ Rw  # world -> camera
    H, W = int(round(2 * args.cy)), int(round(2 * args.cx))
    for i, fn in enumerate(frames):
        img = render_body_in_scene(
            verts[i], faces, scene_cam, scene_f, W, H, args.fx, args.fy,
            args.cx, args.cy, body_color=_body_color(args))
        write_png(osp.join(out_dir, fn + "_scene.png"), img)
    return len(frames)


def main(argv=None, device=None):
    """`device`: None means the CUDA card (the body rebuild runs there;
    the rasterizer on the host)."""
    from lemo_tpu_torch import resolve_device
    from lemo_tpu_torch.data.png import check_color_frames

    args = build_parser().parse_args(argv)
    if args.recording_dir and args.rendering_mode in ("body", "both"):
        check_color_frames(osp.join(args.recording_dir, "Color"))
    frames, verts, faces, num_verts = rebuild_bodies(args,
                                                     resolve_device(device))
    if not frames:
        print("no result pkls found")
        return
    out_dir = args.out_dir or osp.join(args.fitting_dir, "renderings")
    os.makedirs(out_dir, exist_ok=True)
    print(f"saved {draw_marker_sheet(verts, num_verts, frames, out_dir)}")
    if args.recording_dir and args.rendering_mode in ("body", "both"):
        n = write_overlays(args, frames, verts, faces, out_dir)
        print(f"saved {n} overlay renders to {out_dir}")
    if args.recording_dir and args.rendering_mode in ("3d", "both"):
        n = write_scene_renders(args, frames, verts, faces, out_dir)
        if n:
            print(f"saved {n} body-in-scene renders to {out_dir}")


if __name__ == "__main__":
    main()
