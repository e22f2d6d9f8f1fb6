"""Visualize fitted AMASS bodies and contact labels on the port (port of
`lemo_tpu/cli/vis_opt_amass.py`; reference vis_opt_amass.py, drawn
headless):

  python -m lemo_tpu_torch.cli.vis_opt_amass \
      --res_dir res_opt_amass_temp --body_model_path /path/to/body_models \
      --clip_id 0 --out vis_opt_amass.png

Decodes a Stage-2 clip's [T, 72] parameters (VPoser on the card),
rebuilds its bodies in one forward at B = T on the card
(`rebuild_markers`), and draws the markers with the contact labels
(`utils.viz.save_marker_animation`: the port's numpy painter, a png
of lemo_tpu's size, the same on the CPU and on the card's host).
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--res_dir", type=str, default="res_opt_amass_temp")
    p.add_argument("--dataset_name", type=str, default="TotalCapture")
    p.add_argument("--body_model_path", type=str, required=True)
    p.add_argument("--clip_id", type=int, default=0)
    p.add_argument("--out", type=str, default="vis_opt_amass.png")
    p.add_argument("--vposer_ckpt", type=str, default=None)
    return p


def rebuild_markers(args, device):
    """(markers [T, 67, 3] host numpy, contact labels [T, 4]) of clip
    `--clip_id`: its parameters decoded with VPoser (`--vposer_ckpt`, or
    seeded random weights) and its bodies rebuilt in one forward on
    `device`."""
    import torch

    from lemo_tpu_torch.body_model import load_model, make_forward_fn
    from lemo_tpu_torch.body_model import vposer as vp
    from lemo_tpu_torch.body_model.smplx import find_smplx_npz
    from lemo_tpu_torch.data.markers import marker_indices
    from lemo_tpu_torch.fitting import params as P

    folder = os.path.join(args.res_dir, args.dataset_name)
    params72 = np.load(os.path.join(
        folder, f"body_params_opt_clip_{args.clip_id}.npy"))
    contact = np.load(os.path.join(
        folder, f"contact_lbl_rec_clip_{args.clip_id}.npy"))
    genders = np.load(os.path.join(folder, "gender_list.npy"))
    gender = "male" if genders[args.clip_id] == 1 else "female"

    model = load_model(find_smplx_npz(args.body_model_path, gender),
                       gender=gender, use_pca=True, num_pca_comps=12,
                       device=device)
    if args.vposer_ckpt:
        from lemo_tpu_torch.priors.conv_ae import load_torch_state_dict

        vposer_params = load_torch_state_dict(args.vposer_ckpt,
                                              model.device)
    else:
        vposer_params = vp.init_vposer(torch.Generator().manual_seed(0),
                                       device=model.device)
    with torch.no_grad():
        sp = P.smplx_params_from_72(
            torch.as_tensor(params72, dtype=torch.float32,
                            device=model.device), vposer_params)
        verts = make_forward_fn(model)(sp, model.consts)["vertices"]
    ids = marker_indices(False, num_verts=model.num_verts)
    return verts.cpu().numpy()[:, ids, :], contact


def main(argv=None, device=None):
    """`device`: None means the CUDA card. Returns the sheet's path."""
    from lemo_tpu_torch import resolve_device
    from lemo_tpu_torch.utils.viz import save_marker_animation

    args = build_parser().parse_args(argv)
    markers, contact = rebuild_markers(args, resolve_device(device))
    out = save_marker_animation(markers, args.out, contact)
    print(f"saved {out}")
    return out


if __name__ == "__main__":
    main()
