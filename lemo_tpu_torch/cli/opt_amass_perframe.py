"""AMASS Stage-1 fitting CLI on the port (the reference's
opt_amass_perframe.py surface; port of
`lemo_tpu/cli/opt_amass_perframe.py`):

  python -m lemo_tpu_torch.cli.opt_amass_perframe \
      --amass_dir /path/to/AMASS --body_model_path /path/to/body_models \
      --dataset_name TotalCapture --save_dir res_opt_amass_perframe

Writes per clip ``body_params_opt_clip_<i>.npy`` [T, 72] and
``contact_lbl_rec_clip_<i>.npy`` [T, 4], and ``gender_list.npy``, under
<save_dir>/<dataset_name>/. The infill AE and its statistics default to
the port's shipped copies. Without --vposer_ckpt, VPoser is drawn from a
seeded torch.Generator: random weights, not those of `lemo_tpu`'s
PRNG-seeded default. Runs on the CUDA card.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

_ASSET_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets")
INFILL_AE = os.path.join(_ASSET_DIR, "infill_ae.npz")
INFILL_STATS = os.path.join(_ASSET_DIR, "infill_stats.npz")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--amass_dir", type=str, required=True)
    p.add_argument("--body_model_path", type=str, required=True)
    p.add_argument("--clip_seconds", type=int, default=4)
    p.add_argument("--body_mode", type=str, default="local_markers_4chan",
                   choices=["local_markers", "local_markers_4chan"])
    p.add_argument("--conv_k", type=int, default=3)
    p.add_argument("--infill_model_path", type=str, default=INFILL_AE)
    p.add_argument("--start", type=int, default=0)
    p.add_argument("--end", type=int, default=100)
    p.add_argument("--step", type=int, default=20)
    p.add_argument("--dataset_name", type=str, default="TotalCapture")
    p.add_argument("--save_dir", type=str, default="res_opt_amass_perframe")
    p.add_argument("--weight_loss_rec_markers", type=float, default=1.0)
    p.add_argument("--weight_loss_vposer", type=float, default=0.02)
    p.add_argument("--weight_loss_shape", type=float, default=0.01)
    p.add_argument("--weight_loss_hand", type=float, default=0.01)
    p.add_argument("--fit_mode", type=str, default="parallel",
                   choices=["parallel", "sequential"],
                   help="parallel: all frames of a clip in one batched "
                        "fit; sequential: the reference's warm-started "
                        "chain over frames")
    p.add_argument("--num_fit_steps", type=int, default=100)
    p.add_argument("--stats_path", type=str, default=INFILL_STATS)
    p.add_argument("--vposer_ckpt", type=str, default=None)
    return p


def load_weights(path: str, device):
    """A torch state-dict checkpoint, or an npz of the same keys."""
    from lemo_tpu_torch.priors.conv_ae import load_state_dict_npz, \
        load_torch_state_dict

    return (load_state_dict_npz(path, device) if path.endswith(".npz")
            else load_torch_state_dict(path, device))


def load_vposer(path: str | None, device):
    """VPoser from `path`, or seeded random weights without one."""
    import torch

    from lemo_tpu_torch.body_model import vposer as vp

    if path:
        return load_weights(path, device)
    return vp.init_vposer(torch.Generator().manual_seed(0), device=device)


def smplx_model_dir(body_model_path: str) -> str:
    """The builder's model directory: <path>/smplx_model when present."""
    d = os.path.join(body_model_path, "smplx_model")
    return d if os.path.isdir(d) else body_model_path


def fitting_models(body_model_path: str, device) -> dict:
    """The fitters' gendered models (PCA hands, 12 components)."""
    from lemo_tpu_torch.body_model import load_model
    from lemo_tpu_torch.body_model.smplx import find_smplx_npz

    return {g: load_model(find_smplx_npz(body_model_path, g), gender=g,
                          use_pca=True, num_pca_comps=12, device=device)
            for g in ("male", "female")}


def load_clips(args, stats, device):
    """Scan the dataset and build its normalized fitting images
    [N, 4, T-1, d] (unsmoothed forward, the fitting loader's variant)
    with their aux (rot_0_pivot, betas, gender)."""
    from lemo_tpu_torch.data import amass

    builder = amass.AmassRepresentationBuilder(
        smplx_model_dir(args.body_model_path), with_hand=False,
        device=device)
    clips = amass.scan_amass([args.dataset_name], args.amass_dir,
                             args.clip_seconds)
    images, aux = amass.build_dataset(builder, clips, "local_markers_4chan",
                                      args.clip_seconds,
                                      smooth_forward=False)
    return stats.normalize(_tensor(images, device)), aux, len(clips)


def _tensor(x, device):
    import torch

    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def infill_clip(ae, image_n, stats, rot_0_pivot):
    """One clip's infill inference: (marker targets [T-1, 67, 3], contact
    labels [T-1, 4]) from its normalized image [4, T-1, d]."""
    from lemo_tpu_torch.fitting import amass_perframe as s1
    from lemo_tpu_torch.fitting import infill as fi

    clip_img = image_n.transpose(1, 2)[None]                # [1, 4, d, T]
    mask = _tensor(fi.amass_input_mask(clip_img.shape[2], clip_img.shape[3]),
                   image_n.device)
    rec, _, _ = fi.infill_infer(ae, clip_img, mask, finetune_steps=60,
                                finetune_lr=3e-6)
    contact = fi.contact_labels_from_rec(rec)[0]
    targets = s1.reconstruct_marker_targets(
        rec[0], clip_img[0], stats, _tensor(rot_0_pivot, image_n.device))
    return targets, contact


def main(argv=None, device=None):
    """Run Stage 1 on `device` (None: the CUDA card; raises without it)."""
    args = build_parser().parse_args(argv)

    from lemo_tpu_torch import resolve_device
    from lemo_tpu_torch.data.markers import marker_indices
    from lemo_tpu_torch.data.stats import Local4ChanStats
    from lemo_tpu_torch.fitting import amass_perframe as s1

    dev = resolve_device(device)
    ae = load_weights(args.infill_model_path, dev)
    stats = Local4ChanStats.load(args.stats_path, dev)
    vposer_params = load_vposer(args.vposer_ckpt, dev)
    images_n, aux, n_clips = load_clips(args, stats, dev)
    models = fitting_models(args.body_model_path, dev)
    marker_ids = marker_indices(False)

    save_folder = os.path.join(args.save_dir, args.dataset_name)
    os.makedirs(save_folder, exist_ok=True)
    np.save(os.path.join(save_folder, "gender_list.npy"), aux["gender"])

    weights = s1.Stage1Weights(args.weight_loss_rec_markers,
                               args.weight_loss_vposer,
                               args.weight_loss_shape,
                               args.weight_loss_hand)
    # one fitter per gender, reused across clips
    fitters = ({g: s1.make_stage1_fitter(m, vposer_params, marker_ids,
                                         args.num_fit_steps, weights,
                                         device=dev)
                for g, m in models.items()}
               if args.fit_mode == "parallel" else None)

    for i in range(args.start, min(args.end, n_clips), args.step):
        targets, contact = infill_clip(ae, images_n[i], stats,
                                       aux["rot_0_pivot"][i])
        np.save(os.path.join(save_folder, f"contact_lbl_rec_clip_{i}.npy"),
                contact.cpu().numpy())
        gender = "male" if aux["gender"][i] == 1 else "female"
        if fitters is not None:
            fitted, _ = fitters[gender](targets, aux["betas"][i])
        else:
            fitted, _ = s1.fit_clip(models[gender], vposer_params,
                                    marker_ids, targets, aux["betas"][i],
                                    mode=args.fit_mode,
                                    num_steps=args.num_fit_steps,
                                    weights=weights, device=dev)
        np.save(os.path.join(save_folder, f"body_params_opt_clip_{i}.npy"),
                fitted.cpu().numpy())
        print(f"[clip {i}] saved ({fitted.shape[0]} frames)")


if __name__ == "__main__":
    main()
