"""Train the motion-infilling prior on the port (the reference's
train_infill_prior.py CLI; port of `lemo_tpu/cli/train_infill_prior.py`):

  python -m lemo_tpu_torch.cli.train_infill_prior \
      --amass_dir /path/to/AMASS --body_model_path /path/to/body_models \
      --mask_markers_dir mask_markers

Builds the local_markers_4chan clip images of the AMASS train split,
computes their statistics into
preprocess_stats/preprocess_stats_infill_local_markers_4chan.npz
(relative to the working directory, as the reference), and trains the
4-channel AE with the masking curriculum (random markers, then the PROX
occlusion masks under --mask_markers_dir when it exists); writes
<save_dir>/<run id>/{params.json, AE_last_model.npz} and prints
``RUNDIR: <dir>``. Runs on the CUDA card.
"""

from __future__ import annotations

import argparse
import os
import random

import numpy as np

from lemo_tpu_torch.cli.opt_amass_perframe import smplx_model_dir
from lemo_tpu_torch.cli.train_smooth_prior import _flag


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--gpu_id", type=int, default=0)
    p.add_argument("--save_dir", type=str, default="runs_try")
    p.add_argument("--batch_size", type=int, default=120)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--num_epoch", type=int, default=100000)
    p.add_argument("--log_step", type=int, default=500)
    p.add_argument("--save_step", type=int, default=1000)
    p.add_argument("--amass_dir", type=str, required=True)
    p.add_argument("--body_model_path", type=str, required=True)
    p.add_argument("--mask_markers_dir", type=str, default="mask_markers")
    p.add_argument("--clip_seconds", type=int, default=4)
    p.add_argument("--body_mode", type=str, default="local_markers_4chan",
                   choices=["local_markers", "local_markers_4chan"])
    p.add_argument("--conv_k", type=int, default=3)
    p.add_argument("--downsample", type=_flag, default=True)
    p.add_argument("--normalize", type=_flag, default=True)
    p.add_argument("--input_padding", type=_flag, default=True)
    p.add_argument("--weight_loss_rec_body", type=float, default=10.0)
    p.add_argument("--weight_loss_rec_body_v", type=float, default=10.0)
    p.add_argument("--weight_loss_rec_contact_lbl", type=float, default=1.0)
    p.add_argument("--num_steps", type=int, default=None)
    return p


def load_prox_masks(mask_dir: str, clip_len: int = 120,
                    min_mask_ratio: float = 0.05) -> np.ndarray | None:
    """The PROX occlusion-mask curriculum data
    (train_infill_prior.py:112-126): each recording's mask_markers.npy
    cut into clips, the clips with at least 5% occluded entries kept,
    each row repeated x3."""
    if not os.path.isdir(mask_dir):
        return None
    out = []
    for rec in sorted(os.listdir(mask_dir)):
        path = os.path.join(mask_dir, rec, "mask_markers.npy")
        if not os.path.exists(path):
            continue
        m = np.load(path)
        for i in range(len(m) // clip_len):
            clip = m[i * clip_len:(i + 1) * clip_len]
            ratio = 1.0 - clip.sum() / clip.size
            if ratio >= min_mask_ratio:
                out.append(np.repeat(clip, 3, axis=1))
    return np.asarray(out, np.float32) if out else None


def main(argv=None, device=None):
    """Train on `device` (None: the CUDA card; raises without it);
    returns (params, history)."""
    args = build_parser().parse_args(argv)

    import torch

    from lemo_tpu_torch import resolve_device
    from lemo_tpu_torch.data import amass
    from lemo_tpu_torch.priors.conv_ae import save_state_dict
    from lemo_tpu_torch.train import infill as ti
    from lemo_tpu_torch.utils.logging import RunLogger

    dev = resolve_device(device)
    run_id = random.randint(1, 100000)
    logdir = os.path.join(args.save_dir, str(run_id))
    logger = RunLogger(logdir, vars(args))
    print(f"RUNDIR: {logdir}")

    builder = amass.AmassRepresentationBuilder(
        smplx_model_dir(args.body_model_path), with_hand=False, device=dev)
    train_clips = amass.scan_amass(amass.AMASS_TRAIN_DATASETS,
                                   args.amass_dir, args.clip_seconds)
    print(f"[INFO] {len(train_clips)} train clips")
    images, _ = amass.build_dataset(builder, train_clips,
                                    "local_markers_4chan", args.clip_seconds)
    stats = amass.compute_or_load_stats(
        images, "local_markers_4chan",
        "preprocess_stats/preprocess_stats_infill_local_markers_4chan.npz",
        "train", device=dev)
    images = stats.normalize(torch.as_tensor(images, device=dev)) \
        .cpu().numpy()

    prox_masks = load_prox_masks(args.mask_markers_dir)
    cfg = ti.InfillTrainConfig(
        lr=args.lr, batch_size=args.batch_size, conv_k=args.conv_k,
        input_padding=args.input_padding,
        weight_loss_rec_body=args.weight_loss_rec_body,
        weight_loss_rec_body_v=args.weight_loss_rec_body_v,
        weight_loss_rec_contact_lbl=args.weight_loss_rec_contact_lbl)

    steps_per_epoch = max(len(images) // args.batch_size, 1)
    num_steps = args.num_steps or args.num_epoch * steps_per_epoch
    ckpt = os.path.join(logdir, "AE_last_model.npz")

    def callback(step, rec, params):
        logger.log_scalars("train", rec, step)
        if step % args.save_step < args.log_step:
            save_state_dict(params, ckpt)

    params, history = ti.train(images, cfg, num_steps,
                               prox_masks=prox_masks,
                               steps_per_epoch=steps_per_epoch,
                               log_every=args.log_step, callback=callback,
                               device=dev)
    save_state_dict(params, ckpt)
    return params, history


if __name__ == "__main__":
    main()
