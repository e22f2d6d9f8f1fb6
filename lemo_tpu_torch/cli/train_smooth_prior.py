"""Train the motion-smoothness prior on the port (the reference's
train_smooth_prior.py CLI; port of `lemo_tpu/cli/train_smooth_prior.py`):

  python -m lemo_tpu_torch.cli.train_smooth_prior \
      --amass_dir /path/to/AMASS --body_model_path /path/to/body_models

Builds the with-hand global-marker clip images of the AMASS train and
test splits, computes their statistics into
preprocess_stats/preprocess_stats_smooth_withHand_global_markers.npz
(relative to the working directory, as the reference), and trains the
Enc/Dec pair; writes <save_dir>/<run id>/{params.json,
Enc_last_model.npz, Dec_last_model.npz} and prints ``RUNDIR: <dir>``.
Runs on the CUDA card.
"""

from __future__ import annotations

import argparse
import os
import random

from lemo_tpu_torch.cli.opt_amass_perframe import smplx_model_dir


def _flag(x: str) -> bool:
    return x.lower() in ("true", "1")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--gpu_id", type=int, default=0)  # accepted, unused
    p.add_argument("--save_dir", type=str, default="runs_try")
    p.add_argument("--batch_size", type=int, default=60)
    p.add_argument("--num_workers", type=int, default=2)  # compat, unused
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--num_epoch", type=int, default=100000)
    p.add_argument("--log_step", type=int, default=500)
    p.add_argument("--save_step", type=int, default=1000)
    p.add_argument("--amass_dir", type=str, required=True)
    p.add_argument("--body_model_path", type=str, required=True)
    p.add_argument("--clip_seconds", type=int, default=4)
    p.add_argument("--body_mode", type=str, default="global_markers",
                   choices=["global_joints", "local_joints", "local_markers",
                            "global_markers"])
    p.add_argument("--with_hand", type=_flag, default=True)
    p.add_argument("--normalize", type=_flag, default=True)
    p.add_argument("--input_padding", type=_flag, default=True)
    p.add_argument("--downsample", type=_flag, default=False)
    p.add_argument("--z_channel", type=int, default=64)
    p.add_argument("--weight_loss_rec_v", type=float, default=1.0)
    p.add_argument("--weight_loss_z_smooth", type=float, default=1000.0)
    p.add_argument("--num_steps", type=int, default=None,
                   help="total optimizer steps (overrides num_epoch)")
    return p


def main(argv=None, device=None):
    """Train on `device` (None: the CUDA card; raises without it);
    returns (params, history)."""
    args = build_parser().parse_args(argv)

    import torch

    from lemo_tpu_torch import resolve_device
    from lemo_tpu_torch.data import amass
    from lemo_tpu_torch.priors.conv_ae import save_state_dict
    from lemo_tpu_torch.train import smooth as ts
    from lemo_tpu_torch.utils.logging import RunLogger

    dev = resolve_device(device)
    run_id = random.randint(1, 100000)
    logdir = os.path.join(args.save_dir, str(run_id))
    logger = RunLogger(logdir, vars(args))
    print(f"RUNDIR: {logdir}")

    builder = amass.AmassRepresentationBuilder(
        smplx_model_dir(args.body_model_path), with_hand=args.with_hand,
        device=dev)
    train_clips = amass.scan_amass(amass.AMASS_TRAIN_DATASETS,
                                   args.amass_dir, args.clip_seconds)
    test_clips = amass.scan_amass(amass.AMASS_TEST_DATASETS,
                                  args.amass_dir, args.clip_seconds)
    print(f"[INFO] {len(train_clips)} train / {len(test_clips)} test clips")
    images_tr, _ = amass.build_dataset(builder, train_clips, "global_markers",
                                       args.clip_seconds)
    images_te, _ = amass.build_dataset(builder, test_clips, "global_markers",
                                       args.clip_seconds)
    stats = amass.compute_or_load_stats(
        images_tr, "global_markers",
        "preprocess_stats/preprocess_stats_smooth_withHand_global_markers.npz"
        if args.with_hand else
        "preprocess_stats/preprocess_stats_smooth_global_markers.npz",
        "train", device=dev)

    def normalized(images):
        return stats.normalize(torch.as_tensor(images, device=dev)) \
            .cpu().numpy()

    images_tr = normalized(images_tr)
    images_te = normalized(images_te) if len(images_te) else None

    cfg = ts.SmoothTrainConfig(
        lr=args.lr, batch_size=args.batch_size, z_channel=args.z_channel,
        downsample=args.downsample, input_padding=args.input_padding,
        weight_loss_rec_v=args.weight_loss_rec_v,
        weight_loss_z_smooth=args.weight_loss_z_smooth)

    steps_per_epoch = max(len(images_tr) // args.batch_size, 1)
    num_steps = args.num_steps or args.num_epoch * steps_per_epoch

    def save(params):
        save_state_dict(params["enc"],
                        os.path.join(logdir, "Enc_last_model.npz"))
        save_state_dict(params["dec"],
                        os.path.join(logdir, "Dec_last_model.npz"))

    def callback(step, rec, params):
        logger.log_scalars("train", rec, step)
        if step % args.save_step < args.log_step:
            save(params)

    params, history = ts.train(images_tr, images_te, cfg, num_steps,
                               log_every=args.log_step, callback=callback,
                               device=dev)
    save(params)
    return params, history


if __name__ == "__main__":
    main()
