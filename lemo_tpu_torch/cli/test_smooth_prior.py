"""Smoothness-prior evaluation on the port (the reference's
test_smooth_prior.py; port of `lemo_tpu/cli/test_smooth_prior.py`):

  python -m lemo_tpu_torch.cli.test_smooth_prior \
      --amass_dir /path/to/AMASS --body_model_path /path/to/body_models \
      --enc_path RUNDIR/Enc_last_model.npz --dec_path RUNDIR/Dec_last_model.npz \
      --stats_path preprocess_stats/preprocess_stats_smooth_withHand_global_markers.npz

Encodes and decodes held-out velocity clips (the AMASS test split),
integrates the velocities back and prints each clip's reconstruction
error in normalized units and their mean. Runs on the CUDA card.
"""

from __future__ import annotations

import argparse

import numpy as np

from lemo_tpu_torch.cli.opt_amass_perframe import load_weights, \
    smplx_model_dir
from lemo_tpu_torch.cli.train_smooth_prior import _flag


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--amass_dir", type=str, required=True)
    p.add_argument("--body_model_path", type=str, required=True)
    p.add_argument("--enc_path", type=str, required=True)
    p.add_argument("--dec_path", type=str, required=True)
    p.add_argument("--stats_path", type=str, required=True)
    p.add_argument("--clip_seconds", type=int, default=4)
    p.add_argument("--with_hand", type=_flag, default=True)
    p.add_argument("--num_clips", type=int, default=4)
    p.add_argument("--out", type=str, default=None)
    return p


def main(argv=None, device=None):
    """Evaluate on `device` (None: the CUDA card; raises without it);
    returns the per-clip errors."""
    args = build_parser().parse_args(argv)

    import torch

    from lemo_tpu_torch import exact_f32_matmuls, resolve_device
    from lemo_tpu_torch.data import amass
    from lemo_tpu_torch.data.stats import GlobalStats
    from lemo_tpu_torch.ops.signal import reflect_pad_dt, unpad_dt
    from lemo_tpu_torch.priors.conv_ae import smooth_dec_forward, \
        smooth_enc_forward

    dev = resolve_device(device)
    exact_f32_matmuls()
    enc = load_weights(args.enc_path, dev)
    dec = load_weights(args.dec_path, dev)
    stats = GlobalStats.load(args.stats_path, dev)

    builder = amass.AmassRepresentationBuilder(
        smplx_model_dir(args.body_model_path), with_hand=args.with_hand,
        device=dev)
    clips = amass.scan_amass(amass.AMASS_TEST_DATASETS, args.amass_dir,
                             args.clip_seconds)[: args.num_clips]
    images, _ = amass.build_dataset(builder, clips, "global_markers",
                                    args.clip_seconds)
    images = stats.normalize(torch.as_tensor(images, device=dev))

    errors = []
    with torch.no_grad():
        for img in images:
            x = img.T[None, None]                       # [1, 1, d, T]
            v = x[..., 1:] - x[..., :-1]
            z, sizes = smooth_enc_forward(enc, reflect_pad_dt(v))
            rec = unpad_dt(smooth_dec_forward(dec, z, sizes))
            # integrate the velocities back from frame 0
            # (test_smooth_prior.py:133)
            rec_clip = torch.cumsum(torch.cat([x[..., :1], rec], dim=-1),
                                    dim=-1)
            err = float((rec_clip - x).abs().mean())
            errors.append(err)
            print(f"clip rec error (normalized units): {err:.4f}")
    print(f"mean: {np.mean(errors):.4f}")
    return errors


if __name__ == "__main__":
    main()
