"""AMASS Stage-2 temporal fitting CLI on the port (the reference's
opt_amass_temp.py surface; port of `lemo_tpu/cli/opt_amass_temp.py`):

  python -m lemo_tpu_torch.cli.opt_amass_temp \
      --amass_dir /path/to/AMASS --body_model_path /path/to/body_models \
      --smooth_model_path /path/to/Enc_last_model.pkl \
      --smooth_stats_path /path/to/preprocess_stats_smooth_withHand_global_markers.npz \
      --perframe_res_dir res_opt_amass_perframe --clip_batch 4

Refines the Stage-1 results under the learned smoothness prior and
contact friction; writes per clip ``body_params_opt_clip_<i>.npy``
[T, 72] and ``contact_lbl_rec_clip_<i>.npy`` [T, 4], and
``gender_list.npy``, under <save_dir>/<dataset_name>/. With
--clip_batch C > 1, C clips of one (gender, frame count) are fitted
together, folded into one forward of C*T frames. The infill AE and its
statistics default to the port's shipped copies; the smoothness prior
and its statistics are not shipped. Runs on the CUDA card.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from lemo_tpu_torch.cli.opt_amass_perframe import INFILL_AE, INFILL_STATS


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--amass_dir", type=str, required=True)
    p.add_argument("--body_model_path", type=str, required=True)
    p.add_argument("--clip_seconds", type=int, default=4)
    p.add_argument("--body_mode", type=str, default="local_markers_4chan")
    p.add_argument("--infill_model_path", type=str, default=INFILL_AE)
    p.add_argument("--conv_k", type=int, default=3)
    p.add_argument("--smooth_model_path", type=str,
                   default="runs/15217/Enc_last_model.pkl")
    p.add_argument("--start", type=int, default=0)
    p.add_argument("--end", type=int, default=100)
    p.add_argument("--step", type=int, default=20)
    p.add_argument("--dataset_name", type=str, default="TotalCapture")
    p.add_argument("--perframe_res_dir", type=str,
                   default="res_opt_amass_perframe")
    p.add_argument("--save_dir", type=str, default="res_opt_amass_temp")
    p.add_argument("--weight_loss_rec_markers", type=float, default=1.0)
    p.add_argument("--weight_loss_contact_vel", type=float, default=0.03)
    p.add_argument("--weight_loss_smooth", type=float, default=1e6)
    p.add_argument("--weight_loss_vposer", type=float, default=0.02)
    p.add_argument("--weight_loss_shape", type=float, default=0.01)
    p.add_argument("--weight_loss_hand", type=float, default=0.01)
    p.add_argument("--num_fit_steps", type=int, default=100)
    p.add_argument("--clip_batch", type=int, default=1,
                   help="fit this many clips together, folded into one "
                        "forward of clip_batch*T frames. Clips are grouped "
                        "by (gender, frame count), and the last batch of a "
                        "group is padded with copies of its last clip")
    p.add_argument("--stats_path", type=str, default=INFILL_STATS)
    p.add_argument("--smooth_stats_path", type=str,
                   default="preprocess_stats/"
                           "preprocess_stats_smooth_withHand_global_markers.npz")
    p.add_argument("--vposer_ckpt", type=str, default=None)
    return p


def main(argv=None, device=None):
    """Run Stage 2 on `device` (None: the CUDA card; raises without it)."""
    args = build_parser().parse_args(argv)

    import torch

    from lemo_tpu_torch import resolve_device
    from lemo_tpu_torch.cli import opt_amass_perframe as cli1
    from lemo_tpu_torch.data.markers import marker_indices
    from lemo_tpu_torch.data.segments import foot_vertex_ids
    from lemo_tpu_torch.data.stats import GlobalStats, Local4ChanStats
    from lemo_tpu_torch.fitting import amass_temp as s2

    dev = resolve_device(device)
    ae = cli1.load_weights(args.infill_model_path, dev)
    enc = cli1.load_weights(args.smooth_model_path, dev)
    stats = Local4ChanStats.load(args.stats_path, dev)
    smooth_stats = GlobalStats.load(args.smooth_stats_path, dev)
    vposer_params = cli1.load_vposer(args.vposer_ckpt, dev)
    images_n, aux, n_clips = cli1.load_clips(args, stats, dev)
    models = cli1.fitting_models(args.body_model_path, dev)
    ids67, ids81 = marker_indices(False), marker_indices(True)
    feet = foot_vertex_ids(next(iter(models.values())).num_verts)

    save_folder = os.path.join(args.save_dir, args.dataset_name)
    os.makedirs(save_folder, exist_ok=True)
    np.save(os.path.join(save_folder, "gender_list.npy"), aux["gender"])

    weights = s2.Stage2Weights(
        rec_markers=args.weight_loss_rec_markers,
        vposer=args.weight_loss_vposer, shape=args.weight_loss_shape,
        hand=args.weight_loss_hand, smooth=args.weight_loss_smooth,
        contact_vel=args.weight_loss_contact_vel)
    make = (s2.make_temporal_fitter if args.clip_batch <= 1
            else s2.make_temporal_fitter_batched)
    # one fitter per gender, reused across clips
    fitters = {g: make(m, vposer_params, enc, smooth_stats, ids67, ids81,
                       feet, args.num_fit_steps, weights, device=dev)
               for g, m in models.items()}

    def prepare_clip(i):
        """Infill inference and targets for one clip, with its Stage-1
        solution."""
        init72 = np.load(os.path.join(args.perframe_res_dir,
                                      args.dataset_name,
                                      f"body_params_opt_clip_{i}.npy"))
        targets, contact = cli1.infill_clip(ae, images_n[i], stats,
                                            aux["rot_0_pivot"][i])
        np.save(os.path.join(save_folder, f"contact_lbl_rec_clip_{i}.npy"),
                contact.cpu().numpy())
        gender = "male" if aux["gender"][i] == 1 else "female"
        return gender, targets, contact, torch.as_tensor(init72, device=dev)

    def save(i, x72):
        np.save(os.path.join(save_folder, f"body_params_opt_clip_{i}.npy"),
                x72.cpu().numpy())

    indices = list(range(args.start, min(args.end, n_clips), args.step))
    if args.clip_batch <= 1:
        for i in indices:
            gender, targets, contact, init72 = prepare_clip(i)
            fitted, _ = fitters[gender](targets, contact, init72)
            save(i, fitted)
            print(f"[clip {i}] refined ({fitted.shape[0]} frames)")
        return
    # group by (gender, T): a batch must be shape-uniform
    by_group: dict = {}
    for i in indices:
        gender, targets, contact, init72 = prepare_clip(i)
        by_group.setdefault((gender, targets.shape[0]), []).append(
            (i, targets, contact, init72))
    for (gender, _T), items in by_group.items():
        for k in range(0, len(items), args.clip_batch):
            chunk = items[k:k + args.clip_batch]
            # pad the last chunk to the batch size
            pad = args.clip_batch - len(chunk)

            def stack(xs, pad=pad):
                return torch.stack(xs + [xs[-1]] * pad)

            fitted, _ = fitters[gender](stack([c[1] for c in chunk]),
                                        stack([c[2] for c in chunk]),
                                        stack([c[3] for c in chunk]))
            for (i, *_), x72 in zip(chunk, fitted):
                save(i, x72)
            print(f"[clips {[c[0] for c in chunk]}] refined "
                  f"(batch of {len(chunk)})")


if __name__ == "__main__":
    main()
