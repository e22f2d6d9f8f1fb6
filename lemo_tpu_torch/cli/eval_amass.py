"""3-D accuracy of fitted AMASS clips on the port (port of
`lemo_tpu/cli/eval_amass.py`):

  python -m lemo_tpu_torch.cli.eval_amass \
      --fitting_root res_opt_amass_temp --dataset_name TotalCapture \
      --amass_dir /path/to/AMASS --body_model_path /path/to/body_models

The reference exposes GT hooks (the fitting loader returns the GT smplx
params and the world->canonical transform, optimize_loader_amass_new.py:
283-308) but ships no evaluation script. This runs the fitted
``body_params_opt_clip_<i>.npy`` [T, 72] rows and the GT parameters
through the body model, maps GT into the canonical fitted frame, and
writes marker error, MPJPE, acceleration error and foot skate per clip
and their means as JSON. Without --vposer_ckpt the port's seeded VPoser
decodes the rows. Runs on the CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from lemo_tpu_torch.cli.opt_amass_perframe import load_vposer, \
    smplx_model_dir

# GT row layout (optimize_loader_amass_new.py:300-302)
_GT_SLICES = {
    "transl": (0, 3), "global_orient": (3, 6), "betas": (6, 16),
    "body_pose": (16, 79), "left_hand_pose": (79, 124),
    "right_hand_pose": (124, 169),
}


def split_gt_params(row169):
    """[T, 169] GT rows -> smplx kwargs (45-d hands: the GT models are
    the use_pca=False, flat_hand_mean=True preprocessing models)."""
    return {k: row169[:, a:b] for k, (a, b) in _GT_SLICES.items()}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--fitting_root", type=str, default="res_opt_amass_temp")
    p.add_argument("--dataset_name", type=str, default="TotalCapture")
    p.add_argument("--amass_dir", type=str, required=True)
    p.add_argument("--body_model_path", type=str, required=True)
    p.add_argument("--clip_seconds", type=int, default=4)
    p.add_argument("--vposer_ckpt", type=str, default=None)
    p.add_argument("--start", type=int, default=0)
    p.add_argument("--end", type=int, default=100)
    p.add_argument("--step", type=int, default=20)
    p.add_argument("--out", type=str, default="eval_amass.json")
    return p


def evaluate_clip(x72, contact, gt169, transf, model_fit, model_gt,
                  fwd_fit, fwd_gt, vposer_params, marker_ids, foot_ids):
    """Metrics of one clip (numpy inputs), all geometry compared in the
    canonical fitted frame (GT pushed through transf_matrix_smplx)."""
    import torch

    from lemo_tpu_torch.fitting import params as P
    from lemo_tpu_torch.utils import metrics as M

    dev = model_fit.device

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    T = min(x72.shape[0], gt169.shape[0])
    with torch.no_grad():
        out_fit = fwd_fit(P.smplx_params_from_72(t(x72[:T]), vposer_params),
                          model_fit.consts)
        gt = {k: t(v) for k, v in split_gt_params(gt169[:T]).items()}
        for k, v in model_gt.zero_params(T).items():
            gt.setdefault(k, v)
        out_gt = fwd_gt(gt, model_gt.consts)
    tf = t(transf)
    ids = torch.as_tensor(marker_ids, device=dev)

    mk_fit = out_fit["vertices"][:, ids]
    mk_gt = M.apply_world_transform(out_gt["vertices"][:, ids], tf)
    j_fit = out_fit["joints"][:, :25]
    j_gt = M.apply_world_transform(out_gt["joints"][:, :25], tf)

    res = {"marker_error_m": M.marker_error(mk_fit, mk_gt),
           "mpjpe_m": M.mpjpe(j_fit, j_gt),
           "mpjpe_root_aligned_m": M.mpjpe(j_fit, j_gt, align_root=True),
           "accel_error_m_s2": M.accel_error(mk_fit, mk_gt),
           "frames": int(T)}
    if contact is not None:
        c = t(contact[:T])
        res["foot_skate"] = M.foot_skate(out_fit["vertices"], c, foot_ids)
        # GT skate, the reference point of the friction losses
        res["foot_skate_gt"] = M.foot_skate(
            M.apply_world_transform(out_gt["vertices"], tf), c, foot_ids)
    return res


def main(argv=None, device=None):
    """Evaluate on `device` (None: the CUDA card; raises without it)."""
    args = build_parser().parse_args(argv)

    from lemo_tpu_torch import exact_f32_matmuls, resolve_device
    from lemo_tpu_torch.body_model import make_forward_fn
    from lemo_tpu_torch.cli.opt_amass_perframe import fitting_models
    from lemo_tpu_torch.data import amass
    from lemo_tpu_torch.data.markers import marker_indices
    from lemo_tpu_torch.data.segments import foot_vertex_ids

    dev = resolve_device(device)
    exact_f32_matmuls()
    vposer_params = load_vposer(args.vposer_ckpt, dev)
    builder = amass.AmassRepresentationBuilder(
        smplx_model_dir(args.body_model_path), with_hand=False, device=dev)
    clips = amass.scan_amass([args.dataset_name], args.amass_dir,
                             args.clip_seconds)
    T = args.clip_seconds * 30

    models_fit = fitting_models(args.body_model_path, dev)
    fwds_fit = {g: make_forward_fn(m) for g, m in models_fit.items()}
    any_model = next(iter(models_fit.values()))
    marker_ids = marker_indices(False, num_verts=any_model.num_verts)
    foot_ids = foot_vertex_ids(any_model.num_verts)

    folder = os.path.join(args.fitting_root, args.dataset_name)
    report = {"clips": {}, "dataset": args.dataset_name,
              "fitting_root": args.fitting_root}
    for i in range(args.start, min(args.end, len(clips)), args.step):
        fn = os.path.join(folder, f"body_params_opt_clip_{i}.npy")
        if not os.path.exists(fn):
            continue
        x72 = np.load(fn)
        cfn = os.path.join(folder, f"contact_lbl_rec_clip_{i}.npy")
        contact = np.load(cfn) if os.path.exists(cfn) else None
        gt169, transf = builder.gt_eval_data(clips[i], T)
        # the fit: the pipeline's convention (anything but "male" was
        # fitted with the female model); GT: the model the builder used
        g = "male" if clips[i].gender == "male" else "female"
        g_gt = (clips[i].gender if clips[i].gender in builder.models
                else next(iter(builder.models)))
        report["clips"][i] = evaluate_clip(
            x72, contact, gt169, transf, models_fit[g],
            builder.models[g_gt], fwds_fit[g], builder._fwd,
            vposer_params, marker_ids, foot_ids)
        print(f"[clip {i}] marker mean "
              f"{report['clips'][i]['marker_error_m']['mean']:.4f} m, "
              f"MPJPE {report['clips'][i]['mpjpe_m']:.4f} m")

    if report["clips"]:
        vals = list(report["clips"].values())
        report["mean"] = {
            k: float(np.mean([v[k]["mean"] if k == "marker_error_m"
                              else v[k] for v in vals]))
            for k in ("marker_error_m", "mpjpe_m", "mpjpe_root_aligned_m",
                      "accel_error_m_s2")}
        skates = [v["foot_skate"] for v in vals if "foot_skate" in v]
        if skates:
            report["mean"]["foot_skate"] = float(np.mean(skates))
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    print(f"wrote {args.out} ({len(report['clips'])} clips)")
    return report


if __name__ == "__main__":
    main()
