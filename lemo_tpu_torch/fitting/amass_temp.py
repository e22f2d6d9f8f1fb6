"""AMASS Stage 2: temporal whole-clip fitting with the learned smoothness
prior and foot-contact friction (port of `lemo_tpu/fitting/amass_temp.py`,
single-clip fitter).

From the Stage-1 per-frame solution, all T frames are optimized jointly
for 100 Adam steps (lr 0.01 -> 0.005 from step 61, betas frozen) under

  L = w_m  * L1(markers, targets)
    + w_vp * |z_vposer|^2 + w_sh * |betas|^2 + w_h * |hand|^2
    + w_sm * mean(dz/dt of the frozen smoothness encoder)^2
    + w_cv * hinge(contact-vertex speed - 0.1)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lemo_tpu_torch import exact_f32_matmuls, resolve_device
from lemo_tpu_torch.body_model import SmplxModel, make_forward_fn
from lemo_tpu_torch.data.repr import frame0_normalizer
from lemo_tpu_torch.data.stats import GlobalStats
from lemo_tpu_torch.fitting import params as P
from lemo_tpu_torch.fitting.adam import piecewise_lr, run_adam
from lemo_tpu_torch.ops.rotations import aa_to_rot6d, rot6d_to_aa
from lemo_tpu_torch.ops.select import take_rows
from lemo_tpu_torch.ops.signal import reflect_pad_dt
from lemo_tpu_torch.priors.conv_ae import smooth_enc_forward

FOOT_PARTS = ("left_heel", "right_heel", "left_toe", "right_toe")


@dataclasses.dataclass
class Stage2Weights:
    rec_markers: float = 1.0
    vposer: float = 0.02
    shape: float = 0.01
    hand: float = 0.01
    smooth: float = 1e6
    contact_vel: float = 0.03


def smoothness_prior_loss(enc_params, markers_with_hand, joints_frame0,
                          stats: GlobalStats):
    """Latent-acceleration loss of the frozen smoothness encoder.

    markers_with_hand [T, 81, 3]; joints_frame0 [25, 3]. The frame-0
    rotation comes from the (detached) joints, the origin from the
    (detached) first marker of frame 0 (opt_amass_temp.py:363-391).
    """
    R, _ = frame0_normalizer(joints_frame0.detach())
    origin = markers_with_hand[0, 0].detach()
    m = torch.matmul(markers_with_hand - origin, R)  # [T, 81, 3]
    clip = stats.normalize(m.reshape(m.shape[0], -1)[None])  # [1, T, d]
    img = clip.transpose(1, 2)[:, None]  # [1, 1, d, T]
    vel = reflect_pad_dt(img[..., 1:] - img[..., :-1])
    z, _ = smooth_enc_forward(enc_params, vel, downsample=False)
    dz = z[..., 1:] - z[..., :-1]
    return (dz ** 2).mean()


def foot_selection(foot_ids: dict, device):
    """(all foot vertex ids [Nf] on `device`, {part: slice}) — the feet
    are selected once and differenced after selection."""
    all_ids, slices, off = [], {}, 0
    for part in FOOT_PARTS:
        ids = np.asarray(foot_ids[part], np.int64)
        slices[part] = slice(off, off + len(ids))
        all_ids.append(ids)
        off += len(ids)
    return torch.as_tensor(np.concatenate(all_ids), device=device), slices


def contact_friction_loss(verts, contact_lbl, foot_sel, fps: float = 30.0,
                          vel_thresh: float = 0.1):
    """Hinge on contact-vertex speeds (opt_amass_temp.py:406-447).

    verts [T, V, 3]; contact_lbl [T, 4] (lheel, rheel, ltoe, rtoe);
    foot_sel from :func:`foot_selection`. Per foot part, averages speeds
    above `vel_thresh` over frames labelled in contact.
    """
    ids, slices = foot_sel
    feet = take_rows(verts, ids)                    # [T, Nf, 3]
    vel_f = (feet[1:] - feet[:-1]) * fps
    total = 0.0
    for i, part in enumerate(FOOT_PARTS):
        # eps-guarded norm: d|v|/dv is NaN at v=0 (static feet), and the
        # NaN survives multiplication by a zero mask
        speeds = torch.sqrt((vel_f[:, slices[part], :] ** 2).sum(-1) + 1e-12)
        w = contact_lbl[:-1, i][:, None]
        over = (speeds > vel_thresh).to(speeds.dtype) * w
        total = total + torch.sum(speeds * over) / torch.clamp(over.sum(),
                                                               min=1.0)
    return total


def make_temporal_fitter(model: SmplxModel, vposer_params: dict,
                         smooth_enc_params: dict, smooth_stats: GlobalStats,
                         marker_ids_67, marker_ids_81, foot_ids: dict,
                         num_steps: int = 100,
                         weights: Stage2Weights = Stage2Weights(),
                         device=None):
    """Single-clip Stage-2 fitter on `device` (None: the CUDA card; raises
    without CUDA): fit(markers [T, 67, 3], contact [T, 4], init72 [T, 72])
    -> (x72 [T, 72], per-step losses [num_steps]).

    The model must already live on `device`; the prior parameters and
    statistics are moved there once. TF32 is turned off for cuBLAS and
    cuDNN (the forward and the conv prior are exact f32 in `lemo_tpu`).
    """
    dev = resolve_device(device)
    if model.device != dev:
        raise ValueError(f"model is on {model.device}, fitter on {dev}")
    exact_f32_matmuls()
    fwd = make_forward_fn(model)
    vpp = {k: v.to(dev) for k, v in vposer_params.items()}
    enc = {k: v.to(dev) for k, v in smooth_enc_params.items()}
    stats = smooth_stats.to(dev)
    ids67 = torch.as_tensor(np.asarray(marker_ids_67, np.int64), device=dev)
    ids81 = torch.as_tensor(np.asarray(marker_ids_81, np.int64), device=dev)
    foot_sel = foot_selection(foot_ids, dev)
    lr_table = piecewise_lr([(0, 0.01), (61, 0.005)], num_steps)
    num_expr = model.config.num_expressions

    def loss_fn(v, shape10, markers_target, contact_lbl):
        x72 = torch.cat(
            [v["transl"], rot6d_to_aa(v["rot6d"]), shape10, v["other"]],
            dim=-1)
        out = fwd(P.smplx_params_from_72(x72, vpp, num_expr), model.consts)
        verts = out["vertices"]
        total = (weights.rec_markers
                 * (take_rows(verts, ids67) - markers_target).abs().mean()
                 + weights.vposer * (x72[:, 16:48] ** 2).mean()
                 + weights.shape * (x72[:, 6:16] ** 2).mean()
                 + weights.hand * (x72[:, 48:] ** 2).mean())
        if weights.smooth:
            total = total + weights.smooth * smoothness_prior_loss(
                enc, take_rows(verts, ids81), out["joints"][0, :25], stats)
        if weights.contact_vel:
            total = total + weights.contact_vel * contact_friction_loss(
                verts, contact_lbl, foot_sel)
        return total

    def fit(markers_target, contact_lbl, init72):
        markers_target = torch.as_tensor(markers_target, dtype=torch.float32,
                                         device=dev)
        contact_lbl = torch.as_tensor(contact_lbl, dtype=torch.float32,
                                      device=dev)
        init72 = torch.as_tensor(init72, dtype=torch.float32, device=dev)
        shape10 = init72[:, 6:16]  # betas frozen (opt_amass_temp.py:335)
        init_vars = {
            "transl": init72[:, 0:3],
            "rot6d": aa_to_rot6d(init72[:, 3:6]),
            "other": init72[:, 16:],
        }
        final, losses = run_adam(
            lambda v: loss_fn(v, shape10, markers_target, contact_lbl),
            init_vars, num_steps, lr_table)
        x72 = torch.cat([final["transl"], rot6d_to_aa(final["rot6d"]),
                         shape10, final["other"]], dim=-1)
        return x72, losses

    return fit
