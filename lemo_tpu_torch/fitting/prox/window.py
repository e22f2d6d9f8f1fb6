"""Sliding-window PROX fitting (port of `lemo_tpu/fitting/prox/window.py`;
fit_temp_loadprox_slide.py:53-706): warm start from the previous stage's
pkls, the stage-weighted loss, the overlap freeze of the first 15% of a
non-first window's frames, and per-frame pkl results in the reference's
schema.

`lemo_tpu` runs a window's fit as `lax.scan`s of <= 100 steps; here it is
one loop of eager Adam steps (`fitting.adam.run_adam`) with no host sync
inside: the overlap freeze multiplies the gradients by a frame mask, the
NaN/Inf freeze is decided on the device, and the per-step loss terms are
kept in device tensors until the window ends.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Any

import numpy as np
import torch

from lemo_tpu_torch.body_model import SmplxModel, make_forward_fn
from lemo_tpu_torch.body_model import vposer as vp
from lemo_tpu_torch.fitting.adam import run_adam
from lemo_tpu_torch.fitting.lbfgs import create_optimizer
from lemo_tpu_torch.fitting.prox.losses import ProxStatic, ProxWeights, \
    make_prox_loss

_OPT_KEYS = ("transl", "global_orient", "left_hand_pose", "right_hand_pose",
             "jaw_pose", "leye_pose", "reye_pose", "expression")


@dataclasses.dataclass
class WindowResult:
    params: dict[str, np.ndarray]       # optimized per-frame smplx params
    pose_embedding: np.ndarray          # [T, 32]
    body_pose: np.ndarray               # [T, 63]
    final_loss: float
    loss_history: np.ndarray
    term_history: dict[str, np.ndarray] | None = None  # per-step terms
    # wall-clock seconds of this window's phases in run_prox_fitting
    # (load, infill pre-pass, static build, fit, save, total)
    timings: dict[str, float] | None = None
    # the self-intersection candidate pre-pass of the window's last stage
    # (driver._coll_candidate_ids): n_active, n_within, K, scores_s
    broad_phase: dict | None = None


def init_opt_vars(prox_params: dict[str, torch.Tensor], T: int,
                  use_vposer: bool = True):
    """Warm-start optimization variables (fit_temp_loadprox_slide.py:
    494-505); betas averaged over the window and frozen (:497-498)."""
    mean_betas = prox_params["betas"].mean(dim=0, keepdim=True)
    betas = mean_betas.expand(T, mean_betas.shape[1]).contiguous()
    opt_vars = {k: prox_params[k] for k in _OPT_KEYS}
    pose_key = "pose_embedding" if use_vposer else "body_pose"
    opt_vars[pose_key] = prox_params[pose_key]
    return opt_vars, betas


def overlap_grad_mask(T: int, erase_n: int, device):
    """grad_mask for `run_adam`: zero the gradients of the first
    `erase_n` frames (fitting_temp_slide.py:283-289) so overlapped frames
    keep the previous window's solution; 0 on the first window."""
    frame_w = (torch.arange(T, device=device) >= erase_n).to(torch.float32)

    def mask(_name, g):
        if g.dim() >= 1 and g.shape[0] == T:
            return g * frame_w.reshape((T,) + (1,) * (g.dim() - 1))
        return g

    return mask


def make_window_fitter(model: SmplxModel, vposer_params: dict,
                       joint_mapper: np.ndarray,
                       static_template: ProxStatic, weights: ProxWeights,
                       maxiters: int = 900, lr: float = 0.005,
                       overlap_frac: float = 0.15, optim_type: str = "adam",
                       priors: dict | None = None, use_vposer: bool = True):
    """The per-window optimizer, built once per stage and reused by every
    window: ``fit(static, prox_params, first_window) -> (final params,
    losses [maxiters], {term: [maxiters]}, betas)``, all on the device."""
    spec = create_optimizer(optim_type, lr)   # raises on unported types
    T = static_template.gt_joints.shape[0]
    fwd = make_forward_fn(model)
    loss_fn = make_prox_loss(fwd, model.consts, joint_mapper, vposer_params,
                             static_template, weights,
                             model.config.num_expressions, priors=priors,
                             use_vposer=use_vposer)
    erase_frames = int(T * overlap_frac)

    def fit(static: ProxStatic, prox_params, first_window: bool):
        opt_vars, betas = init_opt_vars(prox_params, T, use_vposer)
        mask = overlap_grad_mask(T, 0 if first_window else erase_frames,
                                 betas.device)
        final, losses, terms = run_adam(
            lambda v: loss_fn(v, betas, static), opt_vars, maxiters,
            [spec.lr] * maxiters, b1=spec.b1, b2=spec.b2, eps=spec.eps,
            grad_mask=mask, has_aux=True)
        return final, losses, terms, betas

    return fit


def fit_window(model: SmplxModel, vposer_params: dict,
               joint_mapper: np.ndarray, static: ProxStatic,
               weights: ProxWeights, prox_params: dict[str, torch.Tensor],
               first_window: bool, maxiters: int = 900, lr: float = 0.005,
               fitter=None, use_vposer: bool = True) -> WindowResult:
    """Fit one window; pass `fitter` from :func:`make_window_fitter` to
    reuse it across windows (the driver does). Reads the results back to
    the host once, at the end."""
    if fitter is None:
        fitter = make_window_fitter(model, vposer_params, joint_mapper,
                                    static, weights, maxiters, lr,
                                    use_vposer=use_vposer)
    final, losses, terms, betas = fitter(static, prox_params, first_window)
    with torch.no_grad():
        if use_vposer:
            body_pose = vp.decode(vposer_params, final["pose_embedding"],
                                  "aa")
            pose_embedding = final["pose_embedding"].cpu().numpy()
        else:
            body_pose = final["body_pose"]
            pose_embedding = np.zeros(
                (body_pose.shape[0], vp.latent_dim(vposer_params)),
                np.float32)
    params_np = {k: v.cpu().numpy() for k, v in final.items()
                 if k != "pose_embedding"}
    params_np["betas"] = betas.cpu().numpy()
    params_np["body_pose"] = body_pose.cpu().numpy()
    losses = losses.cpu().numpy()
    return WindowResult(
        params=params_np, pose_embedding=pose_embedding,
        body_pose=params_np["body_pose"], final_loss=float(losses[-1]),
        loss_history=losses,
        term_history={k: v.cpu().numpy() for k, v in terms.items()})


def save_window_pkls(result: WindowResult, frame_names: list[str],
                     result_folder: str, person_id: int = 0,
                     camera_params: dict | None = None) -> list[str]:
    """Per-frame pkl results in the reference's schema
    (fit_temp_loadprox_slide.py:577-594): each frame a dict of [1, ...]
    arrays keyed transl/global_orient/betas/body_pose/pose_embedding/
    left_hand_pose/.../expression (+ camera_*), pickle protocol 2."""
    paths = []
    for i, fn in enumerate(frame_names):
        rec: dict[str, Any] = {}
        if camera_params:
            for k, v in camera_params.items():
                rec[f"camera_{k}"] = np.asarray(v)[None]
        for k, v in result.params.items():
            rec[k] = v[i][None]
        rec["pose_embedding"] = result.pose_embedding[i][None]
        rec["body_pose"] = result.body_pose[i][None]
        folder = os.path.join(result_folder, fn)
        os.makedirs(folder, exist_ok=True)
        path = os.path.join(folder, f"{person_id:03d}.pkl")
        with open(path, "wb") as fh:
            pickle.dump(rec, fh, protocol=2)
        paths.append(path)
    return paths
