"""Sliding-window PROX fitting (port of `lemo_tpu/fitting/prox/window.py`;
fit_temp_loadprox_slide.py:53-706): warm start from the previous stage's
pkls, the stage-weighted loss, the overlap freeze of the first 15% of a
non-first window's frames, and per-frame pkl results in the reference's
schema.

`lemo_tpu` runs a window's fit as `lax.scan`s of `steps_per_dispatch`
steps; here it is one loop of eager steps of Adam, SGD or RMSprop
(`fitting.adam.run_adam`) with no host sync inside, as many steps as
those whole chunks hold: the overlap freeze multiplies the gradients by
a frame mask, the NaN/Inf freeze is decided on the device, and the
per-step loss terms are kept in device tensors until the window ends.
L-BFGS (`fitting.lbfgs`) reads each line-search trial back to the host.

`make_batched_window_fitter` is the window-parallel fitter
(`lemo_tpu/fitting/prox/window.py:229-490`, its `impl='fold'`): all W
windows of a recording in one [W*T] forward a step and one per-window
loss (`losses.terms_folded`).
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
from lemo_tpu_torch.fitting.lbfgs import create_optimizer, \
    make_lbfgs_stepper
from lemo_tpu_torch.fitting.prox.losses import PER_WINDOW_FIELDS, \
    ProxStatic, ProxWeights, make_prox_loss
from lemo_tpu_torch.parallel import sharding

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


def dispatch_chunk(steps_per_dispatch: int, maxiters: int) -> int:
    """The steps of one of `lemo_tpu`'s compiled chunks
    (`lemo_tpu/fitting/prox/window.py:202`); a fit runs whole chunks."""
    return max(min(max(int(steps_per_dispatch), 1), int(maxiters)), 1)


def whole_chunks(iters: int, chunk: int) -> int:
    """The Adam steps `lemo_tpu` runs for `iters`: whole chunks,
    ceil(iters / chunk) * chunk (`while done < iters: ...; done += chunk`)."""
    return -(-int(iters) // chunk) * chunk


def make_window_fitter(model: SmplxModel, vposer_params: dict,
                       joint_mapper: np.ndarray,
                       static_template: ProxStatic, weights: ProxWeights,
                       maxiters: int = 900, lr: float = 0.005,
                       overlap_frac: float = 0.15, optim_type: str = "adam",
                       steps_per_dispatch: int = 100,
                       priors: dict | None = None, use_vposer: bool = True):
    """The per-window optimizer, built once per stage and reused by every
    window: ``fit(static, prox_params, first_window) -> (final params,
    losses [maxiters], {term: [maxiters]}, betas)``, all on the device.
    As `lemo_tpu`'s, the fit runs whole chunks of `steps_per_dispatch`
    steps (`whole_chunks`), so the final parameters have had
    ceil(maxiters / chunk) * chunk steps, and the histories are cut to
    `maxiters` (`lemo_tpu/fitting/prox/window.py:202-218`).

    `optim_type` adam, sgd or rmsprop runs `run_adam` with that spec.
    lbfgs and lbfgsls run strong-Wolfe L-BFGS (`fitting.lbfgs`; the
    reference's optim_type=lbfgsls) as `lemo_tpu/fitting/prox/window.py:
    112-164` does: at lr 1.0 whatever `lr` says, over the frames after
    the overlap head only (the frozen head is a constant of the loss, so
    no masked dimension enters the curvature pairs), in whole chunks with
    the state carried across them, the term history taken at each step's
    x. After each L-BFGS fit, ``fit.last_state`` is the stepper's final
    `LbfgsState` (its per-step trial counts among it).
    """
    spec = create_optimizer(optim_type)   # raises on unknown types
    chunk = dispatch_chunk(steps_per_dispatch, maxiters)
    n_steps = whole_chunks(maxiters, chunk)
    T = static_template.gt_joints.shape[0]
    fwd = make_forward_fn(model)
    loss_fn = make_prox_loss(fwd, model.consts, joint_mapper, vposer_params,
                             static_template, weights,
                             model.config.num_expressions, priors=priors,
                             use_vposer=use_vposer)
    erase_frames = int(T * overlap_frac)

    if spec is None:
        def loss_tail(tail, head, betas, static):
            full = {k: torch.cat([head[k], tail[k]]) for k in tail}
            return loss_fn(full, betas, static)

        def fit_lbfgs(static: ProxStatic, prox_params, first_window: bool):
            opt_vars, betas = init_opt_vars(prox_params, T, use_vposer)
            n_freeze = 0 if first_window else erase_frames
            head = {k: x[:n_freeze].detach() for k, x in opt_vars.items()}
            tail0 = {k: x[n_freeze:] for k, x in opt_vars.items()}
            init_state, run_chunk, unravel = make_lbfgs_stepper(
                loss_tail, tail0, lr=1.0, has_aux=True)
            state = init_state(tail0)
            all_losses, all_terms = [], []
            for _ in range(n_steps // chunk):
                state, losses, terms = run_chunk(state, chunk, head, betas,
                                                 static)
                all_losses.append(losses)
                all_terms.append(terms)
            fit_lbfgs.last_state = state
            tail = unravel(state.x)
            final = {k: torch.cat([head[k], tail[k]]) for k in tail}
            return final, torch.cat(all_losses)[:maxiters], \
                {k: torch.cat([t[k] for t in all_terms])[:maxiters]
                 for k in all_terms[0]}, betas

        fit_lbfgs.last_state = None
        return fit_lbfgs

    def fit(static: ProxStatic, prox_params, first_window: bool):
        opt_vars, betas = init_opt_vars(prox_params, T, use_vposer)
        mask = overlap_grad_mask(T, 0 if first_window else erase_frames,
                                 betas.device)
        final, losses, terms = run_adam(
            lambda v: loss_fn(v, betas, static), opt_vars, n_steps,
            [lr] * n_steps, grad_mask=mask, has_aux=True, spec=spec)
        return final, losses[:maxiters], \
            {k: v[:maxiters] for k, v in terms.items()}, betas

    return fit


def make_batched_window_fitter(model: SmplxModel, vposer_params: dict,
                               joint_mapper: np.ndarray,
                               static_template: ProxStatic,
                               weights: ProxWeights, maxiters: int = 900,
                               lr: float = 0.005, overlap_frac: float = 0.15,
                               mesh=None, steps_per_dispatch: int = 100,
                               priors: dict | None = None,
                               use_vposer: bool = True,
                               optim_type: str = "adam", impl: str = "fold"):
    """The window-parallel fitter: all W windows of a recording optimized
    at once, each warm-started from the previous stage's pkls; the frozen
    overlap heads keep their warm-start values (the driver's polish pass
    restores the sequential stitching).

    Each step runs one SMPL-X forward on the [W*T] frame batch, so every
    kernel launches once a step for all windows, and the per-window loss
    `terms_folded`. The optimizer (Adam, SGD or RMSprop; L-BFGS raises,
    as in `lemo_tpu`) runs with `run_adam(per_clip=True)` on the W
    totals: a window whose loss goes NaN/Inf keeps its last good
    parameters and optimizer state while the others go on, all at one
    step count.

    Returns ``fit(static_batch, prox_params_batch, first_mask,
    maxiters_override=None, erase_override=None) -> (opt_vars [W, T, ...],
    betas [W, T, 10], losses [W, S], final_terms {term: [W]})``, on the
    device. S = ceil(iters / chunk) * chunk, the steps `lemo_tpu` runs,
    and the history is not cut (`lemo_tpu/fitting/prox/window.py:
    472-487`); `final_terms` is one more loss evaluation at the final
    parameters. `erase_override` [W] sets each window's frozen head
    (frames; T freezes a window whole); by default 0 on the first window
    and int(T * overlap_frac) on the others.

    The VPoser decode runs its products a window at a time
    (`vposer.decode(rows=T)`), so that each window's decode equals its
    own fit's bit for bit, and a one-window fold is its sequential fit.

    With `mesh` (`parallel.make_mesh`, one process per card), the window
    axis is sharded over the mesh's "dp" axis: each rank folds its
    `tensor_split` share of the W windows (no padding: `lemo_tpu` pads
    to a multiple of the mesh with copies of window 0), through the
    kernels as without a mesh, and every rank gets the outputs gathered
    to [W, ...]. `first_mask` and `erase_override` hold all W windows;
    `static_batch` and `prox_params_batch` hold all W or this rank's
    share. Needs at least one window a rank.
    """
    if impl == "vmap":
        raise ValueError(
            "impl='vmap' is lemo_tpu's TPU-only alternative (the whole "
            "chunk vmapped with the fused kernel off); impl='fold' computes "
            "the same trajectories and is the one form lemo_tpu_torch has")
    if impl != "fold":
        raise ValueError(f"unknown window-parallel impl {impl!r} "
                         "(expected 'fold' or 'vmap')")
    if optim_type in ("lbfgs", "lbfgsls"):
        raise ValueError(
            "window_parallel supports the gradient-descent family "
            "(adam/rmsprop/sgd); L-BFGS curvature history over a batched "
            "window axis is not implemented — unset window_parallel to "
            f"fit sequentially with optim_type={optim_type!r}")
    spec = create_optimizer(optim_type)   # raises on unknown types
    T = static_template.gt_joints.shape[0]
    fwd = make_forward_fn(model)
    loss_fn = make_prox_loss(fwd, model.consts, joint_mapper, vposer_params,
                             static_template, weights,
                             model.config.num_expressions, priors=priors,
                             use_vposer=use_vposer)
    chunk = dispatch_chunk(steps_per_dispatch, maxiters)
    pose_key = "pose_embedding" if use_vposer else "body_pose"

    def loss_folded(ov, betas, st_b):
        W = betas.shape[0]
        flat = {k: v.reshape((W * T,) + v.shape[2:]) for k, v in ov.items()}
        out = loss_fn.forward_part(flat, betas.reshape(W * T, -1),
                                   decode_rows=T)
        out_w = {k: v.reshape((W, T) + v.shape[1:]) for k, v in out.items()}
        return loss_fn.terms_folded(ov, betas, out_w, st_b)

    def fit_local(static_batch: ProxStatic, prox_params_batch, first_mask,
                  maxiters_override: int | None = None, erase_override=None):
        W = len(first_mask)
        n_steps = whole_chunks(maxiters_override or maxiters, chunk)
        mean_betas = prox_params_batch["betas"].mean(dim=1, keepdim=True)
        betas = mean_betas.expand(W, T, mean_betas.shape[-1]).contiguous()
        opt_vars = {k: prox_params_batch[k] for k in _OPT_KEYS + (pose_key,)}
        dev = betas.device
        if erase_override is not None:
            erase_n = torch.as_tensor(np.asarray(erase_override), device=dev)
        else:
            erase_n = torch.where(
                torch.as_tensor(np.asarray(first_mask), device=dev), 0,
                int(T * overlap_frac))
        frame_w = (torch.arange(T, device=dev)[None]
                   >= erase_n[:, None]).to(torch.float32)          # [W, T]

        def mask(_name, g):
            if g.dim() >= 2 and tuple(g.shape[:2]) == (W, T):
                return g * frame_w.reshape((W, T) + (1,) * (g.dim() - 2))
            return g

        def loss(v):
            totals, _ = loss_folded(v, betas, static_batch)
            return totals.sum(), totals

        final, losses = run_adam(loss, opt_vars, n_steps,
                                 [lr] * n_steps, grad_mask=mask,
                                 per_clip=True, spec=spec)
        with torch.no_grad():
            _, terms = loss_folded(final, betas, static_batch)
        return final, betas, losses, {k: v.detach() for k, v in terms.items()}

    if mesh is None:
        fit = fit_local
    else:
        dp = mesh.along("dp")

        def fit(static_batch: ProxStatic, prox_params_batch, first_mask,
                maxiters_override: int | None = None, erase_override=None):
            W = len(first_mask)
            if W < dp.size:
                raise ValueError(f"{W} windows on {dp.size} ranks: at least "
                                 "one window a rank")
            lo, hi = dp.rows(W)
            if static_batch.gt_joints.shape[0] != hi - lo:
                static_batch = dataclasses.replace(static_batch, **{
                    f: sharding.owned_rows(dp, getattr(static_batch, f), W)
                    for f in PER_WINDOW_FIELDS
                    if getattr(static_batch, f) is not None})
            params = {k: sharding.owned_rows(dp, v, W)
                      for k, v in prox_params_batch.items()}
            erase = (None if erase_override is None
                     else np.asarray(erase_override)[lo:hi])
            out = fit_local(static_batch, params,
                            np.asarray(first_mask)[lo:hi],
                            maxiters_override, erase)
            return sharding.gather_rows(dp, out, W)

    # (opt_vars, betas, static_batch) -> (totals [W], {term: [W]}): one
    # evaluation of the folded loss, for callers that check it
    fit.loss_folded = loss_folded
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
    return window_result(final, betas, losses.cpu().numpy(),
                         {k: v.cpu().numpy() for k, v in terms.items()},
                         vposer_params, use_vposer)


def window_result(final: dict, betas: torch.Tensor, loss_history,
                  term_history: dict, vposer_params: dict,
                  use_vposer: bool = True) -> WindowResult:
    """A window's WindowResult from its final parameters on the device
    (read back to the host, the body pose decoded) and its host-side
    loss and term histories."""
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
    return WindowResult(
        params=params_np, pose_embedding=pose_embedding,
        body_pose=params_np["body_pose"],
        final_loss=float(loss_history[-1]), loss_history=loss_history,
        term_history=term_history)


def save_window_pkls(result: WindowResult, frame_names: list[str],
                     result_folder: str, person_id: int = 0,
                     camera_params: dict | None = None,
                     only: set | None = None) -> list[str]:
    """Per-frame pkl results in the reference's schema
    (fit_temp_loadprox_slide.py:577-594): each frame a dict of [1, ...]
    arrays keyed transl/global_orient/betas/body_pose/pose_embedding/
    left_hand_pose/.../expression (+ camera_*), pickle protocol 2. With
    `only`, just the frames named in it."""
    paths = []
    for i, fn in enumerate(frame_names):
        if only is not None and fn not in only:
            continue
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
