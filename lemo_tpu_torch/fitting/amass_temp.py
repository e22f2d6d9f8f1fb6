"""AMASS Stage 2: temporal whole-clip fitting with the learned smoothness
prior and foot-contact friction (port of `lemo_tpu/fitting/amass_temp.py`:
the single-clip fitter and the clip-batched one, whose default folds C
clips into one forward of C*T frames).

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
from lemo_tpu_torch.fitting.step_graph import StepGraphs
from lemo_tpu_torch.ops.rotations import aa_to_rot6d, rot6d_to_aa
from lemo_tpu_torch.ops.select import take_rows
from lemo_tpu_torch.ops.signal import reflect_pad_dt
from lemo_tpu_torch.priors.conv_ae import smooth_enc_forward
from lemo_tpu_torch.utils.profiling import annotate

FOOT_PARTS = ("left_heel", "right_heel", "left_toe", "right_toe")


@dataclasses.dataclass
class Stage2Weights:
    rec_markers: float = 1.0
    vposer: float = 0.02
    shape: float = 0.01
    hand: float = 0.01
    smooth: float = 1e6
    contact_vel: float = 0.03


def _rotate(x, R):
    """x [..., 3] times R [..., 3, 3] (row vectors, broadcast), as three
    elementwise products in a fixed order: a batched product would round
    by the batch's shape, this rounds each row alike."""
    return (x[..., 0:1] * R[..., 0, :] + x[..., 1:2] * R[..., 1, :]) + \
        x[..., 2:3] * R[..., 2, :]


def smoothness_prior_loss(enc_params, markers_with_hand, joints_frame0,
                          stats: GlobalStats):
    """Latent-acceleration loss of the frozen smoothness encoder.

    markers_with_hand [T, 81, 3]; joints_frame0 [25, 3]. The frame-0
    rotation comes from the (detached) joints, the origin from the
    (detached) first marker of frame 0 (opt_amass_temp.py:363-391).
    """
    R, _ = frame0_normalizer(joints_frame0.detach())
    origin = markers_with_hand[0, 0].detach()
    m = _rotate(markers_with_hand - origin, R)  # [T, 81, 3]
    clip = stats.normalize(m.reshape(m.shape[0], -1)[None])  # [1, T, d]
    img = clip.transpose(1, 2)[:, None]  # [1, 1, d, T]
    vel = reflect_pad_dt(img[..., 1:] - img[..., :-1])
    z, _ = smooth_enc_forward(enc_params, vel, downsample=False)
    dz = z[..., 1:] - z[..., :-1]
    return (dz ** 2).mean()


def smoothness_prior_loss_batched(enc_params, markers, joints_frame0,
                                  stats: GlobalStats,
                                  reduce_clips: bool = True):
    """Clip-batched :func:`smoothness_prior_loss`: markers
    [C, T, 81, 3], joints_frame0 [C, 25, 3] -> the per-clip losses [C]
    (or their sum). On the card the frozen encoder convolves one clip
    image at a time (`smooth_enc_forward(per_sample=True)`), so that each
    clip's gradient equals its own fit's bit for bit; on the CPU the C
    images are one N=C batch."""
    C, T = markers.shape[0], markers.shape[1]
    R, _ = frame0_normalizer(joints_frame0.detach())      # [C, 3, 3]
    origin = markers[:, 0, 0].detach()                     # [C, 3]
    m = _rotate(markers - origin[:, None, None], R[:, None, None])
    clip = stats.normalize(m.reshape(C, T, -1))
    img = clip.transpose(1, 2)[:, None]                    # [C, 1, d, T]
    vel = reflect_pad_dt(img[..., 1:] - img[..., :-1])
    z, _ = smooth_enc_forward(enc_params, vel, downsample=False,
                              per_sample=True)
    dz = z[..., 1:] - z[..., :-1]
    per_clip = (dz ** 2).mean(dim=(1, 2, 3))
    return per_clip.sum() if reduce_clips else per_clip


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


def contact_friction_loss_batched(feet, contact_lbl, part_slices,
                                  fps: float = 30.0,
                                  vel_thresh: float = 0.1,
                                  reduce_clips: bool = True):
    """Clip-batched friction: selected foot vertices [C, T, Nf, 3] and
    labels [C, T, 4] -> per-clip hinge losses [C] (or their sum); the
    velocities are differenced within each clip."""
    vel = (feet[:, 1:] - feet[:, :-1]) * fps           # [C, T-1, Nf, 3]
    per_clip = 0.0
    for i, part in enumerate(FOOT_PARTS):
        speeds = torch.sqrt((vel[:, :, part_slices[part], :] ** 2).sum(-1)
                            + 1e-12)                   # [C, T-1, n]
        w = contact_lbl[:, :-1, i][..., None]
        over = (speeds > vel_thresh).to(speeds.dtype) * w
        num = (speeds * over).sum(dim=(1, 2))
        den = torch.clamp(over.sum(dim=(1, 2)), min=1.0)
        per_clip = per_clip + num / den
    return per_clip.sum() if reduce_clips else per_clip


def _fitter_setup(model, vposer_params, smooth_enc_params, smooth_stats,
                  marker_ids_67, marker_ids_81, foot_ids, device):
    """The fitters' constants on the device, checked against the model."""
    dev = resolve_device(device)
    if model.device != dev:
        raise ValueError(f"model is on {model.device}, fitter on {dev}")
    exact_f32_matmuls()
    return (dev, {k: v.to(dev) for k, v in vposer_params.items()},
            {k: v.to(dev) for k, v in smooth_enc_params.items()},
            smooth_stats.to(dev),
            torch.as_tensor(np.asarray(marker_ids_67, np.int64), device=dev),
            torch.as_tensor(np.asarray(marker_ids_81, np.int64), device=dev),
            foot_selection(foot_ids, dev))


def _init_vars(init72: torch.Tensor) -> dict:
    """[..., 72] Stage-1 rows -> the optimized variables (betas frozen,
    opt_amass_temp.py:335)."""
    return {"transl": init72[..., 0:3],
            "rot6d": aa_to_rot6d(init72[..., 3:6]),
            "other": init72[..., 16:]}


def _x72(v: dict, shape10: torch.Tensor) -> torch.Tensor:
    return torch.cat([v["transl"], rot6d_to_aa(v["rot6d"]), shape10,
                      v["other"]], dim=-1)


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
    dev, vpp, enc, stats, ids67, ids81, foot_sel = _fitter_setup(
        model, vposer_params, smooth_enc_params, smooth_stats,
        marker_ids_67, marker_ids_81, foot_ids, device)
    fwd = make_forward_fn(model)
    lr_table = piecewise_lr([(0, 0.01), (61, 0.005)], num_steps)
    num_expr = model.config.num_expressions

    def loss_fn(v, shape10, markers_target, contact_lbl):
        x72 = _x72(v, shape10)
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
        markers_target, contact_lbl, init72 = (
            torch.as_tensor(x, dtype=torch.float32, device=dev)
            for x in (markers_target, contact_lbl, init72))
        shape10 = init72[:, 6:16]
        final, losses = run_adam(
            lambda v: loss_fn(v, shape10, markers_target, contact_lbl),
            _init_vars(init72), num_steps, lr_table)
        return _x72(final, shape10), losses

    return fit


def make_temporal_fitter_batched(model: SmplxModel, vposer_params: dict,
                                 smooth_enc_params: dict,
                                 smooth_stats: GlobalStats,
                                 marker_ids_67, marker_ids_81,
                                 foot_ids: dict, num_steps: int = 100,
                                 weights: Stage2Weights = Stage2Weights(),
                                 impl: str = "fold", fused: bool = True,
                                 device=None):
    """Clip-batched Stage-2 fitter: every input and output gains a leading
    clip axis C: fit(markers [C, T, 67, 3], contact [C, T, 4],
    init72 [C, T, 72]) -> (x72 [C, T, 72], per-clip losses [C, S]).

    impl='fold' (the default): the C clips are folded into one forward of
    C*T frames, so each chain and vertex kernel launch carries C*T frames.
    The loss is the sum of the per-clip losses; clip parameters are
    disjoint and Adam is elementwise. On the card each clip's gradient
    equals its own fit's bit for bit, so each clip follows its
    single-clip trajectory exactly: Adam turns any other rounding into
    whole steps on entries with near-zero gradients. For that the VPoser
    decode and the body model's hand-PCA products run a clip's rows at a
    time (`vposer.decode(rows=T)`, `smplx_forward(rows=T)`: cuBLAS picks
    its kernel, and with it the rounding, by the row count), the rest
    joints a LANE of frames at a time (`lbs.lane_matmul`), and the
    smoothness prior its convolutions a clip at a time; the body kernels
    and the translation's gradient sum each frame alike whatever the
    batch. On the CPU the decode, the products and the prior run as one
    batch, `lemo_tpu`'s order. The NaN/Inf freeze is per clip: a
    diverging clip freezes only its own parameters and moments
    (`run_adam`'s `per_clip`), so the others keep fitting. On the card
    the fitter captures its Adam step once a shape of its inputs as a
    CUDA graph and replays it (`fitting.step_graph`), so that the host
    no longer dispatches ~2,400 launches a step.

    impl='vmap': C independent single-clip fits, one after another. That
    is the same math as `lemo_tpu`'s vmapped core (each clip its own
    Adam, its own freeze); torch needs no vmap for it.

    `fused=False` exists in `lemo_tpu` only for a clip axis sharded over a
    device mesh, where GSPMD would gather the fused `pallas_call`'s
    operands to one device. The port shards clips with one process per
    card (`parallel.clip_sharded_fit` takes this fitter as built): each
    rank runs the kernels on its own clips, so no such gather arises and
    `fused=False` raises.
    """
    if not fused:
        raise NotImplementedError(
            "fused=False is not needed: lemo_tpu turns the fused kernel off "
            "only because GSPMD gathers its operands under a device mesh; "
            "the port shards clips one process per card "
            "(lemo_tpu_torch.parallel.clip_sharded_fit), each rank running "
            "the kernels on its own clips")
    if impl == "vmap":
        single = make_temporal_fitter(
            model, vposer_params, smooth_enc_params, smooth_stats,
            marker_ids_67, marker_ids_81, foot_ids, num_steps, weights,
            device)

        def fit_each(markers_target, contact_lbl, init72):
            outs = [single(m, c, x) for m, c, x in
                    zip(markers_target, contact_lbl, init72)]
            return (torch.stack([o[0] for o in outs]),
                    torch.stack([o[1] for o in outs]))

        return fit_each
    if impl != "fold":
        raise ValueError(impl)
    dev, vpp, enc, stats, ids67, ids81, (foot_ids_t, slices) = \
        _fitter_setup(model, vposer_params, smooth_enc_params, smooth_stats,
                      marker_ids_67, marker_ids_81, foot_ids, device)
    fwd = make_forward_fn(model)
    lr_table = piecewise_lr([(0, 0.01), (61, 0.005)], num_steps)
    num_expr = model.config.num_expressions

    def loss_fn(v, shape10, markers_target, contact_lbl):
        C, T = markers_target.shape[0], markers_target.shape[1]
        x72 = _x72(v, shape10)                               # [C, T, 72]
        with annotate("term.vposer_decode"):
            params = P.smplx_params_from_72(x72.reshape(C * T, 72), vpp,
                                            num_expr, decode_rows=T)
        with annotate("term.body_model"):
            out = fwd(params, model.consts, rows=T)
        verts = out["vertices"]                              # [C*T, V, 3]
        with annotate("term.markers"):
            mk = take_rows(verts, ids67).reshape(C, T, -1, 3)
            per_clip = weights.rec_markers * \
                (mk - markers_target).abs().mean(dim=(1, 2, 3))
            per_clip = per_clip + weights.vposer * \
                (x72[..., 16:48] ** 2).mean(dim=(1, 2))
            per_clip = per_clip + weights.shape * \
                (x72[..., 6:16] ** 2).mean(dim=(1, 2))
            per_clip = per_clip + weights.hand * \
                (x72[..., 48:] ** 2).mean(dim=(1, 2))
        if weights.smooth:
            with annotate("term.smooth_prior"):
                m81 = take_rows(verts, ids81).reshape(C, T, -1, 3)
                j0 = out["joints"].reshape(C, T, -1, 3)[:, 0, :25]
                per_clip = per_clip + weights.smooth * \
                    smoothness_prior_loss_batched(enc, m81, j0, stats,
                                                  reduce_clips=False)
        if weights.contact_vel:
            with annotate("term.friction"):
                feet = take_rows(verts, foot_ids_t).reshape(C, T, -1, 3)
                per_clip = per_clip + weights.contact_vel * \
                    contact_friction_loss_batched(feet, contact_lbl, slices,
                                                  reduce_clips=False)
        return per_clip.sum(), per_clip

    graphs = StepGraphs()

    def fit(markers_target, contact_lbl, init72):
        markers_target, contact_lbl, init72 = (
            torch.as_tensor(x, dtype=torch.float32, device=dev)
            for x in (markers_target, contact_lbl, init72))
        shape10 = init72[..., 6:16]
        loss = graphs.bind(lambda *b: (lambda v: loss_fn(v, *b)), shape10,
                           markers_target, contact_lbl)
        final, losses = run_adam(loss, _init_vars(init72), num_steps,
                                 lr_table, per_clip=True, graph=graphs)
        return _x72(final, shape10), losses

    return fit


def fit_clip_temporal(model: SmplxModel, vposer_params: dict,
                      smooth_enc_params: dict, smooth_stats: GlobalStats,
                      marker_ids_67, marker_ids_81, foot_ids: dict,
                      markers_target, contact_lbl, init72,
                      num_steps: int = 100,
                      weights: Stage2Weights = Stage2Weights(),
                      device=None):
    """One clip's Stage-2 fit, [T, 67, 3] targets, [T, 4] contact and the
    [T, 72] Stage-1 solution -> (x72, losses). Loops over clips should
    build the fitter once with :func:`make_temporal_fitter`."""
    return make_temporal_fitter(
        model, vposer_params, smooth_enc_params, smooth_stats,
        marker_ids_67, marker_ids_81, foot_ids, num_steps, weights,
        device)(markers_target, contact_lbl, init72)
