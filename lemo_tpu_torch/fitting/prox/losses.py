"""The PROX SMPLify loss (port of `lemo_tpu/fitting/prox/losses.py`;
SMPLifyLoss.forward, temp_prox/fitting_temp_slide.py:564-1062).

Loss families: 2-D keypoints, pose/shape/angle/hand/expression priors,
depth s2m/m2s Chamfer with z-buffer visibility, scene-SDF penetration,
ground friction, scene-contact Chamfer, naive smoothness, the learned
motion-smoothness prior, the motion-infill terms and self-interpenetration
(`self_penetration_loss`, the cone energy of `ops.intersection`).

The JAX package `vmap`s its per-frame Chamfer calls over the T frames of a
window; here every Chamfer call is one batched `nn_distance` over all T
frames, so a step issues one selection per direction (s2m, m2s, contact).
The self-interpenetration term likewise takes all T frames in one call
of the intersection kernel (the JAX package maps them one at a time).

`terms_folded` is the window-parallel form (the JAX package `vmap`s
`terms_part` over windows, `lemo_tpu/fitting/prox/window.py:348-358`):
W windows' frames are one [W*T] frame axis for the kernel-carrying
terms, so each kernel still launches once a step, and every other term
reduces over its window's [T, ...] slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from lemo_tpu_torch.body_model import vposer as vp
from lemo_tpu_torch.data.stats import GlobalStats
from lemo_tpu_torch.fitting.amass_temp import smoothness_prior_loss
from lemo_tpu_torch.fitting.prox.camera import PerspectiveCamera
from lemo_tpu_torch.fitting.amass_temp import \
    smoothness_prior_loss_batched
from lemo_tpu_torch.ops import robust
from lemo_tpu_torch.ops.chamfer import nn_distance
from lemo_tpu_torch.ops.intersection import batched_self_intersection
from lemo_tpu_torch.ops.sdf import sample_sdf_windows, sample_sdf_world
from lemo_tpu_torch.ops.select import take_rows
from lemo_tpu_torch.ops.visibility import vertex_normals, visibility_zbuffer
from lemo_tpu_torch.priors.body_priors import angle_prior, l2_prior

FOOT_PARTS = ("left_heel", "right_heel", "left_toe", "right_toe")


@dataclasses.dataclass
class ProxWeights:
    """Per-stage loss weights (cmd_parser defaults / PROXD_temp_S*.yaml)."""

    data: float = 1.0
    body_pose: float = 4.78e-5
    shape: float = 0.0
    bending_factor: float = 3.17  # bending = factor * body_pose
    hand_prior: float = 4.78e-5
    expr: float = 0.03
    jaw: float = 0.03
    coll: float = 0.0
    s2m: float = 0.0
    m2s: float = 0.0
    rho_s2m: float = 0.2
    rho_m2s: float = 0.5
    sdf_penetration: float = 0.003
    contact: float = 0.0
    smooth_acc: float = 0.0
    smooth_vel: float = 0.0
    motion_smooth: float = 1e8
    friction_normal: float = 10.0
    friction_tangent: float = 20.0
    motion_infill_rec: float = 0.0
    motion_infill_contact: float = 0.0
    # the JAX package's frame chunk of its dense self-intersection sweep;
    # unused here: the kernel takes all T frames in one launch, and its
    # plain version bounds its memory by chunking face pairs instead
    coll_frame_chunk: int = 2
    # the penetration term samples the fp8-quantized grid (ProxConfig
    # sdf_fp8); otherwise the bf16 one when `sdf_packed` holds it
    sdf_fp8: bool = False


@dataclasses.dataclass
class ProxStatic:
    """Per-window constants: tensors on the fit's device unless noted.
    `sdf_packed` holds the quantized grid the penetration term samples
    (`ops.sdf.quantize_grid`, bf16 or fp8 as `ProxWeights.sdf_fp8` says);
    `sdf` the f32 grid friction samples."""

    gt_joints: Any            # [T, 118, 2]
    joints_conf: Any          # [T, 118]
    joint_weights: Any        # [118]
    camera: PerspectiveCamera
    R: Any                    # [3, 3] cam2world
    t: Any                    # [3]
    scan: Any = None          # [T, S, 3] padded scan clouds (cam coords)
    scan_mask: Any = None     # [T, S] bool
    body_mask: Any = None     # [V] bool, body without head
    sdf: Any = None           # [D, D, D] f32
    sdf_packed: Any = None    # [D, D, D] f32, quantized
    grid_min: Any = None      # [3]
    grid_max: Any = None      # [3]
    scene_verts: Any = None   # [Ns, 3] world
    contact_verts_ids: Any = None   # int64 ids
    fric_verts_ids: Any = None
    foot_ids: dict | None = None    # {part: int64 ids}
    smooth_enc_params: dict | None = None
    smooth_stats: GlobalStats | None = None
    smooth_marker_ids: Any = None   # [81]
    infill_targets: Any = None      # [Ti, 67, 3] world
    infill_contact_lbl: Any = None  # [Ti, 4]
    marker_mask: Any = None         # [T, 67] 1 = visible
    infill_marker_ids: Any = None   # [67]
    sdf_candidate_ids: Any = None   # [K]
    depth_scan_cand_ids: Any = None  # [T, Ks]
    depth_vert_cand_ids: Any = None  # [T, Kv]
    s2m_frozen: Any = None           # [T, 2]: (frozen gmof sum, n_valid)
    m2s_frozen: Any = None           # [T, 2]: (frozen gmof*vis sum, count)
    depth_vis_frozen: Any = None     # [T, Kv] bool
    faces_vis: Any = None            # [F, 3] int64, vertex normals
    # self-intersection: the body's faces, their part ids and the [P, P]
    # part-pair ignore table (driver.load_part_segm), and per frame the
    # K candidate faces in face-id order (driver._coll_candidate_ids)
    faces: Any = None                # [F, 3] int64
    faces_segm: Any = None           # [F] int64
    ign_table: Any = None            # [P, P] bool
    coll_candidate_ids: Any = None   # [T, K] int64
    image_size: tuple = (1920, 1080)


# fields that carry a leading window axis when a recording's windows are
# batched (window.make_batched_window_fitter); every other field is shared
PER_WINDOW_FIELDS = frozenset({
    "gt_joints", "joints_conf", "scan", "scan_mask", "marker_mask",
    "infill_targets", "infill_contact_lbl", "sdf_candidate_ids",
    "coll_candidate_ids", "depth_scan_cand_ids", "depth_vert_cand_ids",
    "s2m_frozen", "m2s_frozen", "depth_vis_frozen"})
# the per-window fields whose second axis is the window's T frames
_FRAME_FIELDS = PER_WINDOW_FIELDS - {"infill_targets", "infill_contact_lbl",
                                     "sdf_candidate_ids"}


def stack_statics(statics: list) -> ProxStatic:
    """W windows' statics -> one batched ProxStatic: PER_WINDOW_FIELDS
    stacked on a leading axis, the shared fields taken from window 0."""
    kw = {}
    for f in dataclasses.fields(ProxStatic):
        vals = [getattr(s, f.name) for s in statics]
        kw[f.name] = (torch.stack(vals)
                      if f.name in PER_WINDOW_FIELDS and vals[0] is not None
                      else vals[0])
    return ProxStatic(**kw)


def fold_frames(st: ProxStatic, n_frames: int) -> ProxStatic:
    """A batched static's per-frame fields [W, T, ...] -> [W*T, ...], the
    static the per-frame terms see over the folded frame axis."""
    return dataclasses.replace(st, **{
        name: getattr(st, name).reshape(
            (n_frames,) + getattr(st, name).shape[2:])
        for name in _FRAME_FIELDS if getattr(st, name) is not None})


def to_world(points: torch.Tensor, R: torch.Tensor, t: torch.Tensor):
    """cam -> world (fitting_temp_slide.py:679), exact f32."""
    return torch.matmul(points, R.T) + t


def keypoint_loss(proj: torch.Tensor, st: ProxStatic, w_data: float):
    w = (st.joint_weights[None] * st.joints_conf)[..., None]
    return (w ** 2 * (st.gt_joints - proj).abs()).mean() * w_data


def _gather_frames(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """x [T, N, ...], ids [T, K] -> [T, K, ...]."""
    idx = ids.reshape(ids.shape + (1,) * (x.dim() - 2))
    return torch.gather(x, 1, idx.expand(ids.shape + x.shape[2:]))


def frame_visibility(verts_cam: torch.Tensor, st: ProxStatic):
    """[T, V] bool z-buffer visibility with backface culling."""
    cam = st.camera
    v = verts_cam.detach()
    normals = (vertex_normals(v, st.faces_vis)
               if st.faces_vis is not None else None)
    return visibility_zbuffer(v, cam.focal_length_x, cam.focal_length_y,
                              cam.center[0], cam.center[1],
                              st.image_size[0], st.image_size[1],
                              normals=normals)


def _rsqrt_gmof(d2, rho):
    return robust.gmof(torch.sqrt(d2 + 1e-12), rho)


def _per_frame_masked_mean(values, mask):
    """masked_mean over the last axis, per frame: [T, N] -> [T]."""
    m = mask.to(values.dtype)
    total = m.sum(-1)
    return torch.where(total > 0,
                       (values * m).sum(-1) / torch.clamp(total, min=1.0),
                       torch.zeros_like(total))


def depth_frame_terms(verts_cam: torch.Tensor, st: ProxStatic,
                      w: ProxWeights):
    """s2m / m2s Chamfer with per-frame visibility
    (fitting_temp_slide.py:637-670), full or candidate form, per frame
    and unweighted: ([T] or None when its weight is 0, the same for m2s)."""
    s2m = m2s = None
    if st.depth_scan_cand_ids is None:
        vis = frame_visibility(verts_cam, st)
        if w.s2m > 0:
            d2, _ = nn_distance(st.scan, verts_cam, vis)
            s2m = _per_frame_masked_mean(_rsqrt_gmof(d2, w.rho_s2m),
                                         st.scan_mask)
        if w.m2s > 0:
            d2, _ = nn_distance(verts_cam, st.scan, st.scan_mask)
            mask = vis & st.body_mask[None]
            m2s = _per_frame_masked_mean(_rsqrt_gmof(d2, w.rho_m2s), mask)
        return s2m, m2s

    # temporal-coherence subset (driver._depth_candidate_data): live K x K
    # Chamfer on the candidate clouds; non-candidates enter as the frozen
    # warm-start (sum, count) pairs, so the energy equals the full term
    # exactly at refresh time
    sids, vids = st.depth_scan_cand_ids, st.depth_vert_cand_ids
    v_c = _gather_frames(verts_cam, vids)                     # [T, Kv, 3]
    if st.depth_vis_frozen is not None:
        vis_c = st.depth_vis_frozen
    else:
        vis_c = _gather_frames(frame_visibility(verts_cam, st), vids)
    scan_c = _gather_frames(st.scan, sids)                    # [T, Ks, 3]
    scan_m_c = _gather_frames(st.scan_mask, sids)
    if w.s2m > 0:
        d2, _ = nn_distance(scan_c, v_c, vis_c)
        ds = _rsqrt_gmof(d2, w.rho_s2m)
        live = (ds * scan_m_c.to(ds.dtype)).sum(-1)
        n_valid = st.s2m_frozen[:, 1]
        s2m = torch.where(n_valid > 0, (live + st.s2m_frozen[:, 0])
                          / torch.clamp(n_valid, min=1.0),
                          torch.zeros_like(live))
    if w.m2s > 0:
        mask_f = (vis_c & st.body_mask[vids]).to(verts_cam.dtype)
        d2, _ = nn_distance(v_c, scan_c, scan_m_c)
        ds = _rsqrt_gmof(d2, w.rho_m2s)
        live = (ds * mask_f).sum(-1)
        cnt = mask_f.sum(-1) + st.m2s_frozen[:, 1]
        m2s = torch.where(cnt > 0, (live + st.m2s_frozen[:, 0])
                          / torch.clamp(cnt, min=1.0),
                          torch.zeros_like(live))
    return s2m, m2s


def depth_terms(verts_cam: torch.Tensor, st: ProxStatic, w: ProxWeights):
    """The weighted s2m / m2s terms of one window: the frame mean of
    `depth_frame_terms`."""
    zero = verts_cam.new_zeros(())
    s2m, m2s = depth_frame_terms(verts_cam, st, w)
    return (zero if s2m is None else s2m.mean() * w.s2m,
            zero if m2s is None else m2s.mean() * w.m2s)


def friction_terms(verts_world: torch.Tensor, st: ProxStatic,
                   w: ProxWeights):
    """Ground friction (fitting_temp_slide.py:698-739): for friction
    vertices with scene SDF < 1 cm, the tangential inter-frame speed is
    pushed to 0 and the normal component to >= 0."""
    fv = take_rows(verts_world, st.fric_verts_ids)           # [T, Nf, 3]
    sdf_v = sample_sdf_world(st.sdf, fv, st.grid_min, st.grid_max)
    contact = sdf_v[:-1] < 0.01
    vel = fv[1:] - fv[:-1]
    v_dot_n = vel[..., 2]                                   # floor normal z
    v_t = torch.stack([vel[..., 0], vel[..., 1],
                       vel[..., 2] - v_dot_n], dim=-1)
    tangent_mag = torch.sqrt((v_t ** 2).sum(-1) + 1e-12)
    loss_t = robust.masked_mean(tangent_mag, contact & (tangent_mag > 1e-4))
    loss_n = robust.masked_mean(v_dot_n.abs(), contact & (v_dot_n < 0))
    return loss_t * w.friction_tangent, loss_n * w.friction_normal


def contact_frame_terms(verts_world: torch.Tensor, st: ProxStatic):
    """Scene-contact Chamfer (fitting_temp_slide.py:743-753) per frame,
    unweighted: the contact vertices of all T frames against the shared
    scene cloud, one call -> [T]."""
    cv = take_rows(verts_world, st.contact_verts_ids)        # [T, Nc, 3]
    d2, _ = nn_distance(cv, st.scene_verts)
    ds = torch.sqrt(d2 + 1e-4)
    return (ds / (ds + 1.0)).mean(-1)


def contact_term(verts_world: torch.Tensor, st: ProxStatic,
                 w: ProxWeights):
    """The weighted contact term of one window."""
    return contact_frame_terms(verts_world, st).mean() * w.contact


def infill_terms(verts_world: torch.Tensor, st: ProxStatic,
                 w: ProxWeights, foot_sel=None):
    """Motion-infill reconstruction + contact-velocity terms
    (fitting_temp_slide.py:943-992) against the pre-pass targets.
    `foot_sel`: (all foot ids, {part: slice}) selected once."""
    Ti = st.infill_targets.shape[0]
    markers = take_rows(verts_world, st.infill_marker_ids)[:Ti]
    miss = 1.0 - st.marker_mask[:Ti]                           # 1 = occluded
    diff = (st.infill_targets - markers).abs() * miss[..., None]
    rec = robust.masked_mean(diff, (miss[..., None] > 0).expand_as(diff))
    ids, slices = foot_sel
    feet = take_rows(verts_world, ids)
    vel_f = (feet[1:] - feet[:-1]) * 30.0
    cv_total = verts_world.new_zeros(())
    for i, part in enumerate(FOOT_PARTS):
        speeds = torch.sqrt((vel_f[:, slices[part], :] ** 2).sum(-1) + 1e-12)
        lbl = st.infill_contact_lbl[: speeds.shape[0], i][:, None]
        cv_total = cv_total + robust.hinge_above(speeds, 0.1, lbl)
    return rec * w.motion_infill_rec, cv_total * w.motion_infill_contact


def _sample_penetration_sdf(st: ProxStatic, points, w: ProxWeights,
                            sample=sample_sdf_world):
    """The scene SDF the penetration term samples at `points`: the
    quantized grid when the static holds one, else the f32 grid."""
    if st.sdf_packed is not None:
        return sample(st.sdf_packed, points, st.grid_min, st.grid_max,
                      mode="fp8" if w.sdf_fp8 else "bf16")
    return sample(st.sdf, points, st.grid_min, st.grid_max)


def friction_terms_windows(verts_world: torch.Tensor, st: ProxStatic,
                           w: ProxWeights):
    """`friction_terms` of W windows: verts_world [W, T, V, 3] -> the
    tangent and normal terms [W], velocities inside each window."""
    fv = take_rows(verts_world, st.fric_verts_ids)        # [W, T, Nf, 3]
    sdf_v = sample_sdf_windows(st.sdf, fv, st.grid_min, st.grid_max)
    contact = sdf_v[:, :-1] < 0.01
    vel = fv[:, 1:] - fv[:, :-1]
    v_dot_n = vel[..., 2]
    v_t = torch.stack([vel[..., 0], vel[..., 1],
                       vel[..., 2] - v_dot_n], dim=-1)
    tangent_mag = torch.sqrt((v_t ** 2).sum(-1) + 1e-12)
    loss_t = robust.masked_mean_rows(tangent_mag,
                                     contact & (tangent_mag > 1e-4))
    loss_n = robust.masked_mean_rows(v_dot_n.abs(), contact & (v_dot_n < 0))
    return loss_t * w.friction_tangent, loss_n * w.friction_normal


def infill_terms_windows(verts_world: torch.Tensor, st: ProxStatic,
                         w: ProxWeights, foot_sel):
    """`infill_terms` of W windows: verts_world [W, T, V, 3] and the
    batched static -> the reconstruction and contact terms [W]."""
    Ti = st.infill_targets.shape[1]
    markers = take_rows(verts_world, st.infill_marker_ids)[:, :Ti]
    miss = 1.0 - st.marker_mask[:, :Ti]
    diff = (st.infill_targets - markers).abs() * miss[..., None]
    rec = robust.masked_mean_rows(diff, (miss[..., None] > 0).expand_as(diff))
    ids, slices = foot_sel
    feet = take_rows(verts_world, ids)
    vel_f = (feet[:, 1:] - feet[:, :-1]) * 30.0
    cv_total = verts_world.new_zeros(verts_world.shape[0])
    for i, part in enumerate(FOOT_PARTS):
        speeds = torch.sqrt((vel_f[:, :, slices[part], :] ** 2).sum(-1)
                            + 1e-12)                      # [W, T-1, n]
        lbl = st.infill_contact_lbl[:, : speeds.shape[1], i][..., None]
        cv_total = cv_total + robust.hinge_above_rows(
            speeds, 0.1, lbl.expand_as(speeds))
    return rec * w.motion_infill_rec, cv_total * w.motion_infill_contact


def _prior_rows(prior, x: torch.Tensor) -> torch.Tensor:
    """sum(prior(x)) of each window of x [W, T, ...] -> [W]: the L2 prior
    over the window's entries, a row-wise prior over its frames."""
    W = x.shape[0]
    if prior is l2_prior:
        return (x ** 2).reshape(W, -1).sum(1)
    vals = prior(x.reshape((-1,) + x.shape[2:]))
    if not torch.is_tensor(vals):             # the 'none' prior
        return x.new_full((W,), float(vals))
    return vals.reshape(W, -1).sum(1)


def foot_selection(foot_ids: dict, device):
    """(all foot vertex ids, {part: slice}) in FOOT_PARTS order."""
    all_ids, slices, off = [], {}, 0
    for part in FOOT_PARTS:
        ids = torch.as_tensor(foot_ids[part], dtype=torch.int64)
        slices[part] = slice(off, off + len(ids))
        all_ids.append(ids)
        off += len(ids)
    return torch.cat(all_ids).to(device), slices


def make_prox_loss(forward_fn, consts, joint_mapper, vposer_params,
                   st_template: ProxStatic, w: ProxWeights,
                   num_expressions: int = 10, priors: dict | None = None,
                   use_vposer: bool = True):
    """loss(opt_vars, betas, st) -> (total, {term: scalar tensor}).

    opt_vars: {transl, global_orient, left/right_hand_pose, jaw_pose,
    leye_pose, reye_pose, expression, pose_embedding (or body_pose)},
    each [T, ...]. `st_template` decides which terms exist. `priors` maps
    {body, left_hand, right_hand, jaw, expr, shape} to callables
    (`priors.body_priors.create_prior`); missing entries are L2. With
    VPoser the pose prior is the latent L2; hand/expression priors are
    summed then scaled by weight**2; the jaw prior sees jaw * weight.
    """
    priors = dict(priors or {})
    p_body = priors.get("body", l2_prior)
    p_lhand = priors.get("left_hand", l2_prior)
    p_rhand = priors.get("right_hand", l2_prior)
    p_jaw = priors.get("jaw", l2_prior)
    p_expr = priors.get("expr", l2_prior)
    p_shape = priors.get("shape", l2_prior)
    device = consts["v_template"].device
    jm = torch.as_tensor(joint_mapper, dtype=torch.int64, device=device)
    foot_sel = (foot_selection(st_template.foot_ids, device)
                if st_template.foot_ids is not None else None)

    def forward_part(opt_vars, betas, decode_rows: int | None = None):
        """SMPL-X forward on the frame batch [T, ...] (`decode_rows`:
        the block of rows of `vposer.decode` and of the body model's
        hand products, a window's frames in a fold)."""
        body_pose = (vp.decode(vposer_params, opt_vars["pose_embedding"],
                               "aa", rows=decode_rows)
                     if use_vposer else opt_vars["body_pose"])
        params = {k: opt_vars[k] for k in (
            "transl", "global_orient", "left_hand_pose", "right_hand_pose",
            "jaw_pose", "leye_pose", "reye_pose", "expression")}
        params["betas"] = betas
        params["body_pose"] = body_pose
        return forward_fn(params, consts, rows=decode_rows)

    def terms_part(opt_vars, betas, out, st: ProxStatic):
        verts = out["vertices"]                          # [T, V, 3] cam
        joints_all = out["joints"]
        mapped = joints_all.index_select(1, jm)
        zero = verts.new_zeros(())
        terms = {}
        terms["joint_loss"] = keypoint_loss(st.camera.project(mapped), st,
                                            w.data)
        if use_vposer:
            terms["pprior_loss"] = (opt_vars["pose_embedding"] ** 2).sum() \
                * w.body_pose ** 2
        else:
            terms["pprior_loss"] = torch.sum(
                p_body(opt_vars["body_pose"])) * w.body_pose ** 2
        terms["shape_loss"] = torch.sum(p_shape(betas)) * w.shape ** 2
        terms["angle_prior_loss"] = angle_prior(
            out["full_pose"][:, 3:66]).sum() * \
            (w.bending_factor * w.body_pose) ** 2
        terms["hand_prior_loss"] = (
            torch.sum(p_lhand(opt_vars["left_hand_pose"]))
            + torch.sum(p_rhand(opt_vars["right_hand_pose"]))) * \
            w.hand_prior ** 2
        terms["expression_loss"] = torch.sum(
            p_expr(opt_vars["expression"])) * w.expr ** 2
        terms["jaw_prior_loss"] = torch.sum(p_jaw(opt_vars["jaw_pose"]
                                                  * w.jaw))
        if w.coll > 0 and st.faces is not None:
            terms["self_penetration_loss"] = w.coll * \
                batched_self_intersection(
                    verts, st.faces, candidate_ids=st.coll_candidate_ids,
                    segm=st.faces_segm, ign_table=st.ign_table).sum()
        else:
            terms["self_penetration_loss"] = zero

        if (w.s2m > 0 or w.m2s > 0) and st.scan is not None:
            terms["s2m_dist"], terms["m2s_dist"] = depth_terms(verts, st, w)
        else:
            terms["s2m_dist"] = terms["m2s_dist"] = zero

        verts_world = to_world(verts, st.R, st.t)
        joints_world = to_world(joints_all, st.R, st.t)

        if w.sdf_penetration > 0 and st.sdf is not None:
            vsel = (verts_world.index_select(1, st.sdf_candidate_ids)
                    if st.sdf_candidate_ids is not None else verts_world)
            sdf_vals = _sample_penetration_sdf(st, vsel, w)
            pen = torch.where(sdf_vals < 0, -sdf_vals,
                              torch.zeros_like(sdf_vals))
            terms["sdf_penetration_loss"] = w.sdf_penetration * pen.sum()
        else:
            terms["sdf_penetration_loss"] = zero

        if (w.friction_normal > 0 or w.friction_tangent > 0) and \
                st.fric_verts_ids is not None and st.sdf is not None:
            terms["loss_fric_tangent"], terms["loss_fric_normal"] = \
                friction_terms(verts_world, st, w)
        else:
            terms["loss_fric_tangent"] = terms["loss_fric_normal"] = zero

        if w.contact > 0 and st.scene_verts is not None:
            terms["contact_loss"] = contact_term(verts_world, st, w)
        else:
            terms["contact_loss"] = zero

        terms["smooth_acc_loss"] = terms["smooth_vel_loss"] = zero
        terms["motion_prior_smooth_loss"] = zero
        if st.smooth_marker_ids is not None:
            markers_s = take_rows(verts, st.smooth_marker_ids)
            if w.smooth_acc > 0:
                mv = markers_s[1:] - markers_s[:-1]
                terms["smooth_acc_loss"] = ((mv[1:] - mv[:-1]) ** 2).mean() \
                    * w.smooth_acc
            if w.smooth_vel > 0:
                terms["smooth_vel_loss"] = ((markers_s[1:] - markers_s[:-1])
                                            ** 2).mean() * w.smooth_vel
            if w.motion_smooth > 0 and st.smooth_enc_params is not None:
                terms["motion_prior_smooth_loss"] = w.motion_smooth * \
                    smoothness_prior_loss(
                        st.smooth_enc_params,
                        take_rows(verts_world, st.smooth_marker_ids),
                        joints_world[0, :25], st.smooth_stats)

        if w.motion_infill_rec > 0 and st.infill_targets is not None:
            terms["motion_infill_loss"], \
                terms["motion_infill_contact_loss"] = infill_terms(
                    verts_world, st, w, foot_sel)
        else:
            terms["motion_infill_loss"] = zero
            terms["motion_infill_contact_loss"] = zero

        total = sum(terms.values())
        terms["total_loss"] = total
        return total, terms

    def terms_folded(opt_vars, betas, out, st: ProxStatic):
        """`terms_part` of W windows at once: opt_vars and betas
        [W, T, ...], `out` the forward of their [W*T] frame batch viewed
        [W, T, ...], `st` batched (`stack_statics`) -> (totals [W],
        {term: [W]}). The kernel-carrying terms (self-intersection, depth,
        contact) take the W*T frames in one call; the others reduce over
        each window's frames."""
        verts = out["vertices"]                          # [W, T, V, 3] cam
        W, T = verts.shape[:2]
        N = W * T

        def rows(x):
            return x.reshape(W, -1)

        def per_window_mean(x):                          # [N] -> [W]
            return x.reshape(W, T).mean(1)

        st_f = fold_frames(st, N)
        verts_f = verts.reshape((N,) + verts.shape[2:])
        joints_all = out["joints"]
        mapped = joints_all.index_select(2, jm)
        zero = verts.new_zeros(W)
        terms = {}
        jw = (st.joint_weights * st.joints_conf)[..., None]
        terms["joint_loss"] = rows(
            jw ** 2 * (st.gt_joints - st.camera.project(mapped)).abs()
        ).mean(1) * w.data
        if use_vposer:
            terms["pprior_loss"] = rows(opt_vars["pose_embedding"] ** 2
                                        ).sum(1) * w.body_pose ** 2
        else:
            terms["pprior_loss"] = _prior_rows(
                p_body, opt_vars["body_pose"]) * w.body_pose ** 2
        terms["shape_loss"] = _prior_rows(p_shape, betas) * w.shape ** 2
        full_pose = out["full_pose"]
        terms["angle_prior_loss"] = rows(angle_prior(
            full_pose.reshape((N,) + full_pose.shape[2:])[:, 3:66])).sum(1) \
            * (w.bending_factor * w.body_pose) ** 2
        terms["hand_prior_loss"] = (
            _prior_rows(p_lhand, opt_vars["left_hand_pose"])
            + _prior_rows(p_rhand, opt_vars["right_hand_pose"])) * \
            w.hand_prior ** 2
        terms["expression_loss"] = _prior_rows(
            p_expr, opt_vars["expression"]) * w.expr ** 2
        terms["jaw_prior_loss"] = _prior_rows(p_jaw,
                                              opt_vars["jaw_pose"] * w.jaw)
        if w.coll > 0 and st.faces is not None:
            terms["self_penetration_loss"] = w.coll * \
                batched_self_intersection(
                    verts_f, st.faces, candidate_ids=st_f.coll_candidate_ids,
                    segm=st.faces_segm, ign_table=st.ign_table
                ).reshape(W, T).sum(1)
        else:
            terms["self_penetration_loss"] = zero

        terms["s2m_dist"] = terms["m2s_dist"] = zero
        if (w.s2m > 0 or w.m2s > 0) and st.scan is not None:
            s2m, m2s = depth_frame_terms(verts_f, st_f, w)
            if s2m is not None:
                terms["s2m_dist"] = per_window_mean(s2m) * w.s2m
            if m2s is not None:
                terms["m2s_dist"] = per_window_mean(m2s) * w.m2s

        verts_world = to_world(verts, st.R, st.t)
        joints_world = to_world(joints_all, st.R, st.t)

        if w.sdf_penetration > 0 and st.sdf is not None:
            if st.sdf_candidate_ids is not None:
                ids = st.sdf_candidate_ids                # [W, K]
                vsel = torch.gather(verts_world, 2, ids[:, None, :, None]
                                    .expand(W, T, ids.shape[1], 3))
            else:
                vsel = verts_world
            sdf_vals = _sample_penetration_sdf(st, vsel, w,
                                               sample=sample_sdf_windows)
            pen = torch.where(sdf_vals < 0, -sdf_vals,
                              torch.zeros_like(sdf_vals))
            terms["sdf_penetration_loss"] = w.sdf_penetration * rows(pen).sum(1)
        else:
            terms["sdf_penetration_loss"] = zero

        if (w.friction_normal > 0 or w.friction_tangent > 0) and \
                st.fric_verts_ids is not None and st.sdf is not None:
            terms["loss_fric_tangent"], terms["loss_fric_normal"] = \
                friction_terms_windows(verts_world, st, w)
        else:
            terms["loss_fric_tangent"] = terms["loss_fric_normal"] = zero

        if w.contact > 0 and st.scene_verts is not None:
            terms["contact_loss"] = per_window_mean(contact_frame_terms(
                verts_world.reshape((N,) + verts_world.shape[2:]), st)) \
                * w.contact
        else:
            terms["contact_loss"] = zero

        terms["smooth_acc_loss"] = terms["smooth_vel_loss"] = zero
        terms["motion_prior_smooth_loss"] = zero
        if st.smooth_marker_ids is not None:
            markers_s = take_rows(verts, st.smooth_marker_ids)
            if w.smooth_acc > 0:
                mv = markers_s[:, 1:] - markers_s[:, :-1]
                terms["smooth_acc_loss"] = rows(
                    (mv[:, 1:] - mv[:, :-1]) ** 2).mean(1) * w.smooth_acc
            if w.smooth_vel > 0:
                terms["smooth_vel_loss"] = rows(
                    (markers_s[:, 1:] - markers_s[:, :-1]) ** 2).mean(1) \
                    * w.smooth_vel
            if w.motion_smooth > 0 and st.smooth_enc_params is not None:
                terms["motion_prior_smooth_loss"] = w.motion_smooth * \
                    smoothness_prior_loss_batched(
                        st.smooth_enc_params,
                        take_rows(verts_world, st.smooth_marker_ids),
                        joints_world[:, 0, :25], st.smooth_stats,
                        reduce_clips=False)

        if w.motion_infill_rec > 0 and st.infill_targets is not None:
            terms["motion_infill_loss"], \
                terms["motion_infill_contact_loss"] = infill_terms_windows(
                    verts_world, st, w, foot_sel)
        else:
            terms["motion_infill_loss"] = zero
            terms["motion_infill_contact_loss"] = zero

        total = sum(terms.values())
        terms["total_loss"] = total
        return total, terms

    def loss_fn(opt_vars, betas, st: ProxStatic = st_template):
        return terms_part(opt_vars, betas, forward_part(opt_vars, betas), st)

    loss_fn.forward_part = forward_part
    loss_fn.terms_part = terms_part
    loss_fn.terms_folded = terms_folded
    return loss_fn
