"""Linear blend skinning on torch tensors (port of
`lemo_tpu/body_model/lbs.py`).

Two paths, as in `lemo_tpu`:

- the separate-matmul path (`lbs` without fused constants): blend
  shapes, joint regression, Rodrigues, the level-scheduled kinematic
  chain and skinning as separate ops — what `lemo_tpu` runs off the
  TPU. It runs on the CPU only, and raises for a tensor on the card;
- the fused plane-major path (`_lbs_fused`, taken whenever the model
  carries the fused constants, which it always does on the card): the
  chain and vertex kernels of `chain_cuda.py` / `vertex_cuda.py`, with
  only the tiny joint outputs and the final vertex transpose in
  [B, ...] layout.

Matmuls here are f32: callers on the card turn TF32 off
(`lemo_tpu_torch.exact_f32_matmuls`).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from lemo_tpu_torch.body_model.chain_cuda import _pad_to, chain_affine_planes
from lemo_tpu_torch.body_model.vertex_cuda import (
    LANE, fused_lbs_vertices_planes)
from lemo_tpu_torch.ops.rotations import aa_to_matrot, aa_to_matrot_planes


def lane_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K] @ b [K, Bp] (Bp a multiple of LANE). On a CUDA tensor, one
    product a LANE columns of b: cuBLAS picks its kernel, and with it the
    rounding of each column, by N, so every frame's column rounds as in
    a batch of at most LANE frames (one clip, one window) alone, whatever
    the fold around it (one product of all 1,024 columns of an 8-clip
    AMASS fold rounded its rest joints apart). On the CPU one product,
    `lemo_tpu`'s order."""
    if not b.is_cuda or b.shape[1] <= LANE:
        return torch.matmul(a, b)
    return torch.cat([torch.matmul(a, c.contiguous())
                      for c in b.split(LANE, dim=1)], dim=1)


def blend_shapes(betas: torch.Tensor,
                 shape_dirs_flat: torch.Tensor) -> torch.Tensor:
    """betas [B, S] x shape_dirs_flat [S, V*3] -> [B, V, 3]."""
    return torch.matmul(betas, shape_dirs_flat).reshape(betas.shape[0], -1, 3)


def vertices2joints(J_regressor: torch.Tensor,
                    vertices: torch.Tensor) -> torch.Tensor:
    """J_regressor [J, V] x vertices [B, V, 3] -> joints [B, J, 3]."""
    return torch.einsum("bvk,jv->bjk", vertices, J_regressor)


def _depth_levels(parents) -> list:
    """Joints 1..J-1 grouped by kinematic-tree depth (static topology)."""
    J = len(parents)
    depth = np.full(J, -1, np.int64)
    depth[0] = 0

    def d(i: int) -> int:
        if depth[i] < 0:
            depth[i] = d(int(parents[i])) + 1
        return int(depth[i])

    for i in range(1, J):
        d(i)
    return [np.nonzero(depth == lvl)[0]
            for lvl in range(1, int(depth.max()) + 1)]


def rigid_transform_chain_level(rot_mats, joints, parents):
    """Compose per-joint local transforms along the kinematic tree, one
    batched compose per tree depth.

    rot_mats [B, J, 3, 3], joints (rest pose) [B, J, 3], parents [J]
    ints (parents[0] ignored). Returns (posed_joints [B, J, 3],
    rel_transforms [B, J, 3, 4]); works for any topology.
    """
    J = joints.shape[1]
    dev = joints.device
    parents = np.asarray(parents, np.int64)
    par_idx = torch.as_tensor(parents[1:], device=dev)
    rel_joints = torch.cat(
        [joints[:, :1], joints[:, 1:] - joints[:, par_idx]], dim=1)

    levels = _depth_levels(parents)
    perm = [0] + [int(i) for lvl in levels for i in lvl]
    pos = {j: k for k, j in enumerate(perm)}
    perm_t = torch.as_tensor(perm, device=dev)
    Rl_all = rot_mats[:, perm_t]
    tl_all = rel_joints[:, perm_t]
    R_cat, t_cat = Rl_all[:, 0:1], tl_all[:, 0:1]
    off = 1
    for lvl in levels:
        n = len(lvl)
        sel = torch.as_tensor([pos[int(parents[int(i)])] for i in lvl],
                              device=dev)
        Rp = R_cat[:, sel]
        tp = t_cat[:, sel]
        Rl = Rl_all[:, off:off + n]
        tl = tl_all[:, off:off + n]
        R_cat = torch.cat([R_cat, torch.matmul(Rp, Rl)], dim=1)
        t_cat = torch.cat(
            [t_cat, torch.einsum("blmn,bln->blm", Rp, tl) + tp], dim=1)
        off += n
    inv = torch.as_tensor([pos[j] for j in range(J)], device=dev)
    Rg = R_cat[:, inv]
    tg = t_cat[:, inv]

    rel_t = tg - torch.einsum("bjmn,bjn->bjm", Rg, joints)
    rel = torch.cat([Rg, rel_t[..., None]], dim=-1)  # [B, J, 3, 4]
    return tg, rel


def lbs(
    shape_components: torch.Tensor,  # [B, S] betas (+expression)
    pose: torch.Tensor,  # [B, J*3] axis-angle, or [B, J*9] matrices
    v_template: torch.Tensor,  # [V, 3]
    shapedirs_flat: torch.Tensor,  # [S, V*3]
    posedirs: torch.Tensor | None,  # [9*(J-1), V*3] or None
    J_regressor: torch.Tensor,  # [J, V]
    parents,  # [J] numpy ints
    lbs_weights: torch.Tensor,  # [V, J]
    *,
    pose2rot: bool = True,
    fused_consts: dict[str, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Full LBS forward -> (vertices [B, V, 3], joints [B, J, 3]).
    `pose` holds each joint's axis-angle, or with `pose2rot=False` its
    rotation matrix (row-major, incl. root), which then goes into the
    chain as it is and receives its own gradient. `fused_consts`
    (fused_dirs, lbs_w_pad, j_ext) selects the fused kernel path;
    without them only CPU tensors are accepted."""
    B = shape_components.shape[0]
    V = v_template.shape[0]

    if fused_consts is not None:
        return _lbs_fused(shape_components, pose, parents, fused_consts, V,
                          pose2rot=pose2rot)
    if shape_components.device.type != "cpu":
        raise ValueError("lbs: on the card only the fused kernel path "
                         "runs; load the model with its fused constants")

    v_shaped = v_template[None] + blend_shapes(shape_components,
                                               shapedirs_flat)
    J = vertices2joints(J_regressor, v_shaped)  # [B, J, 3]
    if pose2rot:
        rot_mats = aa_to_matrot(pose.reshape(B, -1, 3))  # [B, J, 3, 3]
    else:
        rot_mats = pose.reshape(B, -1, 3, 3)

    if posedirs is not None:
        ident = torch.eye(3, dtype=rot_mats.dtype, device=rot_mats.device)
        pose_feature = (rot_mats[:, 1:] - ident).reshape(B, -1)
        v_posed = v_shaped + torch.matmul(pose_feature,
                                          posedirs).reshape(B, V, 3)
    else:
        v_posed = v_shaped

    posed_joints, A = rigid_transform_chain_level(rot_mats, J, parents)

    # skinning as one [V, J] @ [J, B*12] matmul, V-major
    num_joints = J_regressor.shape[0]
    A_t = A.reshape(B, num_joints, 12).transpose(0, 1)     # [J, B, 12]
    T_vb = torch.matmul(lbs_weights, A_t.reshape(num_joints, B * 12)
                        ).reshape(V, B, 3, 4)
    v_posed_t = v_posed.transpose(0, 1)                    # [V, B, 3]
    verts_vb = (torch.einsum("vbmn,vbn->vbm", T_vb[..., :3], v_posed_t)
                + T_vb[..., 3])
    return verts_vb.transpose(0, 1), posed_joints


def _lbs_fused(shape_components, pose, parents, fc, num_verts, *,
               pose2rot=True):
    """Fused, plane-major vertex path ([comp, J|V, B] planes, the frame
    batch padded to LANE): rest-pose joints from the shape components via
    `j_ext`, Rodrigues on pose planes (with `pose2rot=False` the rotation
    planes are the given matrices), the chain kernel (which also forms
    the rel-joint translations and the bone affines as planes), and the
    fused vertex kernel. The pose-feature rows of the blend input are a
    reshape of the rotation planes (the posedirs columns were permuted to
    match at load)."""
    B = shape_components.shape[0]
    Jp = fc["lbs_w_pad"].shape[1]
    J = fc["j_ext"].shape[0] // 3
    Bp = B + _pad_to(B, LANE)
    dev = shape_components.device

    # rest-pose joint planes [3, Jp, Bp] from the shape components
    shape_T = F.pad(shape_components.T, (0, Bp - B))                 # [S, Bp]
    ones = torch.ones((1, Bp), dtype=shape_T.dtype, device=dev)
    jr = lane_matmul(fc["j_ext"], torch.cat([shape_T, ones])
                     ).reshape(3, J, Bp)
    jr = F.pad(jr, (0, 0, 0, Jp - J))

    # local rotation planes [9, Jp, Bp] (row k = 3m+n holds R[m, n])
    if pose2rot:
        p_pl = pose.reshape(B, J, 3).permute(2, 1, 0)            # [3, J, B]
        rl = aa_to_matrot_planes(F.pad(p_pl, (0, Bp - B, 0, Jp - J)))
    else:
        rl = F.pad(pose.reshape(B, J, 9).permute(2, 1, 0),
                   (0, Bp - B, 0, Jp - J))

    # the chain with the rel-joint translations tl[j] = jr[j] - jr[parent(j)]
    # before it and the bone affines A_pl = [rg; tg - rg jr] after it
    A_pl, tg = chain_affine_planes(rl, jr, parents)    # [12|3, Jp, Bp]

    # pose-feature rows r = k*(J-1) + (j-1)
    ident_k = torch.eye(3, dtype=rl.dtype, device=dev).reshape(9, 1, 1)
    pf = (rl[:, 1:J, :] - ident_k).reshape(9 * (J - 1), Bp)
    catT = torch.cat([shape_T, pf, ones])

    out = fused_lbs_vertices_planes(catT, A_pl, fc["fused_dirs"],
                                    fc["lbs_w_pad"])  # [3, Vp, Bp]
    verts = out[:, :num_verts, :B].permute(2, 1, 0)
    posed_joints = tg[:, :J, :B].permute(2, 1, 0)
    return verts, posed_joints
