"""SMPL / SMPL-H / SMPL-X forward on torch tensors (port of
`lemo_tpu/body_model/smplx.py`).

Model constants live in a plain dict of tensors on the model's device
(`consts`), the static configuration in a NamedTuple (`SmplxConfig`);
`make_forward_fn` binds them into f(params, consts) -> outputs.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from lemo_tpu_torch import resolve_device
from lemo_tpu_torch.body_model import lbs as _lbs
from lemo_tpu_torch.body_model.vertex_ids import extra_joint_vertex_ids
from lemo_tpu_torch.body_model.vposer import by_rows

_NUM_BODY_JOINTS = {"smpl": 21, "smplh": 21, "smplx": 21}


class SmplxConfig(NamedTuple):
    """Static model configuration."""

    model_type: str = "smplx"
    gender: str = "neutral"
    num_betas: int = 10
    num_expressions: int = 10
    use_pca: bool = False
    num_pca_comps: int = 12
    flat_hand_mean: bool = False
    use_posedirs: bool = True
    use_face_landmarks: bool = True
    use_extra_joints: bool = True


@dataclasses.dataclass
class SmplxModel:
    """A loaded body model: static config + constant tensors on `device`."""

    config: SmplxConfig
    consts: dict[str, torch.Tensor]
    faces: np.ndarray  # [F, 3] int32 (host)
    parents: np.ndarray  # [J] int64 (host, static topology)
    num_verts: int
    num_joints: int  # regressor joints
    device: torch.device

    def zero_params(self, batch_size: int = 1) -> dict[str, torch.Tensor]:
        """All-zeros parameter dict on the model's device."""
        c = self.config
        nhand = c.num_pca_comps if c.use_pca else 45
        shapes = {"transl": 3, "global_orient": 3, "betas": c.num_betas}
        if c.model_type in ("smpl", "smplh", "smplx"):
            shapes["body_pose"] = 3 * _NUM_BODY_JOINTS[c.model_type]
        if c.model_type == "smpl":
            shapes["left_hand_pose"] = 3
            shapes["right_hand_pose"] = 3
        elif c.model_type in ("smplh", "smplx"):
            shapes["left_hand_pose"] = nhand
            shapes["right_hand_pose"] = nhand
        elif c.model_type == "mano":
            shapes["hand_pose"] = nhand
        if c.model_type == "smplx":
            shapes["jaw_pose"] = 3
            shapes["leye_pose"] = 3
            shapes["reye_pose"] = 3
            shapes["expression"] = c.num_expressions
        return {k: torch.zeros((batch_size, n), dtype=torch.float32,
                               device=self.device)
                for k, n in shapes.items()}


def find_smplx_npz(base_path: str, gender: str) -> str:
    """Resolve a SMPL-X npz under any of the conventional layouts:
    <base>/SMPLX_<G>.npz, <base>/smplx/SMPLX_<G>.npz,
    <base>/smplx_model/smplx/SMPLX_<G>.npz (the reference's
    body_models/smplx_model convention)."""
    import os

    fname = f"SMPLX_{gender.upper()}.npz"
    for cand in (
        os.path.join(base_path, fname),
        os.path.join(base_path, "smplx", fname),
        os.path.join(base_path, "smplx_model", fname),
        os.path.join(base_path, "smplx_model", "smplx", fname),
    ):
        if os.path.exists(cand):
            return cand
    raise FileNotFoundError(
        f"no {fname} under {base_path} (tried ./, smplx/, smplx_model/)")


def load_model(
    bm_path_or_dict: Any,
    model_type: str | None = None,
    gender: str = "neutral",
    num_betas: int = 10,
    num_expressions: int = 10,
    use_pca: bool = False,
    num_pca_comps: int = 12,
    flat_hand_mean: bool = False,
    use_posedirs: bool = True,
    build_fused: bool | None = None,
    device=None,
) -> SmplxModel:
    """Load a SMPL-family model from an official .npz (or a dict with the
    same keys) onto `device` (None: the CUDA card; raises without CUDA).

    `build_fused`: attach the fused vertex-path constants (~64 MB at full
    size). On the card they are always built — the fused kernels are the
    only path there — and False raises. On the CPU, None and False keep
    the separate-matmul path, and True runs the fused path through the
    kernels' plain twins.
    """
    dev = resolve_device(device)
    if dev.type == "cuda":
        if build_fused is False:
            raise ValueError("load_model: on the card the body model runs "
                             "only through the fused kernels; "
                             "build_fused=False is for the CPU")
        build_fused = True
    if isinstance(bm_path_or_dict, str):
        with np.load(bm_path_or_dict, allow_pickle=True) as z:
            smpl_dict = {k: z[k] for k in z.files}
    else:
        smpl_dict = dict(bm_path_or_dict)

    posedirs_raw = np.asarray(smpl_dict["posedirs"], np.float64)
    njoints = posedirs_raw.shape[2] // 3
    inferred = {69: "smpl", 153: "smplh", 162: "smplx", 45: "mano"}[njoints]
    if model_type is None:
        model_type = inferred
    if model_type != inferred:
        raise ValueError(f"model_type {model_type} but posedirs say "
                         f"{inferred}")

    V = smpl_dict["v_template"].shape[0]
    shapedirs_all = np.asarray(smpl_dict["shapedirs"], np.float64)  # [V,3,S]
    num_total = shapedirs_all.shape[-1]
    num_betas_eff = num_total if num_betas < 1 else min(num_betas, num_total)
    shapedirs = shapedirs_all[:, :, :num_betas_eff]

    consts: dict[str, np.ndarray] = {}
    if model_type == "smplx":
        begin = 300 if num_total > 300 else 10
        exprdirs = shapedirs_all[:, :, begin: begin + num_expressions]
        shape_expr = np.concatenate([shapedirs, exprdirs], axis=-1)
    else:
        shape_expr = shapedirs
    consts["shapedirs_flat"] = shape_expr.reshape(V * 3, -1).T.astype(
        np.float32)
    if use_posedirs:
        consts["posedirs"] = posedirs_raw.reshape(V * 3, -1).T.astype(
            np.float32)

    consts["v_template"] = np.asarray(smpl_dict["v_template"], np.float32)
    J_regressor = np.asarray(smpl_dict["J_regressor"], np.float64)
    if J_regressor.ndim != 2:  # sparse-stored variants
        J_regressor = np.asarray(J_regressor.item().todense())
    consts["J_regressor"] = J_regressor.astype(np.float32)
    consts["lbs_weights"] = np.asarray(smpl_dict["weights"], np.float32)

    if build_fused:
        from lemo_tpu_torch.body_model.vertex_cuda import build_fused_consts

        # without pose blend shapes the pose block of the dirs is zero, so
        # the kernels add exactly nothing for it
        v_template_f64 = np.asarray(smpl_dict["v_template"], np.float64)
        consts.update(build_fused_consts(
            shape_expr,
            posedirs_raw if use_posedirs else np.zeros_like(posedirs_raw),
            v_template_f64, consts["lbs_weights"], J_regressor))

    kintree = np.asarray(smpl_dict["kintree_table"], np.int64)
    parents = kintree[0].copy()
    parents[0] = 0  # root sentinel (stored as 2**32-1 in official files)

    faces = np.asarray(smpl_dict["f"], np.int64).astype(np.int32)

    if model_type in ("smplh", "smplx", "mano") and \
            "hands_componentsl" in smpl_dict:
        compl = np.asarray(smpl_dict["hands_componentsl"], np.float64)
        compr = np.asarray(smpl_dict["hands_componentsr"], np.float64)
        meanl = np.asarray(smpl_dict["hands_meanl"], np.float64)
        meanr = np.asarray(smpl_dict["hands_meanr"], np.float64)
        if use_pca:
            consts["hand_comps_l"] = compl[:num_pca_comps].astype(np.float32)
            consts["hand_comps_r"] = compr[:num_pca_comps].astype(np.float32)
        consts["hand_mean_l"] = (
            np.zeros_like(meanl) if flat_hand_mean else meanl
        ).astype(np.float32)
        consts["hand_mean_r"] = (
            np.zeros_like(meanr) if flat_hand_mean else meanr
        ).astype(np.float32)

    config = SmplxConfig(
        model_type=model_type,
        gender=gender,
        num_betas=num_betas_eff,
        num_expressions=num_expressions,
        use_pca=use_pca,
        num_pca_comps=num_pca_comps,
        flat_hand_mean=flat_hand_mean,
        use_posedirs=use_posedirs,
        use_face_landmarks=(model_type == "smplx"
                            and "lmk_faces_idx" in smpl_dict),
        use_extra_joints=model_type in ("smpl", "smplh", "smplx"),
    )
    if config.use_extra_joints:
        extra_ids = np.clip(extra_joint_vertex_ids(model_type), 0, V - 1)
        consts["extra_joint_ids"] = extra_ids.astype(np.int64)

    if config.use_face_landmarks:
        lmk_faces_idx = np.asarray(smpl_dict["lmk_faces_idx"], np.int64)
        lmk_bary = np.asarray(smpl_dict["lmk_bary_coords"], np.float64)
        consts["lmk_vert_ids"] = faces[lmk_faces_idx].astype(np.int64)
        consts["lmk_bary"] = lmk_bary.astype(np.float32)  # [51, 3]

    return SmplxModel(
        config=config,
        consts={k: torch.as_tensor(v, device=dev) for k, v in consts.items()},
        faces=faces,
        parents=parents,
        num_verts=V,
        num_joints=J_regressor.shape[0],
        device=dev,
    )


def full_pose_from_params(params: dict[str, torch.Tensor],
                          consts: dict[str, torch.Tensor],
                          config: SmplxConfig,
                          rows: int | None = None) -> torch.Tensor:
    """The [B, J*3] axis-angle pose vector. SMPL-X order: root(3),
    body(63), jaw(3), leye(3), reye(3), left_hand(45), right_hand(45);
    hands PCA-decoded and mean-offset when configured so (their products
    by `rows`: `vposer.by_rows`)."""
    mt = config.model_type

    def hand(side: str) -> torch.Tensor:
        raw = params[f"{side}_hand_pose"]
        if config.use_pca:
            comps = consts[f"hand_comps_{side[0]}"]
            raw = by_rows(lambda c: torch.matmul(c, comps), raw, rows)
        if f"hand_mean_{side[0]}" in consts:
            raw = raw + consts[f"hand_mean_{side[0]}"]
        return raw

    if mt == "smplx":
        return torch.cat([params["global_orient"], params["body_pose"],
                          params["jaw_pose"], params["leye_pose"],
                          params["reye_pose"], hand("left"), hand("right")],
                         dim=1)
    if mt == "smplh":
        return torch.cat([params["global_orient"], params["body_pose"],
                          hand("left"), hand("right")], dim=1)
    if mt == "smpl":
        return torch.cat([params["global_orient"], params["body_pose"],
                          params["left_hand_pose"],
                          params["right_hand_pose"]], dim=1)
    if mt == "mano":
        raw = params["hand_pose"]
        if config.use_pca and "hand_comps_l" in consts:
            raw = torch.matmul(raw, consts["hand_comps_l"])
        if "hand_mean_l" in consts:
            raw = raw + consts["hand_mean_l"]
        return torch.cat([params["global_orient"], raw], dim=1)
    raise ValueError(mt)


def smplx_forward(params: dict[str, torch.Tensor],
                  consts: dict[str, torch.Tensor],
                  config: SmplxConfig,
                  parents: tuple,
                  joint_mapper: torch.Tensor | None = None,
                  rows: int | None = None) -> dict[str, torch.Tensor]:
    """Forward pass; params are [B, ...]. Returns {vertices [B, V, 3],
    joints [B, K, 3], full_pose [B, J*3]} (K = 127 for SMPL-X). Takes the
    fused path whenever `consts` carry the fused constants. `rows`: the
    frames of one fit in a batch of several (a window of the PROX fold);
    on the card each block's hand products then round as that fit's
    alone (`vposer.by_rows`; the kernels compute each frame alone)."""
    full_pose = full_pose_from_params(params, consts, config, rows)
    if config.model_type == "smplx":
        shape_comp = torch.cat([params["betas"], params["expression"]], dim=1)
    else:
        shape_comp = params["betas"]

    fused_consts = None
    if "fused_dirs" in consts:
        fused_consts = {k: consts[k] for k in
                        ("fused_dirs", "lbs_w_pad", "j_ext")}
    verts, joints = _lbs.lbs(
        shape_comp, full_pose, consts["v_template"],
        consts["shapedirs_flat"], consts.get("posedirs"),
        consts["J_regressor"], np.asarray(parents, np.int64),
        consts["lbs_weights"], fused_consts=fused_consts)

    if config.use_extra_joints and "extra_joint_ids" in consts:
        joints = torch.cat(
            [joints, verts.index_select(1, consts["extra_joint_ids"])], dim=1)

    if config.use_face_landmarks and "lmk_vert_ids" in consts:
        ids = consts["lmk_vert_ids"]                   # [51, 3]
        tri = verts.index_select(1, ids.reshape(-1)).reshape(
            verts.shape[0], ids.shape[0], 3, 3)        # [B, 51, 3v, 3]
        lmk = torch.einsum("blvk,lv->blk", tri, consts["lmk_bary"])
        joints = torch.cat([joints, lmk], dim=1)

    if joint_mapper is not None:
        joints = joints.index_select(1, joint_mapper)

    if verts.is_cuda:
        verts, joints = _Translate.apply(verts, joints, params["transl"])
    else:
        # lemo_tpu's broadcast add: the CPU tests hold whole fits to its
        # (a two-window PROX fit moved 1.4e-3 in loss with the halving)
        transl = params["transl"][:, None, :]
        verts, joints = verts + transl, joints + transl
    return {"vertices": verts, "joints": joints, "full_pose": full_pose}


def _sum_rows(g: torch.Tensor) -> torch.Tensor:
    """[B, N, 3] -> [B, 3], the sum over N by repeated halving (zero-padded
    to a power of two): the same additions in the same order for every
    frame, whatever B is. torch's own reductions split the work by the
    output count, so a frame's sum would round by the batch it is in."""
    n = g.shape[1]
    g = torch.nn.functional.pad(g, (0, 0, 0, (1 << (n - 1).bit_length()) - n))
    while g.shape[1] > 1:
        h = g.shape[1] // 2
        g = g[:, :h] + g[:, h:]
    return g[:, 0]


class _Translate(torch.autograd.Function):
    """(vertices, joints) + transl [B, 3], with the translation's gradient
    summed over both by `_sum_rows`, so that a frame's gradient does not
    depend on the other frames of its batch (the clip-folded fits on the
    card)."""

    @staticmethod
    def forward(ctx, verts, joints, transl):
        t = transl[:, None, :]
        return verts + t, joints + t

    @staticmethod
    def backward(ctx, g_verts, g_joints):
        dt = None
        if ctx.needs_input_grad[2]:
            dt = _sum_rows(torch.cat([g_verts, g_joints], dim=1))
        return g_verts, g_joints, dt


def make_forward_fn(model: SmplxModel, joint_mapper: np.ndarray | None = None):
    """Bind a model's static pieces; returns f(params, consts, rows=None)
    -> outputs (`smplx_forward`)."""
    parents = tuple(int(p) for p in model.parents)
    config = model.config
    jm = None if joint_mapper is None else torch.as_tensor(
        np.asarray(joint_mapper, np.int64), device=model.device)

    def forward(params, consts, rows=None):
        return smplx_forward(params, consts, config, parents, jm, rows)

    return forward
