"""`BodyModel`-style API wrapper with human_body_prior's naming (port of
`lemo_tpu/body_model/body_model_api.py`).

The vendored BodyModel (human_body_prior/body_model/body_model.py:35-284)
takes parameters named {trans, root_orient, pose_body, pose_hand,
pose_jaw, pose_eye, betas, expression} and returns an object with
{v, f, Jtr, full_pose}. This wrapper gives that surface over
`make_forward_fn`, including the VPoser-latent variant
(body_model_vposer.py:10-107: `poZ_body` replaces `pose_body`). On the
card the forward and its backward run through the chain and vertex
kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from lemo_tpu_torch.body_model import vposer as vp
from lemo_tpu_torch.body_model.smplx import SmplxModel, load_model, \
    make_forward_fn


@dataclasses.dataclass
class BodyModelOutput:
    v: torch.Tensor          # [B, V, 3]
    f: np.ndarray            # [F, 3]
    Jtr: torch.Tensor        # [B, J, 3]
    full_pose: torch.Tensor  # [B, J*3]


class BodyModel:
    """Callable body model with human_body_prior parameter naming, on
    `device` (None: the CUDA card; raises without it). `build_fused` as
    in `load_model`."""

    def __init__(self, bm_path_or_dict: Any, num_betas: int = 10,
                 batch_size: int = 1, num_expressions: int = 10,
                 use_posedirs: bool = True, model_type: str | None = None,
                 gender: str = "neutral", build_fused: bool | None = None,
                 device=None):
        self.model: SmplxModel = load_model(
            bm_path_or_dict, model_type=model_type, gender=gender,
            num_betas=num_betas, num_expressions=num_expressions,
            use_pca=False, flat_hand_mean=True, use_posedirs=use_posedirs,
            build_fused=build_fused, device=device)
        self.batch_size = batch_size
        self._fwd = make_forward_fn(self.model)
        self.f = self.model.faces
        self.model_type = self.model.config.model_type

    def __call__(self, root_orient=None, pose_body=None, pose_hand=None,
                 pose_jaw=None, pose_eye=None, betas=None, trans=None,
                 expression=None, **kwargs) -> BodyModelOutput:
        B = self.batch_size
        for x in (root_orient, pose_body, trans, betas):
            if x is not None:
                B = x.shape[0]
                break
        p = self.model.zero_params(B)
        if trans is not None:
            p["transl"] = trans
        if root_orient is not None:
            p["global_orient"] = root_orient
        if pose_body is not None and "body_pose" in p:
            p["body_pose"] = pose_body
        if pose_hand is not None:
            if self.model_type in ("smplh", "smplx"):
                p["left_hand_pose"] = pose_hand[:, :45]
                p["right_hand_pose"] = pose_hand[:, 45:]
            elif self.model_type == "smpl":
                p["left_hand_pose"] = pose_hand[:, :3]
                p["right_hand_pose"] = pose_hand[:, 3:6]
        if pose_jaw is not None and "jaw_pose" in p:
            p["jaw_pose"] = pose_jaw
        if pose_eye is not None and "leye_pose" in p:
            p["leye_pose"] = pose_eye[:, :3]
            p["reye_pose"] = pose_eye[:, 3:6]
        if betas is not None:
            p["betas"] = betas
        if expression is not None and "expression" in p:
            p["expression"] = expression
        out = self._fwd(p, self.model.consts)
        return BodyModelOutput(v=out["vertices"], f=self.f,
                               Jtr=out["joints"][:, :self.model.num_joints],
                               full_pose=out["full_pose"])


class BodyModelWithPoser(BodyModel):
    """BodyModel whose body pose is parameterized by a 32-d VPoser latent
    (body_model_vposer.py:10-107: `poZ_body`). Without `vposer_params`,
    seeded random weights (a torch.Generator seeded 0)."""

    def __init__(self, bm_path_or_dict, vposer_params: dict | None = None,
                 **kw):
        super().__init__(bm_path_or_dict, **kw)
        self.vposer_params = (
            vposer_params if vposer_params is not None else
            vp.init_vposer(torch.Generator().manual_seed(0),
                           device=self.model.device))

    def __call__(self, poZ_body=None, pose_body=None, **kwargs):
        if poZ_body is not None:
            pose_body = vp.decode(self.vposer_params, poZ_body, "aa")
        return super().__call__(pose_body=pose_body, **kwargs)
