"""The AMASS fitters' [T, 72] parameter rows (port of
`lemo_tpu/fitting/params.py`):
``[transl(3) | global_orient aa(3) | betas(10) | vposer z(32) |
left_hand(12) | right_hand(12)]``."""

from __future__ import annotations

import torch

from lemo_tpu_torch.body_model import vposer as vp


def split72(x72: torch.Tensor) -> dict[str, torch.Tensor]:
    """[T, 72] -> named parts."""
    return {
        "transl": x72[:, 0:3],
        "global_orient": x72[:, 3:6],
        "betas": x72[:, 6:16],
        "vposer_z": x72[:, 16:48],
        "left_hand_pose": x72[:, 48:60],
        "right_hand_pose": x72[:, 60:72],
    }


def join72(parts: dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.cat(
        [parts["transl"], parts["global_orient"], parts["betas"],
         parts["vposer_z"], parts["left_hand_pose"],
         parts["right_hand_pose"]], dim=-1)


def smplx_params_from_72(x72: torch.Tensor, vposer_params: dict,
                         num_expressions: int = 10,
                         decode_rows: int | None = None
                         ) -> dict[str, torch.Tensor]:
    """Decode [T, 72] rows into SMPL-X parameters (VPoser z -> 63-d body
    pose, zero face params). The body model must use PCA hands with 12
    components. `decode_rows`: `vposer.decode`'s block of rows."""
    T = x72.shape[0]
    parts = split72(x72)
    zeros3 = torch.zeros((T, 3), dtype=x72.dtype, device=x72.device)
    return {
        "transl": parts["transl"],
        "global_orient": parts["global_orient"],
        "betas": parts["betas"],
        "body_pose": vp.decode(vposer_params, parts["vposer_z"], "aa",
                               rows=decode_rows),
        "left_hand_pose": parts["left_hand_pose"],
        "right_hand_pose": parts["right_hand_pose"],
        "jaw_pose": zeros3,
        "leye_pose": zeros3,
        "reye_pose": zeros3,
        "expression": torch.zeros((T, num_expressions), dtype=x72.dtype,
                                  device=x72.device),
    }
