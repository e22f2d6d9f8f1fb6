"""AMASS Stage 1 (port of `lemo_tpu/fitting/amass_perframe.py`; the PROX
infill pre-pass needs only `reconstruct_marker_targets`, the per-frame
fitter is not ported yet)."""

from __future__ import annotations

import torch

from lemo_tpu_torch.data.repr import reconstruct_global_body
from lemo_tpu_torch.data.stats import Local4ChanStats


def reconstruct_marker_targets(clip_img_rec: torch.Tensor,
                               clip_img_input: torch.Tensor,
                               stats: Local4ChanStats,
                               rot_0_pivot: torch.Tensor) -> torch.Tensor:
    """Normalized infilled image [1, d, T] + original image [4, d, T] ->
    global marker targets [T, 67, 3] (opt_amass_perframe.py:241-287):
    channel-0 body rows and the original trajectory channels,
    de-normalized, integrated back to world coordinates, pelvis dropped."""
    body_rows = clip_img_rec[0, :-4, :]
    traj = torch.stack([clip_img_input[1, 0], clip_img_input[2, 0],
                        clip_img_input[3, 0]])
    flat = stats.denormalize_flat(torch.cat([traj, body_rows]).T)
    T = flat.shape[0]
    grid = flat.reshape(T, -1, 3)
    body_in = torch.cat([torch.zeros_like(grid[:, :1]), grid[:, 1:],
                         grid[:, 0:1]], dim=1)
    return reconstruct_global_body(body_in, rot_0_pivot)[:, 1:, :]
