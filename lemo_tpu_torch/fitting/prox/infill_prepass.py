"""Motion-infill pre-pass for PROX windows (port of
`lemo_tpu/fitting/prox/infill_prepass.py`; fitting_temp_slide.py:820-941).

Once per window, before the fit: the warm-start body's markers become the
Holden 4-channel image, the per-frame occlusion mask masks it, the infill
AE is fine-tuned for 60 steps and decodes once, and the trajectory is
integrated back to world-space marker targets and contact labels, which
are constants of the window's loss. `make_batched_prepass` runs it for
every window of a window-parallel fit.
"""

from __future__ import annotations

import dataclasses

import torch

from lemo_tpu_torch.data import repr as rep
from lemo_tpu_torch.data.stats import Local4ChanStats
from lemo_tpu_torch.fitting import infill as fi
from lemo_tpu_torch.fitting.amass_perframe import reconstruct_marker_targets


@dataclasses.dataclass
class InfillPrepassResult:
    targets_world: torch.Tensor   # [T-1, 67, 3]
    contact_lbl: torch.Tensor     # [T-1, 4]
    had_occlusion: bool


def build_marker_image(markers_world, joints_world, stats: Local4ChanStats):
    """[T, 67, 3] world markers + [T, 25, 3] world joints -> normalized
    [4, T-1, d] image, rot_0_pivot and the transform back
    (fitting_temp_slide.py:779-831)."""
    R, origin = rep.frame0_normalizer(joints_world[0])
    joints_n = torch.matmul(joints_world - origin, R)
    markers_n = torch.matmul(markers_world - origin, R)
    contact = rep.contact_labels_from_markers(markers_n)
    pm = torch.cat([joints_n[:, 0:1], markers_n], dim=1)
    img, rot0 = rep.local_markers_4chan(pm, contact)
    img = stats.normalize(img[None])[0]
    return img, rot0, (R, origin, markers_n[:, :, 2].min())


def marker_mask_to_image_mask(marker_mask: torch.Tensor, Tm1: int):
    """[T, 67] per-frame marker visibility -> [d, T-1] channel-0 mask:
    pelvis rows kept, contact rows masked when that foot's markers are
    (fitting_temp_slide.py:836-853)."""
    mm = torch.repeat_interleave(marker_mask[:Tm1].T, 3, dim=0)
    pelvis = torch.ones((3, Tm1), dtype=mm.dtype, device=mm.device)
    left_ok = (mm[16 * 3] == 1) & (mm[30 * 3] == 1)
    right_ok = (mm[47 * 3] == 1) & (mm[60 * 3] == 1)
    contact_rows = torch.stack([left_ok, right_ok, left_ok, right_ok]
                               ).to(mm.dtype)
    return torch.cat([pelvis, mm, contact_rows])


def run_infill_prepass(ae_params: dict, markers_world: torch.Tensor,
                       joints_world: torch.Tensor,
                       marker_mask: torch.Tensor, stats: Local4ChanStats,
                       finetune_steps: int = 60,
                       finetune_lr: float = 3e-6) -> InfillPrepassResult:
    """markers_world [T, 67, 3], joints_world [T, 25, 3] (the warm-start
    body), marker_mask [T, 67] -> targets and contact labels [T-1, ...]."""
    markers_world = markers_world.detach()
    joints_world = joints_world.detach()
    img, rot0, (R, origin, min_z) = build_marker_image(
        markers_world, joints_world, stats)
    mask = marker_mask_to_image_mask(marker_mask, img.shape[1])
    rec, _, _ = fi.infill_infer(ae_params, img.transpose(1, 2)[None], mask,
                                finetune_steps=finetune_steps,
                                finetune_lr=finetune_lr)
    with torch.no_grad():
        contact_lbl = fi.contact_labels_from_rec(rec)[0]
        targets = reconstruct_marker_targets(rec[0], img.transpose(1, 2),
                                             stats, rot0)
        targets = torch.stack([targets[..., 0], targets[..., 1],
                               targets[..., 2] + min_z], dim=-1)
        targets_world = torch.matmul(targets, torch.linalg.inv(R)) + origin
    had_occ = bool(marker_mask.numel() > float(marker_mask.sum()))
    return InfillPrepassResult(targets_world=targets_world,
                               contact_lbl=contact_lbl,
                               had_occlusion=had_occ)


def make_batched_prepass(stats: Local4ChanStats, finetune_steps: int = 60,
                         finetune_lr: float = 3e-6):
    """The pre-pass of W windows (`lemo_tpu/fitting/prox/infill_prepass.py:
    129-142`): ``prepass(ae_params, mv [W, T, 67, 3], mj [W, T, 25, 3],
    mask [W, T, 67]) -> (targets_world [W, T-1, 67, 3], contact
    [W, T-1, 4])``. Each window fine-tunes its own copy of the AE from the
    shared weights, as `lemo_tpu`'s vmap with in_axes=(None, 0, 0, 0)
    does, so the windows run one after another: the pre-pass runs once a
    recording, not once a step."""

    def prepass(ae_params, mv, mj, mask):
        outs = [run_infill_prepass(ae_params, mv[i], mj[i], mask[i], stats,
                                   finetune_steps=finetune_steps,
                                   finetune_lr=finetune_lr)
                for i in range(mv.shape[0])]
        return (torch.stack([o.targets_world for o in outs]),
                torch.stack([o.contact_lbl for o in outs]))

    return prepass
