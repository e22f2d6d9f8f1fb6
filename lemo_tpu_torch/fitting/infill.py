"""Masked motion-infill inference with per-clip self-supervised
fine-tuning (port of `lemo_tpu/fitting/infill.py`;
opt_amass_perframe.py:117-190, fitting_temp_slide.py:820-941): the
pretrained infill AE is fine-tuned for 60 Adam steps at lr 3e-6 on the
channel-0 residual of the visible entries, then decodes once."""

from __future__ import annotations

import numpy as np
import torch

from lemo_tpu_torch.data import markers as mk
from lemo_tpu_torch.fitting.adam import run_adam
from lemo_tpu_torch.ops.signal import reflect_pad_dt, unpad_dt
from lemo_tpu_torch.priors.conv_ae import infill_ae_forward


def leg_mask_rows(d: int, mode: str = "local_markers_4chan") -> np.ndarray:
    """Row indices of the leg markers zeroed during AMASS infill inference
    (opt_amass_perframe.py:136-147); `d` is the image height."""
    base = mk.LEG_MASK_MARKER_SLOTS * 3
    offset = 3 if mode == "local_markers_4chan" else 6  # pelvis (+traj)
    rows = np.concatenate([base + offset, base + offset + 1,
                           base + offset + 2])
    return np.sort(rows)


def amass_input_mask(d: int, T: int,
                     mode: str = "local_markers_4chan") -> np.ndarray:
    """[d, T] keep-mask (1 = keep) of channel 0: the leg-marker rows and
    the 4 contact rows zeroed."""
    m = np.ones((d, T), np.float32)
    m[leg_mask_rows(d, mode)] = 0.0
    m[-4:] = 0.0
    return m


def finetune_weight_from_mask(mask_dT: torch.Tensor) -> torch.Tensor:
    """Residual weights on the padded image from a [., d, T] keep-mask:
    reflect-pad, then zero the bottom 5 rows (4 contact + 1 pad row)."""
    w = reflect_pad_dt(mask_dT[None])[0]
    w = w.clone()
    w[..., -5:, :] = 0.0
    return w


def infill_infer(ae_params: dict, clip_img: torch.Tensor,
                 input_mask: torch.Tensor, finetune_steps: int = 60,
                 finetune_lr: float = 3e-6, kernel: int = 3):
    """clip_img [B, C, d, T] normalized, input_mask [B|1, d, T] or
    [d, T] (1 = visible) -> (reconstruction [B, 1, d, T], fine-tuned
    params, per-step losses)."""
    if input_mask.dim() == 2:
        input_mask = input_mask[None]
    x = clip_img.clone()
    x[:, 0] = x[:, 0] * input_mask
    x = reflect_pad_dt(x)                                 # [B, C, d+2, T+16]
    w = finetune_weight_from_mask(input_mask)            # [B|1, d+2, T+16]
    w_sum = torch.clamp(w.sum(), min=1.0)

    def loss_fn(p):
        rec, _ = infill_ae_forward(p, x, kernel=kernel)
        return ((rec[:, 0] - x[:, 0]).abs() * w).sum() / w_sum

    if finetune_steps > 0:
        tuned, losses = run_adam(loss_fn, ae_params, finetune_steps,
                                 [finetune_lr] * finetune_steps)
    else:
        tuned, losses = ae_params, torch.zeros(0, device=x.device)
    with torch.no_grad():
        rec, _ = infill_ae_forward(tuned, x, kernel=kernel)
    return unpad_dt(rec), tuned, losses


def contact_labels_from_rec(clip_img_rec: torch.Tensor) -> torch.Tensor:
    """[B, 1, d, T] -> binary labels [B, T, 4] from the last 4 rows
    (sigmoid > 0.5, opt_amass_perframe.py:235-237)."""
    logits = clip_img_rec[:, 0, -4:, :].transpose(1, 2)
    return (torch.sigmoid(logits) > 0.5).to(clip_img_rec.dtype)
