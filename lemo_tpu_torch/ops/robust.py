"""Robustifiers and small loss helpers (port of `lemo_tpu/ops/robust.py`,
temp_prox/misc_utils.py:61-85)."""

from __future__ import annotations

import torch


def gmof(residual: torch.Tensor, rho: float) -> torch.Tensor:
    """Geman-McClure robustifier: rho^2 * r^2 / (r^2 + rho^2)."""
    sq = residual ** 2
    return (rho ** 2) * sq / (sq + rho ** 2)


def masked_mean(values: torch.Tensor, mask: torch.Tensor,
                empty_value: float = 0.0) -> torch.Tensor:
    """mean(values[mask]) with fixed shapes; `empty_value` when nothing
    is selected (decided on the device, no host sync)."""
    mask = mask.to(values.dtype)
    total = mask.sum()
    return torch.where(total > 0,
                       (values * mask).sum() / torch.clamp(total, min=1.0),
                       torch.full_like(total, empty_value))


def hinge_above(values: torch.Tensor, threshold: float,
                mask: torch.Tensor | None = None) -> torch.Tensor:
    """mean of |values| over entries where values > threshold (optionally
    pre-masked): the contact-velocity hinge (opt_amass_temp.py:429-447)."""
    over = values > threshold
    if mask is not None:
        over = over & mask.bool()
    return masked_mean(values.abs(), over)


def masked_mean_rows(values: torch.Tensor, mask: torch.Tensor
                     ) -> torch.Tensor:
    """`masked_mean` of each row of the leading axis: [W, ...] -> [W]."""
    W = values.shape[0]
    mask = mask.to(values.dtype).reshape(W, -1)
    total = mask.sum(1)
    return torch.where(total > 0, (values.reshape(W, -1) * mask).sum(1)
                       / torch.clamp(total, min=1.0), torch.zeros_like(total))


def hinge_above_rows(values: torch.Tensor, threshold: float,
                     mask: torch.Tensor) -> torch.Tensor:
    """`hinge_above` of each row of the leading axis: [W, ...] -> [W]."""
    return masked_mean_rows(values.abs(), (values > threshold) & mask.bool())
