"""Signal-processing helpers (port of `lemo_tpu/ops/signal.py`)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def reflect_pad_dt(x: torch.Tensor, pad_t: int = 8,
                   pad_d: int = 1) -> torch.Tensor:
    """Reflect-pad the trailing two axes of [N, C, d, T] by (pad_d, pad_t),
    i.e. ``F.pad(x, (pad_t, pad_t, pad_d, pad_d), 'reflect')``."""
    return F.pad(x, (pad_t, pad_t, pad_d, pad_d), mode="reflect")


def unpad_dt(x: torch.Tensor, pad_t: int = 8, pad_d: int = 1) -> torch.Tensor:
    """Inverse of :func:`reflect_pad_dt` (crop [..., d+2p, T+2q] back)."""
    return x[..., pad_d:-pad_d, pad_t:-pad_t]
