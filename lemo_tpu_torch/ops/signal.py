"""Signal-processing helpers (port of `lemo_tpu/ops/signal.py`): the
reflect padding of the motion images and scipy's nearest-mode Gaussian
smoothing of the forward direction."""

from __future__ import annotations

import numpy as np
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


def gaussian_kernel1d(sigma: float, truncate: float = 4.0) -> np.ndarray:
    """scipy.ndimage's discrete Gaussian kernel (f64, sums to 1)."""
    radius = int(truncate * sigma + 0.5)
    x = np.arange(-radius, radius + 1)
    phi = np.exp(-0.5 / (sigma * sigma) * x**2)
    return (phi / phi.sum()).astype(np.float64)


def gaussian_filter1d_nearest(x: torch.Tensor, sigma: float, axis: int = 0,
                              truncate: float = 4.0) -> torch.Tensor:
    """`scipy.ndimage.gaussian_filter1d(x, sigma, axis, mode='nearest')`:
    an edge pad by the kernel's radius, then a 1-D correlation along
    `axis` (`F.conv1d`, which correlates; the kernel is symmetric)."""
    kernel = torch.as_tensor(gaussian_kernel1d(sigma, truncate),
                             dtype=x.dtype, device=x.device)
    radius = (kernel.shape[0] - 1) // 2
    moved = torch.movedim(x, axis, 0)
    flat = moved.reshape(moved.shape[0], -1).T[:, None, :]   # [cols, 1, L]
    padded = F.pad(flat, (radius, radius), mode="replicate")
    out = F.conv1d(padded, kernel.flip(0)[None, None, :])[:, 0, :].T
    return torch.movedim(out.reshape(moved.shape), 0, axis)
