"""Smoothness-prior normalization statistics (port of
`lemo_tpu/data/stats.py:GlobalStats`), held as tensors on one device so
the fit loop normalizes without host copies."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class GlobalStats:
    """Global-marker statistics: Xmean [1, 1, d], Xstd [d]."""

    Xmean: torch.Tensor
    Xstd: torch.Tensor

    def normalize(self, x: torch.Tensor) -> torch.Tensor:
        return (x - self.Xmean.to(x.dtype)) / self.Xstd.to(x.dtype)

    def to(self, device) -> "GlobalStats":
        return GlobalStats(Xmean=self.Xmean.to(device),
                           Xstd=self.Xstd.to(device))

    @classmethod
    def from_numpy(cls, Xmean, Xstd, device) -> "GlobalStats":
        return cls(Xmean=torch.as_tensor(np.asarray(Xmean, np.float32),
                                         device=device),
                   Xstd=torch.as_tensor(np.asarray(Xstd, np.float32),
                                        device=device))
