"""Normalization statistics of the motion priors (port of
`lemo_tpu/data/stats.py`: `GlobalStats` of the smoothness prior and
`Local4ChanStats` of the infill prior), held as tensors on one device so
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
    def load(cls, path: str, device) -> "GlobalStats":
        with np.load(path) as z:
            return cls.from_numpy(z["Xmean"], z["Xstd"], device)

    @classmethod
    def from_numpy(cls, Xmean, Xstd, device) -> "GlobalStats":
        return cls(Xmean=torch.as_tensor(np.asarray(Xmean, np.float32),
                                         device=device),
                   Xstd=torch.as_tensor(np.asarray(Xstd, np.float32),
                                        device=device))


@dataclasses.dataclass
class Local4ChanStats:
    """Infill-prior (local_markers_4chan) statistics (port of
    `lemo_tpu/data/stats.py:Local4ChanStats`, the npz schema of
    train_loader_infill.py:304-330): per-dim mean/std of channel 0,
    scalar stats of the trajectory channels."""

    Xmean_local: torch.Tensor     # [d]
    Xstd_local: torch.Tensor      # [d]
    Xmean_global_xy: float
    Xstd_global_xy: float
    Xmean_global_r: float
    Xstd_global_r: float

    def normalize(self, img: torch.Tensor) -> torch.Tensor:
        """img [..., 4, T, d] -> normalized, channelwise."""
        c0 = (img[..., 0, :, :] - self.Xmean_local.to(img.dtype)) / \
            self.Xstd_local.to(img.dtype)
        cxy = (img[..., 1:3, :, :] - self.Xmean_global_xy) / \
            self.Xstd_global_xy
        cr = (img[..., 3, :, :] - self.Xmean_global_r) / self.Xstd_global_r
        return torch.cat([c0[..., None, :, :], cxy, cr[..., None, :, :]],
                         dim=-3)

    def denormalize_flat(self, flat: torch.Tensor) -> torch.Tensor:
        """flat [..., T, 3 + d_local]: [global_xy(2), global_r(1),
        local(d)] rows (opt_amass_perframe.py:263-274)."""
        gxy = flat[..., 0:2] * self.Xstd_global_xy + self.Xmean_global_xy
        gr = flat[..., 2:3] * self.Xstd_global_r + self.Xmean_global_r
        loc = flat[..., 3:] * self.Xstd_local[:-4].to(flat.dtype) + \
            self.Xmean_local[:-4].to(flat.dtype)
        return torch.cat([gxy, gr, loc], dim=-1)

    def to(self, device) -> "Local4ChanStats":
        return dataclasses.replace(self,
                                   Xmean_local=self.Xmean_local.to(device),
                                   Xstd_local=self.Xstd_local.to(device))

    @classmethod
    def from_numpy(cls, obj, device) -> "Local4ChanStats":
        """From any object with the six fields (`lemo_tpu`'s class or an
        npz mapping)."""
        get = (obj.__getitem__ if hasattr(obj, "__getitem__")
               and not hasattr(obj, "Xmean_local") else
               lambda k: getattr(obj, k))
        return cls(
            Xmean_local=torch.as_tensor(
                np.asarray(get("Xmean_local"), np.float32), device=device),
            Xstd_local=torch.as_tensor(
                np.asarray(get("Xstd_local"), np.float32), device=device),
            Xmean_global_xy=float(get("Xmean_global_xy")),
            Xstd_global_xy=float(get("Xstd_global_xy")),
            Xmean_global_r=float(get("Xmean_global_r")),
            Xstd_global_r=float(get("Xstd_global_r")))

    @classmethod
    def load(cls, path: str, device) -> "Local4ChanStats":
        with np.load(path) as z:
            return cls.from_numpy(z, device)
