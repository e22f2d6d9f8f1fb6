"""Normalization statistics of the motion priors (port of
`lemo_tpu/data/stats.py`), held as tensors on one device so the fit loop
normalizes without host copies. The npz schemas are the reference's
(`preprocess_stats/`):

- smooth / global_markers: `Xmean` [1, 1, d], `Xstd` [d]
  (train_loader_smooth.py:180-194);
- single-channel local_markers: `Xmean` [d], `Xstd` [d]
  (train_loader_infill.py:287-302);
- infill / local_markers_4chan: `Xmean_local` [d], `Xstd_local` [d] and
  four scalars (train_loader_infill.py:304-330).

`compute` works in numpy, as `lemo_tpu` does, and keeps numpy's dtypes
(a float32 mean, a float64 std), so `save` writes the same npz values;
`load` gives float32 tensors, the fitters' dtype.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


@dataclasses.dataclass
class GlobalStats:
    """Global-marker statistics: Xmean [1, 1, d], Xstd [d]."""

    Xmean: torch.Tensor
    Xstd: torch.Tensor

    @classmethod
    def compute(cls, clips: np.ndarray, device="cpu") -> "GlobalStats":
        """clips [N, T, d]: per-dim mean, one std over everything (the
        reference normalizes all dims by one scalar std,
        train_loader_smooth.py:184-185)."""
        Xmean = clips.mean(axis=1).mean(axis=0)[None, None, :]
        Xstd = np.ones(clips.shape[-1]) * clips.std()
        return cls(Xmean=torch.as_tensor(Xmean, device=device),
                   Xstd=torch.as_tensor(Xstd, device=device))

    def normalize(self, x: torch.Tensor) -> torch.Tensor:
        return (x - self.Xmean.to(x.dtype)) / self.Xstd.to(x.dtype)

    def denormalize(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.Xstd.to(x.dtype) + self.Xmean.to(x.dtype)

    def to(self, device) -> "GlobalStats":
        return type(self)(Xmean=self.Xmean.to(device),
                          Xstd=self.Xstd.to(device))

    def save(self, path: str) -> None:
        np.savez_compressed(path, Xmean=_np(self.Xmean), Xstd=_np(self.Xstd))

    @classmethod
    def load(cls, path: str, device) -> "GlobalStats":
        with np.load(path) as z:
            return cls.from_numpy(z["Xmean"], z["Xstd"], device)

    @classmethod
    def from_numpy(cls, Xmean, Xstd, device) -> "GlobalStats":
        return cls(Xmean=_f32(Xmean, device), Xstd=_f32(Xstd, device))


class LocalFlatStats(GlobalStats):
    """Single-channel local_markers statistics
    (train_loader_infill.py:287-302): Xmean [d] with the contact dims
    pinned to 0, Xstd [d] blockwise (global vel xy / rot vel / local pose,
    contact dims 1)."""

    @classmethod
    def compute(cls, clips: np.ndarray, device="cpu") -> "LocalFlatStats":
        """clips [N, T, d] with layout [gvel(3) | local | contact(4)]."""
        Xmean = clips.mean(axis=1).mean(axis=0)
        Xmean[-4:] = 0.0
        Xstd = np.ones(clips.shape[-1])
        Xstd[0:2] = clips[:, :, 0:2].std()
        Xstd[2] = clips[:, :, 2].std()
        Xstd[3:-4] = clips[:, :, 3:-4].std()
        Xstd[-4:] = 1.0
        return cls(Xmean=torch.as_tensor(Xmean, device=device),
                   Xstd=torch.as_tensor(Xstd, device=device))


@dataclasses.dataclass
class Local4ChanStats:
    """Infill-prior (local_markers_4chan) statistics: per-dim mean/std of
    channel 0, scalar stats of the trajectory channels."""

    Xmean_local: torch.Tensor     # [d]
    Xstd_local: torch.Tensor      # [d]
    Xmean_global_xy: float
    Xstd_global_xy: float
    Xmean_global_r: float
    Xstd_global_r: float

    @classmethod
    def compute(cls, clips: np.ndarray, device="cpu") -> "Local4ChanStats":
        """clips [N, 4, T, d]. Channel 0 gets a per-dim mean and one std
        with the 4 contact dims pinned to (0, 1); channels 1-2 and 3 get
        scalar stats (train_loader_infill.py:304-316)."""
        d = clips.shape[-1]
        Xmean_local = clips[:, 0].mean(axis=1).mean(axis=0)
        Xmean_local[-4:] = 0.0
        Xstd_local = np.ones(d) * clips[:, 0].std()
        Xstd_local[-4:] = 1.0
        return cls(
            Xmean_local=torch.as_tensor(Xmean_local, device=device),
            Xstd_local=torch.as_tensor(Xstd_local, device=device),
            Xmean_global_xy=float(clips[:, 1:3].mean()),
            Xstd_global_xy=float(clips[:, 1:3].std()),
            Xmean_global_r=float(clips[:, 3].mean()),
            Xstd_global_r=float(clips[:, 3].std()))

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

    def save(self, path: str) -> None:
        np.savez_compressed(
            path, Xmean_local=_np(self.Xmean_local),
            Xstd_local=_np(self.Xstd_local),
            Xmean_global_xy=self.Xmean_global_xy,
            Xstd_global_xy=self.Xstd_global_xy,
            Xmean_global_r=self.Xmean_global_r,
            Xstd_global_r=self.Xstd_global_r)

    @classmethod
    def from_numpy(cls, obj, device) -> "Local4ChanStats":
        """From any object with the six fields (`lemo_tpu`'s class or an
        npz mapping)."""
        get = (obj.__getitem__ if hasattr(obj, "__getitem__")
               and not hasattr(obj, "Xmean_local") else
               lambda k: getattr(obj, k))
        return cls(
            Xmean_local=_f32(get("Xmean_local"), device),
            Xstd_local=_f32(get("Xstd_local"), device),
            Xmean_global_xy=float(get("Xmean_global_xy")),
            Xstd_global_xy=float(get("Xstd_global_xy")),
            Xmean_global_r=float(get("Xmean_global_r")),
            Xstd_global_r=float(get("Xstd_global_r")))

    @classmethod
    def load(cls, path: str, device) -> "Local4ChanStats":
        with np.load(path) as z:
            return cls.from_numpy(z, device)
