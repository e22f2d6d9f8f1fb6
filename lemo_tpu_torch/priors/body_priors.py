"""Static body-parameter priors (port of `lemo_tpu/priors/body_priors.py`,
temp_prox/prior.py:36-231):

- L2: sum of squares (the prior type LEMO's shipped configs use);
- angle: exponential bending prior on elbows and knees (prior.py:53-89);
- gmm: max-of-mixtures negative log likelihood (prior.py:100-231), read
  from the pickled mixture the SMPLify-X ecosystem ships.
"""

from __future__ import annotations

import os.path as osp
import pickle

import numpy as np
import torch

# rotation components of left-elbow / right-elbow / left-knee / right-knee
# within the 63-d body pose (prior.py:58-62, idx - 3 for no global pose)
_ANGLE_IDX = (55 - 3, 58 - 3, 12 - 3, 15 - 3)
_ANGLE_SIGN = (1.0, -1.0, -1.0, -1.0)


def l2_prior(x: torch.Tensor) -> torch.Tensor:
    """sum(x^2) (prior.py:92-97)."""
    return (x ** 2).sum()


def angle_prior(body_pose: torch.Tensor) -> torch.Tensor:
    """body_pose [B, 63] -> [B, 4] exponential bending penalties."""
    sign = torch.tensor(_ANGLE_SIGN, dtype=body_pose.dtype,
                        device=body_pose.device)
    return torch.exp(body_pose[:, list(_ANGLE_IDX)] * sign)


class MaxMixturePrior:
    """GMM negative log likelihood, merged form (prior.py:181-196). The
    precisions, square-root determinants and component weights are
    computed in float64 numpy and cast to float32, as `lemo_tpu` does;
    `__call__` is one einsum on the tensors' device."""

    def __init__(self, means: np.ndarray, covs: np.ndarray,
                 weights: np.ndarray, device="cpu"):
        covs = np.asarray(covs)
        precisions = np.stack([np.linalg.inv(c) for c in covs])
        sqrdets = np.array([np.sqrt(np.linalg.det(c)) for c in covs])
        const = (2 * np.pi) ** (covs.shape[1] / 2.0)
        nll_weights = np.asarray(weights) / (const * (sqrdets
                                                      / sqrdets.min()))

        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        self.means = f32(means)                       # [K, D]
        self.precisions = f32(precisions)             # [K, D, D]
        self.nll_weights = f32(nll_weights)           # [K]

    @classmethod
    def from_pickle(cls, path: str, device="cpu") -> "MaxMixturePrior":
        """Read the dict form ({means, covars, weights}) or the sklearn
        form (means_, covars_, weights_); a latin1 pickle."""
        with open(path, "rb") as fh:
            gmm = pickle.load(fh, encoding="latin1")
        if isinstance(gmm, dict):
            return cls(gmm["means"], gmm["covars"], gmm["weights"],
                       device=device)
        return cls(gmm.means_, gmm.covars_, gmm.weights_, device=device)

    def __call__(self, pose: torch.Tensor) -> torch.Tensor:
        """pose [B, D] -> [B] min-component weighted NLL."""
        diff = pose[:, None, :] - self.means[None]            # [B, K, D]
        quad = torch.einsum("bkd,kde,bke->bk", diff, self.precisions, diff)
        ll = 0.5 * quad - torch.log(self.nll_weights)[None]
        return ll.min(dim=1).values


def create_prior(prior_type: str, *, device="cpu", **kwargs):
    """Factory matching temp_prox/prior.py:36-50. For 'gmm', pass either
    `gmm_path` or the reference's `prior_folder` + `num_gaussians` (the
    pickle is then <prior_folder>/gmm_{num_gaussians:02d}.pkl,
    prior.py:119-121); its tensors go to `device`."""
    if prior_type == "l2":
        return l2_prior
    if prior_type == "angle":
        return angle_prior
    if prior_type == "gmm":
        path = kwargs.get("gmm_path")
        if not path:
            folder = kwargs.get("prior_folder", "priors")
            n = int(kwargs.get("num_gaussians", 8))
            path = osp.join(osp.expandvars(folder), f"gmm_{n:02d}.pkl")
        return MaxMixturePrior.from_pickle(path, device)
    if prior_type in (None, "none"):
        return lambda *a, **k: 0.0
    raise ValueError(prior_type)
