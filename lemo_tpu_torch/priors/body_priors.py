"""Static body-parameter priors (port of `lemo_tpu/priors/body_priors.py`,
temp_prox/prior.py:36-231): the L2 and angle forms. The GMM prior needs
the pickled mixture the reference ships separately; it is not ported yet
(ROADMAP queue 1)."""

from __future__ import annotations

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


def create_prior(prior_type: str, **kwargs):
    """Factory matching temp_prox/prior.py:36-50 for the forms the port
    has; 'gmm' raises (ROADMAP queue 1, the GMM prior)."""
    if prior_type == "l2":
        return l2_prior
    if prior_type == "angle":
        return angle_prior
    if prior_type == "gmm":
        raise NotImplementedError(
            "the GMM pose prior is not ported to lemo_tpu_torch yet "
            "(ROADMAP.md queue 1: GMM prior); use prior type 'l2'")
    if prior_type in (None, "none"):
        return lambda *a, **k: 0.0
    raise ValueError(prior_type)
