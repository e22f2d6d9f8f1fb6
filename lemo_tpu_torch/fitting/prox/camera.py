"""Pinhole camera projection (port of `lemo_tpu/fitting/prox/camera.py`,
temp_prox/camera.py:42-116). In the PROX pipeline the camera is fixed:
rotation identity, translation zero, only the intrinsics matter."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class PerspectiveCamera:
    focal_length_x: float = 5000.0
    focal_length_y: float = 5000.0
    center: tuple[float, float] = (0.0, 0.0)

    def project(self, points: torch.Tensor,
                rotation: torch.Tensor | None = None,
                translation: torch.Tensor | None = None) -> torch.Tensor:
        """points [..., N, 3] camera coords -> pixels [..., N, 2]."""
        if rotation is not None:
            points = points @ rotation.T
        if translation is not None:
            points = points + translation
        xy = points[..., :2] / points[..., 2:3]
        f = torch.tensor([self.focal_length_x, self.focal_length_y],
                         dtype=points.dtype, device=points.device)
        c = torch.tensor(self.center, dtype=points.dtype,
                         device=points.device)
        return xy * f + c
