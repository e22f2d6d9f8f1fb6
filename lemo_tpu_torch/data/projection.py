"""Kinect depth-camera unprojection and registration, in numpy (port of
`lemo_tpu/data/projection.py`, temp_prox/projection_utils.py:23-129).

The lens model is OpenCV's (k = [k1, k2, p1, p2, k3(, k4, k5, k6)]):
`undistort_points` is `cv2.undistortPoints` with its default criterion
(a fixed 5 fixed-point iterations, in f64), and `project_points` is
`cv2.projectPoints` with a rotation matrix, so the port needs no cv2.
"""

from __future__ import annotations

import json
import os.path as osp

import numpy as np

UNDISTORT_ITERS = 5   # cv2.undistortPoints' default TermCriteria(COUNT, 5)


def _dist_coeffs(k) -> np.ndarray:
    out = np.zeros(14, np.float64)
    k = np.asarray(k, np.float64).ravel()
    out[:len(k)] = k
    return out


def undistort_points(uv: np.ndarray, camera_mtx, k) -> np.ndarray:
    """Pixel coords [N, 2] -> undistorted normalized coords [N, 2]."""
    A = np.asarray(camera_mtx, np.float64)
    d = _dist_coeffs(k)
    fx, fy, cx, cy = A[0, 0], A[1, 1], A[0, 2], A[1, 2]
    u = np.asarray(uv, np.float64)[:, 0]
    v = np.asarray(uv, np.float64)[:, 1]
    x0 = (u - cx) * (1.0 / fx)
    y0 = (v - cy) * (1.0 / fy)
    x, y = x0.copy(), y0.copy()
    done = np.zeros(x.shape, bool)
    for _ in range(UNDISTORT_ITERS):
        r2 = x * x + y * y
        icdist = ((1 + ((d[7] * r2 + d[6]) * r2 + d[5]) * r2)
                  / (1 + ((d[4] * r2 + d[1]) * r2 + d[0]) * r2))
        # OpenCV restores the distorted point and stops where icdist < 0
        bad = (icdist < 0) & ~done
        x = np.where(bad, x0, x)
        y = np.where(bad, y0, y)
        done |= bad
        dx = (2 * d[2] * x * y + d[3] * (r2 + 2 * x * x) + d[8] * r2
              + d[9] * r2 * r2)
        dy = (d[2] * (r2 + 2 * y * y) + 2 * d[3] * x * y + d[10] * r2
              + d[11] * r2 * r2)
        x = np.where(done, x, (x0 - dx) * icdist)
        y = np.where(done, y, (y0 - dy) * icdist)
    return np.stack([x, y], axis=1)


def project_points(points: np.ndarray, R, T, camera_mtx, k) -> np.ndarray:
    """World points [N, 3] -> distorted pixel coords [N, 2]."""
    X = np.asarray(points, np.float64) @ np.asarray(R, np.float64).T \
        + np.asarray(T, np.float64).ravel()
    d = _dist_coeffs(k)
    A = np.asarray(camera_mtx, np.float64)
    z = np.where(X[:, 2] != 0, 1.0 / np.where(X[:, 2] != 0, X[:, 2], 1.0),
                 1.0)
    x, y = X[:, 0] * z, X[:, 1] * z
    r2 = x * x + y * y
    r4, r6 = r2 * r2, r2 * r2 * r2
    cdist = 1 + d[0] * r2 + d[1] * r4 + d[4] * r6
    icdist2 = 1.0 / (1 + d[5] * r2 + d[6] * r4 + d[7] * r6)
    a1, a2, a3 = 2 * x * y, r2 + 2 * x * x, r2 + 2 * y * y
    xd = x * cdist * icdist2 + d[2] * a1 + d[3] * a2 + d[8] * r2 + d[9] * r4
    yd = y * cdist * icdist2 + d[2] * a3 + d[3] * a1 + d[10] * r2 \
        + d[11] * r4
    return np.stack([xd * A[0, 0] + A[0, 2], yd * A[1, 1] + A[1, 2]], axis=1)


class KinectProjection:
    def __init__(self, calib_dir: str):
        with open(osp.join(calib_dir, "IR.json")) as fh:
            self.depth_cam = json.load(fh)
        with open(osp.join(calib_dir, "Color.json")) as fh:
            self.color_cam = json.load(fh)
        self._grids: dict = {}

    def _undistorted_grid(self, H: int, W: int, cam: dict) -> np.ndarray:
        """The undistorted normalized coordinates of every pixel of an
        [H, W] image: the same for every frame, so computed once per
        camera and size."""
        key = (H, W, id(cam))
        if key not in self._grids:
            us = np.arange(H * W) % W
            vs = np.arange(H * W) // W
            uv = np.stack([us, vs], axis=1).astype(np.float64)
            self._grids[key] = undistort_points(uv, cam["camera_mtx"],
                                                cam["k"])
        return self._grids[key]

    def unproject_depth_image(self, depth_image: np.ndarray,
                              cam: dict) -> np.ndarray:
        """depth [H, W] -> world xyz [H, W, 3] (projection_utils.py:35-48)."""
        H, W = depth_image.shape
        xy = self._undistorted_grid(H, W, cam)
        xyz = np.concatenate([xy, depth_image.ravel()[:, None]], axis=1)
        xyz[:, :2] *= xyz[:, 2:3]
        view = np.asarray(cam["view_mtx"])
        xyz = (xyz - view[:, 3][None]) @ view[:, :3]
        return xyz.reshape(H, W, 3)

    def project_points(self, v: np.ndarray, cam: dict) -> np.ndarray:
        return project_points(v.reshape(-1, 3), cam["R"], cam["T"],
                              cam["camera_mtx"], cam["k"])

    def create_scan(self, mask: np.ndarray, depth_im: np.ndarray,
                    mask_on_color: bool = True, coord: str = "color",
                    thresh: float = 1e-2) -> dict:
        """Masked depth -> point cloud in color-camera coordinates
        (projection_utils.py:54-90)."""
        depth = depth_im.copy()
        if not mask_on_color:
            depth[mask != 0] = 0
        points = self.unproject_depth_image(depth, self.depth_cam)
        points = points.reshape(-1, 3)
        uvs = np.round(self.project_points(points, self.color_cam)
                       ).astype(int)
        valid = (uvs[:, 1] >= 0) & (uvs[:, 1] < 1080) & \
                (uvs[:, 0] >= 0) & (uvs[:, 0] < 1920)
        if mask_on_color:
            vm = valid.copy()
            sel = uvs[valid]
            vm[valid] = mask[sel[:, 1], sel[:, 0]] == 0
            points = points[vm]
        else:
            points = points[valid]
        if coord == "color":
            view = np.asarray(self.color_cam["view_mtx"])
            points = points @ view[:, :3].T + view[:, 3][None]
        keep = points[:, 2] > thresh
        return {"points": np.ascontiguousarray(points[keep])}
