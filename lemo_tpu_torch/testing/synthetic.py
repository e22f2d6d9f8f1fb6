"""Synthetic SMPL-X model npz and scene SDF (copies of
`lemo_tpu/testing/synthetic.py`'s `synthetic_smplx_npz`, random-triangle
topology, and `synthetic_sdf_grid`): the same keys, dtypes, shapes and
kinematic topology as an official file, bit-identical to the JAX
package's output for the same arguments."""

from __future__ import annotations

import numpy as np

# SMPL-X kinematic tree (55 joints)
SMPLX_PARENTS = np.array(
    [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17,
     18, 19, 15, 15, 15,
     20, 25, 26, 20, 28, 29, 20, 31, 32, 20, 34, 35, 20, 37, 38,
     21, 40, 41, 21, 43, 44, 21, 46, 47, 21, 49, 50, 21, 52, 53],
    dtype=np.int64,
)

SMPL_PARENTS = np.array(
    [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17,
     18, 19, 20, 21],
    dtype=np.int64,
)

# rest-pose joint locations (approximate human proportions, m)
_BODY_JOINT_POS = np.array([
    [0.00, 0.00, 0.95], [0.09, 0.00, 0.90], [-0.09, 0.00, 0.90],
    [0.00, 0.02, 1.05], [0.10, 0.00, 0.50], [-0.10, 0.00, 0.50],
    [0.00, 0.02, 1.15], [0.11, -0.02, 0.10], [-0.11, -0.02, 0.10],
    [0.00, 0.02, 1.25], [0.12, 0.10, 0.02], [-0.12, 0.10, 0.02],
    [0.00, 0.00, 1.40], [0.07, 0.00, 1.35], [-0.07, 0.00, 1.35],
    [0.00, 0.02, 1.55], [0.18, 0.00, 1.38], [-0.18, 0.00, 1.38],
    [0.45, 0.00, 1.38], [-0.45, 0.00, 1.38], [0.70, 0.00, 1.38],
    [-0.70, 0.00, 1.38], [0.00, 0.05, 1.50], [0.03, 0.08, 1.58],
    [-0.03, 0.08, 1.58],
])


def _synthetic_joints(num_joints: int) -> np.ndarray:
    J = np.zeros((num_joints, 3))
    n_body = min(num_joints, 25)
    J[:n_body] = _BODY_JOINT_POS[:n_body]
    if num_joints > 25:
        # hand joints: fingers fanning out from the wrists
        for side, wrist in ((0, 20), (1, 21)):
            sign = 1.0 if side == 0 else -1.0
            base = 25 + side * 15
            for f in range(5):
                for k in range(3):
                    idx = base + f * 3 + k
                    if idx >= num_joints:
                        break
                    J[idx] = J[wrist] + np.array(
                        [sign * 0.03 * (k + 1), 0.02 * (f - 2), 0.0])
    return J


def synthetic_smplx_npz(num_verts: int = 536, num_joints: int = 55,
                        num_shape: int = 20, seed: int = 0,
                        gender: str = "neutral",
                        full_size: bool = False) -> dict:
    """A dict with the key layout of an official SMPL-X npz.

    `full_size=True` gives the production 10475-vertex / 400-dir layout;
    the default is small for fast tests. `num_joints` selects the family
    as the loaders infer it from the posedirs width (55 -> smplx,
    24 -> smpl, 52 -> smplh, 16 -> mano).
    """
    if full_size:
        num_verts, num_joints, num_shape = 10475, 55, 400
    rng = np.random.RandomState(
        seed + (0 if gender == "neutral" else hash(gender) % 97))

    J = _synthetic_joints(num_joints)
    parent = (SMPL_PARENTS if num_joints <= 24
              else SMPLX_PARENTS)[:num_joints].copy()
    parent[0] = 0
    bone_of_vert = rng.randint(0, num_joints, size=num_verts)
    alpha = rng.rand(num_verts, 1)
    seg_a, seg_b = J[bone_of_vert], J[parent[bone_of_vert]]
    v_template = (seg_a * alpha + seg_b * (1 - alpha)
                  + rng.randn(num_verts, 3) * 0.03)

    # LBS weights: softmax-like over distance to the 4 nearest joints
    d = np.linalg.norm(v_template[:, None, :] - J[None, :, :], axis=-1)
    w = np.exp(-d / 0.08)
    thresh = np.sort(w, axis=1)[:, -4][:, None]
    w = np.where(w >= thresh, w, 0.0)
    weights = w / w.sum(axis=1, keepdims=True)

    # joint regressor: for each joint, average of its nearest vertices
    Jreg = np.zeros((num_joints, num_verts))
    nearest = np.argsort(d, axis=0)
    k = max(4, num_verts // num_joints // 2)
    for j in range(num_joints):
        Jreg[j, nearest[:k, j]] = 1.0 / k

    shapedirs = rng.randn(num_verts, 3, num_shape) * 0.01
    posedirs = rng.randn(num_verts, 3, 9 * (num_joints - 1)) * 0.001

    nfaces = max(2 * num_verts - 4, 4)
    f = rng.randint(0, num_verts, size=(nfaces, 3)).astype(np.int64)

    parents_tab = (SMPL_PARENTS[:num_joints] if num_joints <= 24
                   else SMPLX_PARENTS[:num_joints])
    kintree_table = np.stack([
        np.where(parents_tab < 0,
                 np.uint32(2**32 - 1).astype(np.int64), parents_tab),
        np.arange(num_joints, dtype=np.int64),
    ])

    out = {
        "v_template": v_template.astype(np.float64),
        "shapedirs": shapedirs.astype(np.float64),
        "posedirs": posedirs.astype(np.float64),
        "J_regressor": Jreg.astype(np.float64),
        "kintree_table": kintree_table,
        "weights": weights.astype(np.float64),
        "f": f,
    }
    if num_joints == 55:  # smplx extras
        out["hands_componentsl"] = (rng.randn(45, 45) * 0.1).astype(np.float64)
        out["hands_componentsr"] = (rng.randn(45, 45) * 0.1).astype(np.float64)
        out["hands_meanl"] = (rng.randn(45) * 0.05).astype(np.float64)
        out["hands_meanr"] = (rng.randn(45) * 0.05).astype(np.float64)
        out["lmk_faces_idx"] = rng.randint(0, nfaces, size=51).astype(np.int64)
        bary = rng.rand(51, 3)
        out["lmk_bary_coords"] = (bary / bary.sum(1, keepdims=True)).astype(
            np.float64)
    return out


def synthetic_sdf_grid(dim: int = 64, floor_z: float = 0.0) -> dict:
    """A scene SDF whose only geometry is a floor plane at z=floor_z,
    matching the PROX scenes_sdf format (json + flat npy grid + normals)."""
    lo = np.array([-3.0, -3.0, -1.0])
    hi = np.array([3.0, 3.0, 3.0])
    zs = np.linspace(lo[2], hi[2], dim)
    sdf = np.broadcast_to(zs[None, None, :] - floor_z, (dim, dim, dim)).copy()
    normals = np.zeros((dim, dim, dim, 3))
    normals[..., 2] = 1.0
    return {
        "min": lo,
        "max": hi,
        "dim": dim,
        "sdf": sdf.astype(np.float32),
        "normals": normals.astype(np.float32),
    }
