"""Synthetic stand-ins for licensed assets (copies of
`lemo_tpu/testing/synthetic.py`): the SMPL-X model npz with both
topologies and its model-directory writer, AMASS mocap sequences and
their dataset writer, SSM2-schema marker sets, the scene SDF and the part
segmentation. The same keys, dtypes, shapes and kinematic topology as the
official files, bit-identical to the JAX package's output for the same
arguments (the random numbers are drawn in the same order)."""

from __future__ import annotations

import json
import os

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


def _tube_surface(num_verts: int, J: np.ndarray, parent: np.ndarray,
                  rng: np.random.RandomState):
    """Smooth articulated surface: one open tapered tube of quads (split
    into triangles, outward normals) per kinematic bone.

    Unlike the random-triangle soup, whose faces interpenetrate
    everywhere, non-adjacent faces only collide where two body parts come
    close: the regime of the self-intersection broad phase. Returns
    (v_template [num_verts, 3], faces [F, 3] int64, face_part [F] int64 =
    the joint id of each face's bone tube); up to n_seg-1 leftover
    vertices are parked near joints, unreferenced by faces.
    """
    n_seg = 8
    bones = [(j, int(parent[j])) for j in range(1, len(J))
             if np.linalg.norm(J[j] - J[int(parent[j])]) > 1e-6]
    if not bones:
        raise ValueError(
            "smooth_surface needs at least one bone of nonzero length; use "
            "the default random-soup topology instead")
    lens = np.array([np.linalg.norm(J[j] - J[p]) for j, p in bones])
    budget = num_verts // n_seg          # total rings available
    if budget < 2 * len(bones):          # tiny test meshes: longest bones
        keep = np.argsort(-lens)[: max(1, budget // 2)]
        bones = [bones[i] for i in keep]
        lens = lens[keep]
    share = np.maximum(lens, 0.02)
    rings = np.maximum(2, np.floor(share / share.sum() * budget).astype(int))
    while rings.sum() > budget:
        rings[int(np.argmax(rings))] -= 1
    order = np.argsort(-lens)
    i = 0
    while rings.sum() < budget:
        rings[order[i % len(bones)]] += 1
        i += 1

    th = np.arange(n_seg) * (2.0 * np.pi / n_seg)
    verts, faces, face_part, off = [], [], [], 0
    for (j, p), n_r, L in zip(bones, rings, lens):
        a, b = J[p], J[j]
        axis = (b - a) / L
        tmp = (np.array([1.0, 0.0, 0.0]) if abs(axis[0]) < 0.9
               else np.array([0.0, 1.0, 0.0]))
        u = np.cross(axis, tmp)
        u /= np.linalg.norm(u)
        w = np.cross(axis, u)
        rb = float(np.clip(0.25 * L, 0.009, 0.05))
        t = np.linspace(0.06, 0.94, n_r)
        prof = rb * (0.18 + 0.82 * np.sin(np.pi * t) ** 0.8)  # taper ends
        radial = np.cos(th)[:, None] * u[None] + np.sin(th)[:, None] * w[None]
        centers = a[None] + t[:, None] * (b - a)[None]
        pts = centers[:, None, :] + prof[:, None, None] * radial[None]
        verts.append(pts.reshape(-1, 3))
        ir = np.arange(n_r - 1)[:, None]
        k = np.arange(n_seg)[None, :]
        a0 = off + ir * n_seg + k
        a1 = off + ir * n_seg + (k + 1) % n_seg
        b0, b1 = a0 + n_seg, a1 + n_seg
        quads = np.stack([np.stack([a0, a1, b0], -1),
                          np.stack([b0, a1, b1], -1)], axis=2)
        f_bone = quads.reshape(-1, 3)
        faces.append(f_bone)
        face_part.append(np.full(f_bone.shape[0], j, np.int64))
        off += n_r * n_seg
    v = np.concatenate(verts)
    rem = num_verts - v.shape[0]
    if rem > 0:
        extra = J[rng.randint(0, len(J), rem)] + rng.randn(rem, 3) * 0.01
        v = np.concatenate([v, extra])
    return v, np.concatenate(faces).astype(np.int64), \
        np.concatenate(face_part)


def synthetic_smplx_npz(num_verts: int = 536, num_joints: int = 55,
                        num_shape: int = 20, seed: int = 0,
                        gender: str = "neutral",
                        full_size: bool = False,
                        smooth_surface: bool = False) -> dict:
    """A dict with the key layout of an official SMPL-X npz.

    `full_size=True` gives the production 10475-vertex / 400-dir layout;
    the default is small for fast tests. `num_joints` selects the family
    as the loaders infer it from the posedirs width (55 -> smplx,
    24 -> smpl, 52 -> smplh, 16 -> mano). `smooth_surface=True` replaces
    the random-triangle topology with per-bone tapered tubes
    (`_tube_surface`), a surface whose faces only interpenetrate where
    body parts meet, and adds the per-face part ids as `face_parts`.
    """
    if full_size:
        num_verts, num_joints, num_shape = 10475, 55, 400
    rng = np.random.RandomState(
        seed + (0 if gender == "neutral" else hash(gender) % 97))

    J = _synthetic_joints(num_joints)
    parent = (SMPL_PARENTS if num_joints <= 24
              else SMPLX_PARENTS)[:num_joints].copy()
    parent[0] = 0
    f = face_parts = None
    if smooth_surface:
        v_template, f, face_parts = _tube_surface(num_verts, J, parent, rng)
    else:
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
    # white-noise posedirs wrinkle the surface ~7 mm at typical poses;
    # on the smooth surface that would make neighbouring faces straddle
    # everywhere, so they are 10x smaller there
    posedirs = rng.randn(num_verts, 3, 9 * (num_joints - 1)) * (
        0.0001 if smooth_surface else 0.001)

    if f is None:
        f = rng.randint(0, num_verts, size=(max(2 * num_verts - 4, 4), 3)
                        ).astype(np.int64)
    nfaces = f.shape[0]

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
    if face_parts is not None:
        # per-face part id (the face's bone tube, a joint id); the model
        # loaders ignore the extra key
        out["face_parts"] = face_parts
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


def write_smplx_model_dir(root: str, full_size: bool = False,
                          seed: int = 0) -> str:
    """Write male/female/neutral synthetic SMPL-X npzs in the layout
    `smplx.create` expects, <root>/smplx/SMPLX_{GENDER}.npz (an existing
    file is kept). Returns the smplx directory."""
    d = os.path.join(root, "smplx")
    os.makedirs(d, exist_ok=True)
    for gender in ("male", "female", "neutral"):
        path = os.path.join(d, f"SMPLX_{gender.upper()}.npz")
        if not os.path.exists(path):
            np.savez(path, **synthetic_smplx_npz(
                gender=gender, full_size=full_size, seed=seed))
    return d


def synthetic_amass_npz(num_frames: int = 600, fps: int = 60,
                        gender: str = "male", seed: int = 0) -> dict:
    """One AMASS-format mocap sequence: poses [N, 156] (3 root + 63 body +
    45 + 45 hands), trans [N, 3], betas [16], dmpls [N, 8],
    mocap_framerate; smooth sinusoidal joint angles and a drifting root."""
    rng = np.random.RandomState(seed)
    t = np.arange(num_frames) / fps
    n_pose = 156
    freqs = rng.uniform(0.3, 1.5, n_pose)
    phases = rng.uniform(0, 2 * np.pi, n_pose)
    amps = np.abs(rng.randn(n_pose)) * 0.12
    poses = amps[None, :] * np.sin(2 * np.pi * freqs[None, :] * t[:, None]
                                   + phases)
    poses[:, 0:3] *= 0.3  # gentle root orientation wobble
    trans = np.stack(
        [0.5 * t * rng.uniform(0.5, 1.0), 0.3 * np.sin(0.7 * t),
         0.02 * np.sin(3 * t)], axis=1)
    return {
        "poses": poses.astype(np.float64),
        "trans": trans.astype(np.float64),
        "betas": (rng.randn(16) * 0.5).astype(np.float64),
        "dmpls": np.zeros((num_frames, 8)),
        "gender": np.array(gender),
        "mocap_framerate": np.array(float(fps)),
    }


def write_amass_dataset(root: str, dataset_name: str = "TotalCapture",
                        num_subjects: int = 1, seqs_per_subject: int = 2,
                        num_frames: int = 600, fps: int = 60,
                        seed: int = 0) -> str:
    """Write synthetic AMASS npzs in the on-disk layout the loaders scan,
    <root>/<dataset>/<subject>/<name>_poses.npz (genders alternate; an
    existing file is kept). Returns `root`."""
    for s in range(num_subjects):
        subj_dir = os.path.join(root, dataset_name, f"s{s:03d}")
        os.makedirs(subj_dir, exist_ok=True)
        for q in range(seqs_per_subject):
            path = os.path.join(subj_dir, f"seq{q:02d}_poses.npz")
            if not os.path.exists(path):
                np.savez(path, **synthetic_amass_npz(
                    num_frames=num_frames, fps=fps,
                    gender="male" if (s + q) % 2 == 0 else "female",
                    seed=seed + 31 * s + q))
    return root


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


def synthetic_marker_set(num_verts: int, n_markers: int = 67,
                         seed: int = 3) -> dict:
    """SSM2-format marker json dict: {'markersets': [{'indices': {...}}]}."""
    rng = np.random.RandomState(seed)
    ids = rng.choice(num_verts, size=n_markers, replace=num_verts < n_markers)
    indices = {f"m{i:02d}": int(v) for i, v in enumerate(ids)}
    return {"markersets": [{"type": "synthetic", "indices": indices}]}


def write_marker_jsons(directory: str, num_verts: int) -> None:
    """SSM2.json (67 markers) and SSM2_withhand.json (81) of
    :func:`synthetic_marker_set` (an existing file is kept)."""
    os.makedirs(directory, exist_ok=True)
    for name, n in (("SSM2.json", 67), ("SSM2_withhand.json", 81)):
        path = os.path.join(directory, name)
        if not os.path.exists(path):
            with open(path, "w") as fh:
                json.dump(synthetic_marker_set(num_verts, n), fh)


def compact_part_table(num_joints: int = 55):
    """Joint id -> compact part id at SMPL-X granularity: body and head
    joints keep their own part, finger joints collapse into their wrist's.
    Returns (part_of_joint [J] int64, part_parent [P] int64), P <= 25."""
    parents = (SMPL_PARENTS[:num_joints] if num_joints <= 24
               else SMPLX_PARENTS[:num_joints]).copy()
    part_of_joint = np.arange(num_joints, dtype=np.int64)
    for j in range(25, num_joints):      # finger joints -> wrist part
        a = j
        while a >= 25:
            a = int(parents[a])
        part_of_joint[j] = a
    used = np.unique(part_of_joint)
    remap = {int(p): i for i, p in enumerate(used)}
    compact = np.array([remap[int(p)] for p in part_of_joint])
    part_parent = np.zeros(len(used), np.int64)
    for i, p in enumerate(used):
        pa = int(parents[int(p)]) if int(p) > 0 else 0
        part_parent[i] = remap[int(part_of_joint[pa])]
    return compact, part_parent


def write_part_segm_pkl(path: str, faces: np.ndarray,
                        num_parts: int = 8) -> dict:
    """Synthetic smplx_parts_segm.pkl stand-in (the FilterFaces input,
    fit_temp_loadprox_slide.py:335-340): faces bucketed into `num_parts`
    contiguous vertex-id ranges; part p's parent is p-1. Returns the dict
    that was pickled."""
    import pickle

    faces = np.asarray(faces)
    V = int(faces.max()) + 1
    segm = np.minimum(faces.min(axis=1) * num_parts // V,
                      num_parts - 1).astype(np.int64)
    part_parent = np.maximum(np.arange(num_parts) - 1, 0)
    data = {"segm": segm, "parents": part_parent[segm]}
    with open(path, "wb") as fh:
        pickle.dump(data, fh, protocol=2)
    return data
