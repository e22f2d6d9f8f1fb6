"""Synthetic stand-ins for the licensed assets, made from the run's seed:
an SMPL-X model file (the published layout and widths), VPoser v1's
decoder and the smoothness encoder. Nothing here is read from disk.

The topology is fixed (one tapered tube of quads a bone of SMPL-X's
kinematic tree, the `smooth_surface` construction of the port's
`testing/synthetic.py`, with its skinning weights and joint regressor),
so it is built on the host; every random array is drawn on the run's
device from a `torch.Generator` seeded with `--seed`, in a few large
calls."""

from __future__ import annotations

import math

import numpy as np
import torch

SMPLX_PARENTS = np.array(
    [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17,
     18, 19, 15, 15, 15,
     20, 25, 26, 20, 28, 29, 20, 31, 32, 20, 34, 35, 20, 37, 38,
     21, 40, 41, 21, 43, 44, 21, 46, 47, 21, 49, 50, 21, 52, 53],
    dtype=np.int64)

# rest-pose joint locations (approximate human proportions, m, z up)
_BODY_JOINTS = np.array([
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


def generator(seed: int, device) -> torch.Generator:
    """A generator on `device` seeded with `seed` (any whole number; taken
    modulo 2**63)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def _rest_joints(J: int) -> np.ndarray:
    out = np.zeros((J, 3))
    out[:25] = _BODY_JOINTS
    for side, wrist in ((0, 20), (1, 21)):       # fingers fan from wrists
        sign = 1.0 if side == 0 else -1.0
        for f in range(5):
            for k in range(3):
                out[25 + side * 15 + f * 3 + k] = out[wrist] + np.array(
                    [sign * 0.03 * (k + 1), 0.02 * (f - 2), 0.0])
    return out


def _tube_surface(V: int, Jpos: np.ndarray, parent: np.ndarray):
    """One open tapered tube of 8-vertex rings a bone, the rings shared
    out by bone length; leftover vertices parked near the joints in a
    fixed pattern. Returns (v_template [V, 3], faces [F, 3])."""
    n_seg = 8
    bones = [(j, int(parent[j])) for j in range(1, len(Jpos))
             if np.linalg.norm(Jpos[j] - Jpos[int(parent[j])]) > 1e-6]
    lens = np.array([np.linalg.norm(Jpos[j] - Jpos[p]) for j, p in bones])
    budget = V // n_seg
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
    verts, faces, off = [], [], 0
    for (j, p), n_r, L in zip(bones, rings, lens):
        a, b = Jpos[p], Jpos[j]
        axis = (b - a) / L
        tmp = (np.array([1.0, 0.0, 0.0]) if abs(axis[0]) < 0.9
               else np.array([0.0, 1.0, 0.0]))
        u = np.cross(axis, tmp)
        u /= np.linalg.norm(u)
        w = np.cross(axis, u)
        rb = float(np.clip(0.25 * L, 0.009, 0.05))
        t = np.linspace(0.06, 0.94, n_r)
        prof = rb * (0.18 + 0.82 * np.sin(np.pi * t) ** 0.8)
        radial = np.cos(th)[:, None] * u[None] + np.sin(th)[:, None] * w[None]
        centers = a[None] + t[:, None] * (b - a)[None]
        verts.append((centers[:, None, :] + prof[:, None, None]
                      * radial[None]).reshape(-1, 3))
        ir = np.arange(n_r - 1)[:, None]
        k = np.arange(n_seg)[None, :]
        a0 = off + ir * n_seg + k
        a1 = off + ir * n_seg + (k + 1) % n_seg
        b0, b1 = a0 + n_seg, a1 + n_seg
        faces.append(np.stack([np.stack([a0, a1, b0], -1),
                               np.stack([b0, a1, b1], -1)],
                              axis=2).reshape(-1, 3))
        off += n_r * n_seg
    v = np.concatenate(verts)
    rem = V - v.shape[0]
    if rem > 0:
        r = np.arange(rem)
        v = np.concatenate([v, Jpos[r % len(Jpos)] + 0.01 * np.stack(
            [np.sin(r), np.cos(r), np.sin(0.5 * r)], 1)])
    return v, np.concatenate(faces).astype(np.int64)


def smplx_topology(V: int = 10475, J: int = 55) -> dict:
    """The fixed arrays of the synthetic model: rest vertices, faces,
    skinning weights (a softmax-like falloff over the 4 nearest joints),
    joint regressor (each joint the mean of its nearest vertices) and
    the kinematic tree, in an official file's layout."""
    Jpos = _rest_joints(J)
    parent = SMPLX_PARENTS.copy()
    parent[0] = 0
    v, faces = _tube_surface(V, Jpos, parent)
    d = np.linalg.norm(v[:, None, :] - Jpos[None, :, :], axis=-1)
    w = np.exp(-d / 0.08)
    w = np.where(w >= np.sort(w, axis=1)[:, -4][:, None], w, 0.0)
    w = w / w.sum(axis=1, keepdims=True)
    Jreg = np.zeros((J, V))
    k = max(4, V // J // 2)
    nearest = np.argsort(d, axis=0)
    for j in range(J):
        Jreg[j, nearest[:k, j]] = 1.0 / k
    kintree = np.stack([np.where(SMPLX_PARENTS < 0, 2**32 - 1,
                                 SMPLX_PARENTS), np.arange(J)])
    return {"v_template": v, "f": faces, "weights": w, "J_regressor": Jreg,
            "kintree_table": kintree.astype(np.int64)}


def smplx_model(g: torch.Generator, device, num_shape: int = 400,
                posedirs_scale: float = 1e-3, V: int = 10475,
                J: int = 55) -> dict:
    """A full SMPL-X model file's arrays: the fixed topology as float32
    tensors on `device`, and shapedirs [V, 3, num_shape] (N(0, 0.01)),
    posedirs [V, 3, 9 (J - 1)] (N(0, posedirs_scale)), the hand PCA
    components [45, 45] (N(0, 0.1)) and means (N(0, 0.05)), and 51 face
    landmarks drawn from `g` on `device`."""
    topo = smplx_topology(V, J)
    out = {k: torch.as_tensor(v, device=device) for k, v in topo.items()}
    for k in ("v_template", "weights", "J_regressor"):
        out[k] = out[k].to(torch.float32)

    def randn(*shape, scale):
        return torch.randn(shape, generator=g, device=device) * scale

    out["shapedirs"] = randn(V, 3, num_shape, scale=0.01)
    out["posedirs"] = randn(V, 3, 9 * (J - 1), scale=posedirs_scale)
    hands = randn(2, 46, 45, scale=1.0)
    out["hands_componentsl"] = hands[0, :45] * 0.1
    out["hands_componentsr"] = hands[1, :45] * 0.1
    out["hands_meanl"] = hands[0, 45] * 0.05
    out["hands_meanr"] = hands[1, 45] * 0.05
    F = topo["f"].shape[0]
    out["lmk_faces_idx"] = torch.randint(0, F, (51,), generator=g,
                                         device=device)
    bary = torch.rand((51, 3), generator=g, device=device) + 0.1
    out["lmk_bary_coords"] = bary / bary.sum(1, keepdim=True)
    return out


def _uniform(g, shape, bound, device):
    return (torch.rand(shape, generator=g, device=device) * 2 - 1) * bound


def vposer_decoder(g, device, latent: int = 32, hidden: int = 512,
                   joints: int = 21) -> dict:
    """VPoser v1's decoder weights under torch.nn.Linear's default
    initialization bounds (uniform in +-1/sqrt(fan_in))."""
    p = {}
    for name, fi, fo in (("bodyprior_dec_fc1", latent, hidden),
                         ("bodyprior_dec_fc2", hidden, hidden),
                         ("bodyprior_dec_out", hidden, joints * 6)):
        b = 1.0 / math.sqrt(fi)
        p[f"{name}.weight"] = _uniform(g, (fo, fi), b, device)
        p[f"{name}.bias"] = _uniform(g, (fo,), b, device)
    return p


def smooth_encoder(g, device, z_channel: int = 64) -> dict:
    """The smoothness encoder's weights (channels 1, 32, 64, 64, 64, 64:
    LEMO's z_channel 64; two 3x3 convolutions a block) under
    torch.nn.Conv2d's default initialization bounds."""
    if z_channel != 64:
        raise ValueError(f"z_channel {z_channel}: only LEMO's 64 is built")
    chans = [1, 32, 64, 64, 64, 64]
    p = {}
    for i in range(1, 6):
        for j, ci in ((0, chans[i - 1]), (2, chans[i])):
            fan_in = ci * 9
            bw = math.sqrt(2.0 / 6.0) * math.sqrt(3.0 / fan_in)
            p[f"enc_blc{i}.main.{j}.weight"] = _uniform(
                g, (chans[i], ci, 3, 3), bw, device)
            p[f"enc_blc{i}.main.{j}.bias"] = _uniform(
                g, (chans[i],), 1.0 / math.sqrt(fan_in), device)
    return p


def to_numpy(tree: dict) -> dict:
    """Tensors -> host numpy arrays (the form the program's loaders take)."""
    return {k: v.detach().cpu().numpy() for k, v in tree.items()}
