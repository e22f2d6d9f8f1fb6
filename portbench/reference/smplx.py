"""Plain SMPL-X in float32 PyTorch: the published forward (shape and
expression blend shapes, Rodrigues, pose blend shapes, the kinematic
chain one joint at a time, linear blend skinning) from the raw arrays of
an official model file, and VPoser v1's decoder. No kernel, no fused
constant, no batching trick. Imports nothing of the program.

The rotation conversions are frozen copies of the plain formulas the
published code uses (Rodrigues with `norm(aa + 1e-8)`, Gram-Schmidt on
the 6-D representation, matrix -> quaternion -> axis-angle)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

NUM_BETAS = 10
NUM_EXPR = 10
NUM_PCA = 12
_EPS = 1e-8


def rodrigues(aa: torch.Tensor) -> torch.Tensor:
    """Axis-angle [N, 3] -> rotation matrices [N, 3, 3]."""
    angle = torch.linalg.norm(aa + _EPS, dim=1, keepdim=True)
    d = aa / angle
    cos, sin = torch.cos(angle)[:, None], torch.sin(angle)[:, None]
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    o = torch.zeros_like(x)
    K = torch.stack([o, -z, y, z, o, -x, -y, x, o], dim=1).reshape(-1, 3, 3)
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device)[None]
    return eye + sin * K + (1.0 - cos) * torch.bmm(K, K)


def rot6d_to_matrot(x: torch.Tensor) -> torch.Tensor:
    """[N, 6] -> [N, 3, 3], Gram-Schmidt on the two columns of view(3, 2)."""
    m = x.reshape(-1, 3, 2)
    a1, a2 = m[:, :, 0], m[:, :, 1]
    b1 = a1 / torch.sqrt((a1 ** 2).sum(dim=1, keepdim=True) + 1e-24)
    b2 = a2 - (b1 * a2).sum(dim=1, keepdim=True) * b1
    b2 = b2 / torch.sqrt((b2 ** 2).sum(dim=1, keepdim=True) + 1e-24)
    return torch.stack([b1, b2, torch.linalg.cross(b1, b2, dim=-1)], dim=-1)


def matrot_to_rot6d(R: torch.Tensor) -> torch.Tensor:
    return R.reshape(-1, 9)[:, [0, 1, 3, 4, 6, 7]]


def matrot_to_aa(R: torch.Tensor) -> torch.Tensor:
    """[N, 3, 3] -> [N, 3]: the quaternion of the largest of its four
    candidate components, w >= 0, then the axis times the angle."""
    m = R.reshape(-1, 3, 3)
    m00, m01, m02 = m[:, 0, 0], m[:, 0, 1], m[:, 0, 2]
    m10, m11, m12 = m[:, 1, 0], m[:, 1, 1], m[:, 1, 2]
    m20, m21, m22 = m[:, 2, 0], m[:, 2, 1], m[:, 2, 2]
    sq = [1.0 + m00 + m11 + m22, 1.0 + m00 - m11 - m22,
          1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22]
    h = [torch.sqrt(torch.clamp(s, min=_EPS)) * 0.5 for s in sq]
    cands = torch.stack([
        torch.stack([h[0], (m21 - m12) / (4 * h[0]), (m02 - m20) / (4 * h[0]),
                     (m10 - m01) / (4 * h[0])], 1),
        torch.stack([(m21 - m12) / (4 * h[1]), h[1], (m01 + m10) / (4 * h[1]),
                     (m02 + m20) / (4 * h[1])], 1),
        torch.stack([(m02 - m20) / (4 * h[2]), (m01 + m10) / (4 * h[2]), h[2],
                     (m12 + m21) / (4 * h[2])], 1),
        torch.stack([(m10 - m01) / (4 * h[3]), (m02 + m20) / (4 * h[3]),
                     (m12 + m21) / (4 * h[3]), h[3]], 1)], 1)
    pick = torch.argmax(torch.stack(sq, 1), dim=1)
    q = torch.gather(cands, 1, pick[:, None, None].expand(-1, 1, 4))[:, 0]
    q = q * torch.where(q[:, :1] < 0, -1.0, 1.0)
    q = q / torch.linalg.norm(q, dim=1, keepdim=True)
    w = torch.clamp(q[:, 0], -1.0, 1.0)
    xyz = q[:, 1:]
    s = torch.sqrt((xyz ** 2).sum(dim=1) + 1e-24)
    angle = 2.0 * torch.atan2(s, w)
    scale = torch.where(s < _EPS, 2.0, angle / torch.clamp(s, min=_EPS))
    return xyz * scale[:, None]


def vposer_decode(p: dict, z: torch.Tensor) -> torch.Tensor:
    """VPoser v1's decoder: z [B, 32] -> body pose axis-angle [B, 63]."""
    def lrelu(x):
        return torch.where(x >= 0, x, 0.2 * x)

    h = lrelu(F.linear(z, p["bodyprior_dec_fc1.weight"],
                       p["bodyprior_dec_fc1.bias"]))
    h = lrelu(F.linear(h, p["bodyprior_dec_fc2.weight"],
                       p["bodyprior_dec_fc2.bias"]))
    h = F.linear(h, p["bodyprior_dec_out.weight"], p["bodyprior_dec_out.bias"])
    return matrot_to_aa(rot6d_to_matrot(h.reshape(-1, 6))).reshape(
        z.shape[0], 63)


class Smplx:
    """The model's arrays as an official SMPL-X npz holds them (shapedirs
    [V, 3, S], posedirs [V, 3, 9 (J - 1)], J_regressor [J, V], weights
    [V, J], kintree_table [2, J], hands_components{l,r} [45, 45],
    hands_mean{l,r} [45]), as float32 tensors on one device; PCA hands
    with 12 components and the hand means added, as the fitters load it."""

    def __init__(self, raw: dict):
        t = {k: v for k, v in raw.items()}
        self.v_template = t["v_template"]
        V = self.v_template.shape[0]
        sd = t["shapedirs"]
        begin = 300 if sd.shape[-1] > 300 else NUM_BETAS
        self.dirs = torch.cat([sd[..., :NUM_BETAS],
                               sd[..., begin:begin + NUM_EXPR]], dim=-1)
        self.posedirs = t["posedirs"].reshape(V * 3, -1).T   # [9 (J-1), 3V]
        self.J_regressor = t["J_regressor"]
        self.weights = t["weights"]
        par = [int(p) for p in t["kintree_table"][0].tolist()]
        par[0] = -1
        self.parents = par
        self.hand_comps = {s: t[f"hands_components{s}"][:NUM_PCA]
                           for s in "lr"}
        self.hand_mean = {s: t[f"hands_mean{s}"] for s in "lr"}

    def forward(self, transl, global_orient, body_pose, lhand, rhand,
                betas):
        """All [B, ...]; face parameters zero. Returns (vertices [B, V, 3],
        the regressor's posed joints [B, J, 3]), translated."""
        B = transl.shape[0]
        J = len(self.parents)
        zeros = torch.zeros((B, 9), dtype=transl.dtype, device=transl.device)
        full = torch.cat([global_orient, body_pose, zeros,
                          lhand @ self.hand_comps["l"] + self.hand_mean["l"],
                          rhand @ self.hand_comps["r"] + self.hand_mean["r"]],
                         dim=1)
        shape = torch.cat([betas, torch.zeros((B, NUM_EXPR),
                                              dtype=betas.dtype,
                                              device=betas.device)], dim=1)
        v_shaped = self.v_template + torch.einsum("bl,vkl->bvk", shape,
                                                  self.dirs)
        joints = torch.einsum("bvk,jv->bjk", v_shaped, self.J_regressor)
        rot = rodrigues(full.reshape(-1, 3)).reshape(B, J, 3, 3)
        eye = torch.eye(3, dtype=rot.dtype, device=rot.device)
        feat = (rot[:, 1:] - eye).reshape(B, -1)
        v_posed = v_shaped + (feat @ self.posedirs).reshape(B, -1, 3)
        # the chain, one joint at a time: world rotation and translation
        Rg, tg = [rot[:, 0]], [joints[:, 0]]
        for j in range(1, J):
            p = self.parents[j]
            Rg.append(Rg[p] @ rot[:, j])
            tg.append(tg[p] + (Rg[p] @ (joints[:, j] - joints[:, p])[
                ..., None])[..., 0])
        Rg, tg = torch.stack(Rg, 1), torch.stack(tg, 1)        # [B, J, ...]
        t_rel = tg - (Rg @ joints[..., None])[..., 0]
        A = torch.cat([Rg, t_rel[..., None]], dim=-1).reshape(B, J, 12)
        Tv = torch.matmul(self.weights, A).reshape(B, -1, 3, 4)  # [B, V, 3, 4]
        verts = (Tv[..., :3] @ v_posed[..., None])[..., 0] + Tv[..., 3]
        tr = transl[:, None]
        return verts + tr, tg + tr
