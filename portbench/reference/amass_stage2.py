"""Plain AMASS Stage-2 temporal fit (LEMO's `opt_amass_temp.py`): from a
Stage-1 solution, all T frames of each clip are optimized jointly by
Adam (lr 0.01, 0.005 from step 61; betas frozen) under

  L = w_m  * mean |markers - targets|
    + w_vp * mean z^2 + w_sh * mean betas^2 + w_h * mean hand^2
    + w_sm * mean (dz/dt of the frozen smoothness encoder)^2
    + w_cv * the contact-vertex speed hinge (friction),

each clip its own problem. float32, one clip batch through the plain
model of `reference.smplx`; imports nothing of the program."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.smplx import (Smplx, matrot_to_aa, matrot_to_rot6d,
                                       rodrigues, rot6d_to_matrot,
                                       vposer_decode)

FOOT_PARTS = ("left_heel", "right_heel", "left_toe", "right_toe")


@dataclasses.dataclass(frozen=True)
class Weights:
    rec_markers: float = 1.0
    vposer: float = 0.02
    shape: float = 0.01
    hand: float = 0.01
    smooth: float = 1e6
    contact_vel: float = 0.03


def lr_at(step: int) -> float:
    return 0.01 if step < 61 else 0.005


def smooth_encoder(p: dict, x: torch.Tensor) -> torch.Tensor:
    """The smoothness encoder without downsampling: five blocks of two
    3x3 convolutions, each followed by a leaky ReLU (0.2)."""
    for i in range(1, 6):
        for j in (0, 2):
            x = F.conv2d(x, p[f"enc_blc{i}.main.{j}.weight"],
                         p[f"enc_blc{i}.main.{j}.bias"], padding=1)
            x = torch.where(x >= 0, x, 0.2 * x)
    return x


def frame0_rotation(j0: torch.Tensor) -> torch.Tensor:
    """[C, J, 3] frame-0 joints -> [C, 3, 3]: x along the hips (in the
    ground plane), z up, y = z x x; points map as (p - origin) @ R."""
    x = j0[:, 2] - j0[:, 1]
    x = torch.cat([x[:, :2], torch.zeros_like(x[:, 2:])], dim=1)
    x = x / torch.linalg.norm(x, dim=1, keepdim=True)
    z = torch.tensor([0.0, 0.0, 1.0], dtype=j0.dtype,
                     device=j0.device).expand_as(x)
    y = torch.linalg.cross(z, x, dim=1)
    y = y / torch.linalg.norm(y, dim=1, keepdim=True)
    return torch.stack([x, y, z], dim=-1)


def smoothness(enc, m81, j0, xmean, xstd):
    """Per-clip latent-acceleration loss: markers [C, T, 81, 3] in each
    clip's frame-0 frame (rotation from the detached frame-0 joints,
    origin the detached first marker of frame 0), normalized, as an image
    [C, 1, 243, T] of frame differences reflect-padded by (1, 8)."""
    C, T = m81.shape[:2]
    R = frame0_rotation(j0.detach())
    origin = m81[:, 0, 0].detach()
    m = torch.einsum("ctnk,ckl->ctnl", m81 - origin[:, None, None], R)
    x = (m.reshape(C, T, -1) - xmean) / xstd
    img = x.transpose(1, 2)[:, None]
    vel = F.pad(img[..., 1:] - img[..., :-1], (8, 8, 1, 1), mode="reflect")
    z = smooth_encoder(enc, vel)
    dz = z[..., 1:] - z[..., :-1]
    return (dz ** 2).mean(dim=(1, 2, 3))


def friction(feet, contact, parts, fps=30.0, thresh=0.1):
    """Per-clip hinge on foot-vertex speeds: feet [C, T, Nf, 3], contact
    [C, T, 4]; per part, the mean speed over the (frame, vertex) pairs
    above `thresh` in frames labelled in contact."""
    vel = (feet[:, 1:] - feet[:, :-1]) * fps
    total = 0.0
    for i, sl in enumerate(parts):
        sp = torch.sqrt((vel[:, :, sl] ** 2).sum(-1) + 1e-12)
        over = (sp > thresh).to(sp.dtype) * contact[:, :-1, i][..., None]
        total = total + (sp * over).sum(dim=(1, 2)) / torch.clamp(
            over.sum(dim=(1, 2)), min=1.0)
    return total


class Stage2:
    """The plain Stage-2 problem of one model, VPoser, encoder and
    statistics: `loss(v, betas, targets, contact)` -> per-clip losses [C]
    and `fit(targets, contact, init72, steps)` -> (x72 [C, T, 72],
    losses [C, steps])."""

    def __init__(self, model_raw: dict, vposer: dict, enc: dict,
                 xmean, xstd, ids67, ids81, foot_ids: dict,
                 weights: Weights = Weights()):
        self.body = Smplx(model_raw)
        self.vposer, self.enc = vposer, enc
        self.xmean, self.xstd = xmean, xstd
        dev = self.body.v_template.device
        self.ids67 = torch.as_tensor(np.asarray(ids67), device=dev)
        self.ids81 = torch.as_tensor(np.asarray(ids81), device=dev)
        ids, parts, off = [], [], 0
        for part in FOOT_PARTS:
            a = np.asarray(foot_ids[part], np.int64)
            parts.append(slice(off, off + len(a)))
            ids.append(a)
            off += len(a)
        self.foot = torch.as_tensor(np.concatenate(ids), device=dev)
        self.parts = parts
        self.w = weights

    def loss(self, v, betas, targets, contact):
        C, T = targets.shape[:2]
        B = C * T
        z = v["other"][..., 0:32]
        hands = v["other"][..., 32:56]
        orient = matrot_to_aa(rot6d_to_matrot(v["rot6d"].reshape(-1, 6)))
        verts, joints = self.body.forward(
            v["transl"].reshape(B, 3), orient,
            vposer_decode(self.vposer, z.reshape(B, 32)),
            hands[..., :12].reshape(B, 12), hands[..., 12:].reshape(B, 12),
            betas.reshape(B, -1))
        verts = verts.reshape(C, T, -1, 3)
        w = self.w
        out = w.rec_markers * (verts[:, :, self.ids67] - targets).abs().mean(
            dim=(1, 2, 3))
        out = out + w.vposer * (z ** 2).mean(dim=(1, 2))
        out = out + w.shape * (betas ** 2).mean(dim=(1, 2))
        out = out + w.hand * (hands ** 2).mean(dim=(1, 2))
        if w.smooth:
            j0 = joints.reshape(C, T, -1, 3)[:, 0, :25]
            out = out + w.smooth * smoothness(
                self.enc, verts[:, :, self.ids81], j0, self.xmean, self.xstd)
        if w.contact_vel:
            out = out + w.contact_vel * friction(verts[:, :, self.foot],
                                                 contact, self.parts)
        return out

    def fit(self, targets, contact, init72, steps: int = 100):
        """`steps` of Adam (optax's update, bias corrections in f32) on
        each clip's loss; a clip whose loss turns non-finite keeps its
        parameters and moments from that step on."""
        C = init72.shape[0]
        betas = init72[..., 6:16]
        v = {"transl": init72[..., 0:3].clone(),
             "rot6d": matrot_to_rot6d(rodrigues(init72[..., 3:6].reshape(
                 -1, 3))).reshape(init72.shape[:2] + (6,)),
             "other": init72[..., 16:72].clone()}
        m = {k: torch.zeros_like(x) for k, x in v.items()}
        s = {k: torch.zeros_like(x) for k, x in v.items()}
        dead = torch.zeros(C, dtype=torch.bool, device=init72.device)
        hist = []
        for i in range(steps):
            leaves = {k: x.detach().requires_grad_(True) for k, x in v.items()}
            per_clip = self.loss(leaves, betas, targets, contact)
            grads = torch.autograd.grad(per_clip.sum(), list(leaves.values()))
            hist.append(per_clip.detach())
            dead = dead | ~torch.isfinite(per_clip.detach())
            t = np.float32(i + 1)
            bc1 = float(np.float32(1) - np.float32(0.9) ** t)
            bc2 = float(np.float32(1) - np.float32(0.999) ** t)
            with torch.no_grad():
                for (k, x), g in zip(v.items(), grads):
                    keep = dead.reshape((C,) + (1,) * (x.dim() - 1))
                    m1 = 0.1 * g + 0.9 * m[k]
                    s1 = 0.001 * (g * g) + 0.999 * s[k]
                    step = (m1 / bc1) / (torch.sqrt(s1 / bc2) + 1e-8)
                    v[k] = torch.where(keep, x, x - lr_at(i) * step)
                    m[k] = torch.where(keep, m[k], m1)
                    s[k] = torch.where(keep, s[k], s1)
        with torch.no_grad():
            orient = matrot_to_aa(rot6d_to_matrot(v["rot6d"].reshape(-1, 6)))
            x72 = torch.cat([v["transl"], orient.reshape(init72.shape[:2]
                                                         + (3,)),
                             betas, v["other"]], dim=-1)
        return x72, torch.stack(hist, dim=1)
