"""VPoser training (port of `lemo_tpu/train/vposer.py`; the vendored
VPoserTrainer capability, human_body_prior/train/vposer_smpl.py:174-340).

VAE over 21-joint body poses: encoder -> Normal(mu, softplus(logvar)),
reparameterized sample -> decoder -> 6-D continuous rotations -> matrot.
Loss = KL + the reconstruction: matrot L1, or with a body model the mean
L1 between the two bodies' vertices (vposer_smpl.py:303-320), through
the port's body forward (on the card: the chain and vertex kernels, two
forwards and one backward a step).
"""

from __future__ import annotations

import dataclasses
import glob
import os

import numpy as np
import torch

from lemo_tpu_torch import exact_f32_matmuls, resolve_device
from lemo_tpu_torch.body_model import vposer as vp
from lemo_tpu_torch.fitting.adam import adam_init, adam_minimize
from lemo_tpu_torch.ops.rotations import aa_to_matrot

# the zero parameters of the mesh loss's body (`use_pca=False`, 10 betas,
# 10 expressions), beside its body_pose
_ZERO_BODY = (("transl", 3), ("global_orient", 3), ("betas", 10),
              ("left_hand_pose", 45), ("right_hand_pose", 45),
              ("jaw_pose", 3), ("leye_pose", 3), ("reye_pose", 3),
              ("expression", 10))


@dataclasses.dataclass
class VPoserTrainConfig:
    lr: float = 1e-3
    batch_size: int = 256
    latent: int = 32
    kl_coef: float = 0.005
    num_joints: int = 21


def make_train_step(cfg: VPoserTrainConfig, body_fwd=None, body_consts=None):
    """train_step(params, state, pose_aa [B, 63], eps [B, latent]) ->
    (params, metrics), eps the reparameterization's standard normal
    sample. With `body_fwd` (`make_forward_fn` of a `use_pca=False`
    model with 10 betas and 10 expressions) and its `body_consts`, the
    reconstruction term is the mesh L1; the target body does not depend
    on the parameters, so it runs under `no_grad`.
    `train_step.loss_fn(params, pose_aa, eps)` is the loss and
    `train_step.lr` its Adam rate."""

    def verts(pose):
        B = pose.shape[0]
        p = {k: pose.new_zeros((B, s)) for k, s in _ZERO_BODY}
        p["body_pose"] = pose
        return body_fwd(p, body_consts)["vertices"]

    def loss_fn(params, pose_aa, eps):
        B = pose_aa.shape[0]
        matrot = aa_to_matrot(pose_aa.reshape(-1, 3)).reshape(B, -1)
        mu, sigma = vp.encode(params, matrot)
        z = mu + sigma * eps
        kl = (0.5 * (sigma ** 2 + mu ** 2 - 1.0
                     - 2.0 * torch.log(sigma + 1e-8))).sum(-1).mean()
        if body_fwd is None:
            rec_matrot = vp.decode(params, z, "matrot").reshape(B, -1)
            loss_rec = (rec_matrot - matrot).abs().mean()
        else:
            with torch.no_grad():
                target = verts(pose_aa)
            loss_rec = (verts(vp.decode(params, z, "aa")) - target).abs() \
                .mean()
        total = cfg.kl_coef * kl + loss_rec
        return total, {"kl": kl, "rec": loss_rec}

    def train_step(params, state, pose_aa, eps):
        return adam_minimize(loss_fn, params, state, cfg.lr, pose_aa, eps)

    train_step.loss_fn = loss_fn
    train_step.lr = cfg.lr
    return train_step


def prepare_amass_poses(amass_dir: str, datasets, max_frames: int = 200000,
                        stride: int = 5) -> np.ndarray:
    """AMASS npz sequences -> [N, 63] body-pose training matrix (the
    human_body_prior/data/prepare_data.py capability)."""
    chunks = []
    total = 0
    for ds in datasets:
        for fn in sorted(glob.glob(os.path.join(amass_dir, ds, "*",
                                                "*_poses.npz"))):
            with np.load(fn) as z:
                poses = z["poses"][::stride, 3:66]
            chunks.append(poses.astype(np.float32))
            total += len(poses)
            if total >= max_frames:
                break
        if total >= max_frames:
            break
    return np.concatenate(chunks)[:max_frames] if chunks else \
        np.zeros((0, 63), np.float32)


def train(poses_aa: np.ndarray, cfg: VPoserTrainConfig, num_steps: int,
          seed: int = 0, body_fwd=None, body_consts=None,
          log_every: int = 200, device=None):
    """poses_aa [N, 63] axis-angle body poses (AMASS frames). Trains on
    `device` (None: the CUDA card; raises without it; with a body model,
    the model's device). Batches are drawn with `lemo_tpu`'s
    `RandomState` calls; eps from a generator of the device seeded
    seed + 1. Returns (params, history)."""
    dev = resolve_device(device)
    exact_f32_matmuls()
    rng = np.random.RandomState(seed)
    params = vp.init_vposer(torch.Generator().manual_seed(seed),
                            num_joints=cfg.num_joints, latent=cfg.latent,
                            device=dev)
    train_step = make_train_step(cfg, body_fwd, body_consts)
    state = adam_init(params)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)

    history = []
    for step in range(1, num_steps + 1):
        pick = rng.randint(0, len(poses_aa), cfg.batch_size)
        eps = torch.randn((cfg.batch_size, cfg.latent), generator=gen,
                          device=dev)
        params, metrics = train_step(
            params, state, torch.as_tensor(poses_aa[pick], device=dev), eps)
        if step % log_every == 0 or step == num_steps:
            history.append({"step": step,
                            **{k: float(v) for k, v in metrics.items()}})
    return params, history
