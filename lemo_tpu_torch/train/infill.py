"""Infilling-prior training (port of `lemo_tpu/train/infill.py`; the
train_infill_prior.py:61-313 recipe).

Trains the 4-channel AE on local_markers_4chan images with the masking
curriculum: random 1-6 whole markers zeroed for the first 20 epochs,
real PROX occlusion masks afterwards; loss = 10 * L1(body rows) +
10 * L1(velocity of body rows) + 1 * BCE(contact-label rows), on the
reflect-padded images as the reference computes it
(train_infill_prior.py:196-208: the `[0:-5]` row slice leaves out the 4
contact rows and 1 pad row; BCE covers the last 5 padded rows).

The corpus stays on the device; a random-mask step takes only its [B]
indices from the host and draws its mask on the device
(`random_mask_draws`, then the deterministic `marker_mask`). The
curriculum's `RandomState` calls are `lemo_tpu`'s, in its order.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from lemo_tpu_torch import exact_f32_matmuls, resolve_device
from lemo_tpu_torch.fitting.adam import adam_init, adam_minimize
from lemo_tpu_torch.ops.signal import reflect_pad_dt
from lemo_tpu_torch.priors.conv_ae import infill_ae_forward, init_infill_ae

N_MASK = 6          # at most 6 markers zeroed a sample
N_MARKERS = 67


@dataclasses.dataclass
class InfillTrainConfig:
    lr: float = 1e-4
    batch_size: int = 120
    in_channel: int = 4
    conv_k: int = 3
    input_padding: bool = True
    weight_loss_rec_body: float = 10.0
    weight_loss_rec_body_v: float = 10.0
    weight_loss_rec_contact_lbl: float = 1.0
    random_mask_epochs: int = 20  # curriculum switch point


def random_mask_draws(gen: torch.Generator, batch_size: int, device):
    """The random mask's draws, on `device` from `gen` (a generator of
    that device): uniform scores [B, 67] and counts n [B, 1] in 1..6."""
    scores = torch.rand((batch_size, N_MARKERS), generator=gen,
                        device=device)
    n = torch.randint(1, N_MASK + 1, (batch_size, 1), generator=gen,
                      device=device)
    return scores, n


def marker_mask(scores: torch.Tensor, n: torch.Tensor, d: int, T: int,
                mode: str = "local_markers_4chan") -> torch.Tensor:
    """The [B, d, T] channel-0 mask of the draws: the markers of the n
    largest scores zeroed (train_infill_prior.py:147-168), and a foot's
    contact rows with them.

    The reference draws ``random.sample(range(67), random.randint(1, 6))``;
    the top 6 of iid uniform scores are a uniformly random distinct
    6-subset in random order, and the first n of it a uniform n-subset.
    """
    B = scores.shape[0]
    offset = 3 if mode == "local_markers_4chan" else 6
    marker_ids = torch.topk(scores, N_MASK, dim=1).indices     # [B, 6]
    active = torch.arange(N_MASK, device=scores.device)[None, :] < n
    rows = marker_ids * 3 + offset                             # [B, 6]
    r = torch.arange(d, device=scores.device)[None, :, None]   # [1, d, 1]
    covered = (r >= rows[:, None, :]) & (r < rows[:, None, :] + 3)
    zeroed = (covered & active[:, None, :]).any(-1)            # [B, d]
    mask = (~zeroed).float()[:, :, None].expand(B, d, T).clone()

    def has(*slots):
        return torch.stack([((marker_ids == s) & active).any(-1)
                            for s in slots]).any(0)            # [B]

    left = (~has(16, 30)).float()[:, None]
    right = (~has(47, 60)).float()[:, None]
    mask[:, -4:, :] = torch.stack([left, right, left, right],
                                  dim=1).expand(B, 4, T)
    return mask


def random_marker_mask(gen: torch.Generator, batch_size: int, d: int, T: int,
                       mode: str = "local_markers_4chan", device="cpu"):
    """Random 1-6 markers zeroed a sample: `marker_mask` of fresh draws."""
    scores, n = random_mask_draws(gen, batch_size, device)
    return marker_mask(scores, n, d, T, mode)


def prox_mask_to_image_mask(prox_masks: np.ndarray, d: int, T: int,
                            mode: str = "local_markers_4chan") -> np.ndarray:
    """[B, T0, 67*3] PROX occlusion masks -> [B, d, T] channel-0 masks
    (train_infill_prior.py:170-188)."""
    B = prox_masks.shape[0]
    mm = prox_masks[:, :T].transpose(0, 2, 1)  # [B, 201, T]
    pelvis = np.ones((B, 3 if mode == "local_markers_4chan" else 6, T))
    left = (mm[:, 16 * 3:16 * 3 + 1] == 1) & (mm[:, 30 * 3:30 * 3 + 1] == 1)
    right = (mm[:, 47 * 3:47 * 3 + 1] == 1) & (mm[:, 60 * 3:60 * 3 + 1] == 1)
    contact = np.concatenate([left, right, left, right], axis=1).astype(
        mm.dtype)
    return np.concatenate([pelvis, mm, contact], axis=1)


def make_train_step(cfg: InfillTrainConfig):
    """(train_step(params, state, clip_img, mask) -> (params, metrics),
    eval_step(params, clip_img, mask) -> metrics); clip_img [B, 4, d, T],
    mask [B, d, T] on channel 0. `train_step.indexed(params, state,
    images_dev, idx, gen)` takes the batch from the device corpus
    [N, 4, d, T] by [B] indices and draws its random mask from `gen`;
    `train_step.loss_fn(params, clip_img, mask)` is the loss and
    `train_step.lr` its Adam rate."""

    def loss_fn(params, clip_img, mask):
        x_in = torch.cat([clip_img[:, :1] * mask[:, None], clip_img[:, 1:]],
                         dim=1)
        if cfg.input_padding:
            x_in = reflect_pad_dt(x_in)
            x_tgt = reflect_pad_dt(clip_img)
        else:
            x_tgt = clip_img
        rec, _ = infill_ae_forward(params, x_in, kernel=cfg.conv_k)

        body_t, body_r = x_tgt[:, 0, :-5], rec[:, 0, :-5]
        loss_body = (body_t - body_r).abs().mean()
        vt = body_t[..., 1:] - body_t[..., :-1]
        vr = body_r[..., 1:] - body_r[..., :-1]
        loss_body_v = (vt - vr).abs().mean()
        loss_bce = F.binary_cross_entropy_with_logits(
            rec[:, 0, -5:], x_tgt[:, 0, -5:])
        total = (cfg.weight_loss_rec_body * loss_body
                 + cfg.weight_loss_rec_body_v * loss_body_v
                 + cfg.weight_loss_rec_contact_lbl * loss_bce)
        return total, {"loss_rec_body": loss_body,
                       "loss_rec_body_v": loss_body_v,
                       "loss_rec_contact_lbl": loss_bce}

    def train_step(params, state, clip_img, mask):
        return adam_minimize(loss_fn, params, state, cfg.lr, clip_img, mask)

    def train_step_indexed(params, state, images_dev, idx, gen):
        batch = images_dev[idx]                        # [B, 4, d, T]
        mask = random_marker_mask(gen, idx.shape[0], batch.shape[2],
                                  batch.shape[3], device=batch.device)
        return train_step(params, state, batch, mask)

    def eval_step(params, clip_img, mask):
        with torch.no_grad():
            return loss_fn(params, clip_img, mask)[1]

    train_step.indexed = train_step_indexed
    train_step.loss_fn = loss_fn
    train_step.lr = cfg.lr
    return train_step, eval_step


def train(images_train: np.ndarray, cfg: InfillTrainConfig, num_steps: int,
          prox_masks: np.ndarray | None = None, seed: int = 0,
          steps_per_epoch: int | None = None, log_every: int = 500,
          callback=None, device=None):
    """Run the curriculum on `device` (None: the CUDA card; raises
    without it); images_train [N, 4, T, d]. Returns (params, history).
    Raises ValueError when there are fewer images than a batch
    (`lemo_tpu` loops forever there)."""
    dev = resolve_device(device)
    exact_f32_matmuls()
    if len(images_train) < cfg.batch_size:
        raise ValueError(f"{len(images_train)} training images, fewer than "
                         f"a batch of {cfg.batch_size}")
    rng = np.random.RandomState(seed)
    params = init_infill_ae(torch.Generator().manual_seed(seed),
                            in_channel=cfg.in_channel, kernel=cfg.conv_k,
                            device=dev)
    train_step, _ = make_train_step(cfg)
    state = adam_init(params)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)

    # the corpus in the training layout, on the device
    images_dev = torch.as_tensor(
        np.ascontiguousarray(images_train.swapaxes(2, 3)), device=dev)

    spe = steps_per_epoch or max(len(images_train) // cfg.batch_size, 1)
    history = []
    step = 0
    while step < num_steps:
        idx_order = rng.permutation(len(images_train))
        for start in range(0, len(images_train) - cfg.batch_size + 1,
                           cfg.batch_size):
            idx = torch.as_tensor(idx_order[start:start + cfg.batch_size],
                                  device=dev)
            epoch = step // spe
            if epoch <= cfg.random_mask_epochs or prox_masks is None:
                params, metrics = train_step.indexed(params, state,
                                                     images_dev, idx, gen)
            else:
                batch = images_dev[idx]
                d, T = batch.shape[2], batch.shape[3]
                pick = rng.randint(0, len(prox_masks), cfg.batch_size)
                mask = torch.as_tensor(
                    prox_mask_to_image_mask(prox_masks[pick], d, T),
                    dtype=torch.float32, device=dev)
                params, metrics = train_step(params, state, batch, mask)
            step += 1
            if step % log_every == 0 or step == num_steps:
                rec = {k: float(v) for k, v in metrics.items()}
                rec["step"] = step
                history.append(rec)
                if callback:
                    callback(step, rec, params)
            if step >= num_steps:
                break
    return params, history
