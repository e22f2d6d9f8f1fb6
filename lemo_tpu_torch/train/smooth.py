"""Smoothness-prior training (port of `lemo_tpu/train/smooth.py`; the
train_smooth_prior.py:58-203 recipe).

Trains the Enc/Dec pair on *velocities* of global-marker clip images:
  loss = w_rec * L1(v, v_rec) + w_zs * mean((z[t+1] - z[t])^2)
with reflect padding (8, 8, 1, 1), Adam 1e-4, batch 60: the shipped
checkpoint's configuration (runs/15217/params.json: z_channel 64,
downsample False, clip 4 s at 30 fps, with-hand global markers).

A step is one eager forward and backward on the device and one Adam
update (`fitting.adam.adam_minimize`); batches are drawn on the host
with the same numpy `RandomState` calls as `lemo_tpu`, so both packages
see the same batches for a seed.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from lemo_tpu_torch import exact_f32_matmuls, resolve_device
from lemo_tpu_torch.fitting.adam import adam_init, adam_minimize
from lemo_tpu_torch.ops.signal import reflect_pad_dt
from lemo_tpu_torch.priors.conv_ae import (init_smooth_dec, init_smooth_enc,
                                           smooth_dec_forward,
                                           smooth_enc_forward)


@dataclasses.dataclass
class SmoothTrainConfig:
    lr: float = 1e-4
    batch_size: int = 60
    z_channel: int = 64
    downsample: bool = False
    input_padding: bool = True
    weight_loss_rec_v: float = 1.0
    weight_loss_z_smooth: float = 1000.0


def make_train_step(cfg: SmoothTrainConfig):
    """(train_step(params, state, clip_img) -> (params, metrics),
    eval_step(params, clip_img) -> metrics); clip_img [B, 1, d, T], the
    state from `fitting.adam.adam_init`. `train_step.loss_fn(params,
    clip_img) -> (loss, metrics)` is the loss it differentiates and
    `train_step.lr` its Adam rate (`parallel.data_parallel_step`)."""

    def loss_fn(params, clip_img):
        v = clip_img[..., 1:] - clip_img[..., :-1]   # the velocity
        if cfg.input_padding:
            v = reflect_pad_dt(v)
        z, sizes = smooth_enc_forward(params["enc"], v,
                                      downsample=cfg.downsample)
        rec = smooth_dec_forward(params["dec"], z, sizes,
                                 downsample=cfg.downsample)
        loss_rec = (v - rec).abs().mean()
        loss_zs = ((z[..., 1:] - z[..., :-1]) ** 2).mean()
        total = cfg.weight_loss_rec_v * loss_rec + \
            cfg.weight_loss_z_smooth * loss_zs
        return total, {"loss_rec_v": loss_rec, "loss_z_smooth": loss_zs}

    def train_step(params, state, clip_img):
        return adam_minimize(loss_fn, params, state, cfg.lr, clip_img)

    def eval_step(params, clip_img):
        with torch.no_grad():
            return loss_fn(params, clip_img)[1]

    train_step.loss_fn = loss_fn
    train_step.lr = cfg.lr
    return train_step, eval_step


def init_params(gen: torch.Generator, cfg: SmoothTrainConfig,
                device="cpu") -> dict:
    """{'enc': ..., 'dec': ...} drawn from `gen` (a CPU generator)."""
    return {"enc": init_smooth_enc(gen, cfg.z_channel, device),
            "dec": init_smooth_dec(gen, cfg.z_channel, device)}


def batches(images: np.ndarray, batch_size: int, rng: np.random.RandomState,
            shuffle: bool = True, device="cpu") -> Iterator[torch.Tensor]:
    """[N, T, d] clip images -> [B, 1, d, T] batches on `device` (the
    loader's permute, train_loader_smooth.py:216-219), shuffled with
    `rng.shuffle` as `lemo_tpu`; the last partial batch is dropped, as
    the reference DataLoader does (drop_last=True)."""
    idx = np.arange(len(images))
    if shuffle:
        rng.shuffle(idx)
    for s in range(0, len(idx) - batch_size + 1, batch_size):
        batch = images[idx[s:s + batch_size]]          # [B, T, d]
        yield torch.as_tensor(np.ascontiguousarray(
            batch.swapaxes(1, 2)[:, None]), device=device)


def train(images_train: np.ndarray, images_test: np.ndarray | None,
          cfg: SmoothTrainConfig, num_steps: int, seed: int = 0,
          log_every: int = 500, callback=None, device=None):
    """Run the training loop on `device` (None: the CUDA card; raises
    without it); returns (params, history). Raises ValueError when there are fewer training
    images than a batch (`lemo_tpu` loops forever there)."""
    dev = resolve_device(device)
    exact_f32_matmuls()
    if len(images_train) < cfg.batch_size:
        raise ValueError(f"{len(images_train)} training images, fewer than "
                         f"a batch of {cfg.batch_size}")
    rng = np.random.RandomState(seed)
    params = init_params(torch.Generator().manual_seed(seed), cfg, dev)
    train_step, eval_step = make_train_step(cfg)
    state = adam_init(params)

    history = []
    step = 0
    while step < num_steps:
        for batch in batches(images_train, cfg.batch_size, rng, device=dev):
            params, metrics = train_step(params, state, batch)
            step += 1
            if step % log_every == 0 or step == num_steps:
                rec = {k: float(v) for k, v in metrics.items()}
                rec["step"] = step
                if images_test is not None and len(images_test) >= 1:
                    test_m = eval_step(params, next(batches(
                        images_test, min(cfg.batch_size, len(images_test)),
                        rng, shuffle=False, device=dev)))
                    rec.update({f"test_{k}": float(v)
                                for k, v in test_m.items()})
                history.append(rec)
                if callback:
                    callback(step, rec, params)
            if step >= num_steps:
                break
    return params, history
