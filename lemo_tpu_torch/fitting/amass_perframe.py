"""AMASS Stage 1: the infill targets' reconstruction and the per-frame
body fit (port of `lemo_tpu/fitting/amass_perframe.py`;
opt_amass_perframe.py:55-364).

The fit has two modes:

- ``parallel`` (the default): all T frames optimized jointly in one
  batched Adam loop. Frames are independent given their marker targets,
  so this is the per-frame problem solved with every frame in each
  kernel launch;
- ``sequential`` (the reference's own form): a loop over frames, each
  warm-started from the previous frame's optimum, lr 0.1 for frame 0 and
  0.01 after, both decaying to 0.003 from step 81
  (opt_amass_perframe.py:316-330). On the card each frame runs its own
  B=1 fit, padded to 128 frames a launch: correct, but slow.

Loss (opt_amass_perframe.py:339-353): L1 marker reconstruction +
0.02 |z_vposer|^2 + 0.01 |betas|^2 + 0.01 |hand|^2.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lemo_tpu_torch import exact_f32_matmuls, resolve_device
from lemo_tpu_torch.body_model import SmplxModel, make_forward_fn
from lemo_tpu_torch.data.repr import reconstruct_global_body
from lemo_tpu_torch.data.stats import Local4ChanStats
from lemo_tpu_torch.fitting import params as P
from lemo_tpu_torch.fitting.adam import piecewise_lr, run_adam
from lemo_tpu_torch.ops.rotations import aa_to_rot6d, rot6d_to_aa
from lemo_tpu_torch.ops.select import take_rows


# On the card the VPoser decode runs one product a block of DECODE_ROWS
# frames (`vposer.decode(rows=...)`): cuBLAS rounds a product by its row
# count, so a frame-sharded fit whose shards are whole blocks
# (`parallel.sharding.frame_sharded_fit`, the fitter's `frame_block`)
# decodes each frame as the unsharded fit does
DECODE_ROWS = 32


def _share_of_mean(x: torch.Tensor, frames: int) -> torch.Tensor:
    """x [T, ...]'s sum over the mean's count for `frames` frames: the
    mean when frames = T, a share of it for a shard of T of `frames`
    frames. Its gradient, 1/count an entry, is the mean's over all
    frames bit for bit."""
    return x.sum() / (frames * (x.numel() // x.shape[0]))


@dataclasses.dataclass
class Stage1Weights:
    rec_markers: float = 1.0
    vposer: float = 0.02
    shape: float = 0.01
    hand: float = 0.01


def reconstruct_marker_targets(clip_img_rec: torch.Tensor,
                               clip_img_input: torch.Tensor,
                               stats: Local4ChanStats,
                               rot_0_pivot: torch.Tensor) -> torch.Tensor:
    """Normalized infilled image [1, d, T] + original image [4, d, T] ->
    global marker targets [T, 67, 3] (opt_amass_perframe.py:241-287):
    channel-0 body rows and the original trajectory channels,
    de-normalized, integrated back to world coordinates, pelvis dropped."""
    body_rows = clip_img_rec[0, :-4, :]
    traj = torch.stack([clip_img_input[1, 0], clip_img_input[2, 0],
                        clip_img_input[3, 0]])
    flat = stats.denormalize_flat(torch.cat([traj, body_rows]).T)
    T = flat.shape[0]
    grid = flat.reshape(T, -1, 3)
    body_in = torch.cat([torch.zeros_like(grid[:, :1]), grid[:, 1:],
                         grid[:, 0:1]], dim=1)
    return reconstruct_global_body(body_in, rot_0_pivot)[:, 1:, :]


def default_init(T: int, device="cpu", dtype=torch.float32):
    """The reference's initialization (opt_amass_perframe.py:299-308):
    transl (0, 0.4, 1), orientation aa (0, 1.6, 3.14), the rest 0."""
    transl = torch.zeros((T, 3), dtype=dtype, device=device)
    transl[:, 1], transl[:, 2] = 0.4, 1.0
    rot_aa = torch.zeros((T, 3), dtype=dtype, device=device)
    rot_aa[:, 1], rot_aa[:, 2] = 1.6, 3.14
    return {"transl": transl, "rot6d": aa_to_rot6d(rot_aa),
            "other": torch.zeros((T, 56), dtype=dtype, device=device)}


def _params72(opt_vars, shape10):
    """(transl, rot6d, other[56]) + fixed betas -> [T, 72]."""
    return torch.cat([opt_vars["transl"], rot6d_to_aa(opt_vars["rot6d"]),
                      shape10, opt_vars["other"]], dim=-1)


def make_stage1_loss(model: SmplxModel, vposer_params: dict, marker_ids,
                     weights: Stage1Weights = Stage1Weights()):
    """loss(opt_vars, shape10 [T, 10], markers_target [T, 67, 3],
    frames_total=None) on the model's device; `vposer_params` must
    already live there. Every term is a mean over the T frames; with
    `frames_total` the T frames are one rank's share of a frame-sharded
    fit, and each term is their share of the mean over all frames_total
    (`_share_of_mean`), so that the ranks' losses sum to the unsharded
    loss and each entry's gradient is the unsharded fit's."""
    fwd = make_forward_fn(model)
    ids = torch.as_tensor(np.asarray(marker_ids, np.int64),
                          device=model.device)
    num_expr = model.config.num_expressions

    def loss_fn(opt_vars, shape10, markers_target, frames_total=None):
        x72 = _params72(opt_vars, shape10)
        n = x72.shape[0] if frames_total is None else frames_total
        out = fwd(P.smplx_params_from_72(x72, vposer_params, num_expr,
                                         decode_rows=DECODE_ROWS),
                  model.consts)
        markers = take_rows(out["vertices"], ids)
        return (weights.rec_markers
                * _share_of_mean((markers - markers_target).abs(), n)
                + weights.vposer * _share_of_mean(x72[:, 16:48] ** 2, n)
                + weights.shape * _share_of_mean(x72[:, 6:16] ** 2, n)
                + weights.hand * _share_of_mean(x72[:, 48:] ** 2, n))

    return loss_fn


def _on(model: SmplxModel, device):
    dev = resolve_device(device)
    if model.device != dev:
        raise ValueError(f"model is on {model.device}, fitter on {dev}")
    exact_f32_matmuls()
    return dev


def make_stage1_fitter(model: SmplxModel, vposer_params: dict, marker_ids,
                       num_steps: int = 100,
                       weights: Stage1Weights = Stage1Weights(),
                       device=None):
    """The parallel Stage-1 fitter on `device` (None: the CUDA card;
    raises without CUDA): fit(markers_target [T, 67, 3], beta [10],
    frames_total=None, reduce_dead=None) -> (x72 [T, 72], per-step
    losses [num_steps]). Build it once per model and reuse it across
    clips. The model must already live on `device`. `frames_total`: the
    T frames are one rank's share of a frame-sharded fit of frames_total
    frames (`parallel.sharding.frame_sharded_fit`), and the losses are
    their share of its mean (`make_stage1_loss`); `reduce_dead` is then
    the ranks' shared freeze flag (`run_adam`). `fit.frame_block`: the
    frames a shard must hold a whole number of (DECODE_ROWS on the card,
    1 on the CPU, where the decode is one product whatever the rows).
    """
    dev = _on(model, device)
    vpp = {k: v.to(dev) for k, v in vposer_params.items()}
    loss_fn = make_stage1_loss(model, vpp, marker_ids, weights)
    lr_table = piecewise_lr([(0, 0.1), (int(num_steps * 0.6), 0.01),
                             (int(num_steps * 0.8), 0.003)], num_steps)

    def fit(markers_target, beta, frames_total=None, reduce_dead=None):
        markers_target = torch.as_tensor(markers_target, dtype=torch.float32,
                                         device=dev)
        beta = torch.as_tensor(beta, dtype=torch.float32, device=dev)
        T = markers_target.shape[0]
        shape10 = beta[None].expand(T, 10)
        final, losses = run_adam(
            lambda v: loss_fn(v, shape10, markers_target, frames_total),
            default_init(T, dev), num_steps, lr_table,
            reduce_dead=reduce_dead)
        return _params72(final, shape10), losses

    fit.frame_block = DECODE_ROWS if dev.type == "cuda" else 1
    return fit


def fit_clip(model: SmplxModel, vposer_params: dict, marker_ids,
             markers_target, beta, mode: str = "parallel",
             num_steps: int = 100, weights: Stage1Weights = Stage1Weights(),
             device=None):
    """Fit a clip to its marker targets [T, 67, 3] with fixed shape
    `beta` [10]. Returns ([T, 72] params, losses): the per-step losses
    [num_steps] in ``parallel`` mode, each frame's last loss [T] in
    ``sequential`` mode. Loops over clips should build the parallel
    fitter once with :func:`make_stage1_fitter`."""
    if mode == "parallel":
        return make_stage1_fitter(model, vposer_params, marker_ids,
                                  num_steps, weights, device)(
            markers_target, beta)
    if mode != "sequential":
        raise ValueError(mode)
    dev = _on(model, device)
    vpp = {k: v.to(dev) for k, v in vposer_params.items()}
    loss_fn = make_stage1_loss(model, vpp, marker_ids, weights)
    markers_target = torch.as_tensor(markers_target, dtype=torch.float32,
                                     device=dev)
    beta = torch.as_tensor(beta, dtype=torch.float32, device=dev)
    shape1 = beta[None]
    lr0 = piecewise_lr([(0, 0.1), (61, 0.01), (81, 0.003)], num_steps)
    lrW = piecewise_lr([(0, 0.01), (81, 0.003)], num_steps)
    carry = default_init(1, dev)
    rows, last = [], []
    for t in range(markers_target.shape[0]):
        target_t = markers_target[t:t + 1]
        carry, losses = run_adam(lambda v: loss_fn(v, shape1, target_t),
                                 carry, num_steps, lr0 if t == 0 else lrW)
        rows.append(_params72(carry, shape1)[0])
        last.append(losses[-1])
    return torch.stack(rows), torch.stack(last)
