"""Convolutional motion priors over torch-layout parameter dicts (port of
`lemo_tpu/priors/conv_ae.py`): the smoothness encoder and the infill
auto-encoder (models/AE.py:78-108).

Parameters are a flat dict keyed by the torch `state_dict` names
(`enc_blc1.main.0.weight` ...), Conv2d weights [O, I, kH, kW],
ConvTranspose2d weights [I, O, kH, kW]. The
convolutions are `torch.nn.functional.conv2d`, as `lemo_tpu` leaves them
to XLA; callers that need exact f32 turn cuDNN's TF32 off
(`lemo_tpu_torch.exact_f32_matmuls`).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def conv2d(x, w, b, stride=(1, 1), padding=(1, 1), per_sample=False):
    """x [N, C, H, W], w [O, I, kH, kW]. With `per_sample`, on a CUDA
    tensor, one convolution a sample: cuDNN picks its algorithm, and with
    it the rounding, by N (FFT convolutions from N = 4), so a sample
    rounds as a convolution of it alone does."""
    if per_sample and x.is_cuda and x.shape[0] > 1:
        return torch.cat([F.conv2d(xi, w, b, stride=stride, padding=padding)
                          for xi in x.split(1)])
    return F.conv2d(x, w, b, stride=stride, padding=padding)


def conv_transpose2d(x, w, b, stride, padding, out_hw):
    """torch ConvTranspose2d with its `output_size=` semantics
    (`lemo_tpu/priors/conv_ae.py:54-86`): `out_hw` pins the output size;
    output_padding = out - ((in - 1) * stride - 2 * pad + kernel), added
    at the bottom/right, and must be reachable."""
    kh, kw = w.shape[2], w.shape[3]
    sh, sw = stride
    ph, pw = padding
    in_h, in_w = x.shape[2], x.shape[3]
    oph = out_hw[0] - ((in_h - 1) * sh - 2 * ph + kh)
    opw = out_hw[1] - ((in_w - 1) * sw - 2 * pw + kw)
    if not (0 <= oph < sh or (oph == 0 and sh == 1)) or not (
            0 <= opw < sw or (opw == 0 and sw == 1)):
        raise ValueError(
            f"requested output size {tuple(out_hw)} unreachable from input "
            f"{(in_h, in_w)} with stride {stride} kernel {(kh, kw)}")
    return F.conv_transpose2d(x, w, None, stride=stride, padding=padding,
                              output_padding=(oph, opw)) + \
        b[None, :, None, None]


def leaky_relu(x, slope=0.2):
    return torch.where(x >= 0, x, slope * x)


def _enc_block(p, prefix, x, *, kernel, pool, pool_stride,
               per_sample=False):
    pad = kernel // 2
    x = leaky_relu(conv2d(x, p[f"{prefix}.main.0.weight"],
                          p[f"{prefix}.main.0.bias"], (1, 1), (pad, pad),
                          per_sample))
    x = leaky_relu(conv2d(x, p[f"{prefix}.main.2.weight"],
                          p[f"{prefix}.main.2.bias"], (1, 1), (pad, pad),
                          per_sample))
    if pool:
        x = F.max_pool2d(x, (3, 3), pool_stride, (1, 1))
    return x


def _dec_block(p, prefix, x, out_hw, *, kernel, stride, final_act=True):
    pad = kernel // 2
    x = leaky_relu(conv_transpose2d(
        x, p[f"{prefix}.deconv1.weight"], p[f"{prefix}.deconv1.bias"],
        stride, (pad, pad), out_hw))
    x = conv_transpose2d(x, p[f"{prefix}.deconv2.weight"],
                         p[f"{prefix}.deconv2.bias"], (1, 1), (pad, pad),
                         out_hw)
    return leaky_relu(x) if final_act else x


def infill_ae_forward(params, x, *, kernel=3, downsample=True):
    """AE.forward (models/AE.py:93-108): x [N, C_in, d, T] ->
    (reconstruction [N, 1, d, T], z). The decoder's output sizes are
    pinned to the encoder intermediates, as the reference passes
    `x_down*.size()`."""
    stride = (2, 2) if downsample else (2, 1)
    sizes = [tuple(x.shape[2:])]
    h = x
    for i in range(1, 6):
        h = _enc_block(params, f"enc_blc{i}", h, kernel=kernel, pool=True,
                       pool_stride=stride)
        sizes.append(tuple(h.shape[2:]))
    z = h
    for i, size in zip(range(1, 5), (sizes[4], sizes[3], sizes[2],
                                     sizes[1])):
        h = _dec_block(params, f"dec_blc{i}", h, size, kernel=kernel,
                       stride=stride)
    rec = _dec_block(params, "dec_blc5", h, sizes[0], kernel=kernel,
                     stride=stride, final_act=False)
    return rec, z


def smooth_enc_forward(params, x, *, downsample=False, per_sample=False):
    """Enc.forward (models/AE_sep.py:91-99): returns (z, sizes tuple).
    With downsample=False (the shipped LEMO configuration) z keeps the
    input's spatial extent. `per_sample`: see `conv2d`."""
    sizes = [tuple(x.shape[2:])]
    h = x
    for i in range(1, 6):
        h = _enc_block(params, f"enc_blc{i}", h, kernel=3,
                       pool=downsample, pool_stride=(2, 2),
                       per_sample=per_sample)
        sizes.append(tuple(h.shape[2:]))
    return h, tuple(sizes)


def smooth_dec_forward(params, z, sizes, *, downsample=False):
    """Dec.forward (models/AE_sep.py:117-123): z and the encoder's
    `sizes` -> the reconstruction [N, 1, d, T]."""
    stride = (2, 2) if downsample else (1, 1)
    h = z
    for i, size in zip(range(1, 5), (sizes[4], sizes[3], sizes[2],
                                     sizes[1])):
        h = _dec_block(params, f"dec_blc{i}", h, size, kernel=3,
                       stride=stride)
    return _dec_block(params, "dec_blc5", h, sizes[0], kernel=3,
                      stride=stride, final_act=False)


def _init_conv(gen, o, i, k, device):
    """torch Conv2d default init: kaiming_uniform(a=sqrt(5)) weight,
    uniform(+-1/sqrt(fan_in)) bias."""
    fan_in = i * k * k
    bound_w = math.sqrt(2.0 / (1 + 5.0)) * math.sqrt(3.0 / fan_in)
    bound_b = 1.0 / math.sqrt(fan_in)
    w = (torch.rand((o, i, k, k), generator=gen) * 2 - 1) * bound_w
    b = (torch.rand((o,), generator=gen) * 2 - 1) * bound_b
    return w.to(device), b.to(device)


def _init_deconv(gen, i, o, k, device):
    """torch ConvTranspose2d default init: as Conv2d's, with torch's
    fan_in weight.size(1) * k * k, the output channels."""
    fan_in = o * k * k
    bound_w = math.sqrt(2.0 / (1 + 5.0)) * math.sqrt(3.0 / fan_in)
    bound_b = 1.0 / math.sqrt(fan_in)
    w = (torch.rand((i, o, k, k), generator=gen) * 2 - 1) * bound_w
    b = (torch.rand((o,), generator=gen) * 2 - 1) * bound_b
    return w.to(device), b.to(device)


def _enc_channels(z_channel):
    if z_channel == 256:
        c2, c3 = 128, 256
    elif z_channel == 64:
        c2, c3 = 64, 64
    else:
        raise ValueError(z_channel)
    return [32, 64, c2, c3, c3]


def _add_enc_blocks(params, gen, chans, kernel, device):
    for i in range(1, 6):
        w, b = _init_conv(gen, chans[i], chans[i - 1], kernel, device)
        params[f"enc_blc{i}.main.0.weight"], params[f"enc_blc{i}.main.0.bias"] = w, b
        w, b = _init_conv(gen, chans[i], chans[i], kernel, device)
        params[f"enc_blc{i}.main.2.weight"], params[f"enc_blc{i}.main.2.bias"] = w, b


def init_smooth_enc(gen: torch.Generator, z_channel=64, device="cpu"):
    """Fresh smoothness-encoder parameters drawn from `gen` (a CPU
    generator), placed on `device`."""
    params = {}
    _add_enc_blocks(params, gen, [1] + _enc_channels(z_channel), 3, device)
    return params


def _add_dec_blocks(params, gen, dec_io, kernel, device):
    for i, (ci, co) in enumerate(dec_io, start=1):
        w, b = _init_deconv(gen, ci, co, kernel, device)
        params[f"dec_blc{i}.deconv1.weight"], params[f"dec_blc{i}.deconv1.bias"] = w, b
        w, b = _init_deconv(gen, co, co, kernel, device)
        params[f"dec_blc{i}.deconv2.weight"], params[f"dec_blc{i}.deconv2.bias"] = w, b


def init_infill_ae(gen: torch.Generator, in_channel=4, kernel=3,
                   device="cpu"):
    """Fresh infill-AE parameters (channels 32/64/128/256/256) drawn from
    `gen` (a CPU generator), placed on `device`."""
    params = {}
    _add_enc_blocks(params, gen, [in_channel, 32, 64, 128, 256, 256], kernel,
                    device)
    _add_dec_blocks(params, gen, [(256, 256), (256, 128), (128, 64),
                                  (64, 32), (32, 1)], kernel, device)
    return params


def init_smooth_dec(gen: torch.Generator, z_channel=64, device="cpu"):
    """Fresh smoothness-decoder parameters drawn from `gen` (a CPU
    generator), placed on `device`."""
    c = _enc_channels(z_channel)
    params = {}
    _add_dec_blocks(params, gen, [(c[4], c[4]), (c[4], c[2]), (c[2], 64),
                                  (64, 32), (32, 1)], 3, device)
    return params


def load_torch_state_dict(path: str, device) -> dict[str, torch.Tensor]:
    """A torch `state_dict` checkpoint (e.g. the shipped smoothness prior
    `runs/15217/Enc_last_model.pkl`) as the flat param dict, layout 1:1.
    A checkpoint that the safe load refuses (an old pickle, a pickled
    module) goes through the legacy loader, as in `lemo_tpu`."""
    try:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    except Exception:
        # older checkpoints (e.g. torch<1.6 zip-less pickles) and ones that
        # pickle a whole module need the legacy loader; only use on
        # checkpoints you trust
        sd = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return {k: v.to(device=device, dtype=torch.float32)
            for k, v in sd.items() if isinstance(v, torch.Tensor)}


def save_state_dict(params: dict[str, torch.Tensor], path: str) -> None:
    """The params as a plain npz (the torch-free checkpoint format that
    both packages' `load_state_dict_npz` read)."""
    np.savez(path, **{k: v.detach().cpu().numpy()
                      for k, v in params.items()})


def load_state_dict_npz(path: str, device) -> dict[str, torch.Tensor]:
    with np.load(path) as z:
        return {k: torch.as_tensor(z[k], device=device) for k in z.files}
