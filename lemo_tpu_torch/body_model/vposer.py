"""VPoser (port of `lemo_tpu/body_model/vposer.py`): the decoder, which
the fitters call as `decode(z, 'aa')`, and the encoder, which the
VPoser trainer calls. Parameters are a flat dict with torch
`state_dict` keys (`bodyprior_dec_fc1.weight` ...)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from lemo_tpu_torch.ops.rotations import matrot_to_aa, rot6d_to_matrot

NUM_JOINTS = 21
LATENT_DIM = 32
NUM_NEURONS = 512


def latent_dim(params: dict | None) -> int:
    """Latent size of a VPoser parameter dict (the decoder's input
    width); LATENT_DIM when there are no parameters."""
    w = None if params is None else params.get("bodyprior_dec_fc1.weight")
    return LATENT_DIM if w is None else int(w.shape[1])


def by_rows(product, x: torch.Tensor, rows: int | None = None):
    """product(x) of a row-wise product. On a CUDA tensor with `rows`,
    one product per block of `rows` rows: cuBLAS picks its kernel, and
    with it the rounding of the product and of its gradient, by the row
    count, so a block rounds as a product of its rows alone does. On the
    CPU one product of all rows, the order `lemo_tpu`'s fold decodes in
    and the CPU tests hold the port to (a product a block there rounds
    apart below 16 rows, and misses `lemo_tpu`'s all-terms fold; PERF.md
    section 6)."""
    if rows is None or x.shape[0] <= rows or not x.is_cuda:
        return product(x)
    return torch.cat([product(c) for c in x.split(rows)])


def _linear(p, name, x, rows=None):
    """x @ w^T + b, by `rows` (`by_rows`)."""
    w, b = p[f"{name}.weight"], p[f"{name}.bias"]
    return by_rows(lambda c: F.linear(c, w, b), x, rows)


def _lrelu(x):
    return torch.where(x >= 0, x, 0.2 * x)


def decode(params, z, output_type: str = "aa", rows: int | None = None):
    """z [B, 32] -> body pose: 'aa' [B, 63] axis-angle, 'matrot'
    [B, 1, 21, 9]. With `rows`, on the card each linear layer runs one
    matrix product per block of `rows` rows, so that a fit of several
    clips or windows folded into one batch decodes each block as its own
    fit does (the rest of the decoder works row by row)."""
    h = _lrelu(_linear(params, "bodyprior_dec_fc1", z, rows))
    h = _lrelu(_linear(params, "bodyprior_dec_fc2", h, rows))
    h = _linear(params, "bodyprior_dec_out", h, rows)  # [B, 21*6]
    R = rot6d_to_matrot(h.reshape(-1, 6))  # [B*21, 3, 3]
    if output_type == "matrot":
        return R.reshape(z.shape[0], 1, NUM_JOINTS, 9)
    aa = matrot_to_aa(R)  # [B*21, 3]
    return aa.reshape(z.shape[0], NUM_JOINTS * 3)


def encode(params, pose_matrot):
    """pose [B, n_features] (flattened matrot) -> (mu [B, 32], sigma
    [B, 32]), sigma = softplus(logvar). BatchNorm runs in inference mode
    over the stored running statistics, as `lemo_tpu` runs it."""
    x = pose_matrot.reshape(pose_matrot.shape[0], -1)
    x = _batchnorm(params, "bodyprior_enc_bn1", x)
    x = _lrelu(_linear(params, "bodyprior_enc_fc1", x))
    x = _batchnorm(params, "bodyprior_enc_bn2", x)
    x = _lrelu(_linear(params, "bodyprior_enc_fc2", x))
    mu = _linear(params, "bodyprior_enc_mu", x)
    sigma = F.softplus(_linear(params, "bodyprior_enc_logvar", x))
    return mu, sigma


def _batchnorm(p, name, x, eps=1e-5):
    """BatchNorm1d in inference mode: the running mean and variance."""
    mean, var = p[f"{name}.running_mean"], p[f"{name}.running_var"]
    return (x - mean) / torch.sqrt(var + eps) * p[f"{name}.weight"] + \
        p[f"{name}.bias"]


def init_vposer(gen: torch.Generator, num_joints: int = NUM_JOINTS,
                latent: int = LATENT_DIM, neurons: int = NUM_NEURONS,
                device="cpu") -> dict:
    """Fresh torch-layout VPoser parameters (torch Linear default init)
    drawn from `gen` (a CPU generator), placed on `device`."""
    n_features = num_joints * 9
    params = {}

    def lin(name, fan_in, fan_out):
        bound = 1.0 / math.sqrt(fan_in)
        w = (torch.rand((fan_out, fan_in), generator=gen) * 2 - 1) * bound
        b = (torch.rand((fan_out,), generator=gen) * 2 - 1) * bound
        params[f"{name}.weight"] = w.to(device)
        params[f"{name}.bias"] = b.to(device)

    lin("bodyprior_enc_fc1", n_features, neurons)
    lin("bodyprior_enc_fc2", neurons, neurons)
    lin("bodyprior_enc_mu", neurons, latent)
    lin("bodyprior_enc_logvar", neurons, latent)
    lin("bodyprior_dec_fc1", latent, neurons)
    lin("bodyprior_dec_fc2", neurons, neurons)
    lin("bodyprior_dec_out", neurons, num_joints * 6)
    for bn, dim in (("bodyprior_enc_bn1", n_features),
                    ("bodyprior_enc_bn2", neurons)):
        params[f"{bn}.weight"] = torch.ones(dim, device=device)
        params[f"{bn}.bias"] = torch.zeros(dim, device=device)
        params[f"{bn}.running_mean"] = torch.zeros(dim, device=device)
        params[f"{bn}.running_var"] = torch.ones(dim, device=device)
    return params
