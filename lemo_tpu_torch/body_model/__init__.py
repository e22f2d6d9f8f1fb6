"""SMPL-family body models on torch tensors."""

from lemo_tpu_torch.body_model.smplx import (  # noqa: F401
    SmplxConfig,
    SmplxModel,
    load_model,
    make_forward_fn,
    smplx_forward,
)
