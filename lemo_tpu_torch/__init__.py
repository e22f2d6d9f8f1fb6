"""PyTorch/CUDA port of `lemo_tpu` for NVIDIA Hopper (H100).

The layout mirrors `lemo_tpu` (body_model/, ops/, data/, priors/,
fitting/, config/, cli/, testing/) so each module's counterpart is easy
to find. The port imports torch and numpy only — never jax, optax,
`lemo_tpu`, cv2 or yaml.

Device rule: entry points (`load_model`, `make_temporal_fitter`,
`load_assets`/`run_prox_fitting`) take `device=None`, meaning "cuda", and
raise when CUDA is absent; callers that want the CPU (the tests) pass
`device="cpu"` explicitly (`run_prox_fitting` runs where its assets'
model lives).

Precision rule: the hand-written kernels accumulate in f32 FFMA, and the
fitters turn TF32 off for cuBLAS and cuDNN (`lemo_tpu` runs the same
paths at Precision.HIGHEST).
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` -> the CUDA card; raises instead of falling back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' explicitly to run "
            "on the CPU")
    return dev


def exact_f32_matmuls() -> None:
    """Turn TF32 off for cuBLAS matmuls and cuDNN convolutions (cuDNN's
    default is TF32, ~3 decimal digits)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
