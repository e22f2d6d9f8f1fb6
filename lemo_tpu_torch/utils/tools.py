"""Small shared helpers (port of `lemo_tpu/utils/tools.py`;
human_body_prior/tools/omni_tools.py: copy2cpu, makepath, log2file,
id_generator), and the VPoser checkpoint loader."""

from __future__ import annotations

import glob
import os
import random
import string

import numpy as np
import torch


def copy2cpu(x) -> np.ndarray:
    """A tensor (on any device) or array-like -> host numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def makepath(path: str, isfile: bool = False) -> str:
    """Create the directory (or the file's parent directory)."""
    d = os.path.dirname(path) if isfile else path
    if d:
        os.makedirs(d, exist_ok=True)
    return path


class log2file:
    """Minimal file logger callable: log2file('run.log')('message')."""

    def __init__(self, logpath: str | None = None, prefix: str = ""):
        self.fhandle = open(makepath(logpath, isfile=True), "a") \
            if logpath else None
        self.prefix = prefix

    def __call__(self, text: str) -> None:
        msg = f"{self.prefix}{text}"
        print(msg)
        if self.fhandle:
            self.fhandle.write(msg + "\n")
            self.fhandle.flush()


def id_generator(size: int = 13) -> str:
    chars = string.ascii_uppercase + string.digits
    return "".join(random.choice(chars) for _ in range(size))


def rel_change(prev_val: float, curr_val: float) -> float:
    """Relative loss change (temp_prox/misc_utils.py:37-38)."""
    return (prev_val - curr_val) / max(abs(prev_val), abs(curr_val), 1.0)


def max_grad_change(grad_arr) -> float:
    """Max absolute gradient entry (temp_prox/misc_utils.py:41-42)."""
    return float(np.abs(copy2cpu(grad_arr)).max())


def load_vposer(expr_dir: str, device=None) -> tuple[dict, str]:
    """Load a VPoser checkpoint directory (model_loader.py:43-72): the
    newest snapshot under <expr_dir>/snapshots, by (mtime, path) as the
    reference's model_loader sorts, as the flat parameter dict on
    `device` (None: the CUDA card). Returns (params, path)."""
    from lemo_tpu_torch import resolve_device
    from lemo_tpu_torch.priors.conv_ae import load_torch_state_dict

    dev = resolve_device(device)
    snaps = sorted(glob.glob(os.path.join(expr_dir, "snapshots", "*.pt"))
                   + glob.glob(os.path.join(expr_dir, "snapshots", "*.pkl")),
                   key=lambda p: (os.path.getmtime(p), p))
    if not snaps:
        raise FileNotFoundError(f"no VPoser snapshots under {expr_dir}")
    path = snaps[-1]
    return load_torch_state_dict(path, dev), path
