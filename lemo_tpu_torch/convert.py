"""Carry parameters across from `lemo_tpu`'s numpy-convertible trees.

`from_numpy_tree` keeps the keys and turns leaves into float32 tensors on
one device. It covers the VPoser params (`bodyprior_dec_*`), the
smoothness-encoder params (already torch-layout OIHW) and a
`GlobalStats` (any object with `Xmean`/`Xstd` arrays). The body model
needs no conversion: `load_model` reads the same npz dict.
"""

from __future__ import annotations

import numpy as np
import torch

from lemo_tpu_torch.data.stats import GlobalStats


def from_numpy_tree(tree, device):
    """dict (nested) of arrays -> same keys with tensors on `device`;
    an object with Xmean/Xstd -> the port's GlobalStats."""
    if isinstance(tree, dict):
        return {k: from_numpy_tree(v, device) for k, v in tree.items()}
    if hasattr(tree, "Xmean") and hasattr(tree, "Xstd"):
        return GlobalStats.from_numpy(np.asarray(tree.Xmean),
                                      np.asarray(tree.Xstd), device)
    arr = np.asarray(tree)
    if arr.dtype.kind == "f":
        arr = arr.astype(np.float32)
    return torch.as_tensor(arr, device=device)
