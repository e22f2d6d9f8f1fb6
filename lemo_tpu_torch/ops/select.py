"""Static row selection.

`lemo_tpu/ops/select.py` selects rows with a one-hot matmul because TPU
gathers are slow; on the GPU a gather is the natural form, so this is
`index_select`.
"""

from __future__ import annotations

import torch


def take_rows(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """x [..., V, K] -> rows `ids` [M] (int64, on x's device): [..., M, K]."""
    return x.index_select(-2, ids)
