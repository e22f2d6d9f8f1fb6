"""The nearest-neighbour selection kernel (csrc/chamfer.cu) and its plain
version's contract.

Replaces `lemo_tpu/ops/chamfer_pallas.py` `_kernel` (pallas_call at
`:116`). The kernel is forward-only: it returns which point is nearest
(and the expanded-form distance it compared), and `ops.chamfer.nn_distance`
re-derives the distance from the winner with a differentiable gather, so
no `autograd.Function` is needed and gradients flow through that gather.

Dispatch lives in `ops.chamfer.nn_distance`: a CPU tensor goes to
`ops.chamfer.nn_select_plain`, any other tensor to `nn_select_kernel`
here, which raises unless it is on CUDA.
"""

from __future__ import annotations

import torch

from lemo_tpu_torch import _build
from lemo_tpu_torch._build import check_operand
from lemo_tpu_torch.utils import routing

# launches of the kernel, counted where the wrapper launches it
launches = {"chamfer": 0}


def nn_select_kernel(query: torch.Tensor, points: torch.Tensor,
                     points_mask: torch.Tensor | None):
    """query [T, N, 3], points [T|1, M, 3], mask [T|1, M] bool or None ->
    (idx [T, N] int64, dmin [T, N] f32): the nearest valid point of each
    query and its squared distance in the recentred expanded form (+inf
    and index 0 for a frame without a valid point)."""
    T, N = query.shape[0], query.shape[1]
    M = points.shape[1]
    query = query.contiguous()
    points = points.contiguous()
    check_operand("query", query, torch.float32, [(T, N, 3)])
    check_operand("points", points, torch.float32,
                  [(T, M, 3), (1, M, 3)])
    if points_mask is not None:
        points_mask = points_mask.contiguous()
        check_operand("points_mask", points_mask, torch.bool,
                      [(T, M), (1, M)])
    if T * N == 0:
        return (torch.zeros((T, N), dtype=torch.int64, device=query.device),
                torch.full((T, N), float("inf"), device=query.device))
    dev = query.device
    center = query.mean(dim=1)                                  # [T, 3]
    idx = torch.empty((T, N), dtype=torch.int64, device=dev)
    dmin = torch.empty((T, N), dtype=torch.float32, device=dev)
    lib = _build.load_library()
    rc = lib.lemo_nn_select(
        query.data_ptr(), points.data_ptr(),
        None if points_mask is None else points_mask.data_ptr(),
        center.data_ptr(), idx.data_ptr(), dmin.data_ptr(), T, N, M,
        int(points.shape[0] == T),
        int(points_mask is not None and points_mask.shape[0] == T),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, f"lemo_nn_select (T={T} N={N} M={M})")
    launches["chamfer"] += 1
    return idx, dmin


# the entry points' routing is watched (`utils.routing`)
routing.watch(__name__)
