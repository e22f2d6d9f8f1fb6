"""Nearest-neighbour (Chamfer) distances between point sets (port of
`lemo_tpu/ops/chamfer.py` and the dispatcher of `ops/chamfer_pallas.py`).

`nn_distance` is the only entry point the fitter calls. It takes one
cloud pair or a batch of frames, so a loss term issues one call per step
instead of one per frame:

    query [N, 3] | [T, N, 3], points [M, 3] | [T, M, 3] (a [M, 3] cloud
    is shared by every frame), points_mask [M] | [T, M] | None
    -> (d2 [..., N], idx [..., N])

Selection (which point is nearest) runs without gradient on coordinates
recentred per frame on the mean of that frame's N query rows, in the
expanded form |q|^2 + |p|^2 - 2 q.p in exact f32, masked points at +inf,
ties to the lowest index; a frame with no valid point keeps index 0.
On a CUDA tensor the selection is the hand-written kernel
(`chamfer_cuda.nn_select_kernel`, csrc/chamfer.cu); on a CPU tensor it is
`nn_select_plain` below. The returned distance is re-derived exactly and
differentiably from the winner, ((q - p[idx])^2).sum(-1), so the kernel
needs no backward: gradients reach both clouds through that gather.
"""

from __future__ import annotations

import torch

from lemo_tpu_torch.ops import chamfer_cuda as _cc

# elements of the [frames, N, chunk] distance block the plain version
# holds at once (a few such blocks are live at a time)
_PLAIN_BLOCK = 1 << 25


def _as_batched(query, points, points_mask):
    """-> (query [T, N, 3], points [T|1, M, 3], mask [T|1, M] bool or
    None, unbatched?)."""
    single = query.dim() == 2
    if single:
        query = query[None]
        if points.dim() == 3:
            raise ValueError("a single query cloud takes a single point "
                             "cloud")
    if points.dim() == 2:
        points = points[None]
    if points_mask is not None:
        points_mask = points_mask.bool()
        if points_mask.dim() == 1:
            points_mask = points_mask[None]
        if points_mask.shape[-1] != points.shape[1]:
            raise ValueError(f"mask {tuple(points_mask.shape)} does not "
                             f"match points {tuple(points.shape)}")
    return query, points, points_mask, single


def _sq3(x: torch.Tensor) -> torch.Tensor:
    """(x*x + y*y) + z*z over the last axis, in that order."""
    return (x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1]) \
        + x[..., 2] * x[..., 2]


@torch.no_grad()
def nn_select_plain(query: torch.Tensor, points: torch.Tensor,
                    points_mask: torch.Tensor | None):
    """Plain version of the kernel: query [T, N, 3], points [T|1, M, 3],
    mask [T|1, M] bool or None -> (idx [T, N] int64, dmin [T, N]).

    The chunked torch form of `lemo_tpu/ops/chamfer.py:36-91`: a running
    (min, argmin) over point chunks, first minimum within a chunk, strict
    < across chunks, so ties go to the lowest index. Each product and sum
    is its own elementwise op, in the kernel's order and rounding
    (csrc/chamfer.cu), so the two agree bit for bit on one device; the
    cross term is no matmul, whose accumulation order and FMAs the kernel
    could not reproduce."""
    T, N, _ = query.shape
    M = points.shape[1]
    # the mean of the same contiguous layout the kernel's wrapper reduces
    # (a permuted layout would sum in another order)
    query = query.contiguous()
    center = query.mean(dim=1)[:, None, :]                    # [T, 1, 3]
    qc = query - center
    q2 = _sq3(qc)                                             # [T, N]
    best_d = torch.full((T, N), float("inf"), dtype=query.dtype,
                        device=query.device)
    best_i = torch.zeros((T, N), dtype=torch.int64, device=query.device)
    chunk = max(1, min(M, 2048))
    frames = max(1, min(T, _PLAIN_BLOCK // max(N * chunk, 1)))
    for t0 in range(0, T, frames):
        t1 = min(T, t0 + frames)
        sl = slice(t0, t1) if points.shape[0] > 1 else slice(0, 1)
        msl = (slice(t0, t1) if points_mask is not None
               and points_mask.shape[0] > 1 else slice(0, 1))
        for m0 in range(0, M, chunk):
            m1 = min(M, m0 + chunk)
            pc = points[sl, m0:m1] - center[t0:t1]            # [t, c, 3]
            p2 = _sq3(pc)                                     # [t, c]
            qb = qc[t0:t1, :, None, :]
            pb = pc[:, None, :, :]
            cross = (qb[..., 0] * pb[..., 0] + qb[..., 1] * pb[..., 1]) \
                + qb[..., 2] * pb[..., 2]                     # [t, N, c]
            d = (q2[t0:t1, :, None] + p2[:, None, :]) - 2.0 * cross
            if points_mask is not None:
                m = points_mask[msl, m0:m1]
                d = torch.where(m[:, None, :], d,
                                torch.full_like(d, float("inf")))
            local_d, local_i = d.min(dim=2)
            better = local_d < best_d[t0:t1]
            best_d[t0:t1] = torch.where(better, local_d, best_d[t0:t1])
            best_i[t0:t1] = torch.where(better, local_i + m0,
                                        best_i[t0:t1])
    return best_i, best_d


def nn_distance(query: torch.Tensor, points: torch.Tensor,
                points_mask: torch.Tensor | None = None):
    """For each query point, the squared distance to its nearest valid
    point and that point's index (shapes in the module docstring)."""
    q, p, m, single = _as_batched(query, points, points_mask)
    if q.device.type == "cpu":
        idx, _ = nn_select_plain(q.detach(), p.detach(), m)
    else:
        idx, _ = _cc.nn_select_kernel(q.detach(), p.detach(), m)
    if p.shape[0] == 1:
        win = p[0][idx]                                        # [T, N, 3]
    else:
        win = torch.gather(p, 1, idx[..., None].expand(-1, -1, 3))
    d2 = ((q - win) ** 2).sum(-1)
    return (d2[0], idx[0]) if single else (d2, idx)


def chamfer_distance(a: torch.Tensor, b: torch.Tensor,
                     a_mask: torch.Tensor | None = None,
                     b_mask: torch.Tensor | None = None):
    """Bidirectional squared Chamfer distances, the reference CUDA op's
    interface (temp_prox/dist_chamfer.py:27-45): (dist_a, dist_b, idx_a,
    idx_b) with dist_a[i] = min_j |a_i - b_j|^2. Invalid queries get 0."""
    da, ia = nn_distance(a, b, b_mask)
    db, ib = nn_distance(b, a, a_mask)
    if a_mask is not None:
        da = torch.where(a_mask.bool(), da, torch.zeros_like(da))
    if b_mask is not None:
        db = torch.where(b_mask.bool(), db, torch.zeros_like(db))
    return da, db, ia, ib
