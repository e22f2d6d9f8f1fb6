"""Operations and bytes that the port's hand-written kernels need, counted
from shapes and data, never from a kernel's own tiling (frozen copies of
`chip_smoke.py`'s `body_kernel_work`, `ISECT_OPS` and `_gate_counts`,
with the plain gate arithmetic of `lemo_tpu_torch/ops/intersection.py`
that the last one walks). A kernel's roofline share is the larger of
operations over the f32 peak and bytes over the HBM peak, over its
device time (`bound_s`)."""

from __future__ import annotations

import torch

from portbench.peaks import F32_FLOPS_PER_S, HBM_BYTES_PER_S


def body_kernel_work(B: int, V: int, J: int, D: int) -> dict:
    """(bytes, f32 operations) each body-model kernel entry point needs at
    B real frames, V real vertices, J real joints and D blend columns:
    each input read once and each output written once.

    The chain's affine entry points, a joint: the walk 63 operations
    forward, 135 backward; t_l 3; the rel translations 18 forward, 21
    back through them and 21 for djr. The vertex backward recomputes vs
    (3 blends) and T[0..8] from its inputs, then forms dcat (3 blends)
    and dA2 (12 skinning products)."""
    f4 = 4.0
    return {
        "chain_fwd": (f4 * 27 * J * B + 4 * J,
                      (66.0 * (J - 1) + 18.0 * J) * B),
        "chain_bwd": (f4 * 48 * J * B + 4 * J,
                      (138.0 * (J - 1) + 42.0 * J) * B),
        "vertex_fwd": (f4 * (D * B + 12 * J * B + 3 * V * D + V * J
                             + 3 * V * B),
                       2.0 * 3 * V * D * B + 2.0 * 12 * V * J * B
                       + 18.0 * V * B),
        "vertex_bwd": (f4 * (2 * D * B + 24 * J * B + 3 * V * D + V * J
                             + 3 * V * B),
                       2.0 * 6 * V * D * B + 2.0 * 21 * V * J * B
                       + 27.0 * V * B),
    }


def bound_s(nbytes: float, flops: float) -> tuple[float, str]:
    """The least time the chip could take, and which peak bounds it."""
    t_b = nbytes / HBM_BYTES_PER_S
    t_f = flops / F32_FLOPS_PER_S
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


# csrc/intersection.cu, f32 operations of one unordered face pair by the
# gate it reaches. The gates are symmetric in the pair, so each is paid
# once: every tested pair the sphere gate (3 sub, 3 mul, 2 add, add, mul,
# cmp); past it validity, adjacency and part (2 + 9 + 3); past those one
# straddle test (3 x (3 mul, 2 add, sub) + 2 min, 2 max, 2 cmp); past
# that the other one (the same 24). Past both, each of the two directions
# pays its cone test (3 x (3 sub, 3 mul, 2 add, mul, sub, 2 cmp, select))
# and its accumulation (3 x (add, 2 mul, 2 add) + 3 x 3 x (mul, sub)
# twice, about 51). The pairs that count as tested are fixed here, not by
# any kernel's tiling, so no design can shrink its own bound: every pair
# of distinct faces of two runs of ISECT_BOUND_RUN consecutive candidate
# faces whose bounding spheres overlap (`tile_spheres` / `tile_pairs` at
# this run length).
ISECT_OPS = (11.0, 14.0, 24.0, 24.0, 2 * (39.0 + 51.0))
ISECT_BOUND_RUN = 32
ISECT_FACE_BYTES = 80.0 + 16.0 + 64.0   # per face: f32 data, ids, outputs
ISECT_PACK = 20                         # floats per face in the kernel's pack
_PAIRS_A_CHUNK = 1 << 24


def _dot3(a, b):
    """(a0*b0 + a1*b1) + a2*b2 over the last axis, each op rounded."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) \
        + a[..., 2] * b[..., 2]


def tile_spheres(pack: torch.Tensor, tile: int) -> torch.Tensor:
    """pack [T, Kp, PACK] -> [T, Kp / tile, 4]: each run of `tile` faces'
    centre (the mean centroid of its valid faces) and skip radius (the
    largest |c - centre| + r of its valid faces)."""
    T, Kp, _ = pack.shape
    NT = Kp // tile
    cc = pack[..., 0:3].reshape(T, NT, tile, 3)
    vv = pack[..., 9].reshape(T, NT, tile)
    cnt = torch.clamp(vv.sum(-1), min=1.0)
    ctr = (cc * vv[..., None]).sum(2) / cnt[..., None]
    dc = cc - ctr[:, :, None]
    d = torch.sqrt(_dot3(dc, dc) + 1e-20)
    sl = ((d + pack[..., 7].reshape(T, NT, tile)) * vv).amax(-1)
    return torch.cat([ctr, sl[..., None]], dim=-1).contiguous()


def tile_pairs(tiles: torch.Tensor) -> torch.Tensor:
    """[T, NT, 4] run spheres -> [T, NT, NT] bool: the run pairs whose
    spheres overlap."""
    a, b = tiles[:, :, None, :], tiles[:, None, :, :]
    dx, dy, dz = a[..., 0] - b[..., 0], a[..., 1] - b[..., 1], \
        a[..., 2] - b[..., 2]
    lim = a[..., 3] + b[..., 3]
    return (dx * dx + dy * dy) + dz * dz <= lim * lim


def sphere_pairs(pack: torch.Tensor, run: int):
    """Yield, a chunk at a time, the face pairs that pass the sphere gate,
    as row and column indices into pack.reshape(-1, PACK)."""
    T, Kp, P = pack.shape
    tp, a, b = tile_pairs(tile_spheres(pack, run)).nonzero(as_tuple=True)
    flat = pack.reshape(T * Kp, P)
    lane = torch.arange(run, device=pack.device)
    chunk = max(1, _PAIRS_A_CHUNK // (run * run))
    for p0 in range(0, tp.numel(), chunk):
        base = tp[p0:p0 + chunk] * Kp
        gi = (base + a[p0:p0 + chunk] * run)[:, None] + lane
        gj = (base + b[p0:p0 + chunk] * run)[:, None] + lane
        A, B = flat[gi][:, :, None], flat[gj][:, None]
        dx, dy, dz = (A[..., k] - B[..., k] for k in range(3))
        rsum = A[..., 7] + B[..., 7]
        hit = (dx * dx + dy * dy) + dz * dz < rsum * rsum
        p_, r_, c_ = hit.nonzero(as_tuple=True)
        yield gi[p_, r_], gj[p_, c_]


def _straddles(owner, other):
    """Whether `other`'s three vertices lie on both sides of `owner`'s
    plane (depths s - n . v)."""
    dep = [owner[:, 6] - _dot3(owner[:, 3:6], other[:, 10 + 3 * k:13 + 3 * k])
           for k in range(3)]
    lo = torch.minimum(torch.minimum(dep[0], dep[1]), dep[2])
    hi = torch.maximum(torch.maximum(dep[0], dep[1]), dep[2])
    return (lo < 0) & (hi > 0)


def pair_gates(a, b, ia, ib, ign=None):
    """The gates past the sphere gate of face pairs a (cone owner) and b
    (vertex supplier), rows of pack [N, PACK] and of ipack [N, 4] ->
    (both valid, not adjacent and not part-ignored [N], forward straddle
    [N], reverse straddle [N])."""
    m = (a[:, 9] > 0) & (b[:, 9] > 0)
    for p in range(3):
        for q in range(3):
            m &= ia[:, p] != ib[:, q]
    if ign is not None:
        m &= ~ign[ia[:, 3].long(), ib[:, 3].long()]
    return m, _straddles(a, b), _straddles(b, a)


def gate_counts(pack, ipack, ign) -> list[float]:
    """Unordered pairs of distinct faces of the cone-energy kernel's
    operands (pack [T, Kp, PACK], ipack [T|1, Kp, 4]) by the gate they
    reach (ISECT_OPS): tested (the pairs of sphere-overlapping runs of
    ISECT_BOUND_RUN faces; padding faces not counted), past the sphere
    gate, past validity/adjacency/part, past the forward straddle test,
    past both straddle tests."""
    T, Kp, P = pack.shape
    run = ISECT_BOUND_RUN
    NR = Kp // run
    tp, a, b = tile_pairs(tile_spheres(pack, run)).nonzero(as_tuple=True)
    nvalid = pack[..., 9].reshape(T * NR, run).sum(-1).double()
    na, nb = nvalid[tp * NR + a], nvalid[tp * NR + b]
    # each pair of distinct runs once, and a run's own n (n - 1) / 2
    tested = torch.where(a < b, na * nb, torch.where(
        a == b, na * (na - 1) / 2, torch.zeros_like(na)))
    counts = [float(tested.sum()), 0.0, 0.0, 0.0, 0.0]
    flat = pack.reshape(T * Kp, P)
    ids = ipack.expand(T, -1, -1).reshape(T * Kp, 4)
    for i, j in sphere_pairs(pack, run):
        once = i < j
        i, j = i[once], j[once]
        m, fwd, rev = pair_gates(flat[i], flat[j], ids[i], ids[j], ign)
        m &= (flat[i, 9] > 0) & (flat[j, 9] > 0)
        counts[1] += float(((flat[i, 9] > 0) & (flat[j, 9] > 0)).sum())
        counts[2] += float(m.sum())
        counts[3] += float((m & fwd).sum())
        counts[4] += float((m & fwd & rev).sum())
    return counts


def isect_work(pack, ipack, ign) -> tuple[float, float]:
    """(bytes, f32 operations) of one cone-energy launch on these
    operands: each face's data read and its outputs written once, and the
    operations of every counted pair by the gate it reaches."""
    T, Kp, _ = pack.shape
    faces = float((pack[..., 9] > 0).sum())
    counts = gate_counts(pack, ipack, ign)
    return ISECT_FACE_BYTES * faces, sum(o * n for o, n in
                                         zip(ISECT_OPS, counts))
