"""Self-intersection penalty: the cone energy, its broad phase and its
part filter (port of `lemo_tpu/ops/intersection.py` and of the wrappers
around the Pallas kernel in `ops/intersection_pallas.py`; the reference
builds it at fit_temp_loadprox_slide.py:314-344 and evaluates it at
fitting_temp_slide.py:618-635).

The energy of a body is

    E = sum over ordered face pairs (i, j) that pass every gate of
        sum over the vertices v of triangle j of phi_i(v)^2,

with phi_i(v) = depth = s_i - n_i . v where depth > 0 and
|v - c_i|^2 - depth^2 < (sigma r_i)^2 (the point-sampled cone field of
Tzionas et al.). The gates are hard (no gradient through them): the
faces' bounding spheres overlap, the faces share no vertex (which also
excludes i = j), the part pair is not ignored, both faces are valid, and
each triangle has vertices on both sides of the other's plane (the
necessary condition for two triangles to intersect that stands in for
the reference BVH's tri-tri test).

`batched_self_intersection` is the entry point the PROX loss calls: all T
frames of a window at once, over all F faces or over per-frame candidate
subsets `[T, K]`. Each frame is recentred on the mean of all its V
vertices (detached), the face geometry is computed in PyTorch, and the
energy with its gradients with respect to s, n and the triangles comes
from one call of `cone_energy_parts`: on a CUDA tensor the hand-written
kernel (`intersection_cuda.cone_energy_kernel`, csrc/intersection.cu),
on a CPU tensor `cone_energy_plain` below. `ConeEnergy` wraps that call
for autograd; the gradients reach the vertices through the face geometry
and the triangle gather.

Arithmetic shared by the kernel, its plain version and the candidate
scores: distances are differences then squares, dot products are
(x + y) + z, and every product and sum is rounded on its own (no FMA), so
all three make the same razor-edge gate decisions on the same inputs.
The kernel and the plain version both cull with the bounding spheres of
runs of 32 consecutive faces (the kernel also with each face's sphere
against a run's): a pair of runs is skipped when their spheres cannot
overlap, which is exact because it implies that every face pair of the
two runs fails the sphere gate.

`intersection_candidate_scores_batched` is the broad phase (plain
PyTorch, as the JAX package computes it in XLA): per frame, each face's
slack to firing the energy, from which the driver picks each frame's K
candidate faces once per window.
"""

from __future__ import annotations

import numpy as np
import torch

from lemo_tpu_torch.ops import intersection_cuda as _ic
from lemo_tpu_torch.ops.intersection_cuda import PACK, RUN, TILE

# face pairs whose sphere gate the plain version tests at once (about ten
# [pairs] f32 blocks are live at a time)
_PLAIN_PAIRS = 1 << 24
# faces per run whose bounding sphere the plain version's skip tests
_PLAIN_TILE = 32
# elements of the [frames, F, columns] block the candidate scores hold,
# and its columns
_SCORE_BLOCK = 1 << 24
_SCORE_COLS = 1024
_BIG = 1e9


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a0*b0 + a1*b1) + a2*b2 over the last axis, each op rounded."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) \
        + a[..., 2] * b[..., 2]


def face_triangles(verts: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """verts [V, 3] or [T, V, 3], faces [F, 3] (shared) or [T, F, 3]
    (per frame) -> triangles [..., F, 3, 3] (an index_select, so the
    backward is a deterministic index_add under deterministic mode)."""
    faces = faces.to(device=verts.device, dtype=torch.int64)
    if verts.dim() == 2:
        return verts.index_select(0, faces.reshape(-1)).reshape(
            faces.shape + (3,))
    T, V = verts.shape[:2]
    if faces.dim() == 2:
        return verts.index_select(1, faces.reshape(-1)).reshape(
            (T,) + faces.shape + (3,))
    flat = faces + (torch.arange(T, device=verts.device) * V)[:, None, None]
    return verts.reshape(T * V, 3).index_select(0, flat.reshape(-1)) \
        .reshape(faces.shape + (3,))


def triangle_geometry(tri: torch.Tensor):
    """tri [..., F, 3, 3] -> centroids [..., F, 3], unit normals
    [..., F, 3], bounding radii [..., F]. The sqrt(x + 1e-24) guards keep
    the gradient of a degenerate face finite (d sqrt/dx is NaN at 0 and
    survives any later masking)."""
    t0, t1, t2 = tri[..., 0, :], tri[..., 1, :], tri[..., 2, :]
    c = ((t0 + t1) + t2) / 3.0
    e1, e2 = t1 - t0, t2 - t0
    n = torch.stack([e1[..., 1] * e2[..., 2] - e1[..., 2] * e2[..., 1],
                     e1[..., 2] * e2[..., 0] - e1[..., 0] * e2[..., 2],
                     e1[..., 0] * e2[..., 1] - e1[..., 1] * e2[..., 0]], -1)
    n = n / torch.sqrt(_dot3(n, n) + 1e-24)[..., None]
    d = tri - c[..., None, :]
    r = torch.sqrt(_dot3(d, d) + 1e-24).amax(dim=-1)
    return c, n, r


def face_geometry(verts: torch.Tensor, faces: torch.Tensor):
    """Centroids, unit normals and bounding radii of the faces (the
    JAX package's `face_geometry`, any leading frame axes)."""
    return triangle_geometry(face_triangles(verts, faces))


def build_face_filter(faces: np.ndarray,
                      faces_segm: np.ndarray | None = None,
                      ign_part_pairs: list[str] | None = None,
                      faces_parents: np.ndarray | None = None) -> dict:
    """Static per-face data of the part filter (FilterFaces analog).

    faces_segm: [F] part id per face; ign_part_pairs: ["9,16", ...] part-id
    pairs whose collisions are ignored (cfg ign_part_pairs); faces_parents:
    [F] parent part id of each face's part, whose collisions with the part
    are ignored too (torch-mesh-isect FilterFaces semantics,
    fit_temp_loadprox_slide.py:335-344). Folded into one [P, P] bool
    ignore table."""
    out = {"faces": np.asarray(faces, np.int32)}
    if faces_segm is not None:
        out["segm"] = np.asarray(faces_segm, np.int32)
        pairs = set()
        for p in ign_part_pairs or []:
            a, b = (int(x) for x in p.split(","))
            pairs.add((a, b))
            pairs.add((b, a))
        nseg = int(out["segm"].max()) + 1
        tab = np.zeros((nseg, nseg), bool)
        for a, b in pairs:
            if a < nseg and b < nseg:
                tab[a, b] = True
        if faces_parents is not None:
            parents = np.asarray(faces_parents, np.int32)
            out["parents"] = parents
            for s, pa in zip(out["segm"], parents):
                if 0 <= pa < nseg:
                    tab[s, pa] = True
                    tab[pa, s] = True
        out["ign_table"] = tab
    elif faces_parents is not None:
        out["parents"] = np.asarray(faces_parents, np.int32)
    return out


# ---------------------------------------------------------------------------
# the kernel's operands


@torch.no_grad()
def pack_faces(s, n, tri, c, r, rad2, fid, seg=None):
    """Per-face data -> the kernel's operands (pack [T, Kp, PACK] f32,
    ipack [T|1, Kp, 4] int32, runs [T, Kp / RUN, 4] f32), K padded to
    Kp, a multiple of TILE, with invalid faces (valid = 0).

    pack: c (0:3), n (3:6), s (6), r (7), rad2 (8), valid (9), the
    triangle's vertices (10:19). ipack: vertex ids (0:3), part id (3); a
    shared [F, 3] `fid` and [F] `seg` give one frame of ipack for all.
    runs: each run of RUN faces' bounding sphere (`tile_spheres`), the
    kernel's culling; `intersection_pallas.py:255-262` computes the same
    spheres for its 256-face tiles."""
    T, K = s.shape
    Kp = -(-K // TILE) * TILE
    dev = s.device
    pack = torch.zeros((T, Kp, PACK), dtype=torch.float32, device=dev)
    pack[:, :K, 0:3] = c
    pack[:, :K, 3:6] = n
    pack[:, :K, 6] = s
    pack[:, :K, 7] = r
    pack[:, :K, 8] = rad2
    pack[:, :K, 9] = 1.0
    pack[:, :K, 10:19] = tri.reshape(T, K, 9)
    Ti = fid.shape[0] if fid.dim() == 3 else 1
    ipack = torch.full((Ti, Kp, 4), -1, dtype=torch.int32, device=dev)
    ipack[:, :K, 0:3] = fid.reshape(Ti, K, 3).to(torch.int32)
    ipack[:, :K, 3] = 0 if seg is None else seg.reshape(-1, K).to(
        torch.int32)
    return pack, ipack, tile_spheres(pack, RUN)


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
    """[T, NT, 4] tile spheres -> [T, NT, NT] bool: the (row tile,
    column tile) pairs that may hold an overlapping face pair. The kernel
    makes the same test on its runs with the radius sum widened by 2^-16
    (so it keeps a superset)."""
    a, b = tiles[:, :, None, :], tiles[:, None, :, :]
    dx, dy, dz = a[..., 0] - b[..., 0], a[..., 1] - b[..., 1], \
        a[..., 2] - b[..., 2]
    lim = a[..., 3] + b[..., 3]
    return (dx * dx + dy * dy) + dz * dz <= lim * lim


def _pair_geometry(ci, ri, ni, si, ui, cj, rj, nj, sj, vj):
    """The gate quantities of row faces i against column faces j, each
    operand broadcast to [..., rows, cols] (c, n, u, v keep a trailing
    axis of 3 or 9): (d2, rsum, depths [3], lat2 [3], reverse depths
    [3]), in the kernel's order and rounding."""
    dx, dy, dz = ci[..., 0] - cj[..., 0], ci[..., 1] - cj[..., 1], \
        ci[..., 2] - cj[..., 2]
    d2 = (dx * dx + dy * dy) + dz * dz
    rsum = ri + rj
    depth, lat2, rdepth = [], [], []
    for a in range(3):
        v = vj[..., 3 * a:3 * a + 3]
        dep = si - _dot3(ni, v)
        lx, ly, lz = v[..., 0] - ci[..., 0], v[..., 1] - ci[..., 1], \
            v[..., 2] - ci[..., 2]
        depth.append(dep)
        lat2.append(((lx * lx + ly * ly) + lz * lz) - dep * dep)
        rdepth.append(sj - _dot3(nj, ui[..., 3 * a:3 * a + 3]))
    return d2, rsum, depth, lat2, rdepth


def _min3(x):
    return torch.minimum(torch.minimum(x[0], x[1]), x[2])


def _max3(x):
    return torch.maximum(torch.maximum(x[0], x[1]), x[2])


def _adjacent(fi, fj):
    """[..., rows, 3] x [..., cols, 3] vertex ids -> shared-vertex mask
    [..., rows, cols] (covers i == j)."""
    adj = None
    for p in range(3):
        for q in range(3):
            e = fi[..., p][..., :, None] == fj[..., q][..., None, :]
            adj = e if adj is None else adj | e
    return adj


def sphere_pairs(pack: torch.Tensor, run: int = _PLAIN_TILE):
    """Yield, a chunk of `_PLAIN_PAIRS` tested pairs at a time, the face
    pairs that pass the sphere gate (the kernel's rounding), as row and
    column indices into pack.reshape(-1, PACK). Only the pairs of
    `run`-face runs whose spheres overlap are tested, which is exact."""
    T, Kp, _ = pack.shape
    tp, a, b = tile_pairs(tile_spheres(pack, run)).nonzero(as_tuple=True)
    flat = pack.reshape(T * Kp, PACK)
    lane = torch.arange(run, device=pack.device)
    chunk = max(1, _PLAIN_PAIRS // (run * run))
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


def pair_gates(a, b, ia, ib, ign=None):
    """The gates past the sphere gate of face pairs a (cone owner) and b
    (vertex supplier), rows of `pack` [N, PACK] and of `ipack` [N, 4] ->
    (both valid, not adjacent and not part-ignored [N], forward straddle
    [N], reverse straddle [N], depths [3] and lat2 [3] of b's vertices in
    a's cone), in the kernel's order and rounding."""
    m = (a[:, 9] > 0) & (b[:, 9] > 0)
    for p in range(3):
        for q in range(3):
            m &= ia[:, p] != ib[:, q]
    if ign is not None:
        m &= ~ign[ia[:, 3].long(), ib[:, 3].long()]
    _, _, depth, lat2, rdep = _pair_geometry(
        a[:, 0:3], a[:, 7], a[:, 3:6], a[:, 6], a[:, 10:19],
        b[:, 0:3], b[:, 7], b[:, 3:6], b[:, 6], b[:, 10:19])
    fwd = (_min3(depth) < 0) & (_max3(depth) > 0)
    rev = (_min3(rdep) < 0) & (_max3(rdep) > 0)
    return m, fwd, rev, depth, lat2


@torch.no_grad()
def cone_energy_plain(pack: torch.Tensor, ipack: torch.Tensor,
                      runs: torch.Tensor, ign: torch.Tensor | None = None):
    """Plain version of the kernel (same operands, same results):
    -> (e [T, Kp] f64: each row face's energy, rowgrad [T, Kp, 4] f32:
    dE/dn (0:3) and dE/ds (3) of each row face, dtri [T, Kp, 9] f32:
    dE/d(vertices) of each column face, active [T, Kp] int32: the pairs
    with energy of each row face).

    The sphere gate runs on the pairs of nearby face runs
    (`sphere_pairs`, which makes its own runs from `pack`; `runs` is
    taken for the kernel's signature), the
    other gates and the cone field only on the pairs past it, with the
    kernel's arithmetic; the per-pair sums reach the faces by index_add
    (deterministic under torch.use_deterministic_algorithms). `ign`:
    [P, P] bool ignore table indexed by the part ids of ipack, or None."""
    T, Kp, _ = pack.shape
    dev = pack.device
    e = torch.zeros(T * Kp, dtype=torch.float64, device=dev)
    rowgrad = torch.zeros((T * Kp, 4), dtype=torch.float32, device=dev)
    dtri = torch.zeros((T * Kp, 9), dtype=torch.float32, device=dev)
    active = torch.zeros(T * Kp, dtype=torch.int32, device=dev)
    out = (e.view(T, Kp), rowgrad.view(T, Kp, 4), dtri.view(T, Kp, 9),
           active.view(T, Kp))
    if T * Kp == 0:
        return out
    flat = pack.reshape(T * Kp, PACK)
    ids = ipack.expand(T, -1, -1).reshape(T * Kp, 4)
    for i, j in sphere_pairs(pack):
        a, b = flat[i], flat[j]
        m, fwd, rev, depth, lat2 = pair_gates(a, b, ids[i], ids[j], ign)
        m &= fwd & rev
        phi = [torch.where(m & (depth[k] > 0) & (lat2[k] < a[:, 8]),
                           depth[k], torch.zeros_like(depth[k]))
               for k in range(3)]
        # only the pairs with energy add anything
        sel = ((phi[0] > 0) | (phi[1] > 0) | (phi[2] > 0)).nonzero()[:, 0]
        i, j, a, b = i[sel], j[sel], a[sel], b[sel]
        phi = [x[sel] for x in phi]
        e_p = ds_p = None
        dn_p = [None] * 3
        dt_p = []
        for k in range(3):
            g = phi[k] + phi[k]
            sq = (phi[k] * phi[k]).double()
            e_p = sq if e_p is None else e_p + sq
            ds_p = g if ds_p is None else ds_p + g
            for c in range(3):
                dn_c = -(g * b[:, 10 + 3 * k + c])
                dn_p[c] = dn_c if dn_p[c] is None else dn_p[c] + dn_c
                dt_p.append(-(g * a[:, 3 + c]))
        e.index_add_(0, i, e_p)
        rowgrad.index_add_(0, i, torch.stack(dn_p + [ds_p], -1))
        dtri.index_add_(0, j, torch.stack(dt_p, -1))
        active.index_add_(0, i, torch.ones_like(i, dtype=torch.int32))
    return out


def _operands(s, n, tri, c, r, rad2, fid, seg, ign_table):
    """Per-face data -> (pack, ipack, runs, ign): `pack_faces` and the
    ignore table as bool, or None unless both `seg` and `ign_table` are
    given."""
    ign = None
    if seg is not None and ign_table is not None:
        ign = ign_table.to(device=s.device, dtype=torch.bool)
    return pack_faces(s, n, tri, c, r, rad2, fid,
                      seg if ign is not None else None) + (ign,)


def cone_energy_parts(s, n, tri, c, r, rad2, fid, seg=None,
                      ign_table=None):
    """The cone energy of each frame with its gradients (the JAX
    package's `_cone_energy_call`, batched over frames):
    s [T, K], n [T, K, 3], tri [T, K, 3, 3], c [T, K, 3], r [T, K],
    rad2 [T, K], fid [T, K, 3] or [K, 3] int, seg [T, K] or [K] int or
    None, ign_table [P, P] bool or None ->
    (E [T] f32, ds [T, K], dn [T, K, 3], dtri [T, K, 3, 3], active pairs
    [T] int). The kernel on a CUDA tensor, the plain version on a CPU
    tensor; part filtering needs both `seg` and `ign_table`."""
    T, K = s.shape
    pack, ipack, runs, ign = _operands(s, n, tri, c, r, rad2, fid, seg,
                                       ign_table)
    if s.device.type == "cpu":
        e, rowgrad, dtri, active = cone_energy_plain(pack, ipack, runs, ign)
    else:
        e, rowgrad, dtri, active = _ic.cone_energy_kernel(pack, ipack, runs,
                                                          ign)
    return (e.sum(1).to(torch.float32), rowgrad[:, :K, 3],
            rowgrad[:, :K, 0:3], dtri[:, :K].reshape(T, K, 3, 3),
            active.sum(1))


class ConeEnergy(torch.autograd.Function):
    """E [T] = cone energy of each frame (`cone_energy_parts`). The
    gates are hard, so only s, n and the triangles carry gradient and the
    backward is the forward's own (ds, dn, dtri) times the upstream g
    (`intersection_pallas.py:315-327`); c, r, rad2 and the integer
    operands get none."""

    @staticmethod
    def forward(ctx, s, n, tri, c, r, rad2, fid, seg, ign_table):
        E, ds, dn, dtri, _ = cone_energy_parts(
            s.detach(), n.detach(), tri.detach(), c.detach(), r.detach(),
            rad2.detach(), fid, seg, ign_table)
        ctx.save_for_backward(ds, dn, dtri)
        return E

    @staticmethod
    def backward(ctx, g):
        ds, dn, dtri = ctx.saved_tensors
        return (g[:, None] * ds, g[:, None, None] * dn,
                g[:, None, None, None] * dtri) + (None,) * 6


def _recentred(verts: torch.Tensor) -> torch.Tensor:
    """Each frame minus the mean of its V vertices (detached): the
    energy is translation-invariant, and s = c . n and depth = s - n . v
    at scene scale would cost ~|c| eps of cancellation at the gates."""
    return verts - verts.mean(dim=-2, keepdim=True).detach()


def _face_data(verts, faces, candidate_ids, sigma, segm):
    """[T, V, 3] -> the per-face operands (s, n, tri, c, r, rad2, fid,
    seg) of each recentred frame, over all faces or the frame's
    candidates."""
    T = verts.shape[0]
    faces = faces.to(device=verts.device, dtype=torch.int64)
    v = _recentred(verts)
    fid = faces
    seg = None if segm is None else segm.to(verts.device)
    if candidate_ids is not None:
        ids = candidate_ids.to(device=verts.device, dtype=torch.int64)
        if ids.dim() == 1:
            ids = ids.expand(T, -1)
        fid = faces[ids]                                    # [T, K, 3]
        seg = None if seg is None else seg[ids]
    tri = face_triangles(v, fid)
    c, n, r = triangle_geometry(tri)
    return _dot3(c, n), n, tri, c, r, (sigma * r) ** 2, fid, seg


@torch.no_grad()
def kernel_operands(verts: torch.Tensor, faces: torch.Tensor,
                    candidate_ids: torch.Tensor | None = None,
                    sigma: float = 0.5, segm: torch.Tensor | None = None,
                    ign_table: torch.Tensor | None = None):
    """What `batched_self_intersection` hands the kernel for these
    arguments: (pack, ipack, runs, ign), the operands of
    `intersection_cuda.cone_energy_kernel` and `cone_energy_plain`."""
    return _operands(*_face_data(verts, faces, candidate_ids, sigma, segm),
                     ign_table)


def batched_self_intersection(verts: torch.Tensor, faces: torch.Tensor,
                              candidate_ids: torch.Tensor | None = None,
                              sigma: float = 0.5,
                              segm: torch.Tensor | None = None,
                              ign_table: torch.Tensor | None = None
                              ) -> torch.Tensor:
    """verts [T, V, 3], faces [F, 3] -> energies [T].

    candidate_ids ([T, K] or [K] int): evaluate each frame's energy only
    on these faces; exact whenever every face with a firing partner is in
    the set (the gates are re-applied on the subset, so extra faces change
    nothing). Kept in face-id order, the subset stays spatially coherent
    and most run pairs are skipped. All T frames go through one call of
    the kernel (on the card) or its plain version (on the CPU), with no
    fallback between them; part filtering reads the [P, P] table at any
    P."""
    s, n, tri, c, r, rad2, fid, seg = _face_data(verts, faces,
                                                 candidate_ids, sigma, segm)
    return ConeEnergy.apply(s, n, tri, c, r, rad2, fid, seg, ign_table)


# ---------------------------------------------------------------------------
# broad phase


@torch.no_grad()
def intersection_candidate_scores_batched(verts: torch.Tensor,
                                          faces: torch.Tensor,
                                          margin: float = 0.05,
                                          sigma: float = 0.5,
                                          segm: torch.Tensor | None = None,
                                          ign_table: torch.Tensor | None
                                          = None):
    """[T, V, 3] -> (score [T, F] f32, counts [T, 2] int64 = (n_active,
    n_within)): per frame, each face's slack to firing the energy, from
    detached geometry (the JAX package's
    `intersection_candidate_scores`, `lemo_tpu/ops/intersection.py:
    225-389`, whose docstring derives it).

    A directed pair (i cone owner, j vertex supplier) has slack
        max(d - (r_i + r_j),
            max(min_a depth_a, -max_a depth_a),
            max(min_a rdepth_a, -max_a rdepth_a),
            min_a max(-depth_a, lat_a - sigma r_i)),
    forced below 0 when the energy's gates fire on the pair and set to
    1e9 for an adjacent, invalid or part-ignored pair. A face's score is
    its smallest slack in either role. n_active counts faces with score
    < 0 (on a firing pair now), n_within those with score < margin.

    One forward-only O(F^2) sweep per frame, in blocks of whole frames
    times `_SCORE_COLS` columns, so the transient memory stays a few GB at
    F = 20,080. The gate arithmetic is the kernel's, so the clamp to < 0
    reproduces its gate decisions and margin 0 covers the energy's active
    set exactly."""
    T = verts.shape[0]
    faces = faces.to(device=verts.device, dtype=torch.int64)
    F = faces.shape[0]
    v = _recentred(verts.detach())
    tri = face_triangles(v, faces)                          # [T, F, 3, 3]
    c, n, r = triangle_geometry(tri)
    s = _dot3(c, n)
    rad = sigma * r
    rad2 = rad ** 2
    u = tri.reshape(T, F, 9)
    ign = None
    if segm is not None and ign_table is not None:
        ign = ign_table.to(device=verts.device, dtype=torch.bool)
        seg = segm.to(device=verts.device, dtype=torch.int64)
    cb = max(1, min(_SCORE_COLS, F))
    fc = max(1, min(T, _SCORE_BLOCK // max(F * cb, 1)))
    score = torch.empty((T, F), dtype=torch.float32, device=verts.device)
    for t0 in range(0, T, fc):
        ts = slice(t0, min(T, t0 + fc))
        row_min = torch.full((score[ts].shape[0], F), _BIG,
                             dtype=torch.float32, device=verts.device)
        col_min = torch.full_like(row_min, _BIG)
        ci, ni, si = c[ts, :, None], n[ts, :, None], s[ts, :, None]
        ri, ui = r[ts, :, None], u[ts, :, None]
        radi, rad2i = rad[ts, :, None], rad2[ts, :, None]
        for j0 in range(0, F, cb):
            js = slice(j0, min(F, j0 + cb))
            d2, rsum, depth, lat2, rdep = _pair_geometry(
                ci, ri, ni, si, ui, c[ts, None, js], r[ts, None, js],
                n[ts, None, js], s[ts, None, js], u[ts, None, js])
            cone = fire_cone = None
            for a in range(3):
                lat = torch.sqrt(torch.clamp(lat2[a], min=0.0))
                ca = torch.maximum(-depth[a], lat - radi)
                fa = (depth[a] > 0) & (lat2[a] < rad2i)
                cone = ca if cone is None else torch.minimum(cone, ca)
                fire_cone = fa if fire_cone is None else fire_cone | fa
            dmin, dmax = _min3(depth), _max3(depth)
            rmin, rmax = _min3(rdep), _max3(rdep)
            strad = torch.maximum(torch.maximum(dmin, -dmax),
                                  torch.maximum(rmin, -rmax))
            sgap = torch.sqrt(torch.clamp(d2, min=0.0)) - rsum
            slack = torch.maximum(torch.maximum(sgap, cone), strad)
            fire = ((d2 < rsum * rsum) & fire_cone & (dmin < 0)
                    & (dmax > 0) & (rmin < 0) & (rmax > 0))
            slack = torch.where(fire, torch.clamp(slack, max=-1e-9), slack)
            invalid = _adjacent(faces[None, :], faces[None, js])
            if ign is not None:
                invalid = invalid | ign[seg[:, None], seg[None, js]]
            slack = torch.where(invalid, torch.full_like(slack, _BIG),
                                slack)
            row_min = torch.minimum(row_min, slack.amin(-1))
            col_min[:, js] = torch.minimum(col_min[:, js], slack.amin(-2))
        score[ts] = torch.minimum(row_min, col_min)
    counts = torch.stack([(score < 0.0).sum(1), (score < margin).sum(1)], 1)
    return score, counts

