"""The fused SMPL-X vertex path: the CUDA kernel pair and its plain twins.

Port of `lemo_tpu/body_model/vertex_pallas.py`. Per vertex tile, with
`cat` = [shape comps | plane-ordered pose feature | 1] (D = S+9(J-1)+1):

    vs[n]  = dirs[n] @ cat                 # shape + pose blend + template
    T      = W @ A2                        # skinning blend, 12 planes
    out[m] = sum_n T[3m+n] * vs[n] + T[9+m]

The forward runs in two stages, each with a plain twin here:

    vs  = blend(catT, dirs)                # a GEMM into a slab [3, Vp, Bp]
    out = fwd_apply(vs, A2, w)             # T formed per tile, then applied

The backward returns (dcat, dA2); dirs and W are model constants and get
no cotangent. It runs in three stages, each with a plain twin here:

    vs, dvs = pointwise(catT, A2, dirs, w, dout)   # dvs[n] = sum_m T[3m+n] dout[m]
    dcat    = sum_n dirs[n]^T @ dvs[n]             # split-K reduction over V
    dA2[k]  = W^T @ dT[k]                          # dT from dout and vs

`_VertexCore` keeps the forward's vs for the backward, whose pointwise
stage then skips the blend: the same kernel on the same operands, so the
same bits as recomputing it. T never reaches device memory
(`csrc/vertex.cu`).

Dispatch: a CPU tensor goes to the plain twin; any other tensor goes to
the kernel, which checks that it is on CUDA and raises otherwise.
"""

from __future__ import annotations

import ctypes
import math
from functools import lru_cache

import numpy as np
import torch

from lemo_tpu_torch import _build
from lemo_tpu_torch.utils import routing

LANE = 128     # frame padding of the plane layout (the TPU's lane width)
TILE_V = 256   # vertex padding of the fused constants (bit-equal to JAX)

# launches of each kernel, counted where the wrapper launches it
launches = {"vertex_fwd": 0, "vertex_bwd": 0}
# launches of the stages on their own (the checks of each stage; the main
# path launches them only through `vertex_fwd_kernel` and
# `vertex_bwd_kernel`)
stage_launches = {"vertex_blend": 0, "vertex_fwd_apply": 0,
                  "vertex_bwd_pointwise": 0, "vertex_bwd_dcat": 0,
                  "vertex_bwd_da2": 0}


def pad_to(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def build_fused_consts(shape_expr_f64: np.ndarray,
                       posedirs_f64: np.ndarray,
                       v_template_f64: np.ndarray,
                       lbs_weights: np.ndarray,
                       J_regressor_f64: np.ndarray) -> dict[str, np.ndarray]:
    """The kernels' constant operands, built at model-load time (numpy,
    bit-identical to `lemo_tpu`'s `build_fused_consts`):

    - `fused_dirs` [3, Vp, D], the pose block permuted to plane order
      r = k*(J-1) + (j-1) (k = 3m+n);
    - `lbs_w_pad` [Vp, Jp];
    - `j_ext` [3*J, S+1]: the J_regressor pre-applied (at f64) to the
      shape dirs plus a template column.
    """
    V, _, S = shape_expr_f64.shape
    P = posedirs_f64.shape[2]
    J = lbs_weights.shape[1]
    D = S + P + 1
    Vp = pad_to(V, TILE_V)
    Jp = pad_to(J, 8)
    dirs = np.zeros((3, Vp, D), np.float32)
    r = np.arange(P)
    perm = (r % (J - 1)) * 9 + (r // (J - 1))
    for n in range(3):
        dirs[n, :V, :S] = shape_expr_f64[:, n, :]
        dirs[n, :V, S:S + P] = posedirs_f64[:, n, perm]
        dirs[n, :V, D - 1] = v_template_f64[:, n]
    w_pad = np.zeros((Vp, Jp), np.float32)
    w_pad[:V, :J] = lbs_weights
    jd = np.einsum("jv,vns->njs", J_regressor_f64, shape_expr_f64)
    jt = (J_regressor_f64 @ v_template_f64).T[..., None]   # [3, J, 1]
    j_ext = np.concatenate([jd, jt], axis=-1).reshape(3 * J, S + 1)
    return {"fused_dirs": dirs, "lbs_w_pad": w_pad,
            "j_ext": j_ext.astype(np.float32)}


def _check(name, t, shape):
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"{name}: expected contiguous float32")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")


def _check_operands(catT, A2, dirs, w):
    """Device, dtype and mutual shapes; the tile divisibility the kernels
    need is checked once, in C (`shapes_ok` in csrc/vertex.cu)."""
    D, Bp = catT.shape
    Jp = A2.shape[1]
    Vp = dirs.shape[1]
    _check("catT", catT, (D, Bp))
    _check("A2", A2, (12, Jp, Bp))
    _check("dirs", dirs, (3, Vp, D))
    _check("w", w, (Vp, Jp))
    return D, Jp, Vp, Bp


def _planes(like, Vp, Bp):
    return torch.empty((3, Vp, Bp), dtype=torch.float32, device=like.device)


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def vertex_fwd_kernel(catT, A2, dirs, w, vs=None):
    """Kernel 3: catT [D, Bp], A2 [12, Jp, Bp], dirs [3, Vp, D],
    w [Vp, Jp] -> vertex planes [3, Vp, Bp]. One C call launches the
    blend into `vs` [3, Vp, Bp] (scratch when None; a caller that passes
    it keeps the blend) and then the skinning and affine apply."""
    D, Jp, Vp, Bp = _check_operands(catT, A2, dirs, w)
    if vs is None:
        vs = _planes(catT, Vp, Bp)
    _check("vs", vs, (3, Vp, Bp))
    lib = _build.load_library()
    out = _planes(catT, Vp, Bp)
    rc = lib.lemo_vertex_fwd(
        catT.data_ptr(), A2.data_ptr(), dirs.data_ptr(), w.data_ptr(),
        vs.data_ptr(), out.data_ptr(), D, Jp, Vp, Bp, _stream(catT))
    _build.check(lib, rc, f"lemo_vertex_fwd (D={D} Jp={Jp} Vp={Vp} Bp={Bp})")
    launches["vertex_fwd"] += 1
    return out


def vertex_blend_kernel(catT, dirs):
    """The blend alone, both directions' first launch: catT [D, Bp],
    dirs [3, Vp, D] -> vs [3, Vp, Bp]."""
    D, Bp = catT.shape
    Vp = dirs.shape[1]
    _check("catT", catT, (D, Bp))
    _check("dirs", dirs, (3, Vp, D))
    lib = _build.load_library()
    vs = _planes(catT, Vp, Bp)
    rc = lib.lemo_vertex_blend(catT.data_ptr(), dirs.data_ptr(),
                               vs.data_ptr(), D, Vp, Bp, _stream(catT))
    _build.check(lib, rc, "lemo_vertex_blend")
    stage_launches["vertex_blend"] += 1
    return vs


def vertex_fwd_apply_kernel(vs, A2, w):
    """The forward's second stage alone: vs [3, Vp, Bp], A2 [12, Jp, Bp],
    w [Vp, Jp] -> vertex planes [3, Vp, Bp]."""
    Vp, Jp = w.shape
    Bp = vs.shape[2]
    _check("vs", vs, (3, Vp, Bp))
    _check("A2", A2, (12, Jp, Bp))
    _check("w", w, (Vp, Jp))
    lib = _build.load_library()
    out = _planes(vs, Vp, Bp)
    rc = lib.lemo_vertex_fwd_apply(vs.data_ptr(), A2.data_ptr(),
                                   w.data_ptr(), out.data_ptr(), Jp, Vp, Bp,
                                   _stream(vs))
    _build.check(lib, rc, "lemo_vertex_fwd_apply")
    stage_launches["vertex_fwd_apply"] += 1
    return out


@lru_cache(maxsize=None)
def bwd_slices(D: int, Jp: int, Vp: int, Bp: int) -> tuple[int, int]:
    """The backward's split-K slice counts (dcat, dA2) at these shapes,
    from the kernel's own tiling (`lemo_vertex_bwd_slices`)."""
    lib = _build.load_library()
    out = (ctypes.c_int * 2)()
    rc = lib.lemo_vertex_bwd_slices(D, Jp, Vp, Bp, out)
    if rc:
        raise ValueError(f"vertex kernel: shapes D={D} Jp={Jp} Vp={Vp} "
                         f"Bp={Bp} are not whole tiles of the kernel")
    return out[0], out[1]


def _bwd_scratch(D, Jp, Vp, Bp, dev, vs=None):
    """The backward's scratch as views of one buffer: vs (unless given),
    dvs [3, Vp, Bp], the dcat partials [S0, D, Bp] and the dA2 partials
    [S1, 12, Jp, Bp] (every view starts on a 16-byte boundary). Returns
    [vs, dvs, dcat partials, dA2 partials]."""
    s_dcat, s_da2 = bwd_slices(D, Jp, Vp, Bp)
    shapes = [(3, Vp, Bp), (s_dcat, D, Bp), (s_da2, 12, Jp, Bp)]
    if vs is None:
        shapes.insert(0, (3, Vp, Bp))
    sizes = [math.prod(s) for s in shapes]
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    views = [v.view(s) for v, s in zip(flat.split(sizes), shapes)]
    return views if vs is None else [vs] + views


def vertex_bwd_kernel(catT, A2, dirs, w, dout, vs=None):
    """Kernel 4: -> (dcat [D, Bp], dA2 [12, Jp, Bp]). One C call launches
    the blend (skipped when `vs`, the forward's blend [3, Vp, Bp], is
    given), the pointwise pass, the two split-K reductions and their
    fixed-order sums on the current stream (deterministic, no atomics)."""
    D, Jp, Vp, Bp = _check_operands(catT, A2, dirs, w)
    _check("dout", dout, (3, Vp, Bp))
    if vs is not None:
        _check("vs", vs, (3, Vp, Bp))
    lib = _build.load_library()
    dev = catT.device
    scratch, dvs, part_dcat, part_da2 = _bwd_scratch(D, Jp, Vp, Bp, dev, vs)
    dcat = torch.empty((D, Bp), dtype=torch.float32, device=dev)
    da2 = torch.empty((12, Jp, Bp), dtype=torch.float32, device=dev)
    tail = (dcat.data_ptr(), da2.data_ptr(), scratch.data_ptr(),
            dvs.data_ptr(), part_dcat.data_ptr(), part_da2.data_ptr(), D, Jp,
            Vp, Bp, _stream(catT))
    if vs is None:
        rc = lib.lemo_vertex_bwd(catT.data_ptr(), A2.data_ptr(),
                                 dirs.data_ptr(), w.data_ptr(),
                                 dout.data_ptr(), *tail)
    else:
        rc = lib.lemo_vertex_bwd_from_vs(A2.data_ptr(), dirs.data_ptr(),
                                         w.data_ptr(), dout.data_ptr(), *tail)
    _build.check(lib, rc, f"lemo_vertex_bwd (D={D} Jp={Jp} Vp={Vp} Bp={Bp}"
                 f"{', from vs' if vs is not None else ''})")
    launches["vertex_bwd"] += 1
    return dcat, da2


def vertex_bwd_pointwise_kernel(catT, A2, dirs, w, dout):
    """The backward's first stage alone -> (vs, dvs) [3, Vp, Bp]."""
    D, Jp, Vp, Bp = _check_operands(catT, A2, dirs, w)
    _check("dout", dout, (3, Vp, Bp))
    lib = _build.load_library()
    vs, dvs = _planes(catT, Vp, Bp), _planes(catT, Vp, Bp)
    rc = lib.lemo_vertex_bwd_pointwise(
        catT.data_ptr(), A2.data_ptr(), dirs.data_ptr(), w.data_ptr(),
        dout.data_ptr(), vs.data_ptr(), dvs.data_ptr(), D, Jp, Vp, Bp,
        _stream(catT))
    _build.check(lib, rc, "lemo_vertex_bwd_pointwise")
    stage_launches["vertex_bwd_pointwise"] += 1
    return vs, dvs


def dcat_kernel_from_dvs(dirs, dvs):
    """The dcat reduction alone: dirs [3, Vp, D], dvs [3, Vp, Bp] ->
    dcat [D, Bp]."""
    _, Vp, D = dirs.shape
    Bp = dvs.shape[2]
    _check("dirs", dirs, (3, Vp, D))
    _check("dvs", dvs, (3, Vp, Bp))
    lib = _build.load_library()
    s_dcat, _ = bwd_slices(D, 1, Vp, Bp)   # S0 does not depend on Jp
    part = torch.empty((s_dcat, D, Bp), dtype=torch.float32,
                       device=dirs.device)
    dcat = torch.empty((D, Bp), dtype=torch.float32, device=dirs.device)
    rc = lib.lemo_vertex_bwd_dcat(dirs.data_ptr(), dvs.data_ptr(),
                                  dcat.data_ptr(), part.data_ptr(), D, Vp,
                                  Bp, _stream(dirs))
    _build.check(lib, rc, "lemo_vertex_bwd_dcat")
    stage_launches["vertex_bwd_dcat"] += 1
    return dcat


def da2_kernel_from_vs(w, vs, dout):
    """The dA2 reduction alone: w [Vp, Jp], vs and dout [3, Vp, Bp] ->
    dA2 [12, Jp, Bp]."""
    Vp, Jp = w.shape
    Bp = vs.shape[2]
    _check("w", w, (Vp, Jp))
    _check("vs", vs, (3, Vp, Bp))
    _check("dout", dout, (3, Vp, Bp))
    lib = _build.load_library()
    _, s_da2 = bwd_slices(1, Jp, Vp, Bp)   # nor S1 on D
    part = torch.empty((s_da2, 12, Jp, Bp), dtype=torch.float32,
                       device=w.device)
    da2 = torch.empty((12, Jp, Bp), dtype=torch.float32, device=w.device)
    rc = lib.lemo_vertex_bwd_da2(w.data_ptr(), vs.data_ptr(), dout.data_ptr(),
                                 da2.data_ptr(), part.data_ptr(), Jp, Vp, Bp,
                                 _stream(w))
    _build.check(lib, rc, "lemo_vertex_bwd_da2")
    stage_launches["vertex_bwd_da2"] += 1
    return da2


def _skin_blend(A2, w):
    """T [12, Vp, Bp] = W @ A2 per plane."""
    return torch.einsum("vj,kjb->kvb", w, A2)


def vertex_plain_blend(catT, dirs):
    """Plain twin of the blend: vs[n] = dirs[n] @ cat -> [3, Vp, Bp]."""
    return torch.matmul(dirs, catT)


def vertex_plain_fwd_apply(vs, A2, w):
    """Plain twin of the forward's second stage: out[m] = T[9+m] +
    sum_n T[3m+n] * vs[n], with T = W @ A2."""
    T = _skin_blend(A2, w)
    return torch.stack([
        T[9 + m] + T[3 * m] * vs[0] + T[3 * m + 1] * vs[1]
        + T[3 * m + 2] * vs[2] for m in range(3)])


def vertex_plain_fwd(catT, A2, dirs, w, vs=None):
    """Plain twin of kernel 3: its two stages in turn; the blend is also
    written into `vs` when given."""
    blend = vertex_plain_blend(catT, dirs)
    if vs is not None:
        vs.copy_(blend)
    return vertex_plain_fwd_apply(blend, A2, w)


def vertex_plain_bwd_pointwise(catT, A2, dirs, w, dout, vs=None):
    """Plain twin of the backward's first stage -> (vs, dvs) [3, Vp, Bp]:
    vs[n] = dirs[n] @ cat (or the given blend) and dvs[n] =
    sum_m T[3m+n] * dout[m]."""
    if vs is None:
        vs = vertex_plain_blend(catT, dirs)
    T = _skin_blend(A2, w)
    dvs = torch.stack([T[n] * dout[0] + T[3 + n] * dout[1]
                       + T[6 + n] * dout[2] for n in range(3)])
    return vs, dvs


def dcat_plain_from_dvs(dirs, dvs):
    """Plain twin of the dcat reduction: sum_n dirs[n]^T @ dvs[n]."""
    return torch.einsum("nvd,nvb->db", dirs, dvs)


def da2_plain_from_vs(w, vs, dout):
    """Plain twin of the dA2 reduction: W^T @ dT[k], with
    dT[3m+n] = dout[m] * vs[n] and dT[9+m] = dout[m]."""
    dT = torch.stack([dout[k // 3] * vs[k % 3] for k in range(9)]
                     + [dout[m] for m in range(3)])  # [12, Vp, Bp]
    return torch.einsum("vj,kvb->kjb", w, dT)


def vertex_plain_bwd(catT, A2, dirs, w, dout, vs=None):
    """Plain twin of kernel 4 -> (dcat [D, Bp], dA2 [12, Jp, Bp]): its
    three stages in turn, from the given blend `vs` if any."""
    vs, dvs = vertex_plain_bwd_pointwise(catT, A2, dirs, w, dout, vs)
    return dcat_plain_from_dvs(dirs, dvs), da2_plain_from_vs(w, vs, dout)


class _VertexCore(torch.autograd.Function):
    """The forward keeps its blend vs [3, Vp, Bp] for the backward, which
    then does not form it again."""

    @staticmethod
    def forward(ctx, catT, A2, dirs, w):
        cpu = catT.device.type == "cpu"
        vs = catT.new_empty((3, dirs.shape[1], catT.shape[1]))
        out = (vertex_plain_fwd if cpu else vertex_fwd_kernel)(
            catT, A2, dirs, w, vs)
        ctx.save_for_backward(catT, A2, dirs, w, vs)
        return out

    @staticmethod
    def backward(ctx, dout):
        catT, A2, dirs, w, vs = ctx.saved_tensors
        cpu = catT.device.type == "cpu"
        dcat, da2 = (vertex_plain_bwd if cpu else vertex_bwd_kernel)(
            catT, A2, dirs, w, dout.contiguous(), vs)
        # dirs / w are frozen model constants: no cotangent by contract
        return dcat, da2, None, None


def fused_lbs_vertices_planes(catT: torch.Tensor, A_planes: torch.Tensor,
                              fused_dirs: torch.Tensor,
                              lbs_w_pad: torch.Tensor) -> torch.Tensor:
    """catT [D, Bp], bone-affine planes [12, Jp, Bp] -> vertex planes
    [3, Vp, Bp], differentiable in catT and A_planes."""
    if catT.shape[0] != fused_dirs.shape[2]:
        raise ValueError(f"catT rows {catT.shape[0]} != dirs depth "
                         f"{fused_dirs.shape[2]}")
    return _VertexCore.apply(catT.contiguous(), A_planes.contiguous(),
                             fused_dirs, lbs_w_pad)


# the entry points' routing is watched (`utils.routing`)
routing.watch(__name__)
