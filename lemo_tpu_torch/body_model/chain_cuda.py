"""Kinematic-chain composition: the CUDA kernel pair and its plain twins.

Port of `lemo_tpu/body_model/chain_pallas.py`. Planes keep the TPU
layout — rotations [9, Jp, B] (row k = 3m+n holds R[m, n]) and
translations [3, Jp, B] — which on the GPU is the coalesced one:

    forward:   G[j] = G[p] @ L[j],  t_g[j] = R_g[p] t_l[j] + t_g[p]
    backward:  dL[j] = G[p]^T dG[j],  dt_l[j] = R_g[p]^T dt_g[j]
               dG[p] += dG[j] L[j]^T + dt_g[j] (x) t_l[j],  dt_g[p] += dt_g[j]

The kernels (`csrc/chain.cu`) give a block a few frames, stage their
planes in shared memory and walk the tree one level at a time, one
thread per (joint of the level, frame, output entry). The wrapper builds
the level schedule from the parents (`chain_schedule`) and keeps it on
the device.

Two entry points:

- `chain_planes(rl, tl, parents)`: (R_l, t_l) -> (R_g, t_g);
- `chain_affine_planes(rl, jr, parents)`: the body model's form, from
  the rest-pose joints jr. It forms t_l[j] = jr[j] - jr[p] before the walk
  and the bone affines A = [R_g; t_g - R_g jr] [12, Jp, B] after it, and
  returns (A, t_g), in one launch each way. The outputs are bit-identical
  to the eager composition around `chain_planes`
  (`chain_affine_planes_unfused`).

Dispatch: a CPU tensor goes to the plain twin; any other tensor goes to
the kernel, which checks that it is on CUDA and raises otherwise.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from lemo_tpu_torch import _build
from lemo_tpu_torch.utils import routing

# the kernels' static limits (kMaxJoints, kMaxLevels in csrc/chain.cu):
# SMPL-X has 56 padded joints on 11 levels, SMPL-H 56 on 11, SMPL 24 on 9,
# MANO 16 on 4
MAX_JOINTS = 64
MAX_LEVELS = 16


def _pad_to(x: int, mult: int) -> int:
    return (-x) % mult


# launches of each kernel, counted where the wrapper launches it (the
# affine entry points count as the chain forward and backward they are)
launches = {"chain_fwd": 0, "chain_bwd": 0}


class ChainSchedule(NamedTuple):
    """The order the kernels walk a tree in: `levels[d]` the joints at
    depth d (ascending), `children[p]` the children of joint p in
    decreasing index (the order the backward adds their shares in)."""
    levels: tuple
    children: tuple


def chain_schedule(parents: tuple) -> ChainSchedule:
    """The level schedule of a tree with parents[j] < j (joint 0 the
    root)."""
    depth = [0] * len(parents)
    for j in range(1, len(parents)):
        depth[j] = depth[parents[j]] + 1
    levels = tuple(tuple(j for j in range(len(parents)) if depth[j] == d)
                   for d in range(max(depth) + 1))
    children = tuple(tuple(c for c in range(len(parents) - 1, 0, -1)
                           if parents[c] == p) for p in range(len(parents)))
    return ChainSchedule(levels, children)


_schedule_cache: dict = {}


def _schedule_on(parents: tuple, device) -> tuple[torch.Tensor, int]:
    """The schedule packed as `csrc/chain.cu` stages it — parent[Jp],
    order[Jp], child_start[Jp+1], child[Jp-1], level_start[nlev+1], int32
    — on `device`, and its number of levels. Raises past the kernels'
    static limits."""
    key = (parents, str(device))
    if key not in _schedule_cache:
        sched = chain_schedule(parents)
        Jp, nlev = len(parents), len(sched.levels)
        if Jp > MAX_JOINTS or nlev > MAX_LEVELS:
            raise ValueError(f"the chain kernels take at most {MAX_JOINTS} "
                             f"joints on {MAX_LEVELS} levels; this tree has "
                             f"{Jp} on {nlev}")
        child_start = np.cumsum([0] + [len(c) for c in sched.children])
        level_start = np.cumsum([0] + [len(lv) for lv in sched.levels])
        packed = np.concatenate([
            parents, [j for lv in sched.levels for j in lv], child_start,
            [c for cs in sched.children for c in cs], level_start])
        _schedule_cache[key] = (torch.tensor(packed.astype(np.int32),
                                             device=device), nlev)
    return _schedule_cache[key]


def _check_planes(name, t, comps, Jp, B):
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"{name}: expected contiguous float32")
    if tuple(t.shape) != (comps, Jp, B):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != "
                         f"{(comps, Jp, B)}")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def chain_fwd_kernel(rl: torch.Tensor, tl: torch.Tensor, parents: tuple):
    """Kernel 1: (R_l [9, Jp, B], t_l [3, Jp, B]) -> (R_g, t_g)."""
    Jp, B = rl.shape[1], rl.shape[2]
    _check_planes("rl", rl, 9, Jp, B)
    _check_planes("tl", tl, 3, Jp, B)
    if len(parents) != Jp:
        raise ValueError(f"parents has {len(parents)} entries, planes {Jp}")
    sched, nlev = _schedule_on(parents, rl.device)
    lib = _build.load_library()
    rg = torch.empty_like(rl)
    tg = torch.empty_like(tl)
    rc = lib.lemo_chain_fwd(sched.data_ptr(), nlev, rl.data_ptr(),
                            tl.data_ptr(), rg.data_ptr(), tg.data_ptr(), Jp,
                            B, _stream(rl))
    _build.check(lib, rc, "lemo_chain_fwd")
    launches["chain_fwd"] += 1
    return rg, tg


def chain_bwd_kernel(rl, tl, rg, drg, dtg, parents: tuple):
    """Kernel 2: cotangents (dR_g, dt_g) -> (dR_l, dt_l)."""
    Jp, B = rl.shape[1], rl.shape[2]
    for name, t, c in (("rl", rl, 9), ("tl", tl, 3), ("rg", rg, 9),
                       ("drg", drg, 9), ("dtg", dtg, 3)):
        _check_planes(name, t, c, Jp, B)
    if len(parents) != Jp:
        raise ValueError(f"parents has {len(parents)} entries, planes {Jp}")
    sched, nlev = _schedule_on(parents, rl.device)
    lib = _build.load_library()
    drl = torch.empty_like(rl)
    dtl = torch.empty_like(tl)
    rc = lib.lemo_chain_bwd(sched.data_ptr(), nlev, rl.data_ptr(),
                            tl.data_ptr(), rg.data_ptr(), drg.data_ptr(),
                            dtg.data_ptr(), drl.data_ptr(), dtl.data_ptr(),
                            Jp, B, _stream(rl))
    _build.check(lib, rc, "lemo_chain_bwd")
    launches["chain_bwd"] += 1
    return drl, dtl


def _padded(parents: tuple, Jp: int) -> tuple:
    """The chain's parents of Jp planes: joints past the model's hang
    under the root."""
    return tuple(parents) + (0,) * (Jp - len(parents))


def _check_affine(rl, jr, parents):
    Jp, B = rl.shape[1], rl.shape[2]
    if not 1 <= len(parents) <= Jp:
        raise ValueError(f"parents has {len(parents)} entries, planes {Jp}")
    _check_planes("rl", rl, 9, Jp, B)
    _check_planes("jr", jr, 3, Jp, B)
    return len(parents), Jp, B


def chain_affine_fwd_kernel(rl: torch.Tensor, jr: torch.Tensor,
                            parents: tuple):
    """The affine forward: (R_l [9, Jp, B], jr [3, Jp, B]) -> (A [12, Jp,
    B], t_g [3, Jp, B]); `parents` has the model's J <= Jp entries."""
    J, Jp, B = _check_affine(rl, jr, parents)
    sched, nlev = _schedule_on(_padded(parents, Jp), rl.device)
    lib = _build.load_library()
    A = torch.empty((12, Jp, B), dtype=rl.dtype, device=rl.device)
    tg = torch.empty_like(jr)
    rc = lib.lemo_chain_affine_fwd(sched.data_ptr(), nlev, rl.data_ptr(),
                                   jr.data_ptr(), A.data_ptr(), tg.data_ptr(),
                                   J, Jp, B, _stream(rl))
    _build.check(lib, rc, "lemo_chain_affine_fwd")
    launches["chain_fwd"] += 1
    return A, tg


def chain_affine_bwd_kernel(rl, jr, A, dA, dtg, parents: tuple):
    """The affine backward: cotangents (dA, dt_g) -> (dR_l, djr); A is
    the forward's output, whose first 9 rows are R_g."""
    J, Jp, B = _check_affine(rl, jr, parents)
    for name, t, c in (("A", A, 12), ("dA", dA, 12), ("dtg", dtg, 3)):
        _check_planes(name, t, c, Jp, B)
    sched, nlev = _schedule_on(_padded(parents, Jp), rl.device)
    lib = _build.load_library()
    drl = torch.empty_like(rl)
    djr = torch.empty_like(jr)
    rc = lib.lemo_chain_affine_bwd(sched.data_ptr(), nlev, rl.data_ptr(),
                                   jr.data_ptr(), A.data_ptr(), dA.data_ptr(),
                                   dtg.data_ptr(), drl.data_ptr(),
                                   djr.data_ptr(), J, Jp, B, _stream(rl))
    _build.check(lib, rc, "lemo_chain_affine_bwd")
    launches["chain_bwd"] += 1
    return drl, djr


def chain_planes_plain_fwd(rl: torch.Tensor, tl: torch.Tensor,
                           parents: tuple):
    """Plain twin of kernel 1: the same serial walk in PyTorch ops
    (differentiable by autograd)."""
    Jp = rl.shape[1]
    R = [rl[:, 0].reshape(3, 3, -1)]
    t = [tl[:, 0]]
    for j in range(1, Jp):
        p = parents[j]
        Rp = R[p]
        Rl = rl[:, j].reshape(3, 3, -1)
        R.append((Rp[:, :, None, :] * Rl[None, :, :, :]).sum(1))
        t.append((Rp * tl[None, :, j]).sum(1) + t[p])
    rg = torch.stack([r.reshape(9, -1) for r in R], dim=1)
    tg = torch.stack(t, dim=1)
    return rg, tg


def chain_planes_plain_bwd(rl, tl, rg, drg, dtg, parents: tuple):
    """Plain twin of kernel 2: the reverse sweep in PyTorch ops."""
    Jp = rl.shape[1]
    sg = [drg[:, j].reshape(3, 3, -1) for j in range(Jp)]
    st = [dtg[:, j] for j in range(Jp)]
    drl = [None] * Jp
    dtl = [None] * Jp
    for j in range(Jp - 1, 0, -1):
        p = parents[j]
        Gp = rg[:, p].reshape(3, 3, -1)
        Lj = rl[:, j].reshape(3, 3, -1)
        tj = tl[:, j]
        dGj, dtj = sg[j], st[j]
        drl[j] = (Gp[:, :, None, :] * dGj[:, None, :, :]).sum(0)
        dtl[j] = (Gp * dtj[:, None, :]).sum(0)
        sg[p] = sg[p] + ((dGj[:, None, :, :] * Lj[None, :, :, :]).sum(2)
                         + dtj[:, None, :] * tj[None, :, :])
        st[p] = st[p] + dtj
    drl[0], dtl[0] = sg[0], st[0]
    return (torch.stack([d.reshape(9, -1) for d in drl], dim=1),
            torch.stack(dtl, dim=1))


class _ChainPlanes(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rl, tl, parents):
        cpu = rl.device.type == "cpu"
        rg, tg = (chain_planes_plain_fwd if cpu else chain_fwd_kernel)(
            rl, tl, parents)
        ctx.save_for_backward(rl, tl, rg)
        ctx.parents = parents
        return rg, tg

    @staticmethod
    def backward(ctx, drg, dtg):
        rl, tl, rg = ctx.saved_tensors
        cpu = rl.device.type == "cpu"
        drl, dtl = (chain_planes_plain_bwd if cpu else chain_bwd_kernel)(
            rl, tl, rg, drg.contiguous(), dtg.contiguous(), ctx.parents)
        return drl, dtl, None


def _topological(parents: tuple) -> bool:
    """parents[j] < j for every non-root joint: the order both the kernels
    and the plain twins walk in."""
    return all(0 <= p < j for j, p in enumerate(parents) if j > 0)


def chain_planes(rl: torch.Tensor, tl: torch.Tensor, parents: tuple):
    """(R_l, t_l) planes [9|3, Jp, B] -> (R_g, t_g) planes,
    differentiable; parents is a tuple of Jp ints with parents[j] < j."""
    parents = tuple(int(p) for p in parents)
    if not _topological(parents):
        raise ValueError("chain_planes needs parents[j] < j; "
                         "rigid_transform_chain_cuda renumbers the joints "
                         "of any other tree")
    return _ChainPlanes.apply(rl.contiguous(), tl.contiguous(), parents)


_msub_cache: dict = {}


def _msub(parents: tuple, Jp: int, device) -> torch.Tensor:
    """[Jp, Jp] static matrix with t_l = Msub @ jr (t_l[j] = jr[j] -
    jr[parent(j)] for the model's joints but the root; the root and the
    padding joints keep their jr)."""
    key = (parents, Jp, str(device))
    if key not in _msub_cache:
        m = np.eye(Jp, dtype=np.float32)
        for j in range(1, len(parents)):
            m[j, parents[j]] -= 1.0
        _msub_cache[key] = torch.as_tensor(m, device=device)
    return _msub_cache[key]


def _compose_affine(rl, jr, parents: tuple, chain):
    """(A, t_g) through `chain` (an (rl, tl, parents) -> (rg, tg) form)
    and eager ops around it: t_l as one ±1 matrix product, the bone
    affines rel_t[m] = t_g[m] - sum_n R_g[m, n] jr[n] after it."""
    Jp = rl.shape[1]
    tl = torch.einsum("jp,npb->njb", _msub(parents, Jp, rl.device), jr)
    rg, tg = chain(rl, tl, _padded(parents, Jp))
    rel_t = torch.stack([
        tg[m] - (rg[3 * m] * jr[0] + rg[3 * m + 1] * jr[1]
                 + rg[3 * m + 2] * jr[2])
        for m in range(3)])
    return torch.cat([rg, rel_t], dim=0), tg


def chain_affine_plain_fwd(rl, jr, parents: tuple):
    """Plain twin of the affine forward: the serial plain chain with the
    eager ops around it (differentiable by autograd)."""
    return _compose_affine(rl, jr, parents, chain_planes_plain_fwd)


def chain_affine_plain_bwd(rl, jr, A, dA, dtg, parents: tuple):
    """Plain twin of the affine backward: autograd through the plain
    forward, recomputed (so `A`, which the kernel reads R_g from, is not
    needed)."""
    with torch.enable_grad():
        rl_ = rl.detach().requires_grad_(True)
        jr_ = jr.detach().requires_grad_(True)
        out = chain_affine_plain_fwd(rl_, jr_, parents)
        return torch.autograd.grad(out, (rl_, jr_), (dA, dtg))


def chain_affine_planes_unfused(rl, jr, parents: tuple):
    """The affine form as eager ops around `chain_planes` (the chain
    kernel pair on the card): what the body model ran before the affine
    kernels, whose outputs it matches to the bit."""
    return _compose_affine(rl, jr, tuple(int(p) for p in parents),
                           chain_planes)


class _ChainAffine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rl, jr, parents):
        cpu = rl.device.type == "cpu"
        A, tg = (chain_affine_plain_fwd if cpu else chain_affine_fwd_kernel)(
            rl, jr, parents)
        ctx.save_for_backward(rl, jr, A)
        ctx.parents = parents
        return A, tg

    @staticmethod
    def backward(ctx, dA, dtg):
        rl, jr, A = ctx.saved_tensors
        cpu = rl.device.type == "cpu"
        drl, djr = (chain_affine_plain_bwd if cpu else chain_affine_bwd_kernel)(
            rl, jr, A, dA.contiguous(), dtg.contiguous(), ctx.parents)
        return drl, djr, None


def chain_affine_planes(rl: torch.Tensor, jr: torch.Tensor, parents):
    """(R_l [9, Jp, B], rest-pose joints jr [3, Jp, B]) -> (bone affines
    A [12, Jp, B] = [R_g; t_g - R_g jr], t_g [3, Jp, B]), differentiable,
    with t_l[j] = jr[j] - jr[parents[j]] (the root's jr[0]). `parents` has
    the model's J <= Jp entries, parents[j] < j; the joints past J are
    padding under the root with t_l = jr."""
    parents = tuple(int(p) for p in parents)
    if not _topological(parents):
        raise ValueError("chain_affine_planes needs parents[j] < j")
    return _ChainAffine.apply(rl.contiguous(), jr.contiguous(), parents)


def _topological_order(parents: tuple) -> list:
    """The joints root first and each after its parent (by tree depth,
    then index); joint 0 is the root."""
    J = len(parents)
    depth = [0] * J
    for j in range(1, J):
        p, d = j, 0
        while p != 0:
            p, d = parents[p], d + 1
            if d > J:
                raise ValueError(f"parents {parents} is not a tree rooted "
                                 "at joint 0")
        depth[j] = d
    return sorted(range(J), key=lambda j: (depth[j], j))


def rigid_transform_chain_cuda(rot_mats, joints, parents):
    """Drop-in for `lbs.rigid_transform_chain_level` through the chain
    kernels: rot_mats [B, J, 3, 3], joints [B, J, 3], parents [J] ints.
    Returns (posed_joints [B, J, 3], rel [B, J, 3, 4]). A tree that
    numbers a parent after its child runs through the kernels too, on
    joints renumbered into a topological order and back."""
    B, J = joints.shape[0], joints.shape[1]
    parents = np.asarray(parents, np.int64)
    par = tuple(int(p) for p in parents)
    if not _topological(par):
        order = _topological_order(par)
        pos = {j: k for k, j in enumerate(order)}
        new_parents = [0] + [pos[par[j]] for j in order[1:]]
        perm = torch.as_tensor(order, device=joints.device)
        inv = torch.as_tensor([pos[j] for j in range(J)],
                              device=joints.device)
        pj, rel = rigid_transform_chain_cuda(
            rot_mats[:, perm], joints[:, perm], new_parents)
        return pj[:, inv], rel[:, inv]

    par_idx = torch.as_tensor(parents[1:], device=joints.device)
    rel_joints = torch.cat(
        [joints[:, :1], joints[:, 1:] - joints[:, par_idx]], dim=1)

    jpad = _pad_to(J, 8)
    Jp = J + jpad
    parents_padded = tuple(int(p) for p in parents) + (0,) * jpad

    # planes: [B, J, 3, 3] -> [3, 3, J, B] -> [9, Jp, B]
    rl = rot_mats.permute(2, 3, 1, 0).reshape(9, J, B)
    tl = rel_joints.permute(2, 1, 0)
    rl = torch.nn.functional.pad(rl, (0, 0, 0, jpad))
    tl = torch.nn.functional.pad(tl, (0, 0, 0, jpad))

    rg, tg = chain_planes(rl, tl, parents_padded)

    Rg = rg[:, :J].reshape(3, 3, J, B).permute(3, 2, 0, 1)
    tg_ = tg[:, :J].permute(2, 1, 0)                   # [B, J, 3]
    rel_t = tg_ - torch.einsum("bjmn,bjn->bjm", Rg, joints)
    rel = torch.cat([Rg, rel_t[..., None]], dim=-1)
    return tg_, rel


# the entry points' routing is watched (`utils.routing`)
routing.watch(__name__)
