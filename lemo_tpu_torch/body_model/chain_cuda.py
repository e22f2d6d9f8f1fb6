"""Kinematic-chain composition: the CUDA kernel pair and its plain twins.

Port of `lemo_tpu/body_model/chain_pallas.py`. Planes keep the TPU
layout — rotations [9, Jp, B] (row k = 3m+n holds R[m, n]) and
translations [3, Jp, B] — which on the GPU is the coalesced one: the
kernel (`csrc/chain.cu`) runs one thread per frame.

    forward:   G[j] = G[p] @ L[j],  t_g[j] = R_g[p] t_l[j] + t_g[p]
    backward:  dL[j] = G[p]^T dG[j],  dt_l[j] = R_g[p]^T dt_g[j]
               dG[p] += dG[j] L[j]^T + dt_g[j] (x) t_l[j],  dt_g[p] += dt_g[j]

Dispatch: a CPU tensor goes to the plain twin; any other tensor goes to
the kernel, which checks that it is on CUDA and raises otherwise.
"""

from __future__ import annotations

import numpy as np
import torch

from lemo_tpu_torch import _build


def _pad_to(x: int, mult: int) -> int:
    return (-x) % mult


# launches of each kernel, counted where the wrapper launches it
launches = {"chain_fwd": 0, "chain_bwd": 0}

_parents_cache: dict = {}


def _parents_on(parents: tuple, device) -> torch.Tensor:
    key = (parents, str(device))
    if key not in _parents_cache:
        _parents_cache[key] = torch.tensor(parents, dtype=torch.int32,
                                           device=device)
    return _parents_cache[key]


def _check_planes(name, t, comps, Jp, B):
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"{name}: expected contiguous float32")
    if tuple(t.shape) != (comps, Jp, B):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != "
                         f"{(comps, Jp, B)}")


def chain_fwd_kernel(rl: torch.Tensor, tl: torch.Tensor, parents: tuple):
    """Kernel 1: (R_l [9, Jp, B], t_l [3, Jp, B]) -> (R_g, t_g)."""
    Jp, B = rl.shape[1], rl.shape[2]
    _check_planes("rl", rl, 9, Jp, B)
    _check_planes("tl", tl, 3, Jp, B)
    if len(parents) != Jp:
        raise ValueError(f"parents has {len(parents)} entries, planes {Jp}")
    lib = _build.load_library()
    par = _parents_on(parents, rl.device)
    rg = torch.empty_like(rl)
    tg = torch.empty_like(tl)
    rc = lib.lemo_chain_fwd(par.data_ptr(), rl.data_ptr(), tl.data_ptr(),
                            rg.data_ptr(), tg.data_ptr(), Jp, B,
                            torch.cuda.current_stream(rl.device).cuda_stream)
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
    lib = _build.load_library()
    par = _parents_on(parents, rl.device)
    drl = torch.empty_like(rl)
    dtl = torch.empty_like(tl)
    sg = torch.empty_like(rl)      # running dG scratch
    st = torch.empty_like(tl)      # running dt_g scratch
    rc = lib.lemo_chain_bwd(par.data_ptr(), rl.data_ptr(), tl.data_ptr(),
                            rg.data_ptr(), drg.data_ptr(), dtg.data_ptr(),
                            drl.data_ptr(), dtl.data_ptr(), sg.data_ptr(),
                            st.data_ptr(), Jp, B,
                            torch.cuda.current_stream(rl.device).cuda_stream)
    _build.check(lib, rc, "lemo_chain_bwd")
    launches["chain_bwd"] += 1
    return drl, dtl


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
