"""The self-intersection cone-energy kernel (csrc/intersection.cu) and
its operands' contract.

Replaces `lemo_tpu/ops/intersection_pallas.py` `_kernel` (pallas_call at
`:267`). One launch takes all T frames and returns, per face, its energy
as a cone owner, dE/dn and dE/ds as a cone owner, dE/d(vertices) as a
vertex supplier and its count of pairs with energy; the
`ops.intersection.ConeEnergy` autograd Function turns them into the
energy and its backward. A warp owns a run of RUN faces in both roles
and culls with each run's bounding sphere (`runs`, from
`ops.intersection.pack_faces`); the kernel keeps its pair queue in
shared memory, so the wrapper allocates the four outputs and no scratch.

Dispatch lives in `ops.intersection.cone_energy_parts`: a CPU tensor goes
to `ops.intersection.cone_energy_plain`, any other tensor to
`cone_energy_kernel` here, which raises unless it is on CUDA.
"""

from __future__ import annotations

import torch

from lemo_tpu_torch import _build
from lemo_tpu_torch._build import check_operand
from lemo_tpu_torch.utils import routing

TILE = 128   # faces per block; Kp is a multiple (kTile in the source)
RUN = 32     # faces per run = lanes per warp (kRun in the source)
PACK = 20    # floats per face in `pack` (kPack in the source)

# launches of the kernel, counted where the wrapper launches it
launches = {"intersection": 0}


def cone_energy_kernel(pack: torch.Tensor, ipack: torch.Tensor,
                       runs: torch.Tensor, ign: torch.Tensor | None):
    """pack [T, Kp, 20] f32, ipack [T|1, Kp, 4] int32, runs [T, Kp/32, 4]
    f32 (`ops.intersection.pack_faces`), ign [P, P] bool or None ->
    (e [T, Kp] f64, rowgrad [T, Kp, 4] f32, dtri [T, Kp, 9] f32,
    active [T, Kp] int32), as `ops.intersection.cone_energy_plain`."""
    T, Kp = pack.shape[0], pack.shape[1]
    if Kp % TILE:
        raise ValueError(f"pack: {Kp} faces is not a multiple of {TILE}")
    check_operand("pack", pack, torch.float32, [(T, Kp, PACK)])
    check_operand("ipack", ipack, torch.int32,
                  [(T, Kp, 4), (1, Kp, 4)])
    check_operand("runs", runs, torch.float32, [(T, Kp // RUN, 4)])
    P = 0
    if ign is not None:
        P = ign.shape[0]
        ign = ign.to(torch.uint8).contiguous()
        check_operand("ign", ign, torch.uint8, [(P, P)])
    dev = pack.device
    e = torch.empty((T, Kp), dtype=torch.float64, device=dev)
    rowgrad = torch.empty((T, Kp, 4), dtype=torch.float32, device=dev)
    dtri = torch.empty((T, Kp, 9), dtype=torch.float32, device=dev)
    active = torch.empty((T, Kp), dtype=torch.int32, device=dev)
    if T * Kp == 0:
        return e, rowgrad, dtri, active
    lib = _build.load_library()
    rc = lib.lemo_cone_energy(
        pack.data_ptr(), ipack.data_ptr(), runs.data_ptr(),
        None if ign is None else ign.data_ptr(), P, e.data_ptr(),
        rowgrad.data_ptr(), dtri.data_ptr(), active.data_ptr(), T, Kp,
        int(ipack.shape[0] == T and T > 1),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, f"lemo_cone_energy (T={T} Kp={Kp} P={P})")
    launches["intersection"] += 1
    return e, rowgrad, dtri, active


# the entry points' routing is watched (`utils.routing`)
routing.watch(__name__)
