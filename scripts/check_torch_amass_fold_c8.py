"""Where does the clip-folded Stage 2 at C = 8 round apart from its clips
fitted alone? On one CUDA card (on an H100 the rest joints' product over
all 1,024 columns did, until `lbs.lane_matmul` ran it a LANE of columns
at a time):

    python3 scripts/check_torch_amass_fold_c8.py

Runs `chip_smoke.py`'s phase-4b corpus path (both AMASS CLIs) for the
Stage-2 inputs, joins its batches into the 8-clip batch of the C sweep
(both genders' clips on the male model), and prints, under
`torch.use_deterministic_algorithms`:

1. whether the fold's start (`amass_temp._init_vars` of all 8 x T rows:
   axis-angle -> 6-D through Rodrigues) equals each clip's own, bit for
   bit;
2. at one start shared by both forms, the first step's forward and
   gradients of the folded loss against each clip's own loss: the
   vertices, each term, and the gradient of each optimized variable
   (max |d| a clip; 0 where bit-equal);
3. the 5-step fold against the 8 single-clip fits (x72 bit-equal clips,
   max |d|) as shipped and under each variant named on the command line
   (default all): `init_by_clip` (the fold's start computed a clip at a
   time), `rodrigues_elementwise` (`aa_to_matrot`'s K @ K as elementwise
   products on the card), `jr_one_product` (the body model's rest
   joints as one product of all the fold's columns, the form before
   `lbs.lane_matmul`);
4. the fused forward's stages (`lbs._lbs_fused`: rest joints, local
   rotations, the chain's affines, the vertices) at the fold's 952
   frames against each clip's 119, max |d| a clip, and the rest joints'
   product at N = 1,024 against N = 128 on the same columns.

Prints human-readable lines and, last, one JSON object.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

VARIANTS = ("jr_one_product", "init_by_clip", "rodrigues_elementwise")


@contextlib.contextmanager
def variant(name):
    import torch

    from lemo_tpu_torch.body_model import lbs
    from lemo_tpu_torch.fitting import amass_temp as s2
    from lemo_tpu_torch.ops import rotations

    if name == "jr_one_product":
        real = lbs.lane_matmul
        lbs.lane_matmul = torch.matmul
        try:
            yield
        finally:
            lbs.lane_matmul = real
    elif name == "init_by_clip":
        real = s2._init_vars

        def init_vars(init72):
            if init72.dim() < 3:
                return real(init72)
            per = [real(x) for x in init72]
            return {k: torch.stack([p[k] for p in per]) for k in per[0]}

        s2._init_vars = init_vars
        try:
            yield
        finally:
            s2._init_vars = real
    elif name == "rodrigues_elementwise":
        real = rotations.aa_to_matrot

        def aa_to_matrot(aa):
            batch_shape = aa.shape[:-1]
            a = aa.reshape(-1, 3)
            angle = torch.linalg.norm(a + rotations._EPS, dim=1, keepdim=True)
            r = a / angle
            cos, sin = torch.cos(angle)[:, None], torch.sin(angle)[:, None]
            rx, ry, rz = r[:, 0], r[:, 1], r[:, 2]
            z = torch.zeros_like(rx)
            K = torch.stack([z, -rz, ry, rz, z, -rx, -ry, rx, z],
                            dim=1).reshape(-1, 3, 3)
            KK = (K[:, :, 0:1] * K[:, 0:1, :] + K[:, :, 1:2] * K[:, 1:2, :]) \
                + K[:, :, 2:3] * K[:, 2:3, :]
            ident = torch.eye(3, dtype=a.dtype, device=a.device)[None]
            return (ident + sin * K + (1.0 - cos) * KK).reshape(
                *batch_shape, 3, 3)

        rotations.aa_to_matrot = aa_to_matrot
        s2_real = s2.aa_to_rot6d if hasattr(s2, "aa_to_rot6d") else None
        if s2_real is not None:
            s2.aa_to_rot6d = lambda x: rotations.matrot_to_rot6d(
                aa_to_matrot(x))
        try:
            yield
        finally:
            rotations.aa_to_matrot = real
            if s2_real is not None:
                s2.aa_to_rot6d = s2_real
    else:
        yield


def _first_step(s2, fargs, fkw, args):
    """The folded loss of all clips and each clip's own loss at one start
    (the fold's), with the forward's vertices and each variable's
    gradient: {name: max |d| a clip}."""
    import torch

    from lemo_tpu_torch.body_model import make_forward_fn
    from lemo_tpu_torch.fitting import params as P

    model, vpp, enc, stats, ids67, ids81, foot = fargs[:7]
    weights = fargs[8]
    dev = fkw["device"]
    _, vpp, enc, stats, ids67, ids81, (foot_t, slices) = s2._fitter_setup(
        model, vpp, enc, stats, ids67, ids81, foot, dev)
    fwd = make_forward_fn(model)
    num_expr = model.config.num_expressions
    target, contact, init72 = args
    C, T = target.shape[:2]
    start = {k: v.detach() for k, v in s2._init_vars(init72).items()}

    def terms(v, shape10, tgt, cl, rows):
        n = tgt.shape[0] if tgt.dim() == 4 else 1
        x72 = s2._x72(v, shape10).reshape(n, T, 72)
        out = fwd(P.smplx_params_from_72(x72.reshape(n * T, 72), vpp,
                                         num_expr, decode_rows=rows),
                  model.consts, rows=rows)
        verts = out["vertices"]
        verts.retain_grad()
        t = {"verts": verts}
        mk = s2.take_rows(verts, ids67).reshape(n, T, -1, 3)
        t["rec_markers"] = (mk - tgt.reshape(n, T, -1, 3)).abs().mean(
            dim=(1, 2, 3))
        m81 = s2.take_rows(verts, ids81).reshape(n, T, -1, 3)
        j0 = out["joints"].reshape(n, T, -1, 3)[:, 0, :25]
        t["smooth"] = s2.smoothness_prior_loss_batched(
            enc, m81, j0, stats, reduce_clips=False)
        feet = s2.take_rows(verts, foot_t).reshape(n, T, -1, 3)
        t["contact_vel"] = s2.contact_friction_loss_batched(
            feet, cl.reshape(n, T, 4), slices, reduce_clips=False)
        total = (weights.rec_markers * t["rec_markers"]
                 + weights.smooth * t["smooth"]
                 + weights.contact_vel * t["contact_vel"]).sum()
        total.backward()
        return t

    def leaves(sl):
        return {k: v[sl].clone().requires_grad_(True)
                for k, v in start.items()}

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        vf = leaves(slice(None))
        tf = terms(vf, init72[..., 6:16], target, contact, T)
        diff: dict = {}
        for c in range(C):
            vs = leaves(c)
            ts = terms(vs, init72[c, :, 6:16], target[c], contact[c], T)
            pairs = {"verts": (tf["verts"].detach().reshape(C, T, -1, 3)[c],
                               ts["verts"].detach()),
                     "verts.grad": (tf["verts"].grad.reshape(C, T, -1, 3)[c],
                                    ts["verts"].grad)}
            for k in ("rec_markers", "smooth", "contact_vel"):
                pairs[k] = (tf[k].detach()[c], ts[k].detach()[0])
            for k in vf:
                pairs[f"{k}.grad"] = (vf[k].grad[c], vs[k].grad)
            for k, (a, b) in pairs.items():
                diff.setdefault(k, []).append(float((a - b).abs().max()))
    finally:
        torch.use_deterministic_algorithms(False)
    return diff


def _stages(model, params):
    """`lbs._lbs_fused`'s intermediates for SMPL-X params [B, ...]:
    {name: tensor with the frame axis last}."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from lemo_tpu_torch.body_model import lbs, smplx
    from lemo_tpu_torch.body_model.chain_cuda import chain_affine_planes
    from lemo_tpu_torch.body_model.vertex_cuda import \
        fused_lbs_vertices_planes

    fc = model.consts
    pose = smplx.full_pose_from_params(params, fc, model.config, rows=119)
    shape = torch.cat([params["betas"], params["expression"]], dim=1)
    B = shape.shape[0]
    Jp = fc["lbs_w_pad"].shape[1]
    J = fc["j_ext"].shape[0] // 3
    Bp = B + (-B) % lbs.LANE
    shape_T = F.pad(shape.T, (0, Bp - B))
    ones = torch.ones((1, Bp), dtype=shape_T.dtype, device=shape.device)
    jr = lbs.lane_matmul(fc["j_ext"], torch.cat([shape_T, ones])).reshape(
        3, J, Bp)
    jr = F.pad(jr, (0, 0, 0, Jp - J))
    p_pl = pose.reshape(B, J, 3).permute(2, 1, 0)
    rl = lbs.aa_to_matrot_planes(F.pad(p_pl, (0, Bp - B, 0, Jp - J)))
    A_pl, tg = chain_affine_planes(
        rl, jr, np.asarray([int(p) for p in model.parents], np.int64))
    ident_k = torch.eye(3, dtype=rl.dtype, device=rl.device).reshape(9, 1, 1)
    pf = (rl[:, 1:J, :] - ident_k).reshape(9 * (J - 1), Bp)
    catT = torch.cat([shape_T, pf, ones])
    out = fused_lbs_vertices_planes(catT, A_pl, fc["fused_dirs"],
                                    fc["lbs_w_pad"])
    return {"pose": pose.T, "jr": jr, "rl": rl, "A_pl": A_pl, "tg": tg,
            "catT": catT, "verts": out}


def _forward_stages(s2, fargs, fkw, args) -> dict:
    import torch

    from lemo_tpu_torch.fitting import params as P

    dev = fkw["device"]
    model, vpp = fargs[0], {k: v.to(dev) for k, v in fargs[1].items()}
    target, contact, init72 = args
    C, T = target.shape[:2]
    x72 = s2._x72(s2._init_vars(init72), init72[..., 6:16])
    ne = model.config.num_expressions
    with torch.no_grad():
        fold = _stages(model, P.smplx_params_from_72(
            x72.reshape(C * T, 72), vpp, ne, decode_rows=T))
        diff: dict = {}
        for c in range(C):
            one = _stages(model, P.smplx_params_from_72(x72[c], vpp, ne))
            for k, v in one.items():
                a = fold[k][..., c * T:(c + 1) * T]
                diff.setdefault(k, []).append(
                    float((a - v[..., :T]).abs().max()))
        j_ext = model.consts["j_ext"]
        cat = torch.randn(j_ext.shape[1], 1024, device=dev)
        wide = torch.matmul(j_ext, cat)
        narrow = torch.matmul(j_ext, cat[:, :128].contiguous())
        diff["j_ext product N=1024 vs 128, first 128 columns"] = float(
            (wide[:, :128] - narrow).abs().max())
    return diff


def main(argv=None) -> int:
    import torch

    if not torch.cuda.is_available():
        print("check_torch_amass_fold_c8: CUDA is not available",
              file=sys.stderr)
        return 1
    names = list(argv if argv is not None else sys.argv[1:]) or \
        list(VARIANTS)
    import chip_smoke as cs
    from lemo_tpu_torch import _build, exact_f32_matmuls
    from lemo_tpu_torch.fitting import amass_temp as s2

    exact_f32_matmuls()
    card = cs._card_line()
    print(card, flush=True)
    _build.build_library(verbose=False)
    amass = cs.phase_amass(card)
    fargs, fkw = amass["s2_calls"][0]["factory"]
    fold8 = [x[:8] for x in cs._sweep_inputs(amass)]
    init72 = fold8[2]
    out: dict = {"card": card}
    a = s2._init_vars(init72)
    eq = [all(torch.equal(a[k][c], s2._init_vars(init72[c])[k]) for k in a)
          for c in range(8)]
    out["init_bit_equal_by_clip"] = eq
    print(f"[c8] the fold's start equals each clip's own: {eq}", flush=True)
    out["first_step_max_abs_by_clip"] = _first_step(s2, fargs, fkw, fold8)
    for k, v in out["first_step_max_abs_by_clip"].items():
        print(f"[c8] first step at a shared start, fold vs each clip: {k} "
              f"max |d| by clip {v}", flush=True)

    out["forward_stages_max_abs_by_clip"] = _forward_stages(
        s2, fargs, fkw, fold8)
    for k, v in out["forward_stages_max_abs_by_clip"].items():
        print(f"[c8] forward stage {k}, fold of 8 vs each clip: max |d| {v}",
              flush=True)

    def fitter(make, steps):
        return make(*fargs[:7], num_steps=steps, weights=fargs[8],
                    device=fkw["device"])

    out["fits"] = {}
    for name in ["shipped"] + names:
        with variant(name):
            row = cs._fold_vs_single(fitter, s2.make_temporal_fitter_batched,
                                     s2.make_temporal_fitter, fold8)
        out["fits"][name] = row
        print(f"[c8] {name}: {row['clips_bit_equal']} of 8 clips' x72 "
              f"bit-equal to their own fits, x72 max |d| by clip "
              f"{row['x72_max_abs_by_clip']} on {card}", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    if os.environ.get("PYTHONHASHSEED") != "0":
        os.execve(sys.executable, [sys.executable] + sys.argv,
                  {**os.environ, "PYTHONHASHSEED": "0"})
    sys.exit(main())
