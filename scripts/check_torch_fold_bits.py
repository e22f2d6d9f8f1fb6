#!/usr/bin/env python3
"""Which parts of the clip-folded Stage 2 round apart from the
single-clip fit, on one CUDA card?

    python3 scripts/check_torch_fold_bits.py [--clips C] [--steps S]

On chip_smoke.py's full-size synthetic model (PCA hands 12) and seeded
random inputs (C clips of T = 119 frames), under deterministic
algorithms, compares each clip's slice of the fold against the same
computation on that clip alone, bit for bit:

- the body forward's vertices and joints, and the gradient of
  <vertices, G> in every parameter (the body kernels and the torch
  operations around them);
- the smoothness prior's value and gradient in the markers;
- the whole Stage-2 loss's gradient at the start, each variable, and the
  fold's S-step fit against S-step single-clip fits (the x72 excess over
  lemo_tpu's fold tolerance, as phase 4b checks it).

Prints a line a comparison (entries that differ, of how many, the
largest difference) and, last, one JSON object.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

T = 119


def compare(name, fold, single, out) -> None:
    import torch

    a, b = fold.detach(), single.detach()
    d = (a - b).abs()
    row = {"name": name, "differ": int((a != b).sum()), "of": a.numel(),
           "max_abs": float(d.max()) if d.numel() else 0.0,
           "max_rel": float(d.max() / b.abs().max().clamp_min(1e-30))}
    out.append(row)
    print(f"{name}: {row['differ']} of {row['of']} entries differ, max "
          f"|d| {row['max_abs']:.3e} (rel {row['max_rel']:.3e})",
          flush=True)
    if not torch.isfinite(a).all():
        raise AssertionError(f"{name}: not finite")


def main() -> int:
    import torch

    import chip_smoke as cs
    from lemo_tpu_torch import _build, exact_f32_matmuls
    from lemo_tpu_torch.body_model import load_model, make_forward_fn
    from lemo_tpu_torch.data.markers import marker_indices
    from lemo_tpu_torch.data.segments import foot_vertex_ids
    from lemo_tpu_torch.data.stats import GlobalStats
    from lemo_tpu_torch.fitting import amass_temp as s2
    from lemo_tpu_torch.body_model import vposer as vp
    from lemo_tpu_torch.priors.conv_ae import init_smooth_enc

    if not torch.cuda.is_available():
        print("check_torch_fold_bits: CUDA is not available",
              file=sys.stderr)
        return 1
    C = int(sys.argv[sys.argv.index("--clips") + 1]) \
        if "--clips" in sys.argv else 4
    S = int(sys.argv[sys.argv.index("--steps") + 1]) \
        if "--steps" in sys.argv else 5
    exact_f32_matmuls()
    card = cs._card_line()
    print(card, flush=True)
    _build.build_library(verbose=False)
    torch.use_deterministic_algorithms(True, warn_only=True)
    dev = "cuda"
    model = load_model(cs.smoke_model_dict(), use_pca=True,
                       num_pca_comps=12, device=dev)
    fwd = make_forward_fn(model)
    rows: list = []

    # the body model: C clips in one forward against each clip alone
    rng = np.random.RandomState(0)
    p = cs._random_params(model, C * T, rng)
    g = torch.as_tensor(rng.randn(C * T, model.num_verts, 3)
                        .astype(np.float32), device=dev)

    def body(params, gv):
        leaves = {k: v.clone().requires_grad_(True)
                  for k, v in params.items()}
        out = fwd(leaves, model.consts)
        grads = torch.autograd.grad((out["vertices"] * gv).sum(),
                                    list(leaves.values()))
        return out, dict(zip(leaves, grads))

    out_f, grad_f = body(p, g)
    for c in range(C):
        sl = slice(c * T, (c + 1) * T)
        out_s, grad_s = body({k: v[sl] for k, v in p.items()}, g[sl])
        compare(f"body clip {c} vertices", out_f["vertices"][sl],
                out_s["vertices"], rows)
        compare(f"body clip {c} joints", out_f["joints"][sl],
                out_s["joints"], rows)
        for k in grad_s:
            if grad_s[k].abs().max() > 0:
                compare(f"body clip {c} d/d{k}", grad_f[k][sl], grad_s[k],
                        rows)

    # the smoothness prior: batched against one clip at a time
    enc = init_smooth_enc(torch.Generator().manual_seed(1), device=dev)
    stats = GlobalStats.from_numpy(np.zeros((1, 1, 243)), np.ones(243), dev)
    m81 = torch.as_tensor(rng.randn(C, T, 81, 3).astype(np.float32) * 0.3,
                          device=dev).requires_grad_(True)
    j0 = torch.as_tensor(rng.randn(C, 25, 3).astype(np.float32) * 0.3,
                         device=dev)
    from lemo_tpu_torch.data.repr import frame0_normalizer

    Rf, _ = frame0_normalizer(j0)
    for c in range(C):
        compare(f"frame-0 rotation clip {c}", Rf[c],
                frame0_normalizer(j0[c])[0], rows)
    lf = s2.smoothness_prior_loss_batched(enc, m81, j0, stats,
                                          reduce_clips=False)
    (gf,) = torch.autograd.grad(lf.sum(), [m81])
    for c in range(C):
        mc = m81[c].detach().clone().requires_grad_(True)
        ls = s2.smoothness_prior_loss(enc, mc, j0[c], stats)
        (gs,) = torch.autograd.grad(ls, [mc])
        compare(f"smoothness clip {c} value", lf[c], ls, rows)
        compare(f"smoothness clip {c} d/dmarkers", gf[c], gs, rows)

    # the whole Stage-2 loss: the first gradient, and S-step fits
    ids = (marker_indices(False, num_verts=model.num_verts),
           marker_indices(True, num_verts=model.num_verts),
           foot_vertex_ids(model.num_verts))
    vpp = vp.init_vposer(torch.Generator().manual_seed(0), device=dev)
    target = torch.as_tensor(rng.randn(C, T, 67, 3).astype(np.float32)
                             * 0.2, device=dev)
    contact = torch.as_tensor((rng.rand(C, T, 4) > 0.5).astype(np.float32),
                              device=dev)
    init72 = torch.as_tensor(rng.randn(C, T, 72).astype(np.float32) * 0.1,
                             device=dev)
    grabbed: list = []
    real_run_adam = s2.run_adam

    def grab(loss_fn, init, num_steps, lr_table, per_clip=False, **kw):
        leaves = {k: v.detach().clone().requires_grad_(True)
                  for k, v in init.items()}
        loss = loss_fn(leaves)
        loss = loss[0] if per_clip else loss
        grabbed.append(dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values())))))
        return real_run_adam(loss_fn, init, num_steps, lr_table,
                             per_clip=per_clip, **kw)

    args = (model, vpp, enc, stats, *ids)
    s2.run_adam = grab
    try:
        xf, lfold = s2.make_temporal_fitter_batched(
            *args, num_steps=S, device=dev)(target, contact, init72)
        single = s2.make_temporal_fitter(*args, num_steps=S, device=dev)
        outs = [single(target[c], contact[c], init72[c]) for c in range(C)]
    finally:
        s2.run_adam = real_run_adam
    for c in range(C):
        for k, gk in grabbed[1 + c].items():
            compare(f"stage 2 clip {c} first d/d{k}", grabbed[0][k][c], gk,
                    rows)
    xs = torch.stack([o[0] for o in outs])
    ls = torch.stack([o[1] for o in outs])
    compare(f"stage 2 x72 after {S} steps", xf, xs, rows)
    compare(f"stage 2 losses over {S} steps", lfold, ls, rows)
    excess = float(((xf - xs).abs() - 6e-2 * xs.abs()).max())
    print(f"stage 2 after {S} steps: x72 max |d| - 6e-2|x| = "
          f"{excess:.3e} (phase 4b holds it at 2e-3) on {card}", flush=True)
    print(json.dumps({"card": card, "C": C, "T": T, "steps": S,
                      "x72_excess": excess, "rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
