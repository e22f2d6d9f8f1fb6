#!/usr/bin/env python3
"""How far the clip-folded Stage 2 parts from the single-clip fits it
folds, in each package alone on the CPU.

    JAX_PLATFORMS=cpu python scripts/check_fold_gap_cpu.py [--steps 20]

On the synthetic 400-vertex model of tests/test_torch_stage2_batched.py
(C = 3 clips of T = 12 frames, the same seeded targets, contact labels
and starts, seeded VPoser and smoothness encoder), each package fits the
C clips once folded (`make_temporal_fitter_batched`, impl 'fold') and
once clip by clip (`make_temporal_fitter`) for --steps Adam steps, and
the script prints, per package, the fold's gap to the single-clip fits:
the largest |x72| difference and where it lies, the count of entries
over lemo_tpu's fold tolerance (rtol 6e-2, atol 2e-3), and the largest
loss difference. The port runs its card path, the fused vertex
constants, through the kernels' plain versions. Prints one JSON line a
package last.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

C, T = 3, 12
NAMES = ["transl"] * 3 + ["global_orient"] * 3 + ["betas"] * 10 + \
    ["vposer_z"] * 32 + ["left_hand"] * 12 + ["right_hand"] * 12


def gap(x_fold, x_single, l_fold, l_single) -> dict:
    d = np.abs(x_fold - x_single)
    worst = np.unravel_index(np.argmax(d), d.shape)
    off = ~np.isclose(x_fold, x_single, rtol=6e-2, atol=2e-3)
    by_part: dict = {}
    for c, t, k in np.argwhere(off):
        by_part[NAMES[k]] = by_part.get(NAMES[k], 0) + 1
    return {"x72_max_abs": float(d.max()),
            "x72_worst": {"clip": int(worst[0]), "frame": int(worst[1]),
                          "entry": NAMES[worst[2]]},
            "x72_excess": float((d - 6e-2 * np.abs(x_single)).max()),
            "entries_over_tol": int(off.sum()), "of": int(off.size),
            "over_tol_by_part": by_part,
            "loss_max_abs": float(np.abs(l_fold - l_single).max()),
            "loss_max_rel": float((np.abs(l_fold - l_single)
                                   / np.abs(l_single)).max())}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import torch

    from lemo_tpu.body_model import load_model as j_load
    from lemo_tpu.body_model import vposer as j_vp
    from lemo_tpu.data import markers as j_markers
    from lemo_tpu.data import segments as j_segments
    from lemo_tpu.data.stats import GlobalStats as JStats
    from lemo_tpu.fitting import amass_temp as j_s2
    from lemo_tpu.priors.conv_ae import init_smooth_enc
    from lemo_tpu.testing.synthetic import synthetic_smplx_npz
    from lemo_tpu_torch.body_model import load_model as t_load
    from lemo_tpu_torch.convert import from_numpy_tree
    from lemo_tpu_torch.fitting import amass_temp as t_s2

    torch.set_num_threads(2)
    md = synthetic_smplx_npz(num_verts=400, seed=4)
    vpp = {k: np.asarray(v) for k, v in
           j_vp.init_vposer(jax.random.PRNGKey(0)).items()}
    enc = {k: np.asarray(v) for k, v in
           init_smooth_enc(jax.random.PRNGKey(1)).items()}
    stats = JStats(Xmean=np.zeros((1, 1, 243)), Xstd=np.ones(243))
    ids = (j_markers.marker_indices(False, num_verts=400),
           j_markers.marker_indices(True, num_verts=400),
           j_segments.foot_vertex_ids(num_verts=400))
    rng = np.random.RandomState(7)
    data = (rng.randn(C, T, 67, 3).astype(np.float32) * 0.2,
            (rng.rand(C, T, 4) > 0.5).astype(np.float32),
            rng.randn(C, T, 72).astype(np.float32) * 0.1)
    S = args.steps
    out = {}

    jm = j_load(md, use_pca=True, num_pca_comps=12)
    jargs = (jm, vpp, enc, stats, *ids)
    fold = j_s2.make_temporal_fitter_batched(*jargs, num_steps=S,
                                             impl="fold")
    xf, lf = (np.asarray(a) for a in fold(*(jnp.asarray(a) for a in data)))
    single = j_s2.make_temporal_fitter(*jargs, num_steps=S)
    outs = [single(*(jnp.asarray(a[c]) for a in data)) for c in range(C)]
    xs = np.stack([np.asarray(o[0]) for o in outs])
    ls = np.stack([np.asarray(o[1]) for o in outs])
    out["lemo_tpu"] = gap(xf, xs, lf, ls)

    tm = t_load(md, use_pca=True, num_pca_comps=12, build_fused=True,
                device="cpu")
    port = tuple(from_numpy_tree(p, "cpu") for p in (vpp, enc, stats))
    targs = (tm, *port, *ids)
    fold = t_s2.make_temporal_fitter_batched(*targs, num_steps=S,
                                             device="cpu")
    td = [torch.as_tensor(a) for a in data]
    xf, lf = (a.numpy() for a in fold(*td))
    single = t_s2.make_temporal_fitter(*targs, num_steps=S, device="cpu")
    outs = [single(*(a[c] for a in td)) for c in range(C)]
    xs = np.stack([o[0].numpy() for o in outs])
    ls = np.stack([o[1].numpy() for o in outs])
    out["lemo_tpu_torch"] = gap(xf, xs, lf, ls)

    for name, row in out.items():
        print(json.dumps({"package": name, "C": C, "T": T, "steps": S,
                          **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
