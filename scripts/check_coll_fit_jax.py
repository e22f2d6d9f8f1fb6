"""Does the JAX package's PROX fit drive the body into itself as the
port's does? Both packages fit the same two windows on the CPU.

    JAX_PLATFORMS=cpu python scripts/check_coll_fit_jax.py \
        [--num_verts 4000] [--batch 30] [--steps 100] [--out FILE]

Writes a synthetic recording with the port's writer (the smooth-surface
tube body of `--num_verts` vertices at pose scale 0.35, as
`chip_smoke.py` phase 6 writes its full-size one, and a 27-part
segmentation pkl), then runs `run_prox_fitting` of `lemo_tpu` and of
`lemo_tpu_torch` on it with `cfg_files/PROXD_temp_S3_all_terms.yaml` as
shipped (interpenetration on at coll weight 1e-5, auto-grown candidates;
windows in sequence, `--steps` Adam steps each, `--batch` frames a
window, so that the recording holds exactly two windows). Both get the
same assets: the recording's VPoser, a seeded smoothness encoder, the
shipped infill AE and statistics.

Prints, for each window and package, the self-intersection broad
phase's largest per-frame n_active (faces on firing pairs at warm
start), n_within (faces within the margin of a partner) and the K chosen
from them, and the coll term's first and final values; then one JSON
object (also written to `--out`). Window 1 starts from the recording's
own PROXD fits; window 2 from window 1's fit, so its counts say how far
each package's fit drove the body into itself.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
CFG = os.path.join(ROOT, "cfg_files", "PROXD_temp_S3_all_terms.yaml")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--num_verts", type=int, default=4000)
    ap.add_argument("--batch", type=int, default=30)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--pose_scale", type=float, default=0.35)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch

    from lemo_tpu.body_model import load_model as j_load
    from lemo_tpu.config import parse_config as j_parse
    from lemo_tpu.data.stats import GlobalStats as JGlobal
    from lemo_tpu.data.stats import Local4ChanStats as JLocal
    from lemo_tpu.fitting.prox import driver as j_driver
    from lemo_tpu.priors.conv_ae import init_smooth_enc
    from lemo_tpu_torch.body_model import load_model as t_load
    from lemo_tpu_torch.config import parse_config as t_parse
    from lemo_tpu_torch.convert import from_numpy_tree
    from lemo_tpu_torch.fitting.prox import driver as t_driver
    from lemo_tpu_torch.testing.synthetic import synthetic_smplx_npz, \
        write_part_segm_pkl
    from lemo_tpu_torch.testing.synthetic_prox import \
        write_synthetic_prox_recording

    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
    frames = a.batch + int(a.batch * 0.7)
    base = tempfile.mkdtemp()
    md = synthetic_smplx_npz(num_verts=a.num_verts, smooth_surface=True)
    info = write_synthetic_prox_recording(
        os.path.join(base, "data"), num_frames=frames, model_dict=md,
        seed=0, pose_scale=a.pose_scale)
    pkl = os.path.join(base, "parts_segm.pkl")
    write_part_segm_pkl(pkl, md["f"], num_parts=27)

    rng = np.random.RandomState(1)
    smooth = JGlobal(Xmean=rng.randn(1, 1, 243) * 0.1,
                     Xstd=np.ones(243) * 0.05)
    enc = {k: np.asarray(v) for k, v in
           init_smooth_enc(jax.random.PRNGKey(0)).items()}
    assets_dir = os.path.join(ROOT, "lemo_tpu_torch", "assets")
    ae = dict(np.load(os.path.join(assets_dir, "infill_ae.npz")))
    stats = JLocal.load(os.path.join(assets_dir, "infill_stats.npz"))
    vpp = {k: v.cpu().numpy() for k, v in info["vposer_params"].items()}

    def argv_for(out):
        return ["--config", CFG, "--recording_dir", info["recording_dir"],
                "--part_segm_fn", pkl, "--output_folder", out,
                "--batch_size", str(a.batch), "--maxiters", str(a.steps),
                "--flip", "false"]

    j_cfg = j_parse(argv_for(tempfile.mkdtemp()))
    t_cfg = t_parse(argv_for(tempfile.mkdtemp()))
    j_model = j_load(md, use_pca=True, num_pca_comps=12)
    segm, tab = j_driver.load_part_segm(pkl, j_model.faces,
                                        j_cfg.ign_part_pairs)
    j_assets = j_driver.ProxAssets(
        model=j_model, faces_segm=segm, ign_table=tab,
        vposer_params={k: jnp.asarray(v) for k, v in vpp.items()},
        smooth_enc_params={k: jnp.asarray(v) for k, v in enc.items()},
        smooth_stats=smooth,
        infill_ae_params={k: jnp.asarray(v) for k, v in ae.items()},
        infill_stats=stats)
    t_model = t_load(md, use_pca=True, num_pca_comps=12, device="cpu")
    t_segm, t_tab = t_driver.part_filter(t_cfg, t_model.faces)
    t_assets = t_driver.ProxAssets(
        model=t_model, faces_segm=t_segm, ign_table=t_tab,
        vposer_params=from_numpy_tree(vpp, "cpu"),
        smooth_enc_params=from_numpy_tree(enc, "cpu"),
        smooth_stats=from_numpy_tree(smooth, "cpu"),
        infill_ae_params=from_numpy_tree(ae, "cpu"),
        infill_stats=from_numpy_tree(stats, "cpu"))

    # lemo_tpu's counts and K, read where its driver computes them
    j_seen: list = []
    real_scores, real_pick = (j_driver._coll_candidate_scores,
                              j_driver._coll_pick_K)

    def scores_spy(cfg, assets, warm):
        s, c = real_scores(cfg, assets, warm)
        j_seen.append({"n_active": int(c[:, 0].max()),
                       "n_within": int(c[:, 1].max())})
        return s, c

    def pick_spy(cfg, n_active, n_within, F):
        K = real_pick(cfg, n_active, n_within, F)
        j_seen[-1]["K"] = K
        return K

    j_driver._coll_candidate_scores = scores_spy
    j_driver._coll_pick_K = pick_spy
    t0 = time.perf_counter()
    try:
        j_res = j_driver.run_prox_fitting(j_cfg, j_assets, max_windows=2,
                                          verbose=False)
    finally:
        j_driver._coll_candidate_scores = real_scores
        j_driver._coll_pick_K = real_pick
    j_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    t_res = t_driver.run_prox_fitting(t_cfg, t_assets, max_windows=2,
                                      verbose=False)
    t_s = time.perf_counter() - t0

    rows = []
    for w in range(2):
        jc = j_res[w].term_history["self_penetration_loss"]
        tc = t_res[w].term_history["self_penetration_loss"]
        bp = t_res[w].broad_phase
        row = {"window": w + 1,
               "jax": dict(j_seen[w], coll_first=float(jc[0]),
                           coll_final=float(jc[-1]),
                           final_loss=float(j_res[w].final_loss)),
               "port": {"n_active": int(bp["n_active"]),
                        "n_within": int(bp["n_within"]), "K": int(bp["K"]),
                        "coll_first": float(tc[0]),
                        "coll_final": float(tc[-1]),
                        "final_loss": float(t_res[w].final_loss)}}
        rows.append(row)
        print(f"window {w + 1}: lemo_tpu {row['jax']}; port {row['port']}",
              flush=True)
    out = {"num_verts": a.num_verts,
           "faces": int(np.asarray(md["f"]).shape[0]),
           "frames": frames, "batch": a.batch, "steps": a.steps,
           "pose_scale": a.pose_scale, "seconds": {"lemo_tpu": j_s,
                                                   "port": t_s},
           "windows": rows}
    print(json.dumps(out), flush=True)
    if a.out:
        with open(a.out, "w") as fh:
            json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
