"""Hold the port's self-intersection broad phase against the JAX
package's on the warm-start bodies of a `chip_smoke.py` run.

    python3 scripts/check_coll_broad_phase_jax.py [NPZ ...] [--frames N]

`chip_smoke.py` phase 6 keeps, for each window, the bodies its broad
phase scored and the port's per-frame (n_active, n_within) in
lemo_tpu_torch/_build/prox_smoke/broad_phase_w<window>.npz (the default
inputs). For each file this script runs the JAX package's
`intersection_candidate_scores` (on the CPU, one frame at a time, with
the same faces, part table and margin) on the N frames (default 3) that
span the port's n_active: the largest, the smallest and those between,
and prints both packages' counts. The two sweeps round their gates
differently (the JAX one takes expanded quadratic forms), so razor-edge
pairs may flip: it exits 1 if a count differs by more than 1% of the
port's. A full-size frame (20,080 faces) takes tens of seconds and a few
GB.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def pick_frames(n_active: np.ndarray, n: int) -> list[int]:
    """Frames at evenly spaced ranks of n_active, largest first."""
    order = np.argsort(-n_active, kind="stable")
    ranks = np.linspace(0, len(order) - 1, num=min(n, len(order)))
    return [int(order[int(round(r))]) for r in ranks]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("npz", nargs="*", default=sorted(glob.glob(os.path.join(
        ROOT, "lemo_tpu_torch", "_build", "prox_smoke",
        "broad_phase_w*.npz"))))
    ap.add_argument("--frames", type=int, default=3)
    a = ap.parse_args(argv)
    if not a.npz:
        print("check_coll_broad_phase_jax: no broad-phase files",
              file=sys.stderr)
        return 1

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from lemo_tpu.ops.intersection import intersection_candidate_scores

    rows, ok = [], True
    for path in a.npz:
        d = np.load(path)
        segm, tab = jnp.asarray(d["faces_segm"]), jnp.asarray(d["ign_table"])
        faces = jnp.asarray(d["faces"])
        margin = float(d["margin"])
        score = jax.jit(lambda v: intersection_candidate_scores(
            v, faces, margin=margin, segm=segm, ign_table=tab)[1])
        counts = d["counts"]
        for t in pick_frames(counts[:, 0], a.frames):
            t0 = time.perf_counter()
            j_counts = np.asarray(score(jnp.asarray(d["verts"][t])))
            secs = time.perf_counter() - t0
            port = [int(x) for x in counts[t]]
            jx = [int(x) for x in j_counts]
            diff = [abs(p - j) for p, j in zip(port, jx)]
            agree = all(df <= 0.01 * max(p, 1) for df, p in zip(diff, port))
            ok &= agree
            rows.append({"file": os.path.basename(path), "frame": t,
                         "port": port, "jax": jx, "seconds": secs})
            print(f"{os.path.basename(path)} frame {t}: n_active port "
                  f"{port[0]} jax {jx[0]}, n_within port {port[1]} jax "
                  f"{jx[1]} (F={faces.shape[0]}; {secs:.1f} s)", flush=True)
    print(json.dumps({"frames": rows, "agree": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
