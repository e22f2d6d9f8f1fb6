"""How far apart two fits of the same PROX window land, on one CUDA card.

    python3 scripts/prox_fit_spread.py [--repeats 3]

Runs `chip_smoke.py`'s phase-6 workload (the full-size synthetic
recording, cfg_files/PROXD_temp_S3_all_terms.yaml with interpenetration
off, 100 Adam steps per window) once through the kernels, then refits
each window from that run's inputs `--repeats` times through the kernels
and through the plain versions of the kernels, with PyTorch's default
(atomic, order-varying) backward and with
`torch.use_deterministic_algorithms(True)`. For each refit it prints the
relative difference to the first kernel fit of the last step's loss and
of the mean loss over the last quarter of steps: the spread that any
comparison of whole fits has to stand above.

Prints human-readable lines and, last, one JSON object.
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import argparse

    import numpy as np
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=3)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("prox_fit_spread: CUDA is not available", file=sys.stderr)
        return 1

    import chip_smoke as cs
    from lemo_tpu_torch import _build, exact_f32_matmuls
    from lemo_tpu_torch.body_model import load_model
    from lemo_tpu_torch.testing.synthetic import synthetic_smplx_npz

    exact_f32_matmuls()
    card = cs._card_line()
    print(card, flush=True)
    _build.build_library()
    md = synthetic_smplx_npz(full_size=True)
    model = load_model(md, use_pca=True, num_pca_comps=12, device="cuda")
    cs.PROX_DIR = os.path.join(cs.ROOT, "lemo_tpu_torch", "_build",
                               "prox_spread")
    _, results, _, fits, _, _ = cs.phase_prox(model, md, card)

    def last_quarter(h):
        return float(np.mean(h[-(len(h) // 4):]))

    rows = []
    for plain in (False, True):
        for det in (False, True):
            for rep in range(a.repeats):
                res, _ = cs.refit_windows(fits, plain, det)
                for w, (r0, r) in enumerate(zip(results, res)):
                    step = abs(r.final_loss - r0.final_loss) / \
                        abs(r0.final_loss)
                    lq = abs(last_quarter(r.loss_history)
                             - last_quarter(r0.loss_history)) / \
                        abs(last_quarter(r0.loss_history))
                    row = {"path": "plain" if plain else "kernels",
                           "deterministic": det, "repeat": rep,
                           "window": w + 1, "rel_last_step": step,
                           "rel_last_quarter_mean": lq}
                    rows.append(row)
                    print(f"[spread] {row['path']:7s} det={det!s:5s} "
                          f"rep {rep} window {w + 1}: last step {step:.3e}, "
                          f"last-quarter mean {lq:.3e} (vs the first kernel "
                          f"fit) on {card}", flush=True)
    print(json.dumps({"card": card, "rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
