"""Does the clip-folded Stage 2 repeat itself, and match the single-clip
fits, on one CUDA card?

    python3 scripts/check_torch_amass_fold.py

Runs `chip_smoke.py`'s phase-4b corpus path (both AMASS CLIs on the
synthetic corpus) to get the Stage-2 CLI's batches of 4 clips (infill
targets, contact labels, Stage-1 solutions), then for each batch, for 5
and 20 Adam steps, and in three modes (the defaults; under
`torch.use_deterministic_algorithms`; with cuDNN off), fits the batch
folded and as 4 single-clip fits, each twice, and prints:

- the fold against the single-clip fits: the x72 excess over lemo_tpu's
  tolerance (max |d| - 6e-2 |x|, held at 2e-3 by chip_smoke.py) and the
  per-step losses' (max |d| - 2e-3 |l|, held at 2e-5);
- each form against its own repeat: the same x72 excess, and whether
  the bits are equal.

Prints human-readable lines and, last, one JSON object.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _excess(x, ref, rtol) -> float:
    return float(((x - ref).abs() - rtol * ref.abs()).max())


@contextlib.contextmanager
def _mode(name):
    import torch

    if name == "deterministic":
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            yield
        finally:
            torch.use_deterministic_algorithms(False)
    elif name == "cudnn_off":
        with torch.backends.cudnn.flags(enabled=False):
            yield
    else:
        yield


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("check_torch_amass_fold: CUDA is not available",
              file=sys.stderr)
        return 1
    import chip_smoke as cs
    from lemo_tpu_torch import _build, exact_f32_matmuls
    from lemo_tpu_torch.fitting import amass_temp as s2

    exact_f32_matmuls()
    card = cs._card_line()
    print(card, flush=True)
    _build.build_library(verbose=False)
    amass = cs.phase_amass(card)
    rows = []
    for b, call in enumerate(amass["s2_calls"]):
        fargs, fkw = call["factory"]
        target, contact, init72 = call["inputs"]
        C = target.shape[0]
        for mode in ("default", "deterministic", "cudnn_off"):
            for steps in (5, 20):
                def make(factory):
                    return factory(*fargs[:7], num_steps=steps,
                                   weights=fargs[8], device=fkw["device"])

                with _mode(mode):
                    fold = make(s2.make_temporal_fitter_batched)
                    single = make(s2.make_temporal_fitter)
                    xf, lf = fold(target, contact, init72)
                    xf2, _ = fold(target, contact, init72)
                    runs = [[single(target[c], contact[c], init72[c])
                             for c in range(C)] for _ in range(2)]
                xs = torch.stack([o[0] for o in runs[0]])
                ls = torch.stack([o[1] for o in runs[0]])
                xs2 = torch.stack([o[0] for o in runs[1]])
                row = {"batch": b, "mode": mode, "steps": steps,
                       "fold_vs_single_x72_excess": _excess(xf, xs, 6e-2),
                       "fold_vs_single_loss_excess": _excess(lf, ls, 2e-3),
                       "fold_repeat_x72_excess": _excess(xf2, xf, 6e-2),
                       "fold_repeat_equal": bool(torch.equal(xf2, xf)),
                       "single_repeat_x72_excess": _excess(xs2, xs, 6e-2),
                       "single_repeat_equal": bool(torch.equal(xs2, xs))}
                rows.append(row)
                print(f"[fold] batch {b}, {mode}, {steps} steps: fold vs "
                      f"single x72 excess "
                      f"{row['fold_vs_single_x72_excess']:.3e} (tol 2e-3), "
                      f"losses {row['fold_vs_single_loss_excess']:.3e} "
                      f"(tol 2e-5); repeats: fold "
                      f"{row['fold_repeat_x72_excess']:.3e} equal "
                      f"{row['fold_repeat_equal']}, single "
                      f"{row['single_repeat_x72_excess']:.3e} equal "
                      f"{row['single_repeat_equal']} on {card}", flush=True)
    print(json.dumps({"card": card, "rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
