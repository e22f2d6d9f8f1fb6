"""How far do the folded fits round from the fits they fold, on one CUDA
card?

    python3 scripts/check_torch_fold_rounding.py [--amass] [--no-prox]
        [--decode] [--amass-dir DIR]

PROX (by default): on `chip_smoke.py`'s phase-6 recording (170 frames,
two windows) with cfg_files/PROXD_temp_S3.yaml, one window-parallel run
without polish gives the fold's inputs; then, under
`torch.use_deterministic_algorithms`, for 1, 5, 6 and 10 Adam steps,
window 1 is fitted by the sequential fitter, by the two-window fold and
by a fold of window 1 alone. Prints each fold's largest transl gap (m)
and loss gap (relative) to the sequential fit, and whether it is
bit-equal.

`--amass`: `chip_smoke.py`'s phase-4b corpus and both CLIs, then, for
each Stage-2 batch of the CLI, the folded fit against its single-clip
fits (5 steps, deterministic algorithms), as phase 4b checks its first
batch: the x72 excess over lemo_tpu's tolerance (max |d| - 6e-2 |x|,
held at 2e-3) and the losses' (max |d| - 2e-3 |l|, held at 2e-5). The
synthetic male and female models are seeded with Python's string hash,
so the corpus follows PYTHONHASHSEED, which is printed.

The fold's VPoser decode is checked in three forms, each a stand-in for
`vposer._linear`, the decoder's linear layer: "one" runs one matrix
product of all the fold's rows, "split" one product a window or clip
(a Python loop), "splitT" one product w @ x^T a window (a loop), "bmm"
one batched product x [n, rows, in] @ w^T and
"bmmT" one batched product w @ x^T [n, in, rows], both also for a
single window (n = 1). Both checks above run once for each form, the
sequential and single-clip fits under the same form.

`--decode`: each form's forward and its gradient in z, block by block,
against the decode of that block alone (does the form keep each window's
bits?), at T = 100 with W = 2, 4, 8 and T = 119 with C = 4, 8; then the
fold's ms/step, kernel launches a step and device-busy time with each
form, interleaved (one, split, bmm, bmm, split, one), on the W = 8 fold
of `chip_smoke.py`'s phase-6b sweep (PROXD_temp_S3.yaml, 590 frames) and
on the C = 8 Stage-2 fold of phase 4b's corpus.

`--amass-dir DIR` writes the AMASS corpus under DIR, so that several
processes (one a hash seed) can run at once.

Prints human-readable lines and, last, one JSON object.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

STEPS = (1, 5, 6, 10)
FORMS = ("one", "split", "splitT", "bmm", "bmmT")
DECODE_SHAPES = ((100, 2), (100, 4), (100, 8), (119, 4), (119, 8))


def _linear_one(p, name, x, rows=None):
    import torch.nn.functional as F
    return F.linear(x, p[f"{name}.weight"], p[f"{name}.bias"])


def _linear_split(p, name, x, rows=None):
    import torch
    import torch.nn.functional as F
    w, b = p[f"{name}.weight"], p[f"{name}.bias"]
    if rows is None or x.shape[0] <= rows:
        return F.linear(x, w, b)
    return torch.cat([F.linear(c, w, b) for c in x.split(rows)])


def _linear_split_t(p, name, x, rows=None):
    import torch
    w, b = p[f"{name}.weight"], p[f"{name}.bias"]
    blocks = [x] if rows is None else x.split(rows)
    return torch.cat([torch.addmm(b[:, None], w, c.t()).t() for c in blocks])


def _blocks(x, rows):
    n = 1 if rows is None else x.shape[0] // rows
    return n, x.reshape(n, -1, x.shape[-1])


def _linear_bmm(p, name, x, rows=None):
    import torch
    w, b = p[f"{name}.weight"], p[f"{name}.bias"]
    n, x3 = _blocks(x, rows)
    return torch.baddbmm(b, x3, w.t().expand(n, -1, -1)).reshape(
        x.shape[0], -1)


def _linear_bmm_t(p, name, x, rows=None):
    import torch
    w, b = p[f"{name}.weight"], p[f"{name}.bias"]
    n, x3 = _blocks(x, rows)
    return torch.baddbmm(b[:, None], w.expand(n, -1, -1),
                         x3.transpose(1, 2)).transpose(1, 2).reshape(
                             x.shape[0], -1)


_LINEAR = {"one": _linear_one, "split": _linear_split,
           "splitT": _linear_split_t, "bmm": _linear_bmm,
           "bmmT": _linear_bmm_t}


@contextlib.contextmanager
def decode_form(form: str):
    """`vposer._linear` replaced by the form's linear layer."""
    from lemo_tpu_torch.body_model import vposer
    real = vposer._linear
    vposer._linear = _LINEAR[form]
    try:
        yield
    finally:
        vposer._linear = real


def decode_bits() -> list[dict]:
    """Each form's decode and its z-gradient, block by block, against the
    same form's decode of the block alone (what a window's own fit runs),
    and against one product of all rows."""
    import torch

    from lemo_tpu_torch.body_model import vposer

    p = vposer.init_vposer(torch.Generator().manual_seed(0), device="cuda")
    gen = torch.Generator().manual_seed(1)
    rows = []
    for T, n in DECODE_SHAPES:
        z = torch.randn(n * T, 32, generator=gen).cuda()
        g = torch.randn(n * T, 63, generator=gen).cuda()

        def run(zz, gg, rows_):
            zz = zz.clone().requires_grad_(True)
            y = vposer.decode(p, zz, "aa", rows=rows_)
            (dz,) = torch.autograd.grad((y * gg).sum(), zz)
            return y.detach(), dz
        one = run(z, g, None)
        for form in FORMS:
            with decode_form(form):
                alone = [run(z[i * T:(i + 1) * T], g[i * T:(i + 1) * T], T)
                         for i in range(n)]
                y, dz = run(z, g, T)
            y_ref = torch.cat([r[0] for r in alone])
            dz_ref = torch.cat([r[1] for r in alone])
            row = {"T": T, "blocks": n, "form": form,
                   "forward_bit_equal": bool(torch.equal(y, y_ref)),
                   "grad_bit_equal": bool(torch.equal(dz, dz_ref)),
                   "forward_max_abs": float((y - y_ref).abs().max()),
                   "grad_max_abs": float((dz - dz_ref).abs().max()),
                   "forward_vs_one_max_abs": float((y - one[0]).abs().max()),
                   "grad_vs_one_max_abs": float((dz - one[1]).abs().max())}
            rows.append(row)
            print(f"[decode bits] T={T} x {n} blocks, {form}: forward "
                  f"bit-equal to each block alone {row['forward_bit_equal']}"
                  f" (max |d| {row['forward_max_abs']:.3e}), z-gradient "
                  f"{row['grad_bit_equal']} (max |d| "
                  f"{row['grad_max_abs']:.3e}); against one product of all "
                  f"rows {row['forward_vs_one_max_abs']:.3e}, "
                  f"{row['grad_vs_one_max_abs']:.3e}", flush=True)
    return rows


def _timed_forms(cs, card, cell: str, fit_of, args) -> list[dict]:
    """The fold's step with each form, in the order one, split, bmm, bmm,
    split, one (`chip_smoke._fold_step_timing`: STEPS steps x N_CALLS
    calls after a warm-up, and a profiled call)."""
    rows = []
    for form in FORMS + FORMS[::-1]:
        with decode_form(form):
            r = cs._fold_step_timing(fit_of, args, cs.STEPS)
        row = {"cell": cell, "form": form, "ms_per_step": r["ms_per_step"],
               "kernel_launches_per_step": r["kernel_launches_per_step"],
               "device_busy_ms_per_step": r["device_busy_ms_per_step"],
               "profiled_ms_per_step": r["profiled_ms_per_step"]}
        rows.append(row)
        print(f"[decode timing] {cell}, {form}: {row['ms_per_step']:.3f} "
              f"ms/step, {row['kernel_launches_per_step']:.1f} kernel "
              f"launches a step, device busy "
              f"{row['device_busy_ms_per_step']:.3f} ms/step (profiled "
              f"{row['profiled_ms_per_step']:.3f} ms/step), on {card}",
              flush=True)
    return rows


def decode_timing(cs, card, amass) -> list[dict]:
    import torch

    from lemo_tpu_torch.body_model import load_model
    from lemo_tpu_torch.fitting import amass_temp as s2
    from lemo_tpu_torch.fitting.prox import driver
    from lemo_tpu_torch.testing.synthetic_prox import \
        write_synthetic_prox_recording

    md = cs.smoke_model_dict()
    model = load_model(md, use_pca=True, num_pca_comps=12, device="cuda")
    base = os.path.join(cs.PROX_DIR, "decode_sweep")
    info = write_synthetic_prox_recording(
        os.path.join(base, "data"), num_frames=cs.WP_SWEEP_FRAMES,
        model_dict=md, seed=1, pose_scale=0.35, device=model.device)
    info["part_segm_fn"] = ""
    cfg = cs.prox_config(info, os.path.join(base, "out"), steps=cs.STEPS,
                         config=cs.PROX_S3_CFG,
                         extra=("--window_parallel", "true",
                                "--window_polish_iters", "0"))
    assets = cs.prox_assets(model, info, cfg)
    W = max(cs.WP_SWEEP_W)
    calls: list = []
    with cs.fold_spy(calls):
        driver.run_prox_fitting(cfg, assets, max_windows=W, verbose=False)
    call = calls[0]
    rows = _timed_forms(cs, card, f"PROX W={W}",
                        lambda n: cs._fold_fitter(call, n), call["inputs"])

    s2_calls = amass["s2_calls"]
    fargs, fkw = s2_calls[0]["factory"]
    inputs = [torch.cat([c["inputs"][k] for c in s2_calls])
              for k in range(3)]
    C = max(cs.AMASS_SWEEP_C)
    rows += _timed_forms(
        cs, card, f"AMASS C={C}",
        lambda n: s2.make_temporal_fitter_batched(
            *fargs[:7], num_steps=n, weights=fargs[8],
            device=fkw["device"]),
        [x[:C] for x in inputs])
    return rows


def amass_rows(cs, amass) -> list[dict]:
    import torch

    from lemo_tpu_torch.fitting import amass_temp as s2

    rows = []
    for b, call in enumerate(amass["s2_calls"]):
        fargs, fkw = call["factory"]
        target, contact, init72 = call["inputs"]

        def fitter(make):
            return make(*fargs[:7], num_steps=cs.AMASS_CHECK_STEPS,
                        weights=fargs[8], device=fkw["device"])

        rows_b = []
        for form in FORMS:
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                with decode_form(form):
                    single = fitter(s2.make_temporal_fitter)
                    outs = [single(target[c], contact[c], init72[c])
                            for c in range(target.shape[0])]
                    xf, lf = fitter(s2.make_temporal_fitter_batched)(
                        target, contact, init72)
            finally:
                torch.use_deterministic_algorithms(False)
            xs = torch.stack([o[0] for o in outs])
            ls = torch.stack([o[1] for o in outs])
            row = {"batch": b, "form": form,
                   "x72_excess": float(((xf - xs).abs()
                                        - 6e-2 * xs.abs()).max()),
                   "loss_excess": float(((lf - ls).abs()
                                         - 2e-3 * ls.abs()).max()),
                   "x72_max_abs": float((xf - xs).abs().max()),
                   "bit_equal": bool(torch.equal(xf, xs))}
            rows_b.append(row)
            print(f"[amass] PYTHONHASHSEED="
                  f"{os.environ.get('PYTHONHASHSEED')} Stage-2 batch {b}, "
                  f"decode {form}: x72 excess {row['x72_excess']:.3e} (held "
                  f"at 2e-3 for batch 0), losses {row['loss_excess']:.3e}, "
                  f"x72 max |d| {row['x72_max_abs']:.3e}, bit-equal "
                  f"{row['bit_equal']}", flush=True)
        rows += rows_b
    return rows


def prox_rows(cs, card) -> list[dict]:
    import torch

    from lemo_tpu_torch.body_model import load_model
    from lemo_tpu_torch.fitting.prox import driver
    from lemo_tpu_torch.fitting.prox.losses import PER_WINDOW_FIELDS
    from lemo_tpu_torch.fitting.prox.window import make_window_fitter

    md = cs.smoke_model_dict()
    model = load_model(md, use_pca=True, num_pca_comps=12, device="cuda")
    info = cs.prox_recording(md, model.device)
    cfg = cs.prox_config(info, os.path.join(cs.PROX_DIR, "out_rounding"),
                         steps=max(STEPS), config=cs.PROX_S3_CFG,
                         extra=("--window_parallel", "true",
                                "--window_polish_iters", "0"))
    assets = cs.prox_assets(model, info, cfg)
    calls: list = []
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with cs.fold_spy(calls):
            driver.run_prox_fitting(cfg, assets, verbose=False)
        call = calls[0]
        st_b, warm, first = call["inputs"]
        fargs, fkw = call["factory"]
        one = dataclasses.replace(st_b, **{
            f: getattr(st_b, f)[:1] for f in PER_WINDOW_FIELDS
            if getattr(st_b, f) is not None})
        forms = {"two-window fold": (st_b, warm, first),
                 "window 1 alone": (one, {k: v[:1] for k, v in warm.items()},
                                    first[:1])}
        rows = []
        for n, form in [(n, f) for n in STEPS for f in FORMS]:
            with decode_form(form):
                seq = make_window_fitter(
                    *fargs[:5], maxiters=n, lr=fkw["lr"],
                    steps_per_dispatch=fkw["steps_per_dispatch"],
                    priors=fkw["priors"], use_vposer=fkw["use_vposer"])(
                    cs._window_static(st_b, 0),
                    {k: v[0] for k, v in warm.items()}, True)
                for name, args in forms.items():
                    ov, _, losses, _ = cs._fold_fitter(call, n)(*args)
                    row = {"steps": n, "fold": name, "decode": form,
                           "transl_gap_m": float((ov["transl"][0]
                                                  - seq[0]["transl"]).abs()
                                                 .max()),
                           "loss_gap_rel": float(((losses[0] - seq[1]).abs()
                                                  / seq[1].abs()).max()),
                           "bit_equal": all(torch.equal(ov[k][0], seq[0][k])
                                            for k in seq[0])}
                    rows.append(row)
                    print(f"[prox] {n:2d} steps, {name}, decode {form}: "
                          f"transl gap {row['transl_gap_m']:.3e} m, loss gap "
                          f"{row['loss_gap_rel']:.3e}, bit-equal "
                          f"{row['bit_equal']}", flush=True)
    finally:
        torch.use_deterministic_algorithms(False)
    return rows


def main() -> int:
    import torch

    import chip_smoke as cs
    from lemo_tpu_torch import _build, exact_f32_matmuls

    if not torch.cuda.is_available():
        print("check_torch_fold_rounding: CUDA is not available",
              file=sys.stderr)
        return 1
    exact_f32_matmuls()
    card = cs._card_line()
    print(card, flush=True)
    _build.build_library(verbose=False)
    out = {"card": card, "pythonhashseed": os.environ.get("PYTHONHASHSEED")}
    if "--amass-dir" in sys.argv:
        cs.AMASS_DIR = os.path.abspath(
            sys.argv[sys.argv.index("--amass-dir") + 1])
    amass = None
    if "--decode" in sys.argv:
        out["decode_bits"] = decode_bits()
    if "--amass" in sys.argv or "--decode" in sys.argv:
        amass = cs.phase_amass(card)
    if "--amass" in sys.argv:
        out["amass"] = amass_rows(cs, amass)
    if "--decode" in sys.argv:
        out["decode_timing"] = decode_timing(cs, card, amass)
    if "--no-prox" not in sys.argv:
        out["prox"] = prox_rows(cs, card)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
