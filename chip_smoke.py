#!/usr/bin/env python3
"""Drive the lemo_tpu_torch port on one CUDA card and check it.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. Set-up: print the card's name and power limit, the torch/CUDA
   versions, and build the CUDA kernels from `lemo_tpu_torch/csrc/`.
2. Kernels: capture each kernel's operands from one forward/backward of
   the full-size synthetic SMPL-X model (V=10475, J=55, D=507) at B=100,
   then hold each kernel against its plain PyTorch twin on the same
   operands and time both with CUDA events (median of 25).
3. Body model: full-size forward and backward through `make_forward_fn`
   (kernels) against the same with the plain twins, on the card.
4. The slice: the AMASS Stage-2 temporal fit (`make_temporal_fitter`,
   T=100, 20 Adam steps per call, the workload `bench.py:main` times)
   with random seeded VPoser/encoder weights. The fit must descend, each
   kernel must launch exactly once per step, and the final loss must
   match the same fit run through the plain twins (rel 1e-3).

Prints the kernels' JSON line, then as the last line
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`.
Exits non-zero without printing a result when CUDA is absent.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

T_FRAMES = 100
STEPS = 20
N_CALLS = 3
REPS = 25
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12        # H100 SXM data sheet, f32 outside tensor cores


def _log(msg: str) -> None:
    print(msg, flush=True)


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, reps: int = REPS) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / F32_FLOPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


@contextlib.contextmanager
def plain_twins():
    """Route the kernels' wrappers to their plain twins (on the card)."""
    from lemo_tpu_torch.body_model import chain_cuda as cc
    from lemo_tpu_torch.body_model import vertex_cuda as vc

    saved = (cc.chain_fwd_kernel, cc.chain_bwd_kernel,
             vc.vertex_fwd_kernel, vc.vertex_bwd_kernel)
    cc.chain_fwd_kernel = cc.chain_planes_plain_fwd
    cc.chain_bwd_kernel = cc.chain_planes_plain_bwd
    vc.vertex_fwd_kernel = vc.vertex_plain_fwd
    vc.vertex_bwd_kernel = vc.vertex_plain_bwd
    try:
        yield
    finally:
        (cc.chain_fwd_kernel, cc.chain_bwd_kernel,
         vc.vertex_fwd_kernel, vc.vertex_bwd_kernel) = saved


@contextlib.contextmanager
def capture_operands(store: dict):
    """Record the operands each kernel wrapper is called with."""
    from lemo_tpu_torch.body_model import chain_cuda as cc
    from lemo_tpu_torch.body_model import vertex_cuda as vc

    names = [(cc, "chain_fwd_kernel"), (cc, "chain_bwd_kernel"),
             (vc, "vertex_fwd_kernel"), (vc, "vertex_bwd_kernel")]
    saved = [getattr(mod, n) for mod, n in names]

    def recorder(name, fn):
        def wrapped(*args):
            store[name] = tuple(a.detach().clone() if hasattr(a, "detach")
                                else a for a in args)
            return fn(*args)
        return wrapped

    for (mod, n), fn in zip(names, saved):
        setattr(mod, n, recorder(n, fn))
    try:
        yield
    finally:
        for (mod, n), fn in zip(names, saved):
            setattr(mod, n, fn)


def _random_params(model, B, rng):
    import torch

    p = {}
    for k, v in model.zero_params(B).items():
        p[k] = torch.as_tensor(rng.randn(*v.shape).astype(np.float32)
                               * (0.5 if k == "transl" else 0.3),
                               device=model.device)
    return p


def _max_rel(a, b) -> float:
    scale = max(float(b.abs().max()), 1e-12)
    return float((a - b).abs().max()) / scale


def phase_kernels(model, card) -> list[dict]:
    """Phase 2: every kernel vs its plain twin at the main-path shapes."""
    import torch

    from lemo_tpu_torch.body_model import chain_cuda as cc
    from lemo_tpu_torch.body_model import make_forward_fn
    from lemo_tpu_torch.body_model import vertex_cuda as vc

    rng = np.random.RandomState(1)
    params = _random_params(model, T_FRAMES, rng)
    for v in params.values():
        v.requires_grad_(True)
    fwd = make_forward_fn(model)
    ops: dict = {}
    with capture_operands(ops):
        out = fwd(params, model.consts)
        gv = torch.as_tensor(rng.randn(*out["vertices"].shape)
                             .astype(np.float32), device=model.device)
        loss = (out["vertices"] * gv).sum() + (out["joints"] ** 2).sum()
        loss.backward()
    torch.cuda.synchronize()

    rl, tl, parents = ops["chain_fwd_kernel"]
    _, _, rg, drg, dtg, _ = ops["chain_bwd_kernel"]
    catT, A2, dirs, w = ops["vertex_fwd_kernel"]
    dout = ops["vertex_bwd_kernel"][4]
    # bounds count the work this run's data needs: B real frames, V real
    # vertices and J real joints, not the padding of the plane layout
    B, V, J = T_FRAMES, model.num_verts, len(model.parents)
    D = catT.shape[0]
    f4 = 4.0

    rows = []

    def add(name, src, replaces, kern, plain, tol, relative, nbytes, flops):
        got = kern()
        ref = plain()
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        abs_err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
        rel_err = max(_max_rel(g, r) for g, r in zip(got, ref))
        err = rel_err if relative else abs_err
        if not all(torch.isfinite(g).all() for g in got) or err > tol:
            raise AssertionError(f"{name}: error {err:.3e} > {tol:g} "
                                 f"(abs {abs_err:.3e}, rel {rel_err:.3e})")
        ms = _time_ms(kern)
        plain_ms = _time_ms(plain)
        bound, by = _bound_ms(nbytes, flops)
        _log(f"[kernels] {name}: max abs err {abs_err:.3e}, rel "
             f"{rel_err:.3e} (tol {tol:g} {'rel' if relative else 'abs'}); "
             f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
             f"{bound:.4f} ms ({by}) on {card}")
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": 0,
                     "max_abs_err": abs_err, "max_rel_err": rel_err,
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                     "bound_by": by, "library_ms": None})

    chain_src = "lemo_tpu_torch/csrc/chain.cu"
    vert_src = "lemo_tpu_torch/csrc/vertex.cu"
    add("chain_fwd", chain_src,
        "lemo_tpu/body_model/chain_pallas.py:48",
        lambda: cc.chain_fwd_kernel(rl, tl, parents),
        lambda: cc.chain_planes_plain_fwd(rl, tl, parents),
        1e-5, False,
        nbytes=f4 * 24 * J * B + 4 * J,
        flops=63.0 * (J - 1) * B)
    add("chain_bwd", chain_src,
        "lemo_tpu/body_model/chain_pallas.py:82",
        lambda: cc.chain_bwd_kernel(rl, tl, rg, drg, dtg, parents),
        lambda: cc.chain_planes_plain_bwd(rl, tl, rg, drg, dtg, parents),
        5e-5, True,
        nbytes=f4 * 45 * J * B + 4 * J,
        flops=135.0 * (J - 1) * B)
    add("vertex_fwd", vert_src,
        "lemo_tpu/body_model/vertex_pallas.py:89",
        lambda: vc.vertex_fwd_kernel(catT, A2, dirs, w),
        lambda: vc.vertex_plain_fwd(catT, A2, dirs, w),
        1e-5, False,
        nbytes=f4 * (D * B + 12 * J * B + 3 * V * D + V * J + 3 * V * B),
        flops=2.0 * 3 * V * D * B + 2.0 * 12 * V * J * B + 18.0 * V * B)
    # the backward recomputes vs (3 blends) and T[0..8] from its inputs,
    # then forms dcat (3 blends) and dA2 (12 skinning products)
    add("vertex_bwd", vert_src,
        "lemo_tpu/body_model/vertex_pallas.py:103",
        lambda: vc.vertex_bwd_kernel(catT, A2, dirs, w, dout),
        lambda: vc.vertex_plain_bwd(catT, A2, dirs, w, dout),
        5e-5, True,
        nbytes=f4 * (2 * D * B + 24 * J * B + 3 * V * D + V * J
                     + 3 * V * B),
        flops=2.0 * 6 * V * D * B + 2.0 * 21 * V * J * B + 27.0 * V * B)
    return rows


def phase_body_model(model) -> None:
    """Phase 3: full-size forward + backward, kernels vs plain twins."""
    import torch

    from lemo_tpu_torch.body_model import make_forward_fn

    rng = np.random.RandomState(2)
    base = _random_params(model, T_FRAMES, rng)
    gv = torch.as_tensor(rng.randn(T_FRAMES, model.num_verts, 3)
                         .astype(np.float32), device=model.device)
    fwd = make_forward_fn(model)

    def run():
        p = {k: v.clone().requires_grad_(True) for k, v in base.items()}
        out = fwd(p, model.consts)
        loss = (out["vertices"] * gv).mean() + (out["joints"] ** 2).mean()
        grads = torch.autograd.grad(loss, list(p.values()))
        return out, dict(zip(p.keys(), grads))

    out_k, g_k = run()
    with plain_twins():
        out_p, g_p = run()
    torch.cuda.synchronize()
    for key in ("vertices", "joints"):
        err = float((out_k[key] - out_p[key]).detach().abs().max())
        _log(f"[body] {key}: max abs err {err:.3e} m")
        if not err < 1e-5:
            raise AssertionError(f"body model {key} err {err}")
    # gradients: 1e-4 of each gradient's own scale. The jaw/eye
    # gradients are ~1e-2 of the body's, and the kernel and cuBLAS sum
    # the 10475 vertices' contributions in different orders.
    for key in g_k:
        err = _max_rel(g_k[key], g_p[key])
        _log(f"[body] d/d{key}: max err rel to scale {err:.3e}")
        if not err < 1e-4:
            raise AssertionError(f"body model grad {key} err {err}")


def s2_workload(model, steps: int = STEPS, weights=None):
    """The Stage-2 fit `bench.py:main` times, on the port: T=100 frames,
    random seeded VPoser/encoder weights, synthetic targets and contact.
    Returns (fit, (target, contact, init72))."""
    import torch

    from lemo_tpu_torch.body_model import vposer as vp
    from lemo_tpu_torch.data.markers import marker_indices
    from lemo_tpu_torch.data.segments import foot_vertex_ids
    from lemo_tpu_torch.data.stats import GlobalStats
    from lemo_tpu_torch.fitting import amass_temp as s2
    from lemo_tpu_torch.priors.conv_ae import init_smooth_enc

    dev = model.device
    vpp = vp.init_vposer(torch.Generator().manual_seed(0), device=dev)
    enc = init_smooth_enc(torch.Generator().manual_seed(1), device=dev)
    stats = GlobalStats.from_numpy(np.zeros((1, 1, 243)), np.ones(243), dev)

    rng = np.random.RandomState(0)
    init72 = np.zeros((T_FRAMES, 72), np.float32)
    init72[:, 0:3] = [0, 0.4, 1.0]
    init72[:, 3:6] = [0, 1.6, 3.14]
    init72[:, 16:48] = rng.randn(T_FRAMES, 32) * 0.2
    target = (rng.randn(T_FRAMES, 67, 3).astype(np.float32) * 0.3
              + np.array([0, 0.4, 1.0], np.float32))
    contact = (rng.rand(T_FRAMES, 4) > 0.5).astype(np.float32)

    fit = s2.make_temporal_fitter(
        model, vpp, enc, stats, marker_indices(False), marker_indices(True),
        foot_vertex_ids(), num_steps=steps,
        weights=weights or s2.Stage2Weights(), device=dev)
    return fit, (target, contact, init72)


def phase_slice(model, card) -> tuple[dict, float]:
    """Phase 4: the Stage-2 temporal fit; returns (launch counts over the
    timed calls, frame-iters/s)."""
    import torch

    from lemo_tpu_torch.body_model import chain_cuda as cc
    from lemo_tpu_torch.body_model import vertex_cuda as vc

    fit, (target, contact, init72) = s2_workload(model)
    fit(target, contact, init72)          # warm-up (caching allocator)
    torch.cuda.synchronize()

    for counts in (cc.launches, vc.launches):
        for name in counts:
            counts[name] = 0
    t0 = time.perf_counter()
    for _ in range(N_CALLS):
        x72, losses = fit(target, contact, init72)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = {**cc.launches, **vc.launches}
    losses = losses.cpu().numpy()
    _log(f"[slice] losses first {losses[0]:.6f} last {losses[-1]:.6f}; "
         f"launches {counts}")
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise AssertionError(f"fit did not descend: {losses}")
    if x72.shape != (T_FRAMES, 72) or not torch.isfinite(x72).all():
        raise AssertionError("fitted parameters malformed")
    for name, n in counts.items():
        if n != N_CALLS * STEPS:
            raise AssertionError(f"{name} launched {n} times, expected "
                                 f"{N_CALLS * STEPS} (one per step)")

    fis = T_FRAMES * STEPS * N_CALLS / dt
    _log(f"[slice] {fis:.1f} frame-iters/s ({dt / (N_CALLS * STEPS) * 1e3:.3f}"
         f" ms/step, T={T_FRAMES}, {STEPS} steps x {N_CALLS} calls) on {card}")

    with plain_twins():
        _, losses_p = fit(target, contact, init72)
    losses_p = losses_p.cpu().numpy()
    rel = abs(losses_p[-1] - losses[-1]) / abs(losses_p[-1])
    _log(f"[slice] final loss kernels {losses[-1]:.7f} vs plain twins "
         f"{losses_p[-1]:.7f} (rel {rel:.3e}, tol 1e-3)")
    if not rel < 1e-3:
        raise AssertionError(f"final loss differs from the twins' by {rel}")
    return counts, fis


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from lemo_tpu_torch import _build, exact_f32_matmuls
    from lemo_tpu_torch.body_model import load_model
    from lemo_tpu_torch.testing.synthetic import synthetic_smplx_npz

    exact_f32_matmuls()
    card = _card_line()
    _log(card)
    _log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
         f"python {sys.version.split()[0]}")
    path, build_s = _build.build_library(verbose=True)
    _log(f"[setup] kernels built in {build_s:.1f} s -> "
         f"{os.path.relpath(path)}")

    t0 = time.perf_counter()
    model = load_model(synthetic_smplx_npz(full_size=True), use_pca=True,
                       num_pca_comps=12, device="cuda")
    _log(f"[setup] full-size model loaded in {time.perf_counter() - t0:.1f} s"
         f" (V={model.num_verts}, fused_dirs "
         f"{tuple(model.consts['fused_dirs'].shape)})")

    rows = phase_kernels(model, card)
    phase_body_model(model)
    counts, _ = phase_slice(model, card)
    for row in rows:
        row["launches"] = counts[row["name"]]
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
