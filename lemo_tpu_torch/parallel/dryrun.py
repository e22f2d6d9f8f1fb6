"""Run the sharded paths on n ranks of one machine, and the rank jobs the
checks run there (the port's counterpart of `__graft_entry__.py:28`
`dryrun_multichip`).

`spawn_ranks(n, job, inputs)` starts n processes (`spawn`), joins them
in a process group through a file store in a fresh temporary directory
(no TCP port, so concurrent runs cannot collide), builds `make_mesh()`
and runs `job(mesh, **inputs)` in each; it returns the ranks' results
and raises if any rank fails or the run outlasts its timeout. `inputs`
and the results travel as files written with `torch.save` (each rank
loads the inputs onto its device). The jobs below are module functions,
so the spawned children import this package, never the caller's script.

    python -c "from lemo_tpu_torch.parallel.dryrun import dryrun_multichip; dryrun_multichip(2, device='cpu')"

rehearses it on the CPU (gloo); `dryrun_multichip(n)` puts one rank on
each of n cards (NCCL).
"""

from __future__ import annotations

import contextlib
import os
import shutil
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from lemo_tpu_torch.parallel import sharding


def _kernel_counters() -> list:
    """The four kernel wrappers' per-process launch counters."""
    from lemo_tpu_torch.body_model import chain_cuda, vertex_cuda
    from lemo_tpu_torch.ops import chamfer_cuda, intersection_cuda

    return [chain_cuda.launches, vertex_cuda.launches,
            chamfer_cuda.launches, intersection_cuda.launches]


def launch_counts() -> dict:
    """This process's kernel launch counts, by name."""
    out: dict = {}
    for c in _kernel_counters():
        out.update(c)
    return dict(out)


def zero_launch_counts() -> None:
    for c in _kernel_counters():
        for name in c:
            c[name] = 0


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    if torch.is_tensor(tree):
        return tree.detach().cpu()
    return tree


def rank_devices(n: int, device=None, backend: str | None = None) -> list:
    """The device of each of n ranks on this machine. `device` None is the
    card; a CUDA device without an index puts rank r on
    cuda:(r % the cards), one card a rank; a CUDA device with an index
    puts every rank there; the CPU takes every rank. Raises ValueError
    where two ranks would share a card and `backend` is not "gloo"
    (NCCL refuses two ranks on one card)."""
    from lemo_tpu_torch import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        return [dev] * n
    if dev.index is None:
        cards = torch.cuda.device_count()
        devs = [torch.device("cuda", r % cards) for r in range(n)]
    else:
        devs = [dev] * n
    if len(set(devs)) < n and backend != "gloo":
        raise ValueError(
            f"{n} ranks on {len(set(devs))} card(s): NCCL takes one card a "
            "rank; pass backend='gloo' to share a card")
    return devs


def _rank_main(rank: int, n: int, job, workdir: str, devices: list,
               backend: str | None, threads: int | None) -> None:
    if threads:
        torch.set_num_threads(threads)
    dev = torch.device(devices[rank])
    sharding.initialize_multihost(
        "file://" + os.path.join(workdir, "store"), n, rank, backend=backend,
        device=dev)
    try:
        mesh = sharding.make_mesh(device=dev)
        inputs = torch.load(os.path.join(workdir, "inputs.pt"),
                            map_location=dev, weights_only=False)
        out = job(mesh, **inputs)
        torch.save(_to_cpu(out), os.path.join(workdir, f"rank{rank}.pt"))
        # every rank has written its result before any rank leaves
        sharding.all_reduce_sum(mesh, torch.zeros(1, device=dev))
    finally:
        dist.destroy_process_group()


def spawn_ranks(n: int, job, inputs: dict | None = None, device=None,
                backend: str | None = None, threads: int | None = None,
                timeout: float = 900.0) -> list:
    """Run `job(mesh, **inputs)` on n spawned ranks placed by
    `rank_devices(n, device, backend)` (None: one card a rank; "cpu" for
    a rehearsal; "cuda:0" with `backend="gloo"` for ranks sharing one
    card), and return each rank's result (on the CPU). Raises if a rank
    raises or exits with a non-zero code, or after `timeout` seconds (the
    ranks are stopped). `threads` sets each rank's intra-op threads."""
    import torch.multiprocessing as mp

    devices = [str(d) for d in rank_devices(n, device, backend)]
    workdir = tempfile.mkdtemp(prefix="lemo_ranks_")
    try:
        torch.save(_to_cpu(inputs or {}), os.path.join(workdir, "inputs.pt"))
        ctx = mp.start_processes(
            _rank_main, args=(n, job, workdir, devices, backend, threads),
            nprocs=n, join=False, start_method="spawn")
        t_end = time.monotonic() + timeout
        while not ctx.join(timeout=1.0):
            if time.monotonic() > t_end:
                for p in ctx.processes:
                    if p.is_alive():
                        p.terminate()
                for p in ctx.processes:
                    p.join(10)
                raise TimeoutError(f"{n} ranks of {job.__name__} did not "
                                   f"end within {timeout} s")
        return [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                           weights_only=False) for r in range(n)]
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


# --- rank jobs -------------------------------------------------------------

def _deterministic(on: bool):
    torch.use_deterministic_algorithms(bool(on), warn_only=True)


def job_dp_step(mesh, cfg, params, batch, steps: int = 1):
    """`steps` data-parallel smoothness-trainer steps on `batch` from
    `params`: the parameters, each step's metrics, the first step's
    summed gradients, ms a step (after the first)."""
    from lemo_tpu_torch import exact_f32_matmuls
    from lemo_tpu_torch.fitting.adam import adam_init
    from lemo_tpu_torch.train import smooth

    exact_f32_matmuls()
    train_step, _ = smooth.make_train_step(cfg)
    step = sharding.data_parallel_step(train_step, mesh)
    state = adam_init(params)
    metrics, grads, walls = [], None, []
    for i in range(steps):
        _sync(batch.device)
        t0 = time.perf_counter()
        params, m = step(params, state, batch)
        _sync(batch.device)
        walls.append(time.perf_counter() - t0)
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            grads = dict(step.last_grads)
    return {"params": params, "metrics": metrics, "grads": grads,
            "ms_step": 1e3 * float(np.mean(walls[1:] or walls))}


def job_stage1(mesh, fitter_args, fitter_kw, target, beta,
               deterministic: bool = False):
    """The frame-sharded parallel Stage 1 (`frame_sharded_fit` of
    `make_stage1_fitter(*fitter_args, **fitter_kw)`) on `target`
    [T, 67, 3]: x72 [T, 72], the losses, this rank's launches, ms a
    step."""
    from lemo_tpu_torch.fitting import amass_perframe as s1

    fit = sharding.frame_sharded_fit(
        s1.make_stage1_fitter(*fitter_args, **fitter_kw), mesh)
    return _timed_fit(fit, (target, beta), fitter_kw.get("num_steps", 100),
                      target.device, deterministic)


def job_stage2(mesh, fitter_args, fitter_kw, inputs,
               deterministic: bool = False):
    """The clip-sharded folded Stage 2 (`clip_sharded_fit` of
    `make_temporal_fitter_batched(*fitter_args, **fitter_kw)` as built)
    on `inputs` (markers [C, T, 67, 3], contact [C, T, 4], init72
    [C, T, 72]): x72, the losses [C, S], this rank's launches, ms a
    step."""
    from lemo_tpu_torch.fitting import amass_temp as s2

    fit = sharding.clip_sharded_fit(
        s2.make_temporal_fitter_batched(*fitter_args, **fitter_kw), mesh)
    return _timed_fit(fit, tuple(inputs), fitter_kw.get("num_steps", 100),
                      inputs[0].device, deterministic)


def _timed_fit(fit, args, steps: int, device, deterministic: bool) -> dict:
    """One call of `fit`, timed and its launches counted. On the card the
    fit runs once untimed first: a process's first fit pays its one-off
    set-up (each kernel's first launch, the cuBLAS and cuDNN handles),
    4.1-4.5x a warm call's wall (`parallel/profile_ranks.py`)."""
    _deterministic(deterministic)
    try:
        if torch.device(device).type == "cuda":
            fit(*args)
        zero_launch_counts()
        _sync(device)
        t0 = time.perf_counter()
        x, losses = fit(*args)
        _sync(device)
        wall = time.perf_counter() - t0
        launches = launch_counts()
    finally:
        _deterministic(False)
    return {"x72": x, "losses": losses, "launches": launches,
            "ms_step": 1e3 * wall / steps}


CANDIDATE_FIELDS = ("coll_candidate_ids", "sdf_candidate_ids",
                    "depth_scan_cand_ids", "depth_vert_cand_ids")


@contextlib.contextmanager
def candidate_spy(store: list):
    """Record the candidate sets of every `_apply_candidates_batch` call
    of the PROX driver: a list a call, a {field: tensor on the CPU} a
    window it built."""
    from lemo_tpu_torch.fitting.prox import driver

    real = driver._apply_candidates_batch

    def spied(*args, **kw):
        statics, broad_phase = real(*args, **kw)
        store.append([{f: getattr(st, f).cpu() for f in CANDIDATE_FIELDS
                       if getattr(st, f) is not None} for st in statics])
        return statics, broad_phase

    driver._apply_candidates_batch = spied
    try:
        yield
    finally:
        driver._apply_candidates_batch = real


def job_prox(mesh, cfg, assets, output_folders=None,
             deterministic: bool = False, capture_candidates: bool = False):
    """`run_prox_fitting(cfg, assets)` (under a process group the
    window-parallel driver shards its windows over the ranks; a mesh with
    no process group runs the unsharded driver), rank r writing under
    `output_folders[r]` when given: the results (numpy), this rank's
    launches, LAST_PARALLEL_TIMINGS (set on rank 0 alone) and, with
    `capture_candidates`, the candidate sets of this rank's windows
    (`candidate_spy`)."""
    import dataclasses

    from lemo_tpu_torch.fitting.prox import driver

    if output_folders is not None:
        cfg = dataclasses.replace(cfg,
                                  output_folder=output_folders[mesh.rank])
    driver.LAST_PARALLEL_TIMINGS.clear()
    candidates: list = []
    _deterministic(deterministic)
    try:
        zero_launch_counts()
        with (candidate_spy(candidates) if capture_candidates
              else contextlib.nullcontext()):
            res = driver.run_prox_fitting(cfg, assets, verbose=False)
        launches = launch_counts()
    finally:
        _deterministic(False)
    return {"results": res, "launches": launches,
            "timings": dict(driver.LAST_PARALLEL_TIMINGS),
            "candidates": candidates}


def job_mesh_checks(mesh):
    """The collectives and meshes on this many ranks: the exact gather
    (-0.0, NaN and uneven shares), the owner's broadcast, both
    factorisations of a 2-D pod mesh and their 1-D axes, a frame-sharded
    fit in blocks of 3 frames, and a mesh of rank 0 alone. Returns what
    each rank saw."""
    n, r = mesh.size, mesh.rank
    dev = mesh.device
    rows = torch.tensor_split(torch.arange(2 * n + 1), n)[r]
    local = torch.stack([torch.full((3,), float(i)) for i in rows]).to(dev)
    if r == 0:
        local[0, 0] = -0.0
        local[0, 1] = float("nan")
    gathered = sharding.gather_rows(
        mesh, {"x": local, "i": rows.to(dev), "b": rows.to(dev) % 2 == 0},
        2 * n + 1)
    src = n - 1
    bc = sharding.broadcast_tree(
        mesh, {"v": torch.full((2,), float(r), device=dev)}, src=src)
    pods = {}
    for dp in (1, n):
        pod = sharding.make_pod_mesh(dp=dp)
        pods[dp] = {"shape": pod.shape, "axis_names": pod.axis_names,
                    "sums": {a: float(sharding.all_reduce_sum(
                        pod.along(a), torch.ones(1, device=dev))[0])
                        for a in pod.axis_names}}
    try:
        sharding.make_pod_mesh(dp=n + 1)
        bad = None
    except ValueError as e:
        bad = str(e)
    seen = []

    def fit(frames, frames_total, reduce_dead):
        seen.append(frames.shape[0])
        return frames * 2, frames.sum(0) / frames_total

    fit.frame_block = 3
    frames = torch.arange(14.0, device=dev).reshape(7, 2)
    blocked = sharding.frame_sharded_fit(fit, mesh)(frames)
    first = sharding.make_mesh(1, device=dev)      # rank 0's subgroup
    first_sum = (float(sharding.all_reduce_sum(
        first, torch.ones(1, device=dev))[0]) if first.rank == 0 else None)
    return {"rows": [int(x) for x in rows], "gathered": gathered,
            "broadcast": bc["v"], "pods": pods, "bad_pod": bad,
            "rank": sharding.initialize_multihost(),
            "blocked": (seen[0], *blocked),
            "first": (first.size, first.rank, first_sum)}


def poisoned_fit(frames, frames_total=None, reduce_dead=None,
                 steps: int = 6):
    """A per-frame fit for `frame_sharded_fit` whose loss goes NaN
    mid-fit: frame i's parameter is pulled to frames[i, 0] by Adam (lr
    0.1), and from step frames[i, 1] on, frame i poisons its share of
    the loss with NaN. Returns (x [T, 1], losses [steps])."""
    from lemo_tpu_torch.fitting.adam import run_adam

    n = frames_total or frames.shape[0]
    step = [0]

    def loss(p):
        poison = (frames[:, 1] <= step[0]).any()
        step[0] += 1
        val = ((p["x"] - frames[:, :1]) ** 2).sum() / n
        return torch.where(poison, torch.full_like(val, float("nan")), val)

    final, losses = run_adam(loss, {"x": torch.zeros_like(frames[:, :1])},
                             steps, [0.1] * steps, reduce_dead=reduce_dead)
    return final["x"], losses


def job_nan_freeze(mesh, frames):
    """`frame_sharded_fit(poisoned_fit)` on `frames` [T, 2]: the gathered
    parameters and the summed losses."""
    return sharding.frame_sharded_fit(poisoned_fit, mesh)(frames)


def job_sequence(mesh, jobs):
    """Run `jobs`, [(job, kwargs), ...], one after another on the same
    ranks (one spawn for several checks); returns their results."""
    return [job(mesh, **kw) for job, kw in jobs]


# --- the dry run -----------------------------------------------------------

def _dryrun_job(mesh, prox_cfg, prox_assets, s1_args, s2_args, s2_inputs,
                target, dp_cfg, dp_params, dp_batch):
    n = mesh.size
    t0 = time.time()
    out = {}

    def mark(msg):
        if mesh.rank == 0:
            print(f"[dryrun +{time.time() - t0:.0f}s] {msg}", flush=True)

    dp = job_dp_step(mesh, dp_cfg, dp_params, dp_batch)
    out["dp_total"] = dp["metrics"][0]["total"]
    mark("dp train step done")
    s1 = job_stage1(mesh, s1_args, {"num_steps": 3,
                                    "device": target.device},
                    target, torch.zeros(10, device=target.device))
    if s1["x72"].shape != (target.shape[0], 72):
        raise AssertionError(f"frame-sharded fit gave {s1['x72'].shape}")
    out["s1_loss"] = float(s1["losses"][-1])
    mark("frame-sharded fit done")
    s2 = job_stage2(mesh, s2_args, {"num_steps": 2,
                                    "device": target.device}, s2_inputs)
    if s2["x72"].shape != tuple(s2_inputs[2].shape):
        raise AssertionError(f"clip-sharded fit gave {s2['x72'].shape}")
    out["s2_loss"] = float(s2["losses"][0, -1])
    mark("clip-sharded stage-2 done")
    mark(f"S3 all-terms window-parallel starting on {n} ranks")
    res = job_prox(mesh, prox_cfg, prox_assets)["results"]
    out["windows"] = len(res)
    out["s3_loss"] = res[-1].final_loss
    for r in res:
        for k, v in r.term_history.items():
            if not np.isfinite(v).all():
                raise AssertionError(f"S3 term {k} is not finite")
    for k, v in out.items():
        if not np.isfinite(v):
            raise AssertionError(f"dry run: {k} = {v}")
    return out


def dryrun_multichip(n: int, device=None, backend: str | None = None,
                     threads: int | None = 2) -> dict:
    """`__graft_entry__.py`'s four parts on n ranks (one process each,
    placed by `rank_devices(n, device, backend)`: None is one card a rank
    under NCCL, "cpu" a rehearsal under gloo) at its small sizes: the data-parallel smoothness-trainer
    step (batch 2n); the frame-sharded Stage 1 (V=128, T=2n, on the card
    a 32-frame decode block a rank; 3 steps); the clip-sharded folded
    Stage 2 (C=n, the fused fold, 2 steps, T=12: `lemo_tpu` takes T=6,
    which torch's reflect padding of the prior refuses); and the
    window-parallel Stage-3 fit on the all-terms configuration (a
    10 + 7(n - 1)-frame synthetic recording, V=256, n windows of 10 at
    stride 7, one a rank; 2 steps, 2 polish iterations, 2 infill finetune
    steps, scans cut to 2,000 points; `lemo_tpu` takes windows of 8, too
    short for torch's reflect padding of the infill prior). Raises if a
    rank fails or a result is not finite; returns rank 0's final
    losses."""

    from lemo_tpu_torch import resolve_device
    from lemo_tpu_torch.body_model import load_model
    from lemo_tpu_torch.body_model import vposer as vp
    from lemo_tpu_torch.config.prox_config import ProxConfig
    from lemo_tpu_torch.data import markers, segments
    from lemo_tpu_torch.data.stats import GlobalStats, Local4ChanStats
    from lemo_tpu_torch.fitting.amass_perframe import DECODE_ROWS
    from lemo_tpu_torch.fitting.prox.driver import ProxAssets, load_part_segm
    from lemo_tpu_torch.priors.conv_ae import init_infill_ae, \
        init_smooth_enc
    from lemo_tpu_torch.testing.synthetic import synthetic_smplx_npz, \
        write_part_segm_pkl
    from lemo_tpu_torch.testing.synthetic_prox import \
        write_synthetic_prox_recording
    from lemo_tpu_torch.train import smooth

    dev = resolve_device(device)
    t0 = time.time()
    base = tempfile.mkdtemp(prefix="lemo_dryrun_")
    try:
        # the data-parallel step
        dp_cfg = smooth.SmoothTrainConfig(batch_size=2 * n, lr=1e-4)
        dp_params = smooth.init_params(torch.Generator().manual_seed(0),
                                       dp_cfg, dev)
        dp_batch = torch.as_tensor(np.random.RandomState(0).randn(
            2 * n, 1, 24, 16).astype(np.float32), device=dev)
        # Stage 1 and Stage 2 on a 128-vertex model
        model = load_model(synthetic_smplx_npz(num_verts=128), use_pca=True,
                           num_pca_comps=12, device=dev)
        vpp = vp.init_vposer(torch.Generator().manual_seed(1), device=dev)
        ids67 = markers.marker_indices(False, num_verts=128)
        # a block of frames a rank (the Stage-1 decode's blocks on the card)
        t1 = n * (2 if dev.type == "cpu" else DECODE_ROWS)
        target = torch.as_tensor(np.random.RandomState(1).randn(
            t1, 67, 3).astype(np.float32) * 0.2, device=dev)
        stats = GlobalStats.from_numpy(np.zeros((1, 1, 243)), np.ones(243),
                                       dev)
        enc = init_smooth_enc(torch.Generator().manual_seed(2), device=dev)
        s2_args = (model, vpp, enc, stats, ids67,
                   markers.marker_indices(True, num_verts=128),
                   segments.foot_vertex_ids(num_verts=128))
        rng = np.random.RandomState(3)
        s2_inputs = tuple(torch.as_tensor(a.astype(np.float32), device=dev)
                          for a in (rng.randn(n, 12, 67, 3) * 0.2,
                                    rng.rand(n, 12, 4) > 0.5,
                                    rng.randn(n, 12, 72) * 0.1))
        # the all-terms window-parallel fit on a tiny recording
        info = write_synthetic_prox_recording(
            base, num_frames=10 + 7 * (n - 1), seed=3,
            model_dict=synthetic_smplx_npz(num_verts=256))
        pm = load_model(info["model_dict"], use_pca=True, num_pca_comps=12,
                        device=dev)
        segm_fn = os.path.join(base, "parts_segm.pkl")
        write_part_segm_pkl(segm_fn, np.asarray(pm.faces), num_parts=4)
        faces_segm, ign_table = load_part_segm(segm_fn, pm.faces, ["0,3"])
        asset_dir = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "assets")
        cfg = ProxConfig(
            recording_dir=info["recording_dir"],
            output_folder=os.path.join(base, "out"),
            window_parallel=True, window_polish_iters=2,
            batch_size=10, maxiters=2, flip=False, init_mode="none",
            s2m=True, m2s=True, read_depth=True, read_mask=True,
            s2m_weights=[5e2], m2s_weights=[1.0],
            sdf_penetration=True, use_friction=True,
            use_motion_smooth_prior=True, motion_prior_smooth_weights=[1e2],
            use_motion_infill_prior=True, motion_infill_rec_weights=[2.0],
            motion_infill_contact_weights=[0.1], infill_finetune_steps=2,
            interpenetration=True, coll_loss_weights=[1e-5],
            contact=True, contact_loss_weights=[1.0])
        assets = ProxAssets(
            model=pm, vposer_params={k: v.to(dev) for k, v in
                                     info["vposer_params"].items()},
            smooth_enc_params=init_smooth_enc(
                torch.Generator().manual_seed(4), device=dev),
            smooth_stats=GlobalStats.from_numpy(np.zeros((1, 1, 243)),
                                                np.ones(243), dev),
            infill_ae_params=init_infill_ae(torch.Generator().manual_seed(5),
                                            in_channel=4, device=dev),
            infill_stats=Local4ChanStats.load(
                os.path.join(asset_dir, "infill_stats.npz"), dev),
            faces_segm=faces_segm, ign_table=ign_table)
        print(f"[dryrun +{time.time() - t0:.0f}s] inputs written; "
              f"{n} ranks on {dev}", flush=True)
        out = spawn_ranks(n, _dryrun_scan_cut, {
            "prox_cfg": cfg, "prox_assets": assets,
            "s1_args": (model, vpp, ids67), "s2_args": s2_args,
            "s2_inputs": s2_inputs, "target": target, "dp_cfg": dp_cfg,
            "dp_params": dp_params, "dp_batch": dp_batch},
            device=dev, backend=backend, threads=threads)[0]
    finally:
        shutil.rmtree(base, ignore_errors=True)
    print(f"dryrun_multichip({n}): dp train step + frame-sharded fit + "
          f"clip-sharded folded Stage-2 + S3 ALL-TERMS window-parallel PROX "
          f"fit ({out['windows']} windows + polish, sharded over {n} ranks) "
          f"OK; final losses {out['dp_total']:.4f} / {out['s1_loss']:.4f} / "
          f"{out['s2_loss']:.4f} / {out['s3_loss']:.4f}", flush=True)
    return out


def _dryrun_scan_cut(mesh, **inputs):
    """The dry run's rank job with the scan padding cut to 2,000 points
    (20,000 in production; the depth Chamfer's cost)."""
    from lemo_tpu_torch.data import prox as prox_data

    prox_data.SCAN_MAX_POINTS = 2000
    return _dryrun_job(mesh, **inputs)
