"""PROX pipeline driver: config -> recording -> sliding-window fits (port
of `lemo_tpu/fitting/prox/driver.py`, sequential path;
temp_prox/main_slide.py:54-373).

Loads the priors and the body model, walks the overlapping windows in
order, warm-starts each from the pkls on disk (its own outputs first, so
a killed run resumes), runs the infill pre-pass and the candidate
pre-passes, fits the window stage by stage, and writes per-frame pkls
and a conf.yaml snapshot; with `save_meshes` / `render_results`, each
window's body meshes and overlay renders after its pkls
(`_make_window_extras_saver`). With `window_parallel`, all windows are
fitted at once (`_run_window_parallel`: one [W*T] forward a step) and a
polish pass restores the sequential stitching; under `torch.distributed`
with more than one process the windows are sharded over the ranks, one
process per card. The tensorboard logger is absent.
"""

from __future__ import annotations

import dataclasses
import os
import os.path as osp
import warnings

import numpy as np
import torch
import torch.distributed as dist

from lemo_tpu_torch import exact_f32_matmuls, resolve_device
from lemo_tpu_torch.body_model import load_model, make_forward_fn
from lemo_tpu_torch.body_model import vposer as vp
from lemo_tpu_torch.body_model.smplx import find_smplx_npz
from lemo_tpu_torch.body_model.vertex_ids import smpl_to_openpose
from lemo_tpu_torch.config.prox_config import ProxConfig, check_ported
from lemo_tpu_torch.config.yaml_subset import dump_yaml
from lemo_tpu_torch.data import markers as mk
from lemo_tpu_torch.data import segments as seg
from lemo_tpu_torch.data.prox import ProxRecording, ProxWindowDataset
from lemo_tpu_torch.data.stats import GlobalStats, Local4ChanStats
from lemo_tpu_torch.fitting.prox.camera import PerspectiveCamera
from lemo_tpu_torch.fitting.prox.infill_prepass import \
    InfillPrepassResult, make_batched_prepass, run_infill_prepass
from lemo_tpu_torch.fitting.prox.losses import ProxStatic, ProxWeights, \
    frame_visibility, stack_statics
from lemo_tpu_torch.fitting.prox.window import dispatch_chunk, \
    fit_window, make_batched_window_fitter, make_window_fitter, \
    save_window_pkls, window_result
from lemo_tpu_torch.ops.chamfer import nn_distance
from lemo_tpu_torch.ops.sdf import quantize_grid, sample_sdf_world
from lemo_tpu_torch.parallel import sharding
from lemo_tpu_torch.utils.profiling import timed
from lemo_tpu_torch.utils.tools import load_vposer

_ASSET_DIR = osp.join(osp.dirname(osp.dirname(osp.dirname(
    osp.abspath(__file__)))), "assets")


def weights_from_config(cfg: ProxConfig, stage: int = 0) -> ProxWeights:
    w = cfg.stage_weights(stage)
    return ProxWeights(
        data=w["data"], body_pose=w["body_pose"], shape=w["shape"],
        hand_prior=w["hand_prior"], expr=w["expr"], jaw=w["jaw"],
        coll=w["coll"], s2m=w["s2m"], m2s=w["m2s"],
        rho_s2m=w["rho_s2m"], rho_m2s=w["rho_m2s"],
        sdf_penetration=w["sdf_penetration"], contact=w["contact"],
        smooth_acc=w["smooth_acc"], smooth_vel=w["smooth_vel"],
        motion_smooth=w["motion_smooth"],
        friction_normal=w["friction_normal"],
        friction_tangent=w["friction_tangent"],
        motion_infill_rec=w["motion_infill_rec"],
        motion_infill_contact=w["motion_infill_contact"],
        sdf_fp8=bool(cfg.sdf_fp8),
        coll_frame_chunk=int(cfg.coll_frame_chunk))


def build_priors(cfg: ProxConfig, device) -> dict:
    """cfg.*_prior_type -> prior callables on `device` (main_slide.py:
    199-237); only non-L2 types are materialized. A hand GMM has
    num_pca_comps components, as the reference's lhand_args/rhand_args
    set them (:218-230)."""
    from lemo_tpu_torch.priors.body_priors import create_prior

    base = {"prior_folder": cfg.prior_folder,
            "num_gaussians": cfg.num_gaussians}
    hand = {"prior_folder": cfg.prior_folder,
            "num_gaussians": cfg.num_pca_comps}
    out: dict = {}
    for key, ptype, kw in (("body", cfg.body_prior_type, base),
                           ("left_hand", cfg.left_hand_prior_type, hand),
                           ("right_hand", cfg.right_hand_prior_type, hand),
                           ("jaw", cfg.jaw_prior_type, base),
                           ("expr", cfg.expr_prior_type, base)):
        if ptype not in (None, "", "l2"):
            out[key] = create_prior(ptype, device=device, **kw)
    return out


@dataclasses.dataclass
class ProxAssets:
    """Models and priors on one device (tests pass synthetic ones;
    `load_assets` reads them from the config's paths)."""

    model: object
    vposer_params: dict
    smooth_enc_params: dict | None = None
    smooth_stats: GlobalStats | None = None
    infill_ae_params: dict | None = None
    infill_stats: Local4ChanStats | None = None
    scene_verts: np.ndarray | None = None
    # the part filter of the self-intersection term: [F] part id per face
    # and the [P, P] bool ignore table folded from ign_part_pairs and the
    # part parents (load_part_segm)
    faces_segm: np.ndarray | None = None
    ign_table: np.ndarray | None = None


def load_part_segm(part_segm_fn: str, faces: np.ndarray,
                   ign_part_pairs: list) -> tuple[np.ndarray, np.ndarray]:
    """Read smplx_parts_segm.pkl ({'segm': [F], 'parents': [F]}, a latin1
    pickle, as fit_temp_loadprox_slide.py:335-340 reads it) -> (faces_segm,
    ign_table) for the intersection kernel."""
    import pickle

    from lemo_tpu_torch.ops.intersection import build_face_filter

    with open(osp.expandvars(part_segm_fn), "rb") as fh:
        data = pickle.load(fh, encoding="latin1")
    filt = build_face_filter(faces, faces_segm=data["segm"],
                             ign_part_pairs=list(ign_part_pairs),
                             faces_parents=data.get("parents"))
    return filt["segm"], filt["ign_table"]


def part_filter(cfg: ProxConfig, faces: np.ndarray) -> tuple:
    """(faces_segm, ign_table) of the self-intersection term: read from
    cfg.part_segm_fn when interpenetration is on, else (None, None), with
    a warning when ign_part_pairs is set but no part file is."""
    if cfg.interpenetration and cfg.part_segm_fn:
        return load_part_segm(cfg.part_segm_fn, faces, cfg.ign_part_pairs)
    if cfg.interpenetration and cfg.ign_part_pairs:
        warnings.warn(
            "interpenetration is on and ign_part_pairs is set, but "
            "part_segm_fn is empty: part-pair filtering is inert and the "
            "term penalizes all overlapping pairs (point part_segm_fn at "
            "smplx_parts_segm.pkl)")
    return None, None


def load_assets(cfg: ProxConfig, device=None) -> ProxAssets:
    from lemo_tpu_torch.priors.conv_ae import load_state_dict_npz, \
        load_torch_state_dict

    dev = resolve_device(device)
    model = load_model(find_smplx_npz(cfg.model_folder, cfg.gender),
                       gender=cfg.gender, use_pca=cfg.use_pca,
                       num_pca_comps=cfg.num_pca_comps,
                       flat_hand_mean=cfg.flat_hand_mean, device=dev)
    vposer_params = (load_vposer(cfg.vposer_ckpt, dev)[0]
                     if cfg.vposer_ckpt else None)
    smooth_enc = smooth_stats = None
    if cfg.use_motion_smooth_prior and cfg.AE_Enc_path:
        smooth_enc = load_torch_state_dict(cfg.AE_Enc_path, dev)
        stats_path = osp.expandvars(cfg.smooth_stats_path) \
            if cfg.smooth_stats_path else osp.join(
                osp.dirname(osp.dirname(cfg.AE_Enc_path)), "..",
                "preprocess_stats",
                "preprocess_stats_smooth_withHand_global_markers.npz")
        if not osp.exists(stats_path):
            raise FileNotFoundError(
                f"smoothness-prior stats not found at {stats_path!r}; set "
                "smooth_stats_path in the config")
        smooth_stats = GlobalStats.load(stats_path, dev)
    infill_ae = infill_stats = None
    if cfg.use_motion_infill_prior:
        if cfg.infill_stats_path:
            infill_stats = Local4ChanStats.load(
                osp.expandvars(cfg.infill_stats_path), dev)
        if cfg.AE_infill_path:
            infill_ae = (load_torch_state_dict(cfg.AE_infill_path, dev)
                         if cfg.AE_infill_path.endswith((".pkl", ".pt"))
                         else load_state_dict_npz(cfg.AE_infill_path, dev))
        else:
            # the shipped retrained AE (byte copy of lemo_tpu's asset)
            infill_ae = load_state_dict_npz(
                osp.join(_ASSET_DIR, "infill_ae.npz"), dev)
            if infill_stats is None:
                infill_stats = Local4ChanStats.load(
                    osp.join(_ASSET_DIR, "infill_stats.npz"), dev)
    faces_segm, ign_table = part_filter(cfg, model.faces)
    return ProxAssets(model=model, vposer_params=vposer_params,
                      smooth_enc_params=smooth_enc, smooth_stats=smooth_stats,
                      infill_ae_params=infill_ae, infill_stats=infill_stats,
                      faces_segm=faces_segm, ign_table=ign_table)


_SDF_CACHE: dict = {}


def _load_sdf_cached(cfg: ProxConfig, rec: ProxRecording, device):
    """Per-recording cache of the scene SDF on the device: (f32 grid,
    the quantized grid the penetration term samples or None, grid_min,
    grid_max). Quantized once at load (ops.sdf.quantize_grid)."""
    key = (rec.sdf_dir, rec.scene_name, bool(cfg.sdf_fp8),
           bool(cfg.sdf_packed), str(device))
    if key not in _SDF_CACHE:
        sdf_np, grid_min, grid_max, _ = rec.load_sdf()
        sdf = torch.as_tensor(sdf_np, device=device)
        mode = "fp8" if key[2] else "bf16" if key[3] else None
        _SDF_CACHE[key] = (
            sdf, None if mode is None else quantize_grid(sdf, mode),
            torch.as_tensor(grid_min, device=device),
            torch.as_tensor(grid_max, device=device))
        if len(_SDF_CACHE) > 4:
            _SDF_CACHE.pop(next(iter(_SDF_CACHE)))
    return _SDF_CACHE[key]


@torch.no_grad()
def _warm_start_vertices(cfg: ProxConfig, assets: ProxAssets,
                         warm: dict) -> torch.Tensor:
    """Body vertices [T, V, 3] (camera coords) of the warm start."""
    model = assets.model
    params = {k: v for k, v in warm.items()
              if k not in ("pose_embedding", "body_pose")}
    if cfg.use_vposer and "pose_embedding" in warm:
        params["body_pose"] = vp.decode(assets.vposer_params,
                                        warm["pose_embedding"], "aa")
    elif "body_pose" in warm:
        params["body_pose"] = warm["body_pose"]
    return make_forward_fn(model)(params, model.consts)["vertices"]


def _sdf_candidate_ids(cfg: ProxConfig, verts: torch.Tensor,
                       st: ProxStatic) -> np.ndarray:
    """[K] ids of the vertices whose warm-start body (`verts` [T, V, 3],
    camera coords) comes nearest the scene anywhere in the window (one
    exact full-vertex SDF pass per window); the K smallest per-vertex
    min-SDF values."""
    return _sdf_candidate_ids_windows(cfg, verts, st, 1)[0]


def _sdf_candidate_ids_windows(cfg: ProxConfig, verts: torch.Tensor,
                               st: ProxStatic, windows: int) -> np.ndarray:
    """`_sdf_candidate_ids` of each of `windows` windows whose frames are
    folded in `verts` [windows * T, V, 3] -> [windows, K], one SDF sample
    of all their bodies."""
    vw = torch.matmul(verts, st.R.T) + st.t
    vals = sample_sdf_world(st.sdf, vw.reshape(-1, 3), st.grid_min,
                            st.grid_max, crop=None)
    min_sdf = vals.reshape(windows, -1, verts.shape[1]).min(dim=1) \
        .values.cpu().numpy()                                 # [W, V]
    K = min(int(cfg.sdf_candidates), verts.shape[1])
    n_close = int((min_sdf < cfg.sdf_candidates_margin).sum(axis=1).max())
    if n_close > K:
        warnings.warn(
            f"sdf_candidates={K} < {n_close} vertices within "
            f"{cfg.sdf_candidates_margin} m of the scene at warm start; "
            "raise sdf_candidates or the term may miss penetrations")
    return np.argsort(min_sdf, axis=1)[:, :K].astype(np.int64)


def _coll_candidate_scores(cfg: ProxConfig, assets: ProxAssets,
                           verts: torch.Tensor) -> tuple:
    """Per-frame face slack scores [T, F] and (n_active, n_within) counts
    [T, 2] of the self-intersection broad phase (one O(F^2) forward-only
    sweep of the warm-start body `verts` [T, V, 3];
    ops.intersection.intersection_candidate_scores_batched)."""
    from lemo_tpu_torch.ops.intersection import \
        intersection_candidate_scores_batched

    dev = verts.device
    segm = (torch.as_tensor(assets.faces_segm, device=dev)
            if assets.faces_segm is not None else None)
    tab = (torch.as_tensor(assets.ign_table, device=dev)
           if assets.ign_table is not None else None)
    scores, counts = intersection_candidate_scores_batched(
        verts, torch.as_tensor(assets.model.faces, device=dev),
        margin=float(cfg.coll_candidates_margin), segm=segm, ign_table=tab)
    return scores.cpu().numpy(), counts.cpu().numpy()


def _coll_pick_K(cfg: ProxConfig, n_active: int, n_within: int,
                 F: int) -> int:
    """Candidate-set size from the configured K and the warm-start live
    count. With cfg.coll_candidates_auto, K grows to cover every face on a
    firing pair, rounded up to a multiple of 1024, so the subset energy
    is exact at refresh time at any configured K."""
    K = min(int(cfg.coll_candidates), F)
    if n_active > K:
        if cfg.coll_candidates_auto:
            K = min(F, -(-n_active // 1024) * 1024)
            print(f"[lemo_tpu_torch] coll_candidates auto-grown to {K} "
                  f"({n_active} faces on firing pairs at warm start > "
                  f"configured {cfg.coll_candidates})", flush=True)
        else:
            warnings.warn(
                f"coll_candidates={K} < {n_active} faces on FIRING energy "
                "pairs at warm start: the subset energy is already "
                "missing penetrations at refresh time; raise "
                "coll_candidates or set coll_candidates_auto")
    elif n_within > K:
        warnings.warn(
            f"coll_candidates={K} < {n_within} faces within "
            f"{cfg.coll_candidates_margin} m of a collision partner at "
            f"warm start ({n_active} live): the margin headroom is "
            "truncated; raise coll_candidates or lower "
            "coll_candidates_margin")
    return K


def _coll_ids_from_scores(scores: np.ndarray, K: int) -> np.ndarray:
    """[T, F] slack scores -> [T, K] face ids (the K smallest slacks),
    in face-id order: the subset energy is order-invariant, and face-id
    order keeps the kernel's tiles compact on the mesh, so its tile-pair
    skip works."""
    ids = np.argsort(scores, axis=1)[:, :K]
    return np.sort(ids, axis=-1).astype(np.int64)


def _coll_candidate_ids(cfg: ProxConfig, assets: ProxAssets, warm: dict,
                        verts: torch.Tensor | None = None
                        ) -> tuple[np.ndarray, dict]:
    """[T, K] face ids of the self-intersection broad phase
    (cfg.coll_candidates): per frame, the K warm-start faces nearest to
    firing. One O(F^2) sweep per window amortizes the reference's per-step
    BVH rebuild (fit_temp_loadprox_slide.py:319-344). `verts`: the
    warm-start body when the caller has it. Returns (ids, stats): the
    largest per-frame n_active and n_within, the K chosen and the sweep's
    seconds."""
    if verts is None:
        verts = _warm_start_vertices(cfg, assets, warm)
    with timed("prox.coll_scores") as sp:
        scores, counts = _coll_candidate_scores(cfg, assets, verts)
        n_active, n_within = int(counts[:, 0].max()), int(counts[:, 1].max())
        K = _coll_pick_K(cfg, n_active, n_within, assets.model.faces.shape[0])
    stats = dict(n_active=n_active, n_within=n_within, K=K,
                 scores_s=sp.seconds)
    return _coll_ids_from_scores(scores, K), stats


def _gmof_np(d: np.ndarray, rho: float) -> np.ndarray:
    sq = d ** 2
    return (rho ** 2) * sq / (sq + rho ** 2)


@torch.no_grad()
def _depth_candidate_data(cfg: ProxConfig, verts: torch.Tensor,
                          st: ProxStatic) -> tuple:
    """Per-frame candidate ids and frozen remainders of the depth Chamfer
    terms (cfg.depth_candidates): one exact bidirectional Chamfer pass on
    the warm-start geometry picks the Ks scan points nearest the visible
    body and the Kv vertices nearest the scan; the frozen pairs are the
    full-cloud warm value minus the candidate-subset warm value, so the
    subset energy equals the exact term at refresh time. Each direction
    is one batched Chamfer call over the window's frames. `verts`: the
    warm-start body [T, V, 3], camera coords."""
    scan, scan_m = st.scan, st.scan_mask
    T, S = int(scan.shape[0]), int(scan.shape[1])
    V = int(verts.shape[1])
    Ks = min(int(cfg.depth_candidates), S)
    Kv = min(int(cfg.depth_candidates), V)

    vis = frame_visibility(verts, st)                          # [T, V]
    d2s, _ = nn_distance(scan, verts, vis)                     # scan -> body
    d2v, _ = nn_distance(verts, scan, scan_m)                  # body -> scan
    ds = torch.sqrt(d2s + 1e-12).cpu().numpy()
    dv = torch.sqrt(d2v + 1e-12).cpu().numpy()
    vis_np = vis.cpu().numpy()
    sm = scan_m.cpu().numpy()
    bm = st.body_mask.cpu().numpy()

    sids = np.argsort(np.where(sm, ds, np.inf), axis=1)[:, :Ks]
    # with s2m on every vertex near the scan is a prospective target;
    # with m2s only, vertices outside body_mask can never contribute
    dv_rank = dv if cfg.s2m else np.where(bm[None, :], dv, np.inf)
    vids = np.argsort(dv_rank, axis=1)[:, :Kv]

    margin = float(cfg.depth_candidates_margin)
    n_s = int((np.where(sm, ds, np.inf) < margin).sum(axis=1).max())
    n_v = int((dv_rank < margin).sum(axis=1).max())
    if n_s > Ks or n_v > Kv:
        warnings.warn(
            f"depth_candidates={cfg.depth_candidates} < {max(n_s, n_v)} "
            f"scan points/vertices within {margin} m at warm start: the "
            "energy is exact at refresh but the margin headroom for "
            "in-window motion is truncated; raise depth_candidates")

    dev = verts.device
    sids_t = torch.as_tensor(sids, device=dev)
    vids_t = torch.as_tensor(vids, device=dev)
    v_c = torch.gather(verts, 1, vids_t[..., None].expand(-1, -1, 3))
    vis_c = torch.gather(vis, 1, vids_t)
    sc_c = torch.gather(scan, 1, sids_t[..., None].expand(-1, -1, 3))
    sm_c = torch.gather(scan_m, 1, sids_t)
    d2s_c, _ = nn_distance(sc_c, v_c, vis_c)
    d2v_c, _ = nn_distance(v_c, sc_c, sm_c)
    ds_c = torch.sqrt(d2s_c + 1e-12).cpu().numpy()
    dv_c = torch.sqrt(d2v_c + 1e-12).cpu().numpy()

    ar = np.arange(T)[:, None]
    full_s = (_gmof_np(ds, cfg.rho_s2m) * sm).sum(axis=1)
    live_s = (_gmof_np(ds_c, cfg.rho_s2m) * sm[ar, sids]).sum(axis=1)
    s2m_frozen = np.stack(
        [full_s - live_s, sm.sum(axis=1).astype(np.float64)],
        axis=1).astype(np.float32)
    mask_full = vis_np & bm[None, :]
    mask_live = vis_np[ar, vids] & bm[vids]
    full_m = (_gmof_np(dv, cfg.rho_m2s) * mask_full).sum(axis=1)
    live_m = (_gmof_np(dv_c, cfg.rho_m2s) * mask_live).sum(axis=1)
    m2s_frozen = np.stack(
        [full_m - live_m,
         (mask_full.sum(axis=1) - mask_live.sum(axis=1)).astype(np.float64)],
        axis=1).astype(np.float32)
    return sids, vids, s2m_frozen, m2s_frozen, vis_np[ar, vids]


def _candidate_updates(cfg: ProxConfig, assets: ProxAssets, warm: dict,
                       st: ProxStatic) -> dict:
    """The candidate-dependent ProxStatic fields from a warm start (the
    window build and the stage-boundary refresh), and under "broad_phase"
    the self-intersection pre-pass's stats (`_coll_candidate_ids`)."""
    dev = assets.model.device
    upd: dict = {}
    want_sdf = bool(cfg.sdf_penetration and st.sdf is not None
                    and cfg.sdf_candidates > 0)
    want_depth = bool((cfg.s2m or cfg.m2s) and st.scan is not None
                      and cfg.depth_candidates > 0)
    want_coll = bool(cfg.interpenetration and cfg.coll_candidates > 0)
    if not (want_sdf or want_depth or want_coll):
        return upd
    verts = _warm_start_vertices(cfg, assets, warm)      # one forward
    if want_coll:
        ids, upd["broad_phase"] = _coll_candidate_ids(cfg, assets, warm,
                                                      verts)
        upd["coll_candidate_ids"] = torch.as_tensor(ids, device=dev)
    if want_sdf:
        upd["sdf_candidate_ids"] = torch.as_tensor(
            _sdf_candidate_ids(cfg, verts, st), device=dev)
    if want_depth:
        upd.update(_depth_updates(cfg, verts, st))
    return upd


def _depth_updates(cfg: ProxConfig, verts: torch.Tensor,
                   st: ProxStatic) -> dict:
    """The depth candidate fields of a window's static
    (`_depth_candidate_data`) as tensors on its device."""
    dev = verts.device
    sids, vids, s2m_fr, m2s_fr, vis_c = _depth_candidate_data(cfg, verts, st)
    upd = dict(depth_scan_cand_ids=torch.as_tensor(sids, device=dev),
               depth_vert_cand_ids=torch.as_tensor(vids, device=dev),
               s2m_frozen=torch.as_tensor(s2m_fr, device=dev),
               m2s_frozen=torch.as_tensor(m2s_fr, device=dev))
    if cfg.depth_frozen_visibility:
        upd["depth_vis_frozen"] = torch.as_tensor(vis_c, device=dev)
    return upd


def _apply_candidates_batch(cfg: ProxConfig, assets: ProxAssets,
                            warm: dict, statics: list, mesh=None,
                            n_windows: int | None = None
                            ) -> tuple[list, dict]:
    """Candidate sets of W windows (`lemo_tpu/fitting/prox/driver.py:
    519-572`) from their warm starts `warm` ({name: [W, T, ...]} on the
    device): one forward and one self-intersection sweep a window (each
    window's bodies and scores those of its sequential fit) feed the
    pre-passes; one K for all windows, sized from the largest live count
    over them (`_coll_pick_K`), so the [T, K] sets stack; the SDF
    candidates from one sample of all W bodies; the depth candidates per
    window. Returns (statics, broad_phase): the self-intersection
    pre-pass's largest per-frame counts over all windows, K, its seconds,
    and each window's own (n_active, n_within) under "per_window"
    (None when the pre-pass did not run). Under a `mesh` (one process
    per card) `warm` and `statics` are this rank's share of `n_windows`
    windows: every pre-pass runs on them alone, and the per-window
    counts are gathered, so that every rank picks the K of the unsharded
    run."""
    dev = assets.model.device
    st0 = statics[0]
    W = len(statics)
    want_sdf = bool(cfg.sdf_penetration and st0.sdf is not None
                    and cfg.sdf_candidates > 0)
    want_depth = bool((cfg.s2m or cfg.m2s) and st0.scan is not None
                      and cfg.depth_candidates > 0)
    want_coll = bool(cfg.interpenetration and cfg.coll_candidates > 0)
    if not (want_sdf or want_depth or want_coll):
        return statics, None
    T = int(warm["transl"].shape[1])
    # a forward a window: products round by their row count, so a window
    # gets the bodies, and with them the candidate sets, of its own
    # sequential or sharded run
    verts = torch.cat([_warm_start_vertices(cfg, assets,
                                            {k: v[i] for k, v in warm.items()})
                       for i in range(W)])                  # [W*T, V, 3]
    upds: list = [{} for _ in range(W)]
    broad_phase = None
    if want_coll:
        with timed("prox.coll_scores") as sp:
            # a window at a time, so that each window's scores are its own
            # sweep's (the sequential driver's, and a sharded rank's)
            sweeps = [_coll_candidate_scores(cfg, assets, v)
                      for v in verts.split(T)]
            scores = np.concatenate([sw[0] for sw in sweeps])
            counts = np.stack([sw[1].max(axis=0) for sw in sweeps])  # [W, 2]
            if mesh is not None:
                counts = sharding.gather_rows(
                    mesh, torch.as_tensor(counts, device=dev),
                    n_windows).cpu().numpy()
            n_active, n_within = (int(c) for c in counts.max(axis=0))
            K = _coll_pick_K(cfg, n_active, n_within,
                             assets.model.faces.shape[0])
            for i in range(W):
                upds[i]["coll_candidate_ids"] = torch.as_tensor(
                    _coll_ids_from_scores(scores[i * T:(i + 1) * T], K),
                    device=dev)
        broad_phase = dict(n_active=n_active, n_within=n_within, K=K,
                           scores_s=sp.seconds,
                           per_window=[tuple(int(x) for x in c)
                                       for c in counts])
    if want_sdf:
        ids = _sdf_candidate_ids_windows(cfg, verts, st0, W)
        for i in range(W):
            upds[i]["sdf_candidate_ids"] = torch.as_tensor(ids[i], device=dev)
    if want_depth:
        for i, st in enumerate(statics):
            upds[i].update(_depth_updates(cfg, verts[i * T:(i + 1) * T], st))
    return [dataclasses.replace(st, **u) for st, u in zip(statics, upds)], \
        broad_phase


def stage_joint_weights(cfg: ProxConfig, joint_weights: np.ndarray,
                        stage: int = 0) -> np.ndarray:
    """Per-stage hand/face keypoint weights
    (fit_temp_loadprox_slide.py:525-528)."""
    def at(lst):
        return float(lst[min(stage, len(lst) - 1)])

    jw = joint_weights.copy()
    if cfg.use_hands:
        jw[25:76] = at(cfg.hand_joints_weights)
    if cfg.use_face:
        jw[76:] = at(cfg.face_joints_weights)
    for j in cfg.joints_to_ign:
        if 0 <= int(j) < len(jw):
            jw[int(j)] = 0.0
    return jw


def build_window_static(cfg: ProxConfig, assets: ProxAssets,
                        rec: ProxRecording, window_data: dict,
                        joint_weights: np.ndarray, infill_result=None,
                        stage: int = 0, with_candidates: bool = True
                        ) -> tuple[ProxStatic, dict | None]:
    """The window's ProxStatic and the stats of its self-intersection
    broad phase (None when it did not run)."""
    model = assets.model
    dev = model.device
    V = model.num_verts

    def t(x, dtype=None):
        return None if x is None else torch.as_tensor(
            np.asarray(x), dtype=dtype, device=dev)

    camera = PerspectiveCamera(cfg.focal_length_x, cfg.focal_length_y,
                               (cfg.camera_center_x, cfg.camera_center_y))
    R, tr = rec.load_cam2world()
    sdf = sdf_q = grid_min = grid_max = None
    if cfg.sdf_penetration or cfg.use_friction:
        sdf, sdf_q, grid_min, grid_max = _load_sdf_cached(cfg, rec, dev)
    jw = stage_joint_weights(cfg, joint_weights, stage)
    _, body_mask = seg.head_and_body_masks(V)
    keypoints = window_data["keypoints"]
    depth = cfg.s2m or cfg.m2s
    i64 = torch.int64
    st = ProxStatic(
        gt_joints=t(keypoints[:, :, :2]),
        joints_conf=t(keypoints[:, :, 2]),
        joint_weights=t(jw),
        camera=camera,
        R=t(R), t=t(tr),
        scan=t(window_data["scan"]) if depth else None,
        scan_mask=t(window_data["scan_mask"], torch.bool) if depth else None,
        body_mask=t(body_mask, torch.bool),
        sdf=sdf, sdf_packed=sdf_q, grid_min=grid_min, grid_max=grid_max,
        scene_verts=(t(assets.scene_verts)
                     if cfg.contact and assets.scene_verts is not None
                     else None),
        contact_verts_ids=(t(seg.contact_vertex_ids(cfg.contact_body_parts,
                                                    V), i64)
                           if cfg.contact else None),
        fric_verts_ids=(t(seg.friction_vertex_ids(V), i64)
                        if cfg.use_friction else None),
        foot_ids=seg.foot_vertex_ids(V),
        smooth_enc_params=assets.smooth_enc_params,
        smooth_stats=assets.smooth_stats,
        smooth_marker_ids=t(mk.marker_indices(True, num_verts=V), i64),
        marker_mask=t(window_data["marker_mask"]),
        infill_marker_ids=t(mk.marker_indices(False, num_verts=V), i64),
        faces_vis=(t(model.faces, i64) if depth else None),
        faces=t(model.faces, i64) if cfg.interpenetration else None,
        faces_segm=(t(assets.faces_segm, i64)
                    if cfg.interpenetration and assets.faces_segm is not None
                    else None),
        ign_table=(t(assets.ign_table, torch.bool)
                   if cfg.interpenetration and assets.ign_table is not None
                   else None),
    )
    broad_phase = None
    if with_candidates:
        warm = {k: t(v) for k, v in window_data["warm_start"].items()}
        upd = _candidate_updates(cfg, assets, warm, st)
        broad_phase = upd.pop("broad_phase", None)
        if upd:
            st = dataclasses.replace(st, **upd)
    if infill_result is not None:
        st = dataclasses.replace(
            st, infill_targets=infill_result.targets_world,
            infill_contact_lbl=infill_result.contact_lbl)
    return st, broad_phase


_CAMERA_PKL_PARAMS = {
    # the PROX camera's pose is frozen at identity/zero (main_slide.py:
    # 192-193); the reference still serializes it per frame
    "rotation": np.eye(3, dtype=np.float32),
    "translation": np.zeros(3, np.float32),
}


def _make_warm_world_markers(assets: ProxAssets, rec: ProxRecording):
    """warm start -> (world 67-markers [T, 67, 3], world joints
    [T, 25, 3]) for the infill pre-pass."""
    model = assets.model
    dev = model.device
    fwd = make_forward_fn(model)
    Rw, tw = rec.load_cam2world()
    Rw = torch.as_tensor(Rw, device=dev)
    tw = torch.as_tensor(tw, device=dev)
    ids67 = torch.as_tensor(mk.marker_indices(False,
                                              num_verts=model.num_verts),
                            device=dev)

    @torch.no_grad()
    def warm_world_markers(warm):
        params = {k: warm[k] for k in
                  ("transl", "global_orient", "betas", "left_hand_pose",
                   "right_hand_pose", "jaw_pose", "leye_pose", "reye_pose",
                   "expression")}
        params["body_pose"] = vp.decode(assets.vposer_params,
                                        warm["pose_embedding"], "aa")
        out = fwd(params, model.consts)
        mv = torch.matmul(out["vertices"], Rw.T) + tw
        mj = torch.matmul(out["joints"][:, :25], Rw.T) + tw
        return mv.index_select(1, ids67), mj

    return warm_world_markers


def _make_window_extras_saver(cfg, assets, rec, output_folder):
    """Per-window `save_meshes` / `render_results` outputs
    (fit_temp_loadprox_slide.py:596-704): body ply per frame under
    <output>/<mesh_folder>/<frame>/000.ply and body-over-Color overlay
    renders under <output>/images/<frame>.png. Returns
    ``save(frame_names, result)`` or None when both flags are off.

    The bodies are rebuilt in one forward of the window's frames on the
    model's device; the overlay goes through the host software rasterizer
    (the reference uses pyrender), seconds a frame at full resolution, so
    it is opt-in like the reference's flag. A Color frame is read as
    `<frame>.jpg`, else `<frame>.png` (`data.png.read_color_frame`; a JPEG
    the decoder refuses is refused by `check_ported` before the fits)."""
    if not (cfg.save_meshes or cfg.render_results):
        return None
    from lemo_tpu_torch.data.png import read_color_frame, write_png
    from lemo_tpu_torch.data.prox import write_ply_vertices
    from lemo_tpu_torch.utils.raster import render_body_overlay

    model = assets.model
    fwd = make_forward_fn(model)
    faces = np.asarray(model.faces)
    mesh_dir = osp.join(output_folder, cfg.mesh_folder)
    img_dir = osp.join(output_folder, "images")
    color_dir = osp.join(rec.recording_dir, cfg.img_folder)

    def save(frame_names, result):
        params = model.zero_params(len(frame_names))
        for k, v in result.params.items():
            if k in params:
                params[k] = torch.as_tensor(v, device=model.device)
        with torch.no_grad():
            verts = fwd(params, model.consts)["vertices"].cpu().numpy()
        n_mesh = n_img = 0
        for i, fn in enumerate(frame_names):
            if cfg.save_meshes:
                d = osp.join(mesh_dir, fn)
                os.makedirs(d, exist_ok=True)
                write_ply_vertices(osp.join(d, "000.ply"), verts[i],
                                   faces=faces)
                n_mesh += 1
            if cfg.render_results:
                img_path = None
                for ext in (".jpg", ".png"):
                    cand = osp.join(color_dir, fn + ext)
                    if osp.exists(cand):
                        img_path = cand
                        break
                if img_path is None:
                    continue
                img = read_color_frame(img_path)
                if cfg.flip:
                    img = img[:, ::-1]
                over = render_body_overlay(
                    verts[i], faces, img,
                    cfg.focal_length_x, cfg.focal_length_y,
                    cfg.camera_center_x, cfg.camera_center_y)
                os.makedirs(img_dir, exist_ok=True)
                write_png(osp.join(img_dir, fn + ".png"), over)
                n_img += 1
        return n_mesh, n_img

    return save


def _sync(dev: torch.device) -> None:
    """Wait for the device, so that a phase's seconds hold its work."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def jacobi_rounds(polish: int, rounds: int, chunk: int) -> tuple[int, int]:
    """(rounds, iterations a round) of the Jacobi polish
    (`lemo_tpu/fitting/prox/driver.py:976-979`); each round then runs
    whole chunks (`window.whole_chunks`), so polish 250 with chunk 100 is
    2 rounds of 200 steps."""
    n = max(1, min(int(rounds), polish // chunk if polish >= chunk else 1))
    return n, max(1, polish // n)


# the wall-clock split of the most recent window-parallel run: seconds
# from the `lemo.prox.*` spans (`utils.profiling.timed`), polish_round_s
# a list, polish_mode a word; each WindowResult of that run carries the
# same dict in `timings`
LAST_PARALLEL_TIMINGS: dict = {}


def _run_window_parallel(cfg, assets, rec, ds, jw, mapper, result_folder,
                         n_windows, verbose, save_extras=None, mesh=None):
    """All windows fitted at once (`lemo_tpu/fitting/prox/driver.py:
    777-1126`): every warm start comes from the previous stage's pkls,
    so windows load in threads and the pre-passes batch; each stage is
    one batched fit (`make_batched_window_fitter`), its candidate sets
    rebuilt at each stage boundary; then the polish pass re-fits each
    window's head from the previous window's solution, Jacobi (batched
    rounds, heads injected before each) or sequential (one window after
    another at the final stage's weights). The pkls are written in
    threads, a shared frame's from the later window (in `lemo_tpu` the
    threads race for it), then `save_extras` (not thread-safe) runs
    window by window.

    With `mesh` (one process per card: `lemo_tpu`'s window axis sharded
    over its device mesh), each rank loads its `tensor_split` share of
    the windows and runs the infill pre-pass, the candidate pre-passes
    (the coll broad phase among them; one K for all windows from the
    gathered counts) and its share of every batched fit on them alone;
    the fits' outputs are gathered, so the Jacobi rounds inject the
    heads as without a mesh. The sequential polish stays one chain: each
    window is re-fitted by its owner after the previous window, whose
    result is broadcast. Every rank returns the same WindowResults (but
    for `timings`, its own walls); rank 0 alone writes the pkls and
    extras and sets LAST_PARALLEL_TIMINGS. With fewer windows than
    ranks, the window axis is padded to one window a rank with copies of
    window 0, as `lemo_tpu` pads it to a multiple of its mesh
    (`lemo_tpu/fitting/prox/window.py:423-450`): a pad is loaded, fitted
    (its head frozen whole in the Jacobi rounds) and joins every
    collective, and is dropped before any result, pkl or count a window
    is formed."""
    from concurrent.futures import ThreadPoolExecutor

    model = assets.model
    dev = model.device
    dp = None if mesh is None else mesh.along("dp")
    # the windows fitted: the recording's, then copies of window 0 up to
    # one a rank (a tensor_split share needs no other padding)
    n_fit = n_windows if dp is None else max(n_windows, dp.size)
    src = list(range(n_windows)) + [0] * (n_fit - n_windows)
    lo, hi = (0, n_fit) if dp is None else dp.rows(n_fit)
    writer = dp is None or dp.rank == 0
    with timed("prox.windows") as whole:
        with timed("prox.load") as sp:
            with ThreadPoolExecutor(max_workers=8) as ex:
                window_data = list(ex.map(ds.load_window, src[lo:hi]))
            warm = {k: torch.as_tensor(np.stack([wd["warm_start"][k]
                                                 for wd in window_data]),
                                       device=dev)
                    for k in window_data[0]["warm_start"]}
            _sync(dev)
        timings: dict = {"load_s": sp.seconds}

        with timed("prox.prepass") as sp:
            infill_results = [None] * len(window_data)
            if cfg.use_motion_infill_prior and assets.infill_ae_params:
                # a forward a window gives its markers (as its sequential
                # fit's: products round by their row count)
                W = warm["transl"].shape[0]
                wwm = _make_warm_world_markers(assets, rec)
                mv67, mj = (torch.stack(x) for x in zip(*[
                    wwm({k: v[i] for k, v in warm.items()})
                    for i in range(W)]))
                masks = np.stack([wd["marker_mask"] for wd in window_data])
                tw, cl = make_batched_prepass(
                    assets.infill_stats,
                    finetune_steps=int(cfg.infill_finetune_steps))(
                    assets.infill_ae_params, mv67, mj,
                    torch.as_tensor(masks, device=dev))
                infill_results = [
                    InfillPrepassResult(targets_world=tw[i],
                                        contact_lbl=cl[i],
                                        had_occlusion=bool(masks[i].size
                                                           > masks[i].sum()))
                    for i in range(W)]
            _sync(dev)
        timings["prepass_s"] = sp.seconds

        with timed("prox.static_build") as sp:
            statics = [build_window_static(cfg, assets, rec, wd, jw, ir,
                                           with_candidates=False)[0]
                       for wd, ir in zip(window_data, infill_results)]
            statics, broad_phase = _apply_candidates_batch(
                cfg, assets, warm, statics, dp, n_fit)
            static_batch = stack_statics(statics)
            first_mask = np.arange(n_fit) == 0
            _sync(dev)
        timings["static_build_s"] = sp.seconds

        priors = build_priors(cfg, dev)
        timings["fit_s"] = timings["refresh_s"] = 0.0
        losses_stages, terms_stages = [], []
        for stage in range(cfg.n_stages):
            w_s = weights_from_config(cfg, stage)
            if stage > 0 and cfg.candidates_refresh_stages:
                # candidate sets from this stage's warm start, the previous
                # stage's solution
                with timed("prox.refresh") as sp:
                    statics, broad_phase = _apply_candidates_batch(
                        cfg, assets, warm, statics, dp, n_fit)
                    static_batch = stack_statics(statics)
                    _sync(dev)
                timings["refresh_s"] += sp.seconds
            static_batch_s = dataclasses.replace(
                static_batch, joint_weights=torch.as_tensor(
                    stage_joint_weights(cfg, jw, stage), device=dev))
            fitter = make_batched_window_fitter(
                model, assets.vposer_params, mapper, statics[0], w_s,
                maxiters=cfg.maxiters, lr=cfg.lr, mesh=dp,
                steps_per_dispatch=cfg.steps_per_dispatch, priors=priors,
                use_vposer=cfg.use_vposer, optim_type=cfg.optim_type)
            with timed("prox.fit") as sp:
                opt_vars, betas, losses, terms = fitter(static_batch_s, warm,
                                                        first_mask)
                losses_stages.append(losses.cpu().numpy())
                terms_stages.append({k: v.cpu().numpy()
                                     for k, v in terms.items()})
            timings["fit_s"] += sp.seconds
            if stage + 1 < cfg.n_stages:
                warm = {k: v[lo:hi] for k, v in dict(opt_vars,
                                                     betas=betas).items()}
        losses = np.concatenate(losses_stages, axis=1)

        sols = [{k: v[i] for k, v in opt_vars.items()}
                for i in range(n_windows)]
        loss_hists = [losses[i] for i in range(n_windows)]
        # one term record per stage (its final solution), then the polish
        # pass's: one a Jacobi round, or one a sequential polish step
        term_hists = [{k: np.stack([ts[k][i] for ts in terms_stages])
                       for k in terms_stages[0]} for i in range(n_windows)]

        polish = int(cfg.window_polish_iters or 0)
        polish_mode = cfg.window_polish_mode
        spans = ds.windows
        T = int(statics[0].gt_joints.shape[0])
        erase_head = int(T * 0.15)
        with timed("prox.polish") as sp:
            if polish > 0 and n_windows > 1 and polish_mode == "jacobi":
                rounds, iters_per_round = jacobi_rounds(
                    polish, cfg.window_polish_rounds,
                    dispatch_chunk(cfg.steps_per_dispatch, cfg.maxiters))
                # window 0 stays frozen whole, as the sequential polish
                # never re-fits it, and so do the pads; the others freeze
                # their overlap heads
                erase = np.full((n_fit,), erase_head, np.int64)
                erase[0] = T
                erase[n_windows:] = T
                cur = {k: v.clone() for k, v in opt_vars.items()}

                def inject_heads(arrs, n_inject_of):
                    for i in range(1, n_windows):
                        s_prev, e_prev = spans[i - 1]
                        s_cur, _ = spans[i]
                        n_inj = n_inject_of(max(e_prev - s_cur, 0))
                        if n_inj > 0:
                            off = s_cur - s_prev
                            for k in arrs:
                                arrs[k][i, :n_inj] = \
                                    arrs[k][i - 1, off:off + n_inj]

                round_s = []
                for r in range(rounds):
                    with timed("prox.polish_round") as sp_r:
                        inject_heads(cur, lambda ov_n: ov_n)
                        ov2, _, p_losses, p_terms = fitter(
                            static_batch_s, dict(cur, betas=betas),
                            first_mask, maxiters_override=iters_per_round,
                            erase_override=erase)
                        cur = {k: v.clone() for k, v in ov2.items()}
                        p_losses = p_losses.cpu().numpy()
                        p_terms = {k: v.cpu().numpy()
                                   for k, v in p_terms.items()}
                    round_s.append(sp_r.seconds)
                    for i in range(n_windows):
                        loss_hists[i] = np.concatenate([loss_hists[i],
                                                        p_losses[i]])
                        term_hists[i] = {
                            k: np.concatenate([term_hists[i][k],
                                               p_terms[k][i:i + 1]])
                            for k in term_hists[i]}
                timings["polish_round_s"] = round_s
                # the frozen heads equal the previous window's final tail
                # (they were frozen through the rounds, so no optimized
                # frame changes)
                inject_heads(cur, lambda ov_n: min(ov_n, erase_head))
                sols = [{k: v[i] for k, v in cur.items()}
                        for i in range(n_windows)]
            elif polish > 0 and n_windows > 1:
                jw_final = torch.as_tensor(
                    stage_joint_weights(cfg, jw, cfg.n_stages - 1),
                    device=dev)
                statics = [dataclasses.replace(st, joint_weights=jw_final)
                           for st in statics]
                pfitter = make_window_fitter(
                    model, assets.vposer_params, mapper, statics[0], w_s,
                    maxiters=polish, lr=cfg.lr,
                    steps_per_dispatch=cfg.steps_per_dispatch,
                    priors=priors, use_vposer=cfg.use_vposer)
                for i in range(1, n_windows):
                    owner = 0 if dp is None else \
                        sharding.shard_owner(n_fit, dp.size, i)
                    if dp is None or owner == dp.rank:
                        s_prev, e_prev = spans[i - 1]
                        s_cur, _ = spans[i]
                        ov_n = max(e_prev - s_cur, 0)
                        prox_params = {k: v.clone()
                                       for k, v in sols[i].items()}
                        prox_params["betas"] = betas[i]
                        if ov_n > 0:
                            off = s_cur - s_prev
                            for k in sols[i]:
                                prox_params[k][:ov_n] = \
                                    sols[i - 1][k][off:off + ov_n]
                        final, p_losses, p_terms, _ = pfitter(
                            statics[i - lo], prox_params, first_window=False)
                    else:   # buffers of the owner's shapes, for the broadcast
                        final = {k: torch.empty_like(v)
                                 for k, v in sols[i].items()}
                        p_losses = torch.empty(polish, device=dev)
                        p_terms = {}
                    if dp is not None:
                        final, p_losses, p_terms = _broadcast_polish(
                            dp, owner, final, p_losses, p_terms,
                            list(term_hists[i]), polish)
                    sols[i] = final
                    loss_hists[i] = np.concatenate([loss_hists[i],
                                                    p_losses.cpu().numpy()])
                    term_hists[i] = {k: np.concatenate([term_hists[i][k],
                                                        v.cpu().numpy()])
                                     for k, v in p_terms.items()
                                     if k in term_hists[i]}
            _sync(dev)
        timings["polish_s"] = sp.seconds

        with timed("prox.save") as sp:
            results = [window_result(sols[i], betas[i], loss_hists[i],
                                     term_hists[i], assets.vposer_params,
                                     cfg.use_vposer)
                       for i in range(n_windows)]
            if writer:
                # a frame two windows share gets the later window's pkl, as
                # in the sequential driver: each thread writes only the
                # frames no later window holds (threads writing one file
                # from two windows would race)
                fns = [ds.frame_names[s:e] for s, e in spans[:n_windows]]
                last = {fn: i for i in range(n_windows) for fn in fns[i]}
                with ThreadPoolExecutor(max_workers=8) as ex:
                    list(ex.map(lambda i: save_window_pkls(
                        results[i], fns[i], result_folder,
                        camera_params=_CAMERA_PKL_PARAMS,
                        only={fn for fn in fns[i] if last[fn] == i}),
                        range(n_windows)))
                if save_extras is not None:
                    for i in range(n_windows):
                        save_extras(fns[i], results[i])
        timings["save_s"] = sp.seconds
    timings["total_s"] = whole.seconds
    timings["polish_mode"] = polish_mode if polish > 0 else "off"
    if writer:
        LAST_PARALLEL_TIMINGS.clear()
        LAST_PARALLEL_TIMINGS.update(timings)
    if verbose and writer:
        print(f"[window-parallel] {n_windows} windows in "
              f"{timings['total_s']:.1f}s"
              f"{f' (+{polish}-iter {polish_mode} polish)' if polish else ''}"
              f"; losses {[round(float(h[-1]), 3) for h in loss_hists]}; "
              "split " + ", ".join(f"{k}={v:.1f}s" for k, v in timings.items()
                                   if isinstance(v, float)), flush=True)
    if broad_phase is not None:
        broad_phase = dict(broad_phase,
                           per_window=broad_phase["per_window"][:n_windows])
    return [dataclasses.replace(r, timings=timings, broad_phase=broad_phase)
            for r in results]


def _broadcast_polish(dp, owner: int, final: dict, p_losses, p_terms: dict,
                      keys: list, polish: int):
    """A sequential polish's result (its parameters, losses [polish] and
    the terms of `keys`, [polish] each) from the window's owner rank to
    every rank. A term the owner's polish does not report stays out, as
    without a mesh."""
    dev = p_losses.device
    have = torch.tensor([k in p_terms for k in keys], device=dev)
    rows = torch.stack([p_terms[k] if k in p_terms else
                        torch.zeros(polish, device=dev) for k in keys])
    final, p_losses, have, rows = sharding.broadcast_tree(
        dp, (final, p_losses, have, rows), src=owner)
    return final, p_losses, {k: rows[j] for j, k in enumerate(keys)
                             if bool(have[j])}


def run_prox_fitting(cfg: ProxConfig, assets: ProxAssets | None = None,
                     max_windows: int | None = None, verbose: bool = True,
                     device=None) -> list:
    """Fit a recording window by window; returns WindowResults, each with
    the wall-clock split of its window in `timings` (seconds for load,
    infill pre-pass, static build with the candidate pre-passes, fit and
    save, each a `lemo.prox.*` span's, `utils.profiling.timed`; every
    phase ends in a host read of device results, so the split is
    synchronous) and, with interpenetration candidates, the last
    stage's self-intersection pre-pass in `broad_phase`. The fit runs on
    `assets.model.device` (or `device` when assets are loaded here: None
    means the CUDA card).

    Under an initialised process group (`parallel.initialize_multihost`,
    a no-op in one process; `lemo_tpu` builds its mesh when it has more
    than one device), the window-parallel fit shards its windows over
    `parallel.make_mesh()` (`_run_window_parallel`; one rank included)
    and rank 0 alone writes files; the sequential fit refuses to run
    under more than one process."""
    check_ported(cfg)
    mesh = sharding.make_mesh() if dist.is_available() and \
        dist.is_initialized() else None
    if mesh is not None and mesh.size > 1 and not cfg.window_parallel:
        raise ValueError(
            "window_parallel: false fits the windows one after another on "
            f"one card; under {mesh.size} processes set window_parallel: "
            "true (the windows sharded over them) or run one process")
    writer = mesh is None or mesh.rank == 0
    if assets is None:
        assets = load_assets(cfg, device)
    exact_f32_matmuls()
    rec = ProxRecording.from_recording_dir(cfg.recording_dir)
    if cfg.contact and cfg.load_scene and assets.scene_verts is None:
        assets = dataclasses.replace(assets,
                                     scene_verts=rec.load_scene_mesh())
    output_folder = osp.join(osp.expandvars(cfg.output_folder),
                             rec.recording_name)
    result_folder = osp.join(output_folder, cfg.result_folder)
    if writer:
        os.makedirs(result_folder, exist_ok=True)
        with open(osp.join(output_folder, "conf.yaml"), "w") as fh:
            fh.write(dump_yaml(dataclasses.asdict(cfg)))

    ds = ProxWindowDataset(
        rec, output_params_dir=output_folder, batch_size=cfg.batch_size,
        img_folder=cfg.img_folder,
        read_depth=cfg.read_depth and (cfg.s2m or cfg.m2s
                                       or cfg.init_mode == "scan"),
        read_mask=cfg.read_mask, mask_on_color=cfg.mask_on_color,
        flip=cfg.flip, use_hands=cfg.use_hands, use_face=cfg.use_face,
        joints_to_ign=cfg.joints_to_ign, start=cfg.start, step=cfg.step,
        frame_ids=cfg.frame_ids)
    jw = ds.joint_weights()
    mapper = smpl_to_openpose(cfg.model_type, cfg.use_hands, cfg.use_face,
                              cfg.use_face_contour)
    n_windows = len(ds.windows) if max_windows is None else \
        min(max_windows, len(ds.windows))
    save_extras = _make_window_extras_saver(cfg, assets, rec, output_folder) \
        if writer else None
    if cfg.window_parallel:
        return _run_window_parallel(cfg, assets, rec, ds, jw, mapper,
                                    result_folder, n_windows, verbose,
                                    save_extras=save_extras, mesh=mesh)

    # host-side loading of window i+1 (PNG decoding, scan unprojection)
    # overlaps window i's fit; warm-start pkls are read only after the
    # previous window saved (own-output-first resume)
    from concurrent.futures import ThreadPoolExecutor

    prefetcher = ThreadPoolExecutor(max_workers=1) \
        if (cfg.prefetch_windows and n_windows > 0) else None
    fut = prefetcher.submit(ds.load_window, 0, False) if prefetcher else None
    try:
        return _fit_windows_sequential(cfg, assets, rec, ds, jw, mapper,
                                       result_folder, n_windows, verbose,
                                       prefetcher, fut, save_extras)
    finally:
        if prefetcher:
            prefetcher.shutdown(wait=False, cancel_futures=True)


def _fit_windows_sequential(cfg, assets, rec, ds, jw, mapper, result_folder,
                            n_windows, verbose, prefetcher, fut,
                            save_extras=None):
    model = assets.model
    dev = model.device
    priors = build_priors(cfg, dev)
    warm_world_markers = None
    if cfg.use_motion_infill_prior and assets.infill_ae_params:
        warm_world_markers = _make_warm_world_markers(assets, rec)
    stage_fitters: dict = {}
    results = []
    for widx in range(n_windows):
        with timed("prox.window") as whole:
            with timed("prox.load") as sp:
                if prefetcher:
                    wd = fut.result()
                    if widx + 1 < n_windows:
                        fut = prefetcher.submit(ds.load_window, widx + 1,
                                                False)
                    wd["warm_start"] = ds.load_window_warm_start(widx)
                else:
                    wd = ds.load_window(widx)
                warm = {k: torch.as_tensor(v, device=dev)
                        for k, v in wd["warm_start"].items()}
            timing = {"load_s": sp.seconds}

            with timed("prox.prepass") as sp:
                infill_result = None
                if warm_world_markers is not None:
                    mv67, mj = warm_world_markers(warm)
                    infill_result = run_infill_prepass(
                        assets.infill_ae_params, mv67, mj,
                        torch.as_tensor(wd["marker_mask"], device=dev),
                        assets.infill_stats,
                        finetune_steps=int(cfg.infill_finetune_steps))
            timing["prepass_s"] = sp.seconds

            # one full maxiters run per weight stage, the next stage
            # warm-started from the previous one
            # (fit_temp_loadprox_slide.py:507-528)
            result = None
            wd_stage = wd
            timing["static_s"] = timing["fit_s"] = 0.0
            broad_phase = None
            for stage in range(cfg.n_stages):
                if stage > 0 and cfg.candidates_refresh_stages:
                    wd_stage = dict(wd)
                    wd_stage["warm_start"] = {k: v.cpu().numpy()
                                              for k, v in warm.items()}
                with timed("prox.static_build") as sp:
                    static, broad_phase = build_window_static(
                        cfg, assets, rec, wd_stage, jw, infill_result,
                        stage=stage)
                timing["static_s"] += sp.seconds
                w_s = weights_from_config(cfg, stage)
                if stage not in stage_fitters:
                    stage_fitters[stage] = make_window_fitter(
                        model, assets.vposer_params, mapper, static, w_s,
                        maxiters=cfg.maxiters, lr=cfg.lr,
                        optim_type=cfg.optim_type,
                        steps_per_dispatch=cfg.steps_per_dispatch,
                        priors=priors, use_vposer=cfg.use_vposer)
                with timed("prox.fit") as sp:
                    result_s = fit_window(
                        model, assets.vposer_params, mapper, static, w_s,
                        warm, first_window=(widx == 0),
                        maxiters=cfg.maxiters, lr=cfg.lr,
                        fitter=stage_fitters[stage],
                        use_vposer=cfg.use_vposer)
                timing["fit_s"] += sp.seconds
                if result is None:
                    result = result_s
                else:
                    result = dataclasses.replace(
                        result_s,
                        loss_history=np.concatenate(
                            [result.loss_history, result_s.loss_history]),
                        term_history={
                            k: np.concatenate([result.term_history[k], v])
                            for k, v in result_s.term_history.items()})
                if stage + 1 < cfg.n_stages:
                    warm = {k: torch.as_tensor(v, device=dev)
                            for k, v in result_s.params.items()}
                    warm["pose_embedding"] = torch.as_tensor(
                        result_s.pose_embedding, device=dev)
            with timed("prox.save") as sp:
                save_window_pkls(result, wd["fns"], result_folder,
                                 camera_params=_CAMERA_PKL_PARAMS)
                if save_extras is not None:
                    save_extras(wd["fns"], result)
            timing["save_s"] = sp.seconds
        timing["total_s"] = whole.seconds
        results.append(dataclasses.replace(
            result, timings=timing, broad_phase=broad_phase))
        if verbose:
            print(f"[window {widx + 1}/{n_windows}] frames "
                  f"{ds.windows[widx]}: loss {result.final_loss:.4f} "
                  f"({timing['total_s']:.1f}s)", flush=True)
    return results
