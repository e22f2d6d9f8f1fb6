"""AMASS mocap plumbing (port of `lemo_tpu/data/amass.py`): the sequence
scan with fps resampling and clip chunking, and the batched body
representations of the three reference loaders
(loader/train_loader_smooth.py, train_loader_infill.py,
optimize_loader_amass_new.py).

The scan is host-side numpy. The SMPL-X forward that turns each clip's
parameters into markers and joints runs on the model's device over all T
frames at once, under `no_grad` (on the card: the chain and vertex
forward kernels), and the representation transforms are the functions
of :mod:`lemo_tpu_torch.data.repr` on that device.
"""

from __future__ import annotations

import dataclasses
import glob
import os
from typing import Iterable

import numpy as np
import torch

from lemo_tpu_torch import exact_f32_matmuls, resolve_device
from lemo_tpu_torch.body_model import load_model, make_forward_fn
from lemo_tpu_torch.body_model.smplx import find_smplx_npz
from lemo_tpu_torch.data import markers as mk
from lemo_tpu_torch.data import repr as rep
from lemo_tpu_torch.data.stats import GlobalStats, Local4ChanStats, \
    LocalFlatStats

AMASS_TRAIN_DATASETS = [
    "HumanEva", "MPI_HDM05", "MPI_mosh", "Transitions_mocap", "ACCAD",
    "BMLhandball", "BMLmovi", "BioMotionLab_NTroje", "CMU", "DFaust_67",
    "Eyes_Japan_Dataset", "MPI_Limits",
]
AMASS_TEST_DATASETS = ["TCD_handMocap", "TotalCapture", "SFU"]

_SAMPLE_RATE = {150: 5, 120: 4, 60: 2}  # -> 30 fps (train_loader_smooth.py:39-46)


@dataclasses.dataclass
class Clip:
    """One fixed-length mocap clip at 30 fps."""

    trans: np.ndarray   # [T, 3]
    poses: np.ndarray   # [T, 156]
    betas: np.ndarray   # [16]
    gender: str
    src_fps: int


def scan_amass(datasets: Iterable[str], amass_dir: str,
               clip_seconds: int = 4) -> list[Clip]:
    """Scan ``<amass_dir>/<dataset>/*/*_poses.npz`` and cut non-overlapping
    clips resampled to 30 fps (divide_clip, train_loader_smooth.py:27-74);
    sequences at other rates, or shorter than a clip, are skipped."""
    clips: list[Clip] = []
    for ds in datasets:
        for fn in sorted(glob.glob(os.path.join(amass_dir, ds, "*",
                                                "*_poses.npz"))):
            with np.load(fn) as cdata:
                fps = int(cdata["mocap_framerate"])
                if fps not in _SAMPLE_RATE:
                    continue
                rate = _SAMPLE_RATE[fps]
                clip_len = clip_seconds * fps
                N = len(cdata["poses"])
                if N < clip_len:
                    continue
                trans, poses = cdata["trans"], cdata["poses"]
                betas, gender = cdata["betas"], str(cdata["gender"])
            for i in range(N // clip_len):
                sl = slice(clip_len * i, clip_len * (i + 1), rate)
                clips.append(Clip(
                    trans=np.asarray(trans[sl], np.float32),
                    poses=np.asarray(poses[sl], np.float32),
                    betas=np.asarray(betas, np.float32),
                    gender=gender, src_fps=fps))
    return clips


def _clip_params(clip: Clip, T: int) -> dict[str, np.ndarray]:
    return {
        "transl": clip.trans[:T],
        "global_orient": clip.poses[:T, 0:3],
        "body_pose": clip.poses[:T, 3:66],
        "left_hand_pose": clip.poses[:T, 66:111],
        "right_hand_pose": clip.poses[:T, 111:156],
        "betas": np.tile(clip.betas[:10], (T, 1)).astype(np.float32),
    }


class AmassRepresentationBuilder:
    """Batched marker/joint extraction and representation building.

    Uses a gendered pair of SMPL-X models with ``use_pca=False,
    flat_hand_mean=True``, the configuration of the reference's
    preprocessing models (train_loader_smooth.py:86-97), on `device`
    (None: the CUDA card; raises without CUDA). Every mode returns tensors
    on that device.
    """

    def __init__(self, smplx_model_path_or_dicts, with_hand: bool = False,
                 markerset_json: str | None = None, device=None):
        dev = resolve_device(device)
        exact_f32_matmuls()
        if isinstance(smplx_model_path_or_dicts, dict):
            # {'male': dict, 'female': dict} raw model dicts
            sources = smplx_model_path_or_dicts
        else:
            sources = {g: find_smplx_npz(smplx_model_path_or_dicts, g)
                       for g in ("male", "female")}
        self.models = {
            g: load_model(src, gender=g, use_pca=False, flat_hand_mean=True,
                          device=dev)
            for g, src in sources.items()}
        any_model = next(iter(self.models.values()))
        self._fwd = make_forward_fn(any_model)
        self.marker_ids = torch.as_tensor(mk.marker_indices(
            with_hand=with_hand, markerset_json=markerset_json,
            num_verts=any_model.num_verts), device=dev)
        self.with_hand = with_hand
        self.device = dev

    def markers_and_joints(self, clip: Clip, T: int):
        """Run the body model over one clip: (markers [T, M, 3],
        joints [T, K, 3]) on the device."""
        model = self.models.get(clip.gender,
                                next(iter(self.models.values())))
        params = {k: torch.as_tensor(v, device=self.device)
                  for k, v in _clip_params(clip, T).items()}
        for k, z in model.zero_params(T).items():
            params.setdefault(k, z)
        with torch.no_grad():
            out = self._fwd(params, model.consts)
        return out["vertices"][:, self.marker_ids, :], out["joints"]

    # representation modes (train_smooth / train_infill / fit loaders)

    def global_markers(self, clip: Clip, T: int) -> torch.Tensor:
        """[T, M*3] frame-0-normalized global marker image
        (mode='global_markers', train_loader_smooth.py:164-167)."""
        m, j = self.markers_and_joints(clip, T)
        return rep.global_marker_image(m, j[0, :25])

    def _pelvis_markers(self, clip: Clip, T: int):
        m, j = self.markers_and_joints(clip, T)
        joints_n = rep.normalize_to_frame0(j[:, :25], j[0, :25])
        markers_n = rep.normalize_to_frame0(m, j[0, :25])
        contact = rep.contact_labels_from_markers(markers_n)
        return torch.cat([joints_n[:, 0:1], markers_n], dim=1), contact

    def local_markers_4chan(self, clip: Clip, T: int,
                            smooth_forward: bool = True):
        """([4, T-1, d], rot_0_pivot) infill representation
        (mode='local_markers_4chan', train_loader_infill.py:125-275)."""
        pm, contact = self._pelvis_markers(clip, T)
        return rep.local_markers_4chan(pm, contact,
                                       smooth_forward=smooth_forward)

    def local_markers(self, clip: Clip, T: int, smooth_forward: bool = True):
        """([T-1, 3+(1+67)*3+4], pivot) single-channel infill mode
        (mode='local_markers', train_loader_infill.py:261-264)."""
        pm, contact = self._pelvis_markers(clip, T)
        return rep.local_markers_flat(pm, contact,
                                      smooth_forward=smooth_forward)

    def local_joints_4chan(self, clip: Clip, T: int,
                           smooth_forward: bool = True):
        """Joint-based 4-channel variant (mode='local_joints_4chan'): the
        shoulder/hip direction rows are joints 16/17/1/2 and the contact
        labels come from foot joints 7/8/10/11 (velocity + height,
        train_loader_infill.py:149-173, 234-235)."""
        _, j = self.markers_and_joints(clip, T)
        joints_n = rep.normalize_to_frame0(j[:, :25], j[0, :25])
        feet = joints_n[:, torch.as_tensor([7, 8, 10, 11],
                                           device=self.device), :]
        vel = torch.linalg.norm((feet[1:] - feet[:-1]) * 30.0, dim=-1)
        vel_c = torch.cat([(vel.abs() < 0.22).to(torch.float32),
                           torch.zeros((1, 4), device=self.device)])
        z_thr = joints_n[:, :, -1].min() + 0.10
        h_c = (feet[:, :, 2] < z_thr).to(torch.float32)
        contact = torch.cat([(vel_c * h_c)[:-1], h_c[-1:]])
        return rep.local_markers_4chan(joints_n, contact,
                                       smooth_forward=smooth_forward,
                                       direction_slots=(16, 17, 1, 2))

    def global_joints(self, clip: Clip, T: int, with_hand: bool = False):
        """[T, 25*3 or 55*3] (mode='global_joints',
        train_loader_smooth.py:148-156)."""
        _, j = self.markers_and_joints(clip, T)
        k = 55 if with_hand else 25
        return rep.normalize_to_frame0(j[:, :k], j[0, :25]).reshape(T, -1)

    def local_joints(self, clip: Clip, T: int, with_hand: bool = False):
        """[T, 25*3 or 55*3] pelvis-relative (mode='local_joints',
        train_loader_smooth.py:158-162)."""
        _, j = self.markers_and_joints(clip, T)
        k = 55 if with_hand else 25
        return rep.local_joint_image(j[:, :k], j[0, :25])

    def gt_eval_data(self, clip: Clip, T: int):
        """Ground-truth hooks for 3D-accuracy evaluation
        (optimize_loader_amass_new.py:283-308): (smplx_params_gt
        [T, 169] numpy, rows [transl(3) | global_orient(3) | betas(10) |
        body_pose(63) | lhand(45) | rhand(45)], and transf_matrix_smplx
        [4, 4] numpy, the homogeneous transform from AMASS world into the
        canonical fitted frame: frame-0 normalized, then put on the floor
        over pelvis + markers)."""
        m, j = self.markers_and_joints(clip, T)
        R, origin = rep.frame0_normalizer(j[0, :25])
        pm = torch.cat([j[:, 0:1], m], dim=1)
        z_transl = torch.matmul(pm - origin, R)[:, :, 2].min()
        eye = torch.eye(4, device=self.device)
        t1, t2, t3 = eye.clone(), eye.clone(), eye.clone()
        t1[0:3, 3] = -origin
        t2[0:3, 0:3] = R.T
        t3[2, 3] = -z_transl
        transf = t3 @ t2 @ t1
        p = _clip_params(clip, T)
        params_gt = np.concatenate(
            [p["transl"], p["global_orient"], p["betas"], p["body_pose"],
             p["left_hand_pose"], p["right_hand_pose"]],
            axis=-1).astype(np.float32)
        return params_gt, transf.cpu().numpy()


def build_dataset(builder: AmassRepresentationBuilder, clips: list[Clip],
                  mode: str, clip_seconds: int = 4,
                  smooth_forward: bool = True, with_gt: bool = False):
    """Materialize the clip-image array of a clip list (numpy).

    Returns (images, aux): images [N, T, d] for the flat modes or
    [N, 4, T-1, d] for 'local_markers_4chan'; aux holds rot_0_pivot,
    betas and gender (1 male, 0 female) per clip
    (optimize_loader_amass_new.py:371-388), and with `with_gt` the
    3D-accuracy hooks smplx_params_gt [N, T, 169] and
    transf_matrix_smplx [N, 4, 4].
    """
    T = clip_seconds * 30
    images, pivots, betas, genders = [], [], [], []
    gt_params, gt_transf = [], []
    for clip in clips:
        pivot = 0.0
        if mode == "global_markers":
            img = builder.global_markers(clip, T)
        elif mode == "local_markers_4chan":
            img, pivot = builder.local_markers_4chan(
                clip, T, smooth_forward=smooth_forward)
        elif mode == "local_markers":
            img, pivot = builder.local_markers(
                clip, T, smooth_forward=smooth_forward)
        elif mode == "global_joints":
            img = builder.global_joints(clip, T)
        elif mode == "local_joints":
            img = builder.local_joints(clip, T)
        else:
            raise ValueError(mode)
        images.append(img.cpu().numpy())
        pivots.append(float(pivot))
        betas.append(clip.betas[:10])
        genders.append(1 if clip.gender == "male" else 0)
        if with_gt:
            pg, tf = builder.gt_eval_data(clip, T)
            gt_params.append(pg)
            gt_transf.append(tf)
    aux = {
        "rot_0_pivot": np.asarray(pivots, np.float32),
        "betas": np.stack(betas).astype(np.float32),
        "gender": np.asarray(genders, np.int32),
    }
    if with_gt:
        aux["smplx_params_gt"] = np.stack(gt_params)
        aux["transf_matrix_smplx"] = np.stack(gt_transf)
    return np.stack(images), aux


def compute_or_load_stats(images: np.ndarray, mode: str, path: str,
                          split: str = "train", device="cpu"):
    """Train split: compute and persist; test split: load
    (train_loader_smooth.py:188-204)."""
    cls = {"global_markers": GlobalStats, "global_joints": GlobalStats,
           "local_joints": GlobalStats,
           "local_markers": LocalFlatStats,
           "local_markers_4chan": Local4ChanStats,
           "local_joints_4chan": Local4ChanStats}[mode]
    if split == "train":
        stats = cls.compute(images, device)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        stats.save(path)
        return stats
    return cls.load(path, device)
