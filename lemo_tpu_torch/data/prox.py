"""PROX recording plumbing (port of `lemo_tpu/data/prox.py`;
temp_prox/data_parser_slide.py:47-346): OpenPose keypoints, depth scans,
marker masks, warm-start pkls and the overlapping sliding-window
schedule. A window is assembled on the host into fixed-shape numpy
arrays and moved to the card once. Depth and mask frames are read by
`data.png.imread` in the modes `lemo_tpu` reads them with `cv2.imread`
(IMREAD_UNCHANGED and IMREAD_GRAYSCALE), bit for bit, so the port needs
no cv2.
"""

from __future__ import annotations

import dataclasses
import json
import os
import os.path as osp
import pickle

import numpy as np

from lemo_tpu_torch.data.png import IMREAD_GRAYSCALE, IMREAD_UNCHANGED, imread
from lemo_tpu_torch.data.projection import KinectProjection


SCAN_MAX_POINTS = 20000  # fixed scan padding (data_parser_slide.py:317-323)


def read_ply_vertices(path: str) -> np.ndarray:
    """Minimal PLY reader -> vertex positions [N, 3] float32.

    Handles ascii and binary_little_endian PLY with x/y/z float or double
    vertex properties (the PROX `scenes/<scene>.ply` meshes; the reference
    reads them through psbody.mesh at fit_temp_loadprox_slide.py:368-373).
    Faces and other elements are skipped.
    """
    return _read_ply(path, want_faces=False)[0]


def read_ply_mesh(path: str) -> tuple[np.ndarray, np.ndarray | None]:
    """PLY reader -> (vertices [N, 3] f32, triangles [F, 3] i32 or None).

    Polygons with more than 3 vertices are fan-triangulated. Used by the
    body-in-scene renderer (reference temp_prox/renderer.py:110-151
    rendering_mode='3d' loads the scene mesh through trimesh)."""
    return _read_ply(path, want_faces=True)


def _read_ply(path: str, want_faces: bool):
    _SIZES = {"char": ("i1", 1), "uchar": ("u1", 1), "int8": ("i1", 1),
              "uint8": ("u1", 1), "short": ("i2", 2), "ushort": ("u2", 2),
              "int16": ("i2", 2), "uint16": ("u2", 2), "int": ("i4", 4),
              "uint": ("u4", 4), "int32": ("i4", 4), "uint32": ("u4", 4),
              "float": ("f4", 4), "float32": ("f4", 4),
              "double": ("f8", 8), "float64": ("f8", 8)}
    with open(path, "rb") as fh:
        if fh.readline().strip() != b"ply":
            raise ValueError(f"{path} is not a PLY file")
        fmt = None
        elements = []  # [(name, count, [(prop_name, dtype) | ('list', ...)])]
        while True:
            line = fh.readline()
            if not line:
                raise ValueError(f"{path}: unexpected EOF in header")
            tok = line.decode("ascii", "replace").strip().split()
            if not tok or tok[0] == "comment":
                continue
            if tok[0] == "format":
                fmt = tok[1]
            elif tok[0] == "element":
                elements.append((tok[1], int(tok[2]), []))
            elif tok[0] == "property":
                if tok[1] == "list":
                    elements[-1][2].append(("list", tok[2], tok[3], tok[4]))
                else:
                    elements[-1][2].append((tok[2], tok[1]))  # (name, type)
            elif tok[0] == "end_header":
                break
        verts = None
        tris: list = []

        def add_polygon(poly):
            for k in range(1, len(poly) - 1):  # fan triangulation
                tris.append((poly[0], poly[k], poly[k + 1]))

        for name, count, props in elements:
            if verts is not None and not want_faces:
                break
            if fmt == "ascii":
                if name == "vertex":
                    rows = [fh.readline().split()[:len(props)]
                            for _ in range(count)]
                    arr = np.asarray(rows, np.float64)
                    idx = [i for i, p in enumerate(props)
                           if p[0] in ("x", "y", "z")]
                    verts = arr[:, idx].astype(np.float32)
                elif name == "face" and want_faces:
                    for _ in range(count):
                        row = fh.readline().split()
                        add_polygon([int(x) for x in row[1:1 + int(row[0])]])
                else:
                    for _ in range(count):
                        fh.readline()
            else:
                little = fmt == "binary_little_endian"
                pre = "<" if little else ">"
                if any(p[0] == "list" for p in props):
                    # variable-length rows (faces): walk them
                    if name == "vertex":
                        raise ValueError(f"{path}: list property on vertex")
                    keep = name == "face" and want_faces
                    for _ in range(count):
                        for p in props:
                            if p[0] == "list":
                                cnt_t, item_t = _SIZES[p[1]], _SIZES[p[2]]
                                n = int(np.frombuffer(
                                    fh.read(cnt_t[1]),
                                    pre + cnt_t[0])[0])
                                buf = fh.read(item_t[1] * n)
                                if keep:
                                    add_polygon(np.frombuffer(
                                        buf, pre + item_t[0]).tolist())
                            else:
                                fh.read(_SIZES[p[1]][1])
                else:
                    dt = np.dtype([(p[0], pre + _SIZES[p[1]][0])
                                   for p in props])
                    buf = fh.read(dt.itemsize * count)
                    if name == "vertex":
                        rec = np.frombuffer(buf, dt, count)
                        verts = np.stack([rec["x"], rec["y"], rec["z"]],
                                         axis=1).astype(np.float32)
    if verts is None:
        raise ValueError(f"{path}: no vertex element found")
    faces = np.asarray(tris, np.int32) if tris else None
    return verts, faces


def write_ply_vertices(path: str, verts: np.ndarray,
                       faces: np.ndarray | None = None) -> None:
    """ascii PLY writer (test fixtures / synthetic scenes)."""
    verts = np.asarray(verts, np.float32)
    with open(path, "w") as fh:
        fh.write("ply\nformat ascii 1.0\n")
        fh.write(f"element vertex {len(verts)}\n")
        fh.write("property float x\nproperty float y\nproperty float z\n")
        if faces is not None:
            fh.write(f"element face {len(faces)}\n")
            fh.write("property list uchar int vertex_indices\n")
        fh.write("end_header\n")
        for v in verts:
            fh.write(f"{v[0]} {v[1]} {v[2]}\n")
        if faces is not None:
            fh.write("".join(f"3 {a} {b} {c}\n" for a, b, c in
                             np.asarray(faces, np.int64).tolist()))


def read_keypoints_all(path: str, use_hands: bool = True,
                       use_face: bool = True,
                       use_face_contour: bool = False
                       ) -> tuple[list[np.ndarray], list]:
    """OpenPose json -> ([P] list of [118, 3] keypoint arrays — one per
    detected person — and the per-person `gender_pd` predictions when
    present). 25 body + 2x21 hands + 51 face rows per person
    (data_parser_slide.py:54-102)."""
    with open(path) as fh:
        data = json.load(fh)
    people, gender_pd = [], []
    for person in data.get("people", []):
        parts = [np.asarray(person["pose_keypoints_2d"],
                            np.float32).reshape(-1, 3)]
        if use_hands:
            parts.append(np.asarray(person["hand_left_keypoints_2d"],
                                    np.float32).reshape(-1, 3))
            parts.append(np.asarray(person["hand_right_keypoints_2d"],
                                    np.float32).reshape(-1, 3))
        if use_face:
            face = np.asarray(person["face_keypoints_2d"],
                              np.float32).reshape(-1, 3)[17:17 + 51]
            parts.append(face)
            if use_face_contour:
                parts.append(np.asarray(person["face_keypoints_2d"],
                                        np.float32).reshape(-1, 3)[:17])
        people.append(np.concatenate(parts, axis=0))
        if "gender_pd" in person:
            gender_pd.append(person["gender_pd"])
    return people, gender_pd


def read_keypoints(path: str, use_hands: bool = True, use_face: bool = True,
                   use_face_contour: bool = False,
                   person_id: int = 0) -> np.ndarray | None:
    """Keypoints of one detected person (the reference also fits person 0:
    data_parser_slide.py:280 takes keypoints[0]). None when no detection
    (or fewer than person_id+1 people)."""
    people, _ = read_keypoints_all(path, use_hands, use_face,
                                   use_face_contour)
    return people[person_id] if len(people) > person_id else None


def read_prox_pkl(path: str) -> dict[str, np.ndarray]:
    """Warm-start body params from a previous stage's per-frame pkl
    (data_parser_slide.py:106-126)."""
    with open(path, "rb") as fh:
        data = pickle.load(fh)
    keys = ["transl", "global_orient", "betas", "body_pose", "pose_embedding",
            "left_hand_pose", "right_hand_pose", "jaw_pose", "leye_pose",
            "reye_pose", "expression"]
    return {k: np.asarray(data[k][0], np.float32) for k in keys}


def sliding_windows(num_frames: int, window: int,
                    stride_frac: float = 0.7) -> list[tuple[int, int]]:
    """Overlapping windows: size=window, stride=0.7*window
    (data_parser_slide.py:199-212). Returns [(start, end)) index pairs.

    All windows are exactly `window` frames (static shapes for one
    compilation). Where the reference *drops* a short tail window
    (DataLoader drop_last=True), we instead clamp the final window to
    [num_frames - window, num_frames] so every frame is fitted. Sequences
    shorter than `window` yield a single short window.
    """
    if num_frames <= window:
        return [(0, num_frames)]
    stride = int(window * stride_frac)
    spans = []
    start = 0
    while start + window <= num_frames:
        spans.append((start, start + window))
        start += stride
    if spans[-1][1] < num_frames:
        spans.append((num_frames - window, num_frames))
    return spans


@dataclasses.dataclass
class ProxRecording:
    """Locations and calibration of one PROX recording
    (main_slide.py:61-77 path layout)."""

    recording_dir: str
    base_dir: str
    recording_name: str
    scene_name: str
    keyp_folder: str
    calib_dir: str
    cam2world_dir: str
    scene_dir: str
    sdf_dir: str
    marker_mask_dir: str
    prox_params_dir: str

    @classmethod
    def from_recording_dir(cls, recording_dir: str,
                           marker_mask_root: str | None = None,
                           prox_params_root: str | None = None
                           ) -> "ProxRecording":
        name = osp.basename(osp.normpath(recording_dir))
        base = osp.abspath(osp.join(recording_dir, os.pardir, os.pardir))
        scene = name.split("_")[0]
        return cls(
            recording_dir=recording_dir,
            base_dir=base,
            recording_name=name,
            scene_name=scene,
            keyp_folder=osp.join(base, "keypoints", name),
            calib_dir=osp.join(base, "calibration"),
            cam2world_dir=osp.join(base, "cam2world"),
            scene_dir=osp.join(base, "scenes"),
            sdf_dir=osp.join(base, "scenes_sdf"),
            marker_mask_dir=(marker_mask_root or
                             osp.join(base, "mask_markers", name)),
            prox_params_dir=(prox_params_root or
                             osp.join(base, "PROXD", name)),
        )

    def load_cam2world(self) -> tuple[np.ndarray, np.ndarray]:
        with open(osp.join(self.cam2world_dir,
                           self.scene_name + ".json")) as fh:
            m = np.asarray(json.load(fh))
        return m[:3, :3].astype(np.float32), m[:3, 3].astype(np.float32)

    def load_scene_mesh(self) -> np.ndarray:
        """Scene mesh vertices [Ns, 3] world coords from
        scenes/<scene>.ply — the contact-term target point set
        (fit_temp_loadprox_slide.py:365-373; only the vertices reach the
        Chamfer contact loss, fitting_temp_slide.py:743-753)."""
        return read_ply_vertices(
            osp.join(self.scene_dir, self.scene_name + ".ply"))

    def load_scene_mesh_full(self) -> tuple[np.ndarray, np.ndarray | None]:
        """(vertices, triangles or None) of scenes/<scene>.ply, world
        coords — for body-in-scene result rendering
        (temp_prox/renderer.py rendering_mode='3d')."""
        return read_ply_mesh(
            osp.join(self.scene_dir, self.scene_name + ".ply"))

    def load_sdf(self):
        """(sdf [D,D,D], grid_min, grid_max, normals or None) — the
        scenes_sdf layout (fit_temp_loadprox_slide.py:286-305)."""
        with open(osp.join(self.sdf_dir, self.scene_name + ".json")) as fh:
            meta = json.load(fh)
        dim = meta["dim"]
        sdf = np.load(osp.join(self.sdf_dir, self.scene_name + "_sdf.npy")
                      ).reshape(dim, dim, dim).astype(np.float32)
        normals_path = osp.join(self.sdf_dir, self.scene_name + "_normals.npy")
        normals = None
        if osp.exists(normals_path):
            normals = np.load(normals_path).reshape(dim, dim, dim, 3)
        return sdf, np.asarray(meta["min"], np.float32), \
            np.asarray(meta["max"], np.float32), normals


class ProxWindowDataset:
    """Window-batched PROX frame loader.

    Per frame: OpenPose keypoints, depth scan cloud (padded to 20000 pts),
    marker occlusion mask, and the warm-start body params (own output dir
    first, then the previous stage's — data_parser_slide.py:325-333).
    """

    def __init__(self, rec: ProxRecording, output_params_dir: str,
                 batch_size: int = 100, img_folder: str = "Color",
                 depth_folder: str = "Depth",
                 mask_color_folder: str = "BodyIndexColor",
                 read_depth: bool = True, read_mask: bool = True,
                 mask_on_color: bool = True, depth_scale: float = 1e-3,
                 flip: bool = True, use_hands: bool = True,
                 use_face: bool = True, joints_to_ign=(1, 9, 12),
                 start: int = 0, step: int = 1, frame_ids=None):
        self.rec = rec
        self.batch_size = batch_size
        self.flip = flip
        self.read_depth = read_depth
        self.read_mask = read_mask
        self.mask_on_color = mask_on_color
        self.depth_scale = depth_scale
        self.use_hands = use_hands
        self.use_face = use_face
        self.joints_to_ign = joints_to_ign
        self.output_params_dir = output_params_dir

        self.img_folder = osp.join(rec.recording_dir, img_folder)
        self.depth_folder = osp.join(rec.recording_dir, depth_folder)
        self.mask_color_folder = osp.join(rec.recording_dir, mask_color_folder)

        self.img_paths = sorted(
            osp.join(self.img_folder, f) for f in os.listdir(self.img_folder)
            if f.endswith((".png", ".jpg")) and not f.startswith("."))
        # frame selection (data_parser_slide.py:188-191): explicit 1-based
        # frame_ids win over start/step slicing
        if frame_ids is not None and len(frame_ids):
            sel = [int(i) - 1 for i in frame_ids]
        else:
            sel = list(range(int(start), len(self.img_paths),
                             max(int(step), 1)))
        self.img_paths = [self.img_paths[i] for i in sel]
        self.frame_names = [osp.splitext(osp.basename(p))[0]
                            for p in self.img_paths]
        mask_path = osp.join(rec.marker_mask_dir, "mask_markers.npy")
        if osp.exists(mask_path):
            masks = np.load(mask_path).astype(np.float32)
            # the per-frame occlusion mask follows the SAME selection so
            # masks stay frame-aligned (the reference indexes the unsliced
            # mask with post-slice window positions, silently misaligning
            # when start/step/frame_ids are non-default)
            self.marker_masks = (masks[sel] if len(masks) > max(sel, default=0)
                                 else masks)
        else:
            self.marker_masks = np.ones((len(self.img_paths), 67), np.float32)
        self.windows = sliding_windows(len(self.img_paths), batch_size)
        self.projection = (KinectProjection(rec.calib_dir)
                           if read_depth else None)

    def joint_weights(self) -> np.ndarray:
        """[118] per-joint weights with the ignored joints zeroed
        (data_parser_slide.py:238-250)."""
        n = 25 + 40 * self.use_hands + 51 * self.use_face + 2 * self.use_hands
        w = np.ones(n, np.float32)
        if self.joints_to_ign and -1 not in self.joints_to_ign:
            w[list(self.joints_to_ign)] = 0.0
        return w

    def _warm_start(self, frame_name: str) -> dict[str, np.ndarray]:
        own = osp.join(self.output_params_dir, "results", frame_name,
                       "000.pkl")
        prev = osp.join(self.rec.prox_params_dir, "results", frame_name,
                        "000.pkl")
        return read_prox_pkl(own if osp.exists(own) else prev)

    def load_frame(self, idx: int, with_warm_start: bool = True) -> dict:
        img_path = self.img_paths[idx]
        fn = self.frame_names[idx]
        keyp = read_keypoints(
            osp.join(self.rec.keyp_folder, fn + "_keypoints.json"),
            self.use_hands, self.use_face)
        if keyp is None:
            # no detection this frame (occlusion / person out of view):
            # zero-confidence keypoints make the 2-D data term vanish for
            # the frame while the temporal priors keep constraining it —
            # the fixed-shape equivalent of the reference skipping the
            # frame. LEMO's occluded-frame robustness rides on this.
            keyp = np.zeros((len(self.joint_weights()), 3), np.float32)
        scan = np.zeros((SCAN_MAX_POINTS, 3), np.float32)
        n_pts = 0
        if self.read_depth and self.read_mask:
            depth = imread(osp.join(self.depth_folder, fn + ".png"),
                           IMREAD_UNCHANGED).astype(float)
            depth = depth / 8.0 * self.depth_scale
            mask = imread(osp.join(self.mask_color_folder, fn + ".png"),
                          IMREAD_GRAYSCALE)
            if self.flip:
                depth = np.ascontiguousarray(depth[:, ::-1])
                mask = np.ascontiguousarray(mask[:, ::-1])
            pts = self.projection.create_scan(
                mask, depth, mask_on_color=self.mask_on_color)["points"]
            n_pts = min(len(pts), SCAN_MAX_POINTS)
            scan[:n_pts] = pts[:n_pts]
        return {
            "fn": fn,
            "keypoints": keyp,
            "scan": scan,
            "scan_point_num": n_pts,
            "marker_mask": self.marker_masks[min(idx, len(self.marker_masks) - 1)],
            "warm_start": self._warm_start(fn) if with_warm_start else None,
        }

    def load_window(self, widx: int, with_warm_start: bool = True) -> dict:
        """All host-side data for one window.

        ``with_warm_start=False`` loads only the fit-independent parts
        (keypoints, depth scans, masks) — safe to PREFETCH on a thread
        while the previous window is still fitting. The warm starts must
        be read after the previous window's pkls are on disk
        (own-output-first resume, data_parser_slide.py:325-333); fetch
        them separately via :meth:`load_window_warm_start`.
        """
        start, end = self.windows[widx]
        frames = [self.load_frame(i, with_warm_start=with_warm_start)
                  for i in range(start, end)]
        out = {
            "fns": [f["fn"] for f in frames],
            "keypoints": np.stack([f["keypoints"] for f in frames]),
            "scan": np.stack([f["scan"] for f in frames]),
            "scan_mask": np.stack(
                [np.arange(SCAN_MAX_POINTS) < f["scan_point_num"]
                 for f in frames]),
            "marker_mask": np.stack([f["marker_mask"] for f in frames]),
        }
        if with_warm_start:
            ws_keys = frames[0]["warm_start"].keys()
            out["warm_start"] = {k: np.stack([f["warm_start"][k]
                                              for f in frames])
                                 for k in ws_keys}
        return out

    def load_window_warm_start(self, widx: int) -> dict:
        """Stacked warm-start params for one window (own-output pkls
        first, then the previous stage's)."""
        start, end = self.windows[widx]
        rows = [self._warm_start(self.frame_names[i])
                for i in range(start, end)]
        return {k: np.stack([r[k] for r in rows]) for k in rows[0]}
