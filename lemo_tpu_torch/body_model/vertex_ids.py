"""SMPL-family landmark vertex ids (copy of the tables in
`lemo_tpu/body_model/vertex_ids.py`, from the public `smplx` package).
"""

from __future__ import annotations

import numpy as np

VERTEX_IDS = {
    "smplh": {
        "nose": 332, "reye": 6260, "leye": 2800, "rear": 4071, "lear": 583,
        "rthumb": 6191, "rindex": 5782, "rmiddle": 5905, "rring": 6016,
        "rpinky": 6133, "lthumb": 2746, "lindex": 2319, "lmiddle": 2445,
        "lring": 2556, "lpinky": 2673, "LBigToe": 3216, "LSmallToe": 3226,
        "LHeel": 3387, "RBigToe": 6617, "RSmallToe": 6624, "RHeel": 6787,
    },
    "smplx": {
        "nose": 9120, "reye": 9929, "leye": 9448, "rear": 616, "lear": 6,
        "rthumb": 8079, "rindex": 7669, "rmiddle": 7794, "rring": 7905,
        "rpinky": 8022, "lthumb": 5361, "lindex": 4933, "lmiddle": 5058,
        "lring": 5169, "lpinky": 5286, "LBigToe": 5770, "LSmallToe": 5780,
        "LHeel": 8846, "RBigToe": 8463, "RSmallToe": 8474, "RHeel": 8635,
    },
    "mano": {
        "thumb": 744, "index": 320, "middle": 443, "ring": 554, "pinky": 671,
    },
}
VERTEX_IDS["smpl"] = VERTEX_IDS["smplh"]

_FACE_KEYS = ["nose", "reye", "leye", "rear", "lear"]
_FEET_KEYS = ["LBigToe", "LSmallToe", "LHeel", "RBigToe", "RSmallToe", "RHeel"]
_TIP_KEYS = [
    "lthumb", "lindex", "lmiddle", "lring", "lpinky",
    "rthumb", "rindex", "rmiddle", "rring", "rpinky",
]


def extra_joint_vertex_ids(
    model_type: str, use_hands: bool = True, use_feet_keypoints: bool = True
) -> np.ndarray:
    """Vertex ids appended after the regressor joints (face 5, feet 6,
    fingertips 10); joints 55..75 for SMPL-X."""
    table = VERTEX_IDS[model_type]
    ids: list[int] = [table[k] for k in _FACE_KEYS]
    if use_feet_keypoints:
        ids += [table[k] for k in _FEET_KEYS]
    if use_hands and model_type != "mano":
        ids += [table[k] for k in _TIP_KEYS]
    return np.asarray(ids, dtype=np.int64)


def smpl_to_openpose(
    model_type: str = "smplx",
    use_hands: bool = True,
    use_face: bool = True,
    use_face_contour: bool = False,
    openpose_format: str = "coco25",
) -> np.ndarray:
    """Permutation mapping model joints -> OpenPose keypoint order.

    Behavioral parity with temp_prox/misc_utils.py:87-197 (only the
    combinations LEMO uses are filled in; others raise)."""
    if openpose_format.lower() != "coco25":
        raise NotImplementedError(openpose_format)
    if model_type == "smplx":
        body = np.array(
            [55, 12, 17, 19, 21, 16, 18, 20, 0, 2, 5, 8, 1, 4, 7,
             56, 57, 58, 59, 60, 61, 62, 63, 64, 65],
            dtype=np.int64,
        )
        parts = [body]
        if use_hands:
            lhand = np.array(
                [20, 37, 38, 39, 66, 25, 26, 27, 67, 28, 29, 30, 68,
                 34, 35, 36, 69, 31, 32, 33, 70], dtype=np.int64)
            rhand = np.array(
                [21, 52, 53, 54, 71, 40, 41, 42, 72, 43, 44, 45, 73,
                 49, 50, 51, 74, 46, 47, 48, 75], dtype=np.int64)
            parts += [lhand, rhand]
        if use_face:
            parts.append(np.arange(76, 127 + 17 * use_face_contour, dtype=np.int64))
        return np.concatenate(parts)
    if model_type == "smpl":
        return np.array(
            [24, 12, 17, 19, 21, 16, 18, 20, 0, 2, 5, 8, 1, 4, 7,
             25, 26, 27, 28, 29, 30, 31, 32, 33, 34], dtype=np.int64)
    raise NotImplementedError(model_type)
