"""SSM2 surface-marker vertex ids on the SMPL-X mesh (copy of the tables
in `lemo_tpu/data/markers.py`; dict order is marker slot order). A custom
markerset json in the SSM2 schema can be read instead."""

from __future__ import annotations

import json

import numpy as np

# 67-marker body set (loader/SSM2.json)
SSM2 = {
    "C7": 3832, "CLAV": 5533, "LANK": 5882, "LFWT": 3486, "LBAK": 3336,
    "LBCEP": 4029, "LBSH": 4137, "LBUM": 5694, "LBUST": 3228,
    "LCHEECK": 2081, "LELB": 4302, "LELBIN": 4363, "LFIN": 4788,
    "LFRM2": 4379, "LFTHI": 3504, "LFTHIIN": 3998, "LHEE": 8846,
    "LIWR": 4726, "LKNE": 3682, "LKNI": 3688, "LMT1": 5890, "LMT5": 5901,
    "LNWST": 3260, "LOWR": 4722, "LBWT": 5697, "LRSTBEEF": 5838,
    "LSHO": 4481, "LTHI": 4088, "LTHMB": 4839, "LTIB": 3745, "LTOE": 5787,
    "MBLLY": 5942, "RANK": 8576, "RFWT": 6248, "RBAK": 6127, "RBCEP": 6776,
    "RBSH": 7192, "RBUM": 8388, "RBUSTLO": 8157, "RCHEECK": 8786,
    "RELB": 7040, "RELBIN": 7099, "RFIN": 7524, "RFRM2": 7115,
    "RFRM2IN": 7303, "RFTHI": 6265, "RFTHIIN": 6746, "RHEE": 8634,
    "RKNE": 6443, "RKNI": 6449, "RMT1": 8584, "RMT5": 8595, "RNWST": 6023,
    "ROWR": 7458, "RBWT": 8391, "RRSTBEEF": 8532, "RSHO": 6627,
    "RTHI": 6832, "RTHMB": 7575, "RTIB": 6503, "RTOE": 8481, "STRN": 5531,
    "T8": 5487, "LFHD": 707, "LBHD": 2026, "RFHD": 2198, "RBHD": 3066,
}

# 81-marker set with fingertips/face (loader/SSM2_withhand.json)
SSM2_WITHHAND = dict(SSM2)
SSM2_WITHHAND.update({
    "CHN1": 8757, "CHN2": 9066, "MTH3": 8985, "MTH7": 8947,
    "LIDX3": 4931, "LMID3": 5045, "LPNK3": 5268, "LRNG3": 5149,
    "LTHM4": 5346, "RIDX3": 7667, "RMID3": 7781, "RPNK3": 8001,
    "RRNG3": 7884, "RTHM4": 8082,
})


# foot-marker slots within SSM2 order (lheel, rheel, ltoe, rtoe) and the
# shoulder/hip slots of the forward-direction estimate
LEFT_HEEL, RIGHT_HEEL, LEFT_TOE, RIGHT_TOE = 16, 47, 30, 60
FOOT_MARKER_SLOTS = np.array([LEFT_HEEL, RIGHT_HEEL, LEFT_TOE, RIGHT_TOE])
SDR_L, SDR_R, HIP_L, HIP_R = 26, 56, 27, 57

# leg-marker slots zeroed during masked infill inference
# (opt_amass_perframe.py:136-138; the reference's comments say "upper
# body", the ids are the leg and foot markers)
LEG_MASK_MARKER_SLOTS = np.array(
    [14, 15, 18, 19, 29, 2, 20, 21, 30, 25, 16,
     45, 46, 48, 49, 59, 32, 50, 51, 55, 60, 47]
)


def marker_indices(with_hand: bool = False, markerset_json: str | None = None,
                   num_verts: int | None = None) -> np.ndarray:
    """Vertex ids of the 67 (or, `with_hand`, 81) marker slots in slot
    order, from the embedded tables or, given `markerset_json`, from a
    file in the SSM2 schema ({"markersets": [{"indices": {...}}]}).
    `num_verts` folds ids into range for reduced synthetic meshes
    (modulo, so distinct slots stay on distinct vertices)."""
    if markerset_json is not None:
        with open(markerset_json) as fh:
            table = json.load(fh)["markersets"][0]["indices"]
    else:
        table = SSM2_WITHHAND if with_hand else SSM2
    ids = np.asarray(list(table.values()), dtype=np.int64)
    if num_verts is not None and ids.max() >= num_verts:
        ids = ids % num_verts
    return ids
