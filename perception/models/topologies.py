"""Full OpenPose pose-model topology zoo.

Completes the part-map/pair-list zoo beyond the four core topologies in
``models/pose.py`` (BODY_25 / COCO_18 / MPI_15 / CAR_12): BODY_19,
BODY_23, BODY_25B, BODY_25D, BODY_25E, CAR_22 and the 135-keypoint
whole-body model BODY_135 (body + two 20-keypoint hands + 70 face
landmarks).

These are the *what* of the reference's model registry
(``openpose/src/openpose/pose/poseParameters.cpp:7-538``: part-name
maps, limb pair lists, part counts). The structured families (hand
finger chains, face landmark chains) are generated from their joint
structure rather than written out as 300-entry literals — the hand
follows the standard five-finger four-joint skeleton and the face the
standard 68+2-landmark layout, both of which the reference encodes the
same way.

Every topology here plugs straight into ``models/pose.PoseNet`` /
``extract_people`` (a topology is just (part names, (L, 2) pair
array)); tests assert counts and graph structure against the
reference's declared sizes.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from perception.models.pose import (
    BODY_25_PAIRS,
    BODY_25_PARTS,
    CAR_12_PAIRS,
    CAR_12_PARTS,
    COCO_18_PAIRS,
    COCO_18_PARTS,
    MPI_15_PAIRS,
    MPI_15_PARTS,
    TOPOLOGIES,
)

Pairs = np.ndarray


def _pairs(seq: Sequence[Tuple[int, int]]) -> Pairs:
    return np.asarray(seq, np.int32).reshape(-1, 2)


def _chain(indices: Sequence[int]) -> List[Tuple[int, int]]:
    """Consecutive links along a list of part indices."""
    return [(indices[i], indices[i + 1]) for i in range(len(indices) - 1)]


def _loop(indices: Sequence[int]) -> List[Tuple[int, int]]:
    return _chain(list(indices) + [indices[0]])


# --- BODY_19 / BODY_25D / BODY_25E: BODY_25-family trees --------------------
#
# BODY_19 is BODY_25 without the six foot keypoints (indices 0..18 of the
# BODY_25 part order); BODY_25D shares BODY_25's parts and tree; BODY_25E
# shares the parts but trains with extra redundant limbs
# (poseParameters.cpp:441-449).

BODY_19_PARTS = BODY_25_PARTS[:19]

# BODY_25 tree rooted at the neck, plus the redundant ear-shoulder links the
# reference includes for all BODY_25-family models (poseParameters.cpp:417-419).
_BODY_25_TREE = [
    (1, 8), (1, 2), (1, 5), (2, 3), (3, 4), (5, 6), (6, 7), (8, 9),
    (9, 10), (10, 11), (8, 12), (12, 13), (13, 14), (1, 0), (0, 15),
    (15, 17), (0, 16), (16, 18), (2, 17), (5, 18),
]
_FOOT_LINKS = [(14, 19), (19, 20), (14, 21), (11, 22), (22, 23), (11, 24)]

BODY_19_PAIRS = _pairs(_BODY_25_TREE)
BODY_25D_PARTS = BODY_25_PARTS
BODY_25D_PAIRS = _pairs(_BODY_25_TREE + _FOOT_LINKS)

# BODY_25E: same parts; tree plus the redundancy set the reference trains
# with (ears-shoulders, shoulders-hips, shoulders-wrists, hips-ankles,
# wrists, ankles, wrists-hips, small-toes-ankles; poseParameters.cpp:441-449).
_BODY_25E_REDUNDANT = [
    (2, 9), (5, 12), (2, 4), (5, 7), (9, 11), (12, 14), (4, 7), (11, 14),
    (4, 9), (7, 12), (11, 23), (14, 20),
]
BODY_25E_PARTS = BODY_25_PARTS
BODY_25E_PAIRS = _pairs(_BODY_25_TREE + _FOOT_LINKS + _BODY_25E_REDUNDANT)

# --- BODY_23: no neck / midhip (poseParameters.cpp:215-239, 458-466) --------

BODY_23_PARTS = [
    "Nose", "RShoulder", "RElbow", "RWrist", "LShoulder", "LElbow", "LWrist",
    "RHip", "RKnee", "RAnkle", "LHip", "LKnee", "LAnkle", "REye", "LEye",
    "REar", "LEar", "LBigToe", "LSmallToe", "LHeel", "RBigToe", "RSmallToe",
    "RHeel",
]

_BODY_23_TREE = [
    (0, 1), (1, 2), (2, 3), (0, 4), (4, 5), (5, 6), (7, 8), (8, 9),
    (10, 11), (11, 12), (0, 13), (13, 15), (0, 14), (14, 16), (12, 17),
    (17, 18), (12, 19), (9, 20), (20, 21), (9, 22), (1, 7), (4, 10),
]
_BODY_23_REDUNDANT = [
    (1, 15), (4, 16), (15, 16), (7, 10), (1, 3), (4, 6), (7, 9), (10, 12),
    (3, 6), (9, 12), (3, 7), (6, 10), (9, 21), (12, 18),
]
BODY_23_PAIRS = _pairs(_BODY_23_TREE + _BODY_23_REDUNDANT)

# --- BODY_25B: COCO-ordered body + UpperNeck/HeadTop + feet -----------------
# (poseParameters.cpp:122-148, 487-499)

BODY_25B_PARTS = [
    "Nose", "LEye", "REye", "LEar", "REar", "LShoulder", "RShoulder",
    "LElbow", "RElbow", "LWrist", "RWrist", "LHip", "RHip", "LKnee",
    "RKnee", "LAnkle", "RAnkle", "UpperNeck", "HeadTop", "LBigToe",
    "LSmallToe", "LHeel", "RBigToe", "RSmallToe", "RHeel",
]

_BODY_25B_TREE = [
    # COCO body tree
    (0, 1), (0, 2), (1, 3), (2, 4), (0, 5), (0, 6), (5, 7), (6, 8),
    (7, 9), (8, 10), (5, 11), (6, 12), (11, 13), (12, 14), (13, 15),
    (14, 16),
    # feet
    (15, 19), (19, 20), (15, 21), (16, 22), (22, 23), (16, 24),
    # MPII extras (neck / head-top)
    (5, 17), (5, 18),
]
_BODY_25B_REDUNDANT = [
    (6, 17), (6, 18), (3, 4), (3, 5), (4, 6), (5, 9), (6, 10), (9, 10),
    (9, 11), (10, 12), (11, 12), (15, 16),
]
BODY_25B_PAIRS = _pairs(_BODY_25B_TREE + _BODY_25B_REDUNDANT)

# --- CAR_22 (poseParameters.cpp:240-266, 467-474) ---------------------------

CAR_22_PARTS = [
    "FLWheel", "BLWheel", "FRWheel", "BRWheel", "FRFogLight", "FLFogLight",
    "FRLight", "FLLight", "Grilles", "FBumper", "LMirror", "RMirror",
    "FRTop", "FLTop", "BLTop", "BRTop", "BLLight", "BRLight", "Trunk",
    "BBumper", "BLCorner", "BRCorner",
]

CAR_22_PAIRS = _pairs(
    _loop([0, 1, 3, 2])                     # wheels
    + _loop([6, 7, 16, 17])                 # front+back lights ring
    + _loop([12, 13, 14, 15])               # roof
    + [(6, 8), (7, 8), (6, 9), (7, 9), (6, 4), (7, 5)]   # front cluster
    + [(12, 11), (13, 10)]                  # mirrors
    + [(16, 18), (17, 18), (16, 19), (17, 19)]           # back cluster
    + [(0, 7), (3, 17), (6, 12), (16, 14)]  # vertical struts
    + [(6, 21), (7, 20), (3, 21), (20, 14)] # corner fallbacks
)

# --- BODY_135: whole-body = BODY_25B + 2x20 hand + 70 face ------------------
# (poseParameters.cpp:149-199, 500-538). Hand joints follow the standard
# five-finger skeleton: thumb CMC/Knuckles/IP/FingerTip, other fingers
# Knuckles/PIP/DIP/FingerTip; face follows the 68-landmark Multi-PIE
# layout + 2 pupils.

_HAND_FINGERS = [
    ("Thumb", ["1CMC", "2Knuckles", "3IP", "4FingerTip"]),
    ("Index", ["1Knuckles", "2PIP", "3DIP", "4FingerTip"]),
    ("Middle", ["1Knuckles", "2PIP", "3DIP", "4FingerTip"]),
    ("Ring", ["1Knuckles", "2PIP", "3DIP", "4FingerTip"]),
    ("Pinky", ["1Knuckles", "2PIP", "3DIP", "4FingerTip"]),
]


def _hand_parts(side: str) -> List[str]:
    return [f"{side}{f}{j}" for f, joints in _HAND_FINGERS for j in joints]


def _hand_pairs(wrist: int, base: int) -> List[Tuple[int, int]]:
    """Wrist -> finger-base, then chain down each finger (4 joints)."""
    out: List[Tuple[int, int]] = []
    for f in range(5):
        root = base + 4 * f
        out.append((wrist, root))
        out.extend(_chain([root, root + 1, root + 2, root + 3]))
    return out


_FACE_GROUPS: List[Tuple[str, int]] = [
    ("FaceContour", 17),
    # The reference numbers the left eyebrow right-to-left (mirror of the
    # right): REyeBrow0..4 then LEyeBrow4..0 — one chain across the brow line.
    ("REyeBrow", 5),
    ("LEyeBrow", -5),   # negative: reversed numbering
    ("NoseUpper", 4),
    ("NoseLower", 5),
    ("REye", 6),
    ("LEye", 6),
    ("OMouth", 12),
    ("IMouth", 8),
]


def _face_parts() -> List[str]:
    names: List[str] = []
    for group, n in _FACE_GROUPS:
        idxs = range(abs(n)) if n > 0 else reversed(range(-n))
        names.extend(f"{group}{i}" for i in idxs)
    names += ["RPupil", "LPupil"]
    return names


def _face_pairs(F: int) -> List[Tuple[int, int]]:
    """Face landmark connectivity (chains within each landmark group +
    the cross-group links the reference declares)."""
    out: List[Tuple[int, int]] = []
    # COCO-face: nose tip / eye corners anchored to the body keypoints
    # 0 (Nose), 2 (REye), 1 (LEye).
    out += [(0, F + 30), (2, F + 39), (1, F + 42)]
    out += _chain([F + i for i in range(17)])              # jaw contour
    out += [(F + 0, F + 17), (F + 16, F + 26)]             # contour-brow
    out += _chain([F + i for i in range(17, 27)])          # brow line
    out += [(F + 21, F + 27), (F + 22, F + 27)]            # brow-nose
    out += _chain([F + i for i in (27, 28, 29, 30, 33, 32, 31)])  # nose ridge
    out += _chain([F + 33, F + 34, F + 35])                # nostrils
    out += [(F + 27, F + 39), (F + 27, F + 42)]            # nose-eyes
    out += _chain([F + i for i in range(36, 42)])          # right eye
    out += _chain([F + i for i in range(42, 48)])          # left eye
    out += [(F + 33, F + 51)]                              # nose-mouth
    out += _chain([F + i for i in range(48, 60)])          # outer mouth
    out += [(F + 48, F + 60), (F + 54, F + 64)]            # outer-inner
    out += _chain([F + i for i in range(60, 68)])          # inner mouth
    out += [(F + 36, F + 68), (F + 39, F + 68),
            (F + 42, F + 69), (F + 45, F + 69)]            # eyes-pupils
    return out


_H135 = 25            # hand block offset
_F135 = _H135 + 40    # face block offset

BODY_135_PARTS = (
    list(BODY_25B_PARTS) + _hand_parts("L") + _hand_parts("R") + _face_parts()
)

# Body tree for 135 differs from 25B only in the MPII links: UpperNeck
# chains to HeadTop (5,17 / 17,18) and one redundant 6,17
# (poseParameters.cpp:500-508).
_BODY_135_BODY = [
    p for p in _BODY_25B_TREE if p != (5, 18)
] + [(17, 18)] + [
    p for p in _BODY_25B_REDUNDANT if p != (6, 18)
]

BODY_135_PAIRS = _pairs(
    _BODY_135_BODY
    + _hand_pairs(wrist=9, base=_H135)          # left hand off LWrist
    + _hand_pairs(wrist=10, base=_H135 + 20)    # right hand off RWrist
    + _face_pairs(_F135)
)


# --- registry ---------------------------------------------------------------

FULL_ZOO = dict(TOPOLOGIES)
FULL_ZOO.update({
    "BODY_19": (BODY_19_PARTS, BODY_19_PAIRS),
    "BODY_23": (BODY_23_PARTS, BODY_23_PAIRS),
    "BODY_25B": (BODY_25B_PARTS, BODY_25B_PAIRS),
    "BODY_25D": (BODY_25D_PARTS, BODY_25D_PAIRS),
    "BODY_25E": (BODY_25E_PARTS, BODY_25E_PAIRS),
    "CAR_22": (CAR_22_PARTS, CAR_22_PAIRS),
    "BODY_135": (BODY_135_PARTS, BODY_135_PAIRS),
})

# Reference part counts (poseParameters.cpp POSE_NUMBER_BODY_PARTS).
REFERENCE_NUM_PARTS = {
    "BODY_25": 25, "COCO_18": 18, "MPI_15": 15, "BODY_19": 19,
    "BODY_23": 23, "BODY_25B": 25, "BODY_25D": 25, "BODY_25E": 25,
    "CAR_12": 12, "CAR_22": 22, "BODY_135": 135,
}


def get_topology(name: str) -> Tuple[List[str], Pairs]:
    return FULL_ZOO[name]
