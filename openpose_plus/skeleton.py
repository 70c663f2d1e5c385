"""Body-part / limb schema shared by training, post-processing and evaluation.

Rebuild of the reference's part schema
(reference: openpose_plus/inference/common.py :: CocoPart, CocoPairs,
CocoPairsNetwork, CocoColors — mount was empty at survey time, see SURVEY.md
provenance caveat; indices follow the OpenPose CVPR'17 convention and MUST stay
stable for AP parity).

Everything in this module is a plain Python constant so it can be captured
statically inside jit-compiled functions.
"""

from __future__ import annotations

import enum

import numpy as np


class CocoPart(enum.IntEnum):
    """OpenPose 18-part body schema (+ background channel 18)."""

    Nose = 0
    Neck = 1
    RShoulder = 2
    RElbow = 3
    RWrist = 4
    LShoulder = 5
    LElbow = 6
    LWrist = 7
    RHip = 8
    RKnee = 9
    RAnkle = 10
    LHip = 11
    LKnee = 12
    LAnkle = 13
    REye = 14
    LEye = 15
    REar = 16
    LEar = 17
    Background = 18


N_PARTS = 18          # body parts (heatmap channels 0..17)
N_HEATMAPS = 19       # parts + background channel
N_LIMBS = 19          # limb (part-pair) count
N_PAF_CHANNELS = 38   # 2 channels (x, y) per limb

# Limb endpoints as (part_a, part_b) index pairs, OpenPose ordering.
COCO_PAIRS: tuple[tuple[int, int], ...] = (
    (1, 2), (1, 5), (2, 3), (3, 4), (5, 6), (6, 7), (1, 8), (8, 9), (9, 10),
    (1, 11), (11, 12), (12, 13), (1, 0), (0, 14), (14, 16), (0, 15), (15, 17),
    (2, 16), (5, 17),
)

# PAF channel pair (x-channel, y-channel) for each limb in COCO_PAIRS order.
COCO_PAIRS_NETWORK: tuple[tuple[int, int], ...] = (
    (12, 13), (20, 21), (14, 15), (16, 17), (22, 23), (24, 25), (0, 1),
    (2, 3), (4, 5), (6, 7), (8, 9), (10, 11), (28, 29), (30, 31), (34, 35),
    (32, 33), (36, 37), (18, 19), (26, 27),
)

# Subset of limbs used for final rendering (drops the ear-shoulder links).
COCO_PAIRS_RENDER = COCO_PAIRS[:17]

# BGR draw colors per part (host-side visualization only).
COCO_COLORS: tuple[tuple[int, int, int], ...] = (
    (255, 0, 0), (255, 85, 0), (255, 170, 0), (255, 255, 0), (170, 255, 0),
    (85, 255, 0), (0, 255, 0), (0, 255, 85), (0, 255, 170), (0, 255, 255),
    (0, 170, 255), (0, 85, 255), (0, 0, 255), (85, 0, 255), (170, 0, 255),
    (255, 0, 255), (255, 0, 170), (255, 0, 85),
)

# Left/right part index swaps applied when an image is horizontally flipped.
FLIP_SWAP_PAIRS: tuple[tuple[int, int], ...] = (
    (2, 5), (3, 6), (4, 7), (8, 11), (9, 12), (10, 13), (14, 15), (16, 17),
)

# COCO-dataset 17-keypoint ordering (annotations) -> index in that ordering.
# 0 nose, 1 left_eye, 2 right_eye, 3 left_ear, 4 right_ear, 5 left_shoulder,
# 6 right_shoulder, 7 left_elbow, 8 right_elbow, 9 left_wrist, 10 right_wrist,
# 11 left_hip, 12 right_hip, 13 left_knee, 14 right_knee, 15 left_ankle,
# 16 right_ankle.
#
# OPENPOSE_FROM_COCO[p] = the COCO-17 index whose keypoint feeds OpenPose part
# p, with -1 for the synthesized Neck (mid-point of the two shoulders).
# (reference: openpose_plus/utils :: PoseInfo 17->18 conversion [MED file]).
OPENPOSE_FROM_COCO: tuple[int, ...] = (
    0,   # Nose
    -1,  # Neck = midpoint(left_shoulder=5, right_shoulder=6)
    6,   # RShoulder
    8,   # RElbow
    10,  # RWrist
    5,   # LShoulder
    7,   # LElbow
    9,   # LWrist
    12,  # RHip
    14,  # RKnee
    16,  # RAnkle
    11,  # LHip
    13,  # LKnee
    15,  # LAnkle
    2,   # REye
    1,   # LEye
    4,   # REar
    3,   # LEar
)

# Inverse map for exporting detections back to COCO-17 for OKS evaluation.
# COCO_FROM_OPENPOSE[c] = OpenPose part index feeding COCO keypoint c.
COCO_FROM_OPENPOSE: tuple[int, ...] = (
    0,   # nose
    15,  # left_eye
    14,  # right_eye
    17,  # left_ear
    16,  # right_ear
    5,   # left_shoulder
    2,   # right_shoulder
    6,   # left_elbow
    3,   # right_elbow
    7,   # left_wrist
    4,   # right_wrist
    11,  # left_hip
    8,   # right_hip
    12,  # left_knee
    9,   # right_knee
    13,  # left_ankle
    10,  # right_ankle
)

# Per-keypoint OKS falloff constants (COCO keypoint evaluation standard),
# COCO-17 ordering. sigma = k / 2.
COCO_OKS_SIGMAS = np.array(
    [0.026, 0.025, 0.025, 0.035, 0.035, 0.079, 0.079, 0.072, 0.072,
     0.062, 0.062, 0.107, 0.107, 0.087, 0.087, 0.089, 0.089],
    dtype=np.float32,
)


def pairs_array() -> np.ndarray:
    """(N_LIMBS, 2) int32 array of limb endpoint part indices."""
    return np.asarray(COCO_PAIRS, dtype=np.int32)


def paf_channels_array() -> np.ndarray:
    """(N_LIMBS, 2) int32 array of (x, y) PAF channel indices per limb."""
    return np.asarray(COCO_PAIRS_NETWORK, dtype=np.int32)
