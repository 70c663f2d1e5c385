"""Keypoint-aware augmentation as a single affine warp.

Replaces the reference's chained TL prepro ops (train.py :: _data_aug_fn
calling tl.prepro.keypoint_random_{rotate,crop,flip,resize} [HIGH; empty
mount — SURVEY.md §2]) with ONE fused affine transform per sample — same
augmentation family (rotate +-40 deg, scale jitter, random crop to net
input, horizontal flip with left/right part swap) but a single resample on
the host, with keypoints and the ignore mask warped by the same matrix.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from openpose_plus import skeleton
from openpose_plus.config import DataConfig

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


@dataclasses.dataclass
class AugmentedSample:
    image: np.ndarray       # (hin, win, 3) uint8
    keypoints: np.ndarray   # (P, 18, 3) in network-input pixels
    mask: np.ndarray        # (hin, win) uint8, 1 = apply loss


def _affine_matrix(src_w: int, src_h: int, dst_w: int, dst_h: int,
                   angle_deg: float, scale: float, shift: tuple[float, float],
                   flip: bool) -> np.ndarray:
    """2x3 src->dst matrix: center, rotate+scale, flip, recenter+shift."""
    theta = np.deg2rad(angle_deg)
    c, s = np.cos(theta) * scale, np.sin(theta) * scale
    rot = np.array([[c, -s], [s, c]], np.float64)
    if flip:
        rot = np.array([[-1.0, 0.0], [0.0, 1.0]]) @ rot
    src_c = np.array([src_w / 2, src_h / 2])
    dst_c = np.array([dst_w / 2 + shift[0], dst_h / 2 + shift[1]])
    t = dst_c - rot @ src_c
    return np.concatenate([rot, t[:, None]], axis=1)


def _apply_to_points(m: np.ndarray, pts: np.ndarray) -> np.ndarray:
    return pts @ m[:, :2].T + m[:, 2]


def _warp(sample_image, keypoints, mask, m, dst_w, dst_h, flip):
    if cv2 is None:
        raise RuntimeError("cv2 required for augmentation")
    img = cv2.warpAffine(sample_image, m, (dst_w, dst_h),
                         flags=cv2.INTER_LINEAR,
                         borderMode=cv2.BORDER_CONSTANT, borderValue=0)
    # outside-source content contributes no loss
    wmask = cv2.warpAffine(mask, m, (dst_w, dst_h),
                           flags=cv2.INTER_NEAREST,
                           borderMode=cv2.BORDER_CONSTANT, borderValue=0)
    kp = keypoints.copy()
    kp[..., :2] = _apply_to_points(m, keypoints[..., :2])
    inside = ((kp[..., 0] >= 0) & (kp[..., 0] < dst_w)
              & (kp[..., 1] >= 0) & (kp[..., 1] < dst_h))
    kp[..., 2] = np.where(inside, kp[..., 2], 0.0)
    if flip:
        for a, b in skeleton.FLIP_SWAP_PAIRS:
            kp[:, [a, b]] = kp[:, [b, a]]
    return img, kp, wmask


def augment_sample(image: np.ndarray, keypoints: np.ndarray,
                   mask: np.ndarray, cfg: DataConfig, hin: int, win: int,
                   rng: np.random.Generator) -> AugmentedSample:
    """Random train-time augmentation (one warp)."""
    src_h, src_w = image.shape[:2]
    fit = min(win / src_w, hin / src_h)
    scale = fit * rng.uniform(cfg.scale_min, cfg.scale_max)
    angle = rng.uniform(-cfg.rotate_max_deg, cfg.rotate_max_deg)
    # random crop: shift the warped center (reference keypoint_random_crop)
    f = cfg.shift_frac
    shift = (rng.uniform(-f, f) * win, rng.uniform(-f, f) * hin)
    flip = bool(rng.uniform() < cfg.flip_prob)
    m = _affine_matrix(src_w, src_h, win, hin, angle, scale, shift, flip)
    img, kp, wmask = _warp(image, keypoints, mask, m, win, hin, flip)
    return AugmentedSample(image=img, keypoints=kp, mask=wmask)


def letterbox(image: np.ndarray, hin: int, win: int
              ) -> tuple[np.ndarray, float, tuple[float, float]]:
    """Eval-time resize+pad to the network input, keypoint-free.

    Returns (image, scale, (pad_x, pad_y)); a network-space point maps back
    to the original as (p - pad) / scale.
    """
    src_h, src_w = image.shape[:2]
    scale = min(win / src_w, hin / src_h)
    m = _affine_matrix(src_w, src_h, win, hin, 0.0, scale, (0.0, 0.0), False)
    if cv2 is None:
        raise RuntimeError("cv2 required")
    img = cv2.warpAffine(image, m, (win, hin), flags=cv2.INTER_LINEAR,
                         borderMode=cv2.BORDER_CONSTANT, borderValue=0)
    pad_x = win / 2 - scale * src_w / 2
    pad_y = hin / 2 - scale * src_h / 2
    return img, scale, (pad_x, pad_y)
