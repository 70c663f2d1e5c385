"""Host-side skeleton rendering (cv2). Not performance-critical.

Replaces the reference's draw_humans (openpose_plus/inference/common.py)
and src/vis.cpp [MED; empty mount — SURVEY.md §2]: limbs/parts drawn with
the standard per-part colors onto the original-resolution frame.
"""

from __future__ import annotations

import numpy as np

from openpose_plus import skeleton
from openpose_plus.postproc import HumanBatch

try:
    import cv2
except ImportError:  # pragma: no cover - cv2 is installed in the build env
    cv2 = None


def draw_humans(image: np.ndarray, humans: HumanBatch, batch_index: int = 0
                ) -> np.ndarray:
    """Draw detected skeletons onto a BGR uint8 image (returns a copy).

    `humans` coords are normalized [0,1]; scaled to the image size here.
    """
    if cv2 is None:
        raise RuntimeError("cv2 unavailable")
    img = image.copy()
    h, w = img.shape[:2]
    valid = np.asarray(humans.valid[batch_index])
    coords = np.asarray(humans.coords[batch_index])
    pvalid = np.asarray(humans.part_valid[batch_index])
    radius = max(2, int(round(min(h, w) / 120)))
    for m in range(valid.shape[0]):
        if not valid[m]:
            continue
        centers = {}
        for part in range(skeleton.N_PARTS):
            if not pvalid[m, part]:
                continue
            cx = int(round(coords[m, part, 0] * w))
            cy = int(round(coords[m, part, 1] * h))
            centers[part] = (cx, cy)
            cv2.circle(img, (cx, cy), radius,
                       skeleton.COCO_COLORS[part], -1)
        for limb, (ia, ib) in enumerate(skeleton.COCO_PAIRS_RENDER):
            if ia in centers and ib in centers:
                cv2.line(img, centers[ia], centers[ib],
                         skeleton.COCO_COLORS[limb % len(skeleton.COCO_COLORS)],
                         radius // 2 + 1)
    return img


def draw_maps_overlay(image: np.ndarray, conf: np.ndarray) -> np.ndarray:
    """Debug view: heatmap max-projection blended over the image (the
    reference's draw_results training visualization analogue)."""
    if cv2 is None:
        raise RuntimeError("cv2 unavailable")
    h, w = image.shape[:2]
    m = np.asarray(conf)[..., : skeleton.N_PARTS].max(-1)
    m = cv2.resize(m, (w, h), interpolation=cv2.INTER_LINEAR)
    m8 = np.clip(m * 255, 0, 255).astype(np.uint8)
    heat = cv2.applyColorMap(m8, cv2.COLORMAP_JET)
    return cv2.addWeighted(image, 0.6, heat, 0.4, 0)
