"""Synthetic heatmap/PAF scenes for decoder checks (tests, chip_smoke.py).

Builds idealized network outputs (max-of-Gaussians heatmaps, unit-vector PAF
bands averaged where people overlap — the same formulas the reference's GT
synthesis uses) from hand-placed keypoints, so grouping results are known.
"""

from __future__ import annotations

import numpy as np

from openpose_plus import skeleton


def make_maps(people: list[dict[int, tuple[float, float]]], h: int, w: int,
              sigma: float = 2.0, limb_width: float = 1.5,
              noise: float = 0.0, seed: int = 0):
    """people: list of {part_idx: (x, y)} dicts in map coords.

    Returns (conf (h,w,19), paf (h,w,38)) float32.
    """
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    conf = np.zeros((h, w, skeleton.N_HEATMAPS), np.float32)
    for person in people:
        for part, (px, py) in person.items():
            g = np.exp(-((xx - px) ** 2 + (yy - py) ** 2) / (2 * sigma ** 2))
            conf[:, :, part] = np.maximum(conf[:, :, part], g)
    conf[:, :, skeleton.N_PARTS] = 1.0 - conf[:, :, : skeleton.N_PARTS].max(-1)

    paf = np.zeros((h, w, skeleton.N_PAF_CHANNELS), np.float32)
    count = np.zeros((h, w, skeleton.N_LIMBS), np.float32)
    for person in people:
        for limb, (ia, ib) in enumerate(skeleton.COCO_PAIRS):
            if ia not in person or ib not in person:
                continue
            ax, ay = person[ia]
            bx, by = person[ib]
            dx, dy = bx - ax, by - ay
            norm = max(np.hypot(dx, dy), 1e-4)
            ux, uy = dx / norm, dy / norm
            # distance along / perpendicular to the limb segment
            relx, rely = xx - ax, yy - ay
            along = relx * ux + rely * uy
            perp = np.abs(relx * (-uy) + rely * ux)
            band = (along >= 0) & (along <= norm) & (perp <= limb_width)
            cx, cy = skeleton.COCO_PAIRS_NETWORK[limb]
            paf[:, :, cx] += band * ux
            paf[:, :, cy] += band * uy
            count[:, :, limb] += band
    for limb, (cx, cy) in enumerate(skeleton.COCO_PAIRS_NETWORK):
        nz = count[:, :, limb] > 0
        paf[:, :, cx][nz] /= count[:, :, limb][nz]
        paf[:, :, cy][nz] /= count[:, :, limb][nz]

    if noise > 0:
        rng = np.random.default_rng(seed)
        conf = conf + rng.normal(0, noise, conf.shape).astype(np.float32)
        paf = paf + rng.normal(0, noise, paf.shape).astype(np.float32)
    return conf.astype(np.float32), paf.astype(np.float32)


def standing_person(cx: float, cy: float, scale: float = 1.0
                    ) -> dict[int, tuple[float, float]]:
    """A full 18-part stick figure centered near (cx, cy)."""
    s = scale
    return {
        0: (cx, cy - 10 * s),          # nose
        1: (cx, cy - 7 * s),           # neck
        2: (cx - 3 * s, cy - 7 * s),   # r shoulder
        3: (cx - 4 * s, cy - 3 * s),   # r elbow
        4: (cx - 5 * s, cy + 1 * s),   # r wrist
        5: (cx + 3 * s, cy - 7 * s),   # l shoulder
        6: (cx + 4 * s, cy - 3 * s),   # l elbow
        7: (cx + 5 * s, cy + 1 * s),   # l wrist
        8: (cx - 2 * s, cy),           # r hip
        9: (cx - 2 * s, cy + 5 * s),   # r knee
        10: (cx - 2 * s, cy + 9 * s),  # r ankle
        11: (cx + 2 * s, cy),          # l hip
        12: (cx + 2 * s, cy + 5 * s),  # l knee
        13: (cx + 2 * s, cy + 9 * s),  # l ankle
        14: (cx - 1 * s, cy - 11 * s),  # r eye
        15: (cx + 1 * s, cy - 11 * s),  # l eye
        16: (cx - 2 * s, cy - 10.5 * s),  # r ear
        17: (cx + 2 * s, cy - 10.5 * s),  # l ear
    }
