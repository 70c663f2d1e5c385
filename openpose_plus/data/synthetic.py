"""Seeded synthetic scene bank: the standing quality benchmark's dataset.

No COCO dataset can exist in the build environment (zero egress), so the
framework's quality (AP) axis is tracked on a FIXED, SEEDED bank of
rendered multi-person scenes instead — the regimes PAF grouping exists
for: crowds, overlapping people, wide scale variation, border truncation,
and background clutter. Train and val splits use disjoint seeds; the val
split is held out (never trained on), unlike the r2 smoke proof which
evaluated on its own training images.

Scene recipe (per image):
  * 1-6 people; with probability ~0.5 each person after the first is
    placed CLOSE to an existing one (overlapping bounding boxes — the
    bipartite-assignment stress case).
  * log-uniform scale over ~3.5x (small background figures next to large
    foreground ones — multi-scale search's reason to exist).
  * whole-figure rotation +-25 deg and per-joint jitter (articulation),
    so limbs are not axis-aligned templates.
  * centers may fall near the border: out-of-frame joints are marked
    invisible (v=0) in the annotation, exercising truncation handling.
  * clutter: random non-person line segments + low-level noise
    background, so peak finding sees distractor edges.

The bank is COCO-format (images dir + annotations.json) and feeds the
real pipeline end to end: CocoPoseDataset -> augmentation -> on-device GT
synthesis -> train step; letterbox -> engine -> grouping -> OKS eval.

Reference parity note: the reference (SURVEY.md §2 "Python examples /
eval") evaluated on COCO val2017 via pycocotools; this module substitutes
a generated bank with the same annotation schema so the identical
evaluator path is exercised.
"""

from __future__ import annotations

import json
import os

import numpy as np

from openpose_plus import skeleton

# Canonical 18-part figure in unit coordinates (spans ~[-5,5] x [-10,9]
# around the pelvis); mirrors data/scenes.standing_person.
_CANONICAL: dict[int, tuple[float, float]] = {
    0: (0.0, -10.0), 1: (0.0, -7.0),
    2: (-3.0, -7.0), 3: (-4.0, -3.0), 4: (-5.0, 1.0),
    5: (3.0, -7.0), 6: (4.0, -3.0), 7: (5.0, 1.0),
    8: (-2.0, 0.0), 9: (-2.0, 5.0), 10: (-2.0, 9.0),
    11: (2.0, 0.0), 12: (2.0, 5.0), 13: (2.0, 9.0),
    14: (-1.0, -10.5), 15: (1.0, -10.5),
    16: (-2.0, -10.0), 17: (2.0, -10.0),
}


def _sample_person(rng: np.random.Generator, cx: float, cy: float,
                   s: float) -> dict[int, tuple[float, float]]:
    """Articulated figure: global rotation + per-joint jitter at scale s."""
    theta = rng.uniform(-25, 25) * np.pi / 180.0
    ct, st = np.cos(theta), np.sin(theta)
    pose = {}
    for part, (ux, uy) in _CANONICAL.items():
        jx = ux + rng.normal(0, 0.45)
        jy = uy + rng.normal(0, 0.45)
        pose[part] = (cx + s * (ct * jx - st * jy),
                      cy + s * (st * jx + ct * jy))
    return pose


def render_scene(rng: np.random.Generator, size: int,
                 scale_div_lo: float = 48, scale_div_hi: float = 16,
                 max_people: int = 6,
                 ) -> tuple[np.ndarray, list[dict[int, tuple[float, float]]]]:
    """One clutter+crowd scene; returns (HxWx3 uint8, list of poses).

    Figure scale is log-uniform over size/scale_div_lo .. size/scale_div_hi
    (the default spans ~3.5x); the "val_large" split overrides these to
    produce few, frame-filling figures — the regime where down-scale TTA
    is supposed to help."""
    import cv2

    base = int(rng.integers(10, 70))
    img = rng.integers(0, base, (size, size, 3), dtype=np.uint8)
    # clutter: distractor segments that are NOT limbs of any person
    for _ in range(int(rng.integers(0, 5))):
        p0 = tuple(int(v) for v in rng.integers(0, size, 2))
        p1 = tuple(int(v) for v in rng.integers(0, size, 2))
        color = tuple(int(c) for c in rng.integers(60, 160, 3))
        cv2.line(img, p0, p1, color, int(rng.integers(1, 3)))

    n_people = int(rng.integers(1, max_people + 1))
    poses: list[dict[int, tuple[float, float]]] = []
    centers: list[tuple[float, float, float]] = []  # (cx, cy, s)
    for k in range(n_people):
        # log-uniform scale: ~size/48 (small background) .. size/16 (large)
        s = float(np.exp(rng.uniform(np.log(size / scale_div_lo),
                                     np.log(size / scale_div_hi))))
        if centers and rng.random() < 0.5:
            # crowd: drop next to an existing person (overlapping boxes)
            bx, by, bs = centers[int(rng.integers(0, len(centers)))]
            cx = bx + rng.uniform(-4, 4) * max(s, bs)
            cy = by + rng.uniform(-3, 3) * max(s, bs)
        else:
            # margin allows partial truncation at every border
            cx = rng.uniform(-2 * s, size + 2 * s)
            cy = rng.uniform(6 * s, size + 4 * s)
        cx = float(np.clip(cx, -3 * s, size + 3 * s))
        cy = float(np.clip(cy, 2 * s, size + 6 * s))
        pose = _sample_person(rng, cx, cy, s)
        poses.append(pose)
        centers.append((cx, cy, s))

    # NOTE: colors here are nominal-RGB but the bank is SAVED channel-
    # swapped — make_scene_bank writes with cv2.imwrite (BGR convention)
    # and the loaders read it back consistently, so train/eval agree; only
    # a human inspecting the .jpg files sees swapped R/B on the joints.
    # Kept as-is because converting would invalidate every recorded AP.
    # render back-to-front so overlapping people occlude consistently
    for pose in poses:
        color = tuple(int(c) for c in rng.integers(120, 255, 3))
        for ia, ib in skeleton.COCO_PAIRS_RENDER:
            if ia in pose and ib in pose:
                cv2.line(img, (int(pose[ia][0]), int(pose[ia][1])),
                         (int(pose[ib][0]), int(pose[ib][1])), color, 2)
        for p, (x, y) in pose.items():
            cv2.circle(img, (int(x), int(y)), 3,
                       skeleton.COCO_COLORS[p % 18], -1)
    return img, poses


def make_scene_bank(out_dir: str, split: str, n_images: int,
                    size: int = 256, version: int = 1) -> tuple[str, str]:
    """Seeded scene bank -> (annotations.json path, images dir).

    Seeds are derived from (split, version) only, so the bank is bit-
    reproducible; bump `version` to invalidate every recorded number at
    once. Reuses an existing complete bank on disk.
    """
    import cv2

    bank = os.path.join(out_dir, f"{split}_v{version}_{n_images}x{size}")
    img_dir = os.path.join(bank, "images")
    ann_path = os.path.join(bank, "annotations.json")
    if os.path.exists(os.path.join(bank, ".complete")):
        return ann_path, img_dir
    os.makedirs(img_dir, exist_ok=True)
    seed = {"train": 1000, "val": 2000, "val_large": 3000}.get(split)
    if seed is None:
        raise ValueError(f"unknown split {split!r} (train|val|val_large)")
    # val_large: few, frame-filling (often truncated) figures — the
    # large-figure regime the multi-scale TTA study slices on.
    style = ({"scale_div_lo": 24, "scale_div_hi": 10, "max_people": 3}
             if split == "val_large" else {})
    rng = np.random.default_rng(seed + version * 10_000)

    images, annotations = [], []
    ann_id = 0
    for i in range(n_images):
        img, poses = render_scene(rng, size, **style)
        for pose in poses:
            kp, n_vis = [], 0
            for c17 in range(17):
                x, y = pose[skeleton.COCO_FROM_OPENPOSE[c17]]
                v = 2 if 0 <= x < size and 0 <= y < size else 0
                n_vis += v > 0
                kp += [float(x), float(y), v]
            if n_vis == 0:
                continue  # fully out of frame
            xs = [p[0] for p in pose.values()]
            ys = [p[1] for p in pose.values()]
            area = max((max(xs) - min(xs)) * (max(ys) - min(ys)), 1.0)
            annotations.append({
                "id": ann_id, "image_id": i, "category_id": 1, "iscrowd": 0,
                "area": float(area), "keypoints": kp, "segmentation": [],
                "num_keypoints": int(n_vis),
            })
            ann_id += 1
        name = f"{split}{i:04d}.jpg"
        cv2.imwrite(os.path.join(img_dir, name), img)
        images.append({"id": i, "file_name": name, "width": size,
                       "height": size})
    with open(ann_path, "w") as f:
        json.dump({"images": images, "annotations": annotations}, f)
    open(os.path.join(bank, ".complete"), "w").close()
    return ann_path, img_dir
