"""End-to-end learning demo on synthetic data: train -> decode -> AP.

No COCO dataset exists in the build environment (zero egress), so this
script proves the full stack works as a system: it renders a synthetic
dataset of stick figures (images + COCO-format keypoint annotations),
trains a small model with the real pipeline (augmentation, on-device GT
synthesis, jit train step), and evaluates keypoint AP with the real
evaluator (letterbox -> engine -> on-device grouping -> OKS matching) —
before and after training.

    python scripts/synthetic_e2e.py --steps 300 --n-images 64

Prints one JSON line: {"ap_before": ..., "ap_after": ..., "loss_first":
..., "loss_last": ...}.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def make_synthetic_dataset(out_dir: str, n_images: int, size: int = 256,
                           seed: int = 0) -> tuple[str, str]:
    """Stick-figure scenes + COCO-format annotations."""
    import cv2

    from openpose_plus import skeleton

    img_dir = os.path.join(out_dir, "images")
    os.makedirs(img_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    images, annotations = [], []
    ann_id = 0
    for i in range(n_images):
        img = rng.integers(0, 60, (size, size, 3), dtype=np.uint8)
        n_people = int(rng.integers(1, 4))
        from openpose_plus.data.scenes import standing_person

        for _ in range(n_people):
            s = rng.uniform(size / 48, size / 24)  # pixels per canonical unit
            cx = rng.uniform(6 * s, size - 6 * s)
            cy = rng.uniform(12 * s, size - 10 * s)
            # canonical figure spans ~[-5,5] x [-11,9] units around its
            # center; evaluating at (cx/s, cy/s) and scaling by s places
            # it at (cx, cy) in pixels.
            pose = {p: (x * s, y * s)
                    for p, (x, y) in standing_person(cx / s, cy / s).items()}
            # draw skeleton
            color = tuple(int(c) for c in rng.integers(120, 255, 3))
            for ia, ib in skeleton.COCO_PAIRS_RENDER:
                if ia in pose and ib in pose:
                    cv2.line(img, (int(pose[ia][0]), int(pose[ia][1])),
                             (int(pose[ib][0]), int(pose[ib][1])), color, 2)
            for p, (x, y) in pose.items():
                cv2.circle(img, (int(x), int(y)), 3,
                           skeleton.COCO_COLORS[p % 18], -1)
            # COCO-17 annotation
            kp = []
            for c17, p18 in enumerate(skeleton.COCO_FROM_OPENPOSE):
                x, y = pose[p18]
                v = 2 if 0 <= x < size and 0 <= y < size else 0
                kp += [float(x), float(y), v]
            xs = [pose[p][0] for p in pose]
            ys = [pose[p][1] for p in pose]
            area = max((max(xs) - min(xs)) * (max(ys) - min(ys)), 1.0)
            annotations.append({
                "id": ann_id, "image_id": i, "category_id": 1, "iscrowd": 0,
                "area": float(area), "keypoints": kp, "segmentation": [],
            })
            ann_id += 1
        name = f"syn{i:04d}.jpg"
        cv2.imwrite(os.path.join(img_dir, name), img)
        images.append({"id": i, "file_name": name, "width": size,
                       "height": size})
    ann_path = os.path.join(out_dir, "annotations.json")
    with open(ann_path, "w") as f:
        json.dump({"images": images, "annotations": annotations}, f)
    return ann_path, img_dir


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--n-images", type=int, default=64)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--hin", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--eval-limit", type=int, default=32)
    ap.add_argument("--model", default="vggtiny")
    args = ap.parse_args()

    import jax

    from openpose_plus import train as T
    from openpose_plus.config import default_config
    from openpose_plus.data.coco import CocoPoseDataset
    from openpose_plus.engine import Engine
    from openpose_plus.eval_coco import evaluate_engine

    workdir = args.workdir or tempfile.mkdtemp(prefix="synth_e2e_")
    ann, imgs = make_synthetic_dataset(workdir, args.n_images, args.size)

    cfg = default_config(args.model)
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, hin=args.hin, win=args.hin,
                                  n_stages=3),
        data=dataclasses.replace(
            cfg.data, train_annotations=ann, train_images=imgs,
            num_workers=4, prefetch=4,
            # mild augmentation: the synthetic set is small
            rotate_max_deg=15.0, scale_min=0.8, scale_max=1.1,
            shift_frac=0.1, sigma=6.0, limb_width=6.0),
        train=dataclasses.replace(
            cfg.train, batch_size=args.batch, lr_init=args.lr,
            lr_decay_every=10_000, weight_decay=0.0, log_every=50,
            checkpoint_every=10 ** 9,
            checkpoint_dir=os.path.join(workdir, "ck")),
    )

    dataset = CocoPoseDataset(ann, imgs)
    print(f"dataset: {len(dataset)} images", flush=True)

    state = T.create_train_state(cfg, jax.random.PRNGKey(0))
    eng_before = Engine(cfg, params=state.params)
    ap_before = evaluate_engine(eng_before, dataset, batch_size=args.batch,
                                limit=args.eval_limit)

    # train (reuse train_loop internals minimally: manual loop for control)
    from openpose_plus.data.pipeline import TrainPipeline

    pipeline = TrainPipeline(dataset, cfg, seed=0)
    step_fn = T.make_train_step_on_batch(cfg)
    it = iter(pipeline)
    losses = []
    for i in range(args.steps):
        state, metrics = step_fn(state, next(it))
        if i % 50 == 0 or i == args.steps - 1:
            l = float(metrics["loss"])
            losses.append(l)
            print(f"step {i}: loss {l:.2f}", flush=True)
    pipeline.stop()

    eng_after = Engine(cfg, params=state.params)
    ap_after = evaluate_engine(eng_after, dataset, batch_size=args.batch,
                               limit=args.eval_limit)

    print(json.dumps({
        "ap_before": round(ap_before.ap, 4),
        "ap_after": round(ap_after.ap, 4),
        "ap50_after": round(ap_after.ap50, 4),
        "ar_after": round(ap_after.ar, 4),
        "loss_first": round(losses[0], 2),
        "loss_last": round(losses[-1], 2),
        "workdir": workdir,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
