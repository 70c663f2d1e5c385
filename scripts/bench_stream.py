"""Stream-mode sustained-throughput benchmark (BASELINE config #4).

Reproducible version of `pose stream --loop`: generates a SEEDED photo set
at a given source resolution (smooth low-frequency content, like camera
shots — JPEG entropy decode cost is content-dependent, so the set must be
pinned for before/after comparisons), then runs the end-to-end stream loop
(native decode+letterbox+s2d workers -> engine batches on the chip) and
prints one JSON line.

    python scripts/bench_stream.py [--src-h 3000 --src-w 4000] [--n 16]
                                   [--batch 8] [--workers 4] [--repeat 40]

The source resolution is the experiment variable: large photos exercise
the DCT-scaled JPEG decode path (libjpeg scale_num/denom set from the
letterbox target — native/src/image.cpp), which is what makes stream mode
scale with target size instead of source size.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def make_photo_set(src_h: int, src_w: int, n: int, quality: int = 90) -> str:
    """Seeded smooth-content JPEGs in a content-addressed cache dir."""
    import numpy as np
    from PIL import Image

    # v2: cache lives under the repo (not a predictable world-shared /tmp
    # path another user could pre-populate); bump the version token with
    # any generator change so stale sets are never trusted.
    key = hashlib.sha1(
        f"{src_h}x{src_w}x{n}q{quality}v2".encode()).hexdigest()[:10]
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out_dir = os.path.join(here, ".bench_photos", f"photos_{key}")
    marker = os.path.join(out_dir, ".complete")
    if os.path.exists(marker):
        return out_dir
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(0)
    for i in range(n):
        small = rng.integers(0, 255, (max(src_h // 60, 8),
                                      max(src_w // 60, 8), 3), dtype=np.uint8)
        img = Image.fromarray(small).resize((src_w, src_h), Image.BILINEAR)
        img.save(os.path.join(out_dir, f"p{i:03d}.jpg"), quality=quality)
    open(marker, "w").close()
    return out_dir


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="mobilenet_thin")
    ap.add_argument("--src-h", type=int, default=3000)
    ap.add_argument("--src-w", type=int, default=4000)
    ap.add_argument("--n", type=int, default=16)
    ap.add_argument("--hin", type=int, default=368)
    ap.add_argument("--win", type=int, default=656)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--repeat", type=int, default=40,
                    help="timed batches after warmup")
    ap.add_argument("--loader-only", action="store_true",
                    help="host pipeline only (no engine), isolates decode")
    args = ap.parse_args()

    import glob
    import time

    photo_dir = make_photo_set(args.src_h, args.src_w, args.n)
    paths = sorted(glob.glob(os.path.join(photo_dir, "*.jpg")))

    from openpose_plus import native

    name = (f"stream_fps_{args.model}_{args.hin}x{args.win}_bs{args.batch}"
            f"_src{args.src_h}x{args.src_w}"
            + ("_loader_only" if args.loader_only else ""))

    if args.loader_only:
        loader = native.NativeStreamLoader(
            paths, hin=args.hin, win=args.win, batch=args.batch,
            workers=args.workers, queue_capacity=4, loop=True, s2d=2)
        it = iter(loader)
        for _ in range(12):  # drain the pre-filled channel inventory
            next(it)
        t0 = time.perf_counter()
        frames = 0
        while frames < args.repeat * args.batch:
            frames += next(it)["images"].shape[0]
        dt = time.perf_counter() - t0
        loader.close()
    else:
        import dataclasses

        import jax

        from openpose_plus.utils.compile_cache import (
            configure_compile_cache)

        configure_compile_cache()

        from openpose_plus.config import default_config
        from openpose_plus.engine import Engine
        from openpose_plus.stream import StreamEstimator

        cfg = default_config(args.model)
        cfg = cfg.replace(model=dataclasses.replace(
            cfg.model, hin=args.hin, win=args.win))
        eng = Engine(cfg, fast_init=True)
        est = StreamEstimator(eng, batch=args.batch, workers=args.workers)
        it = est.run_files(paths, loop=True)
        # Warmup must DRAIN the decode backlog, not just compile: during
        # engine compile the workers pre-fill the frame channel (up to
        # ~2*queue_capacity batches); timing from a full queue overstates
        # steady-state throughput by that free inventory.
        for _ in range(12):
            next(it)
        t0 = time.perf_counter()
        frames = 0
        for _ in range(args.repeat):
            frames += next(it).n
        dt = time.perf_counter() - t0
        it.close()

    print(json.dumps({
        "metric": name,
        "value": round(frames / dt, 2),
        "unit": "frames/s",
        "ms_per_frame": round(dt / frames * 1e3, 3),
    }), flush=True)
    print(native.tracer_report(), file=sys.stderr)


if __name__ == "__main__":
    main()
