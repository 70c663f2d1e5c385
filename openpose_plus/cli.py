"""Command-line apps: the reference's examples layer as subcommands.

Maps the reference's binaries/scripts (SURVEY.md §2 "C++ examples" /
"Python examples": example-inference-1, example-batch-detector,
example-stream-detector, example-live-camera, eval + train scripts) onto
one entry point:

    python -m openpose_plus infer  --images a.jpg b.jpg --draw-dir out/
    python -m openpose_plus stream --images 'dir/*.jpg' --loop --repeat 200
    python -m openpose_plus camera --device 0
    python -m openpose_plus bench
    python -m openpose_plus eval   --annotations ... --images ...
    python -m openpose_plus train  --model vgg19 ...
    python -m openpose_plus export --out engine_dir/ --batch 8

`export` is the reference's export-uff.py analogue: a frozen, self-contained
StableHLO artifact (weights baked in) that `infer --engine-dir` reloads
without the model-building code.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import sys
import time
from typing import Optional


def _build_engine(args) -> "Engine":
    from openpose_plus.config import default_config
    from openpose_plus.engine import Engine

    cfg = default_config(args.model)
    mc = dataclasses.replace(cfg.model, hin=args.input_height,
                             win=args.input_width)
    cfg = cfg.replace(model=mc)
    if getattr(args, "fidelity", False):
        cfg = cfg.replace(postproc=cfg.postproc.fidelity())
    if getattr(args, "frag_merge", 0.0):
        cfg = cfg.replace(postproc=dataclasses.replace(
            cfg.postproc, fragment_merge_rel=args.frag_merge))
    params = None
    if args.checkpoint:
        from openpose_plus import checkpoint as ckpt
        from openpose_plus import train as T
        import jax

        template = T.create_train_state(cfg, jax.random.PRNGKey(0))
        if args.checkpoint.endswith(".npz"):
            params = ckpt.load_npz(args.checkpoint, template.params)
        else:
            params = ckpt.restore(args.checkpoint, template).params
    return Engine(cfg, params=params)


def _engine_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--model", default="mobilenet_thin")
    p.add_argument("--checkpoint", default=None,
                   help="orbax dir or .npz weights")
    p.add_argument("--input-height", type=int, default=368)
    p.add_argument("--input-width", type=int, default=432)
    p.add_argument("--fidelity", action="store_true",
                   help="reference-style high-fidelity grouping (8x maps)")
    p.add_argument("--frag-merge", type=float, default=0.0, metavar="REL",
                   help="fragment-merge repair pass: re-join disjoint-part "
                        "skeletons closer than REL x the larger fragment's "
                        "bbox diagonal (0 = off; 0.5 = tuned setting). "
                        "Recovers truncated people the bottom-up assembly "
                        "structurally fragments")


def cmd_infer(args) -> int:
    """Batch image files -> skeletons (example-inference-1 equivalent)."""
    import numpy as np

    from openpose_plus import native
    from openpose_plus.eval_coco import humans_to_detections

    if getattr(args, "engine_dir", None):
        # frozen StableHLO artifact (the reference's run-from-.uff path);
        # the artifact fixes model/weights/dims/grouping at export time, so
        # engine-building flags cannot be honored — reject rather than
        # silently ignore them.
        for flag, default in (("checkpoint", None), ("fidelity", False),
                              ("model", "mobilenet_thin"),
                              ("input_height", 368), ("input_width", 432)):
            if getattr(args, flag, default) != default:
                print(f"--engine-dir runs a frozen artifact; --{flag} "
                      f"has no effect (set it at `export` time)",
                      file=sys.stderr)
                return 2
        from openpose_plus.export import load_engine

        eng = load_engine(args.engine_dir)
        args.batch = eng.batch_size
    else:
        eng = _build_engine(args)
    m = eng.config.model
    paths = _expand(args.images)
    if not paths:
        print("no input images", file=sys.stderr)
        return 2
    batch = args.batch
    out = []
    for i in range(0, len(paths), batch):
        chunk = paths[i:i + batch]
        images, metas = [], []
        for p in chunk:
            loaded = native.load_image(p, m.hin, m.win) \
                if native.is_available() else None
            if loaded is None:
                from openpose_plus.data.augment import letterbox
                from openpose_plus.data.pipeline import _load_image
                img, scale, pad = letterbox(_load_image(p), m.hin, m.win)
            else:
                img, scale, pad = loaded
            images.append(img)
            metas.append((p, scale, pad))
        while len(images) < batch:
            images.append(np.zeros_like(images[0]))
        humans = eng.infer(np.stack(images))
        for b, (p, scale, pad) in enumerate(metas):
            dets = humans_to_detections(humans, b, 0, scale, pad, m.hin,
                                        m.win)
            out.append({"image": p, "n_humans": len(dets),
                        "humans": [
                            {"score": d.score,
                             "keypoints": d.keypoints.round(2).tolist()}
                            for d in dets]})
            print(f"{p}: {len(dets)} humans")
            if args.draw_dir:
                _draw(p, humans, b, args.draw_dir)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(out, f)
    return 0


def _draw(path: str, humans, b: int, draw_dir: str) -> None:
    import cv2

    from openpose_plus.utils.vis import draw_humans

    os.makedirs(draw_dir, exist_ok=True)
    img = cv2.imread(path)
    vis = draw_humans(img, humans, b)
    cv2.imwrite(os.path.join(draw_dir, os.path.basename(path)), vis)


def cmd_stream(args) -> int:
    """Sustained pipelined throughput (example-stream-detector)."""
    from openpose_plus.stream import StreamEstimator
    from openpose_plus import native

    eng = _build_engine(args)
    est = StreamEstimator(eng, batch=args.batch, workers=args.workers)
    if args.video:
        it = est.run_video(args.video)
    else:
        paths = _expand(args.images or [])
        if not paths:
            print("no input images (use --images or --video)",
                  file=sys.stderr)
            return 2
        it = est.run_files(paths, loop=args.loop)
    n_batches = args.repeat if args.loop else None
    frames = 0
    t0: Optional[float] = None
    for i, r in enumerate(it):
        if i == 0:
            t0 = time.perf_counter()   # skip compile batch
        else:
            frames += r.n
        if n_batches is not None and i >= n_batches:
            break
    dt = time.perf_counter() - (t0 or time.perf_counter())
    if frames:
        print(f"{frames} frames in {dt:.2f}s = {frames / dt:.1f} FPS")
    if native.is_available():
        print(native.tracer_report())
    return 0


def cmd_camera(args) -> int:
    """Live camera loop (example-live-camera)."""
    import cv2

    from openpose_plus.stream import StreamEstimator
    from openpose_plus.utils.vis import draw_humans

    cap = cv2.VideoCapture(args.device)
    if not cap.isOpened():
        print(f"cannot open camera {args.device}", file=sys.stderr)
        return 2
    eng = _build_engine(args)
    est = StreamEstimator(eng, batch=1)

    def frames():
        while True:
            ok, frame = cap.read()
            if not ok:
                return
            yield cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)

    for r in est.run_frames(frames()):
        print(f"frame {int(r.indices[0])}: "
              f"{int(r.humans.num_humans[0])} humans")
        if args.save_dir:
            import numpy as np

            os.makedirs(args.save_dir, exist_ok=True)
            canvas = np.zeros((eng.config.model.hin, eng.config.model.win, 3),
                              np.uint8)
            cv2.imwrite(os.path.join(args.save_dir,
                                     f"frame{int(r.indices[0]):06d}.jpg"),
                        draw_humans(canvas, r.humans, 0))
    cap.release()
    return 0


def cmd_bench(args) -> int:
    """Engine-throughput benchmark (the reference's --fake mode)."""
    import bench as bench_mod

    bench_mod.main()
    return 0


def cmd_eval(args) -> int:
    """COCO val AP (distributed when launched multi-host)."""
    from openpose_plus.data.coco import CocoPoseDataset
    from openpose_plus.eval_coco import evaluate_engine

    eng = _build_engine(args)
    ds = CocoPoseDataset(args.annotations, args.images)
    res = evaluate_engine(eng, ds, batch_size=args.batch, limit=args.limit,
                          distributed=args.distributed,
                          flip_tta=args.flip_tta,
                          scales=tuple(args.scales) if args.scales else None,
                          ms_combine=args.ms_combine)
    print(json.dumps(res.as_dict()))
    return 0


def cmd_train(args, extra) -> int:
    from openpose_plus import train as T

    T.main(extra)
    return 0


def cmd_export(args) -> int:
    """Freeze the engine to a StableHLO artifact (export-uff.py analogue)."""
    from openpose_plus.export import save_engine

    eng = _build_engine(args)
    save_engine(eng, args.out, batch_size=args.batch,
                input_layout=args.input_layout)
    print(json.dumps({"out": args.out, "model": args.model,
                      "batch_size": args.batch,
                      "input_layout": args.input_layout}))
    return 0


def _expand(patterns) -> list[str]:
    out = []
    for p in patterns:
        hits = sorted(glob.glob(p))
        out.extend(hits if hits else ([p] if os.path.exists(p) else []))
    return out


def main(argv: Optional[list[str]] = None) -> int:
    from openpose_plus.utils.compile_cache import configure_compile_cache

    configure_compile_cache()
    parser = argparse.ArgumentParser(prog="openpose_plus")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("infer", help="pose estimation on image files")
    _engine_flags(p)
    p.add_argument("--images", nargs="+", required=True)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--draw-dir", default=None)
    p.add_argument("--json-out", default=None)
    p.add_argument("--engine-dir", default=None,
                   help="run a frozen artifact from `export` instead of "
                        "building the model")

    p = sub.add_parser("stream", help="pipelined stream throughput")
    _engine_flags(p)
    p.add_argument("--images", nargs="+", default=None)
    p.add_argument("--video", default=None,
                   help="stream a video file instead of image files")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--loop", action="store_true")
    p.add_argument("--repeat", type=int, default=50,
                   help="batches to time in --loop mode")

    p = sub.add_parser("camera", help="live camera inference")
    _engine_flags(p)
    p.add_argument("--device", type=int, default=0)
    p.add_argument("--save-dir", default=None,
                   help="write rendered skeleton frames here")

    p = sub.add_parser("bench", help="device benchmark (fake-input mode)")

    p = sub.add_parser("eval", help="COCO keypoint AP evaluation")
    _engine_flags(p)
    p.add_argument("--annotations", required=True)
    p.add_argument("--images", required=True)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--distributed", action="store_true")
    p.add_argument("--scales", type=float, nargs="+", default=None,
                   help="multi-scale search, e.g. --scales 0.5 1.0 1.5 "
                        "(maps averaged on the base grid; higher AP)")
    p.add_argument("--ms-combine", choices=("avg", "dedup"), default="avg",
                   help="multi-scale combiner: avg = map averaging "
                        "(reference-style), dedup = per-scale decode + "
                        "OKS-NMS merge")
    p.add_argument("--flip-tta", action="store_true",
                   help="average horizontally-flipped predictions")

    p = sub.add_parser("train", help="train a model (see train.py flags)")

    p = sub.add_parser("export", help="freeze the engine to a StableHLO "
                                      "artifact (export-uff.py analogue)")
    _engine_flags(p)
    p.add_argument("--out", required=True, help="output artifact directory")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--input-layout", default="plain",
                   choices=["plain", "s2d", "s2d2"],
                   help="input signature baked into the artifact (the "
                        "space-to-depth layouts the host loader emits); "
                        "loaded artifacts still accept plain images and "
                        "permute on the host")

    args, extra = parser.parse_known_args(argv)
    if args.cmd == "train":
        return cmd_train(args, extra)
    if extra:
        parser.error(f"unknown arguments: {extra}")
    return {"infer": cmd_infer, "stream": cmd_stream, "camera": cmd_camera,
            "bench": cmd_bench, "eval": cmd_eval,
            "export": cmd_export}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
