"""Fragment-merge threshold sweep on the TRAIN bank's GT-map oracle.

The repair pass (postproc/decode.py::_merge_fragments_single) has one
free parameter: `fragment_merge_rel`, the max part-to-part gap as a
fraction of the larger fragment's bbox diagonal. Protocol: the value is
chosen HERE, on the TRAIN bank's oracle decode (GT maps -> decoder), and
frozen before any val measurement — so the val oracle/model deltas in
BASELINE.md are clean of threshold tuning. Re-running this script reprints
the sweep that picked rel=0.5.

    python scripts/tune_fragment_merge.py --geometry serving --cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import ap_benchmark as apb  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--geometry", choices=tuple(apb.GEOMETRIES),
                    default="serving")
    ap.add_argument("--rels", type=str, default="0,0.3,0.4,0.5,0.6,0.8",
                    help="comma-separated fragment_merge_rel values "
                         "(0 = pass disabled)")
    ap.add_argument("--bank", choices=("train", "val"), default="train",
                    help="train is the tuning protocol; val only for "
                         "post-hoc sensitivity reporting")
    ap.add_argument("--cpu", action="store_true",
                    help="decode on CPU (leave the accelerator to other jobs)")
    args = ap.parse_args()

    import jax

    from openpose_plus.utils.compile_cache import configure_compile_cache

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    configure_compile_cache()

    from openpose_plus.config import PostprocConfig
    from openpose_plus.data.coco import CocoPoseDataset
    from openpose_plus.data.synthetic import make_scene_bank
    from openpose_plus.data.targets import make_targets
    from openpose_plus.eval_coco import (evaluate_detections_full,
                                             humans_to_detections)
    from openpose_plus.postproc import build_decoder

    geo = apb.GEOMETRIES[args.geometry]
    n = geo["n_train"] if args.bank == "train" else geo["n_val"]
    ann, imgs = make_scene_bank(apb.BANK_DIR, args.bank, n, geo["size"])
    ds = CocoPoseDataset(ann, imgs)
    samples = [ds[i] for i in range(len(ds))]
    maxp = max(s.keypoints.shape[0] for s in samples)
    gt_by_image = {s.image_id: (s.keypoints_coco, s.areas, s.ignore_boxes)
                   for s in samples}

    hin, win, stride = geo["hin"], geo["win"], 8
    hout, wout = hin // stride, win // stride
    render = jax.jit(jax.vmap(lambda kp: make_targets(
        kp, hout, wout, stride, geo["sigma"], geo["limb"])))

    metas, kp_all = [], []
    for s in samples:
        scale = min(win / s.width, hin / s.height)
        pad = (win / 2 - scale * s.width / 2, hin / 2 - scale * s.height / 2)
        metas.append((scale, pad))
        kp = np.zeros((maxp, 18, 3), np.float32)
        k = s.keypoints
        kp[: k.shape[0], :, 0] = k[:, :, 0] * scale + pad[0]
        kp[: k.shape[0], :, 1] = k[:, :, 1] * scale + pad[1]
        kp[: k.shape[0], :, 2] = k[:, :, 2]
        kp_all.append(kp)

    # render GT maps once; decode per rel value
    bs = 8
    rendered = []
    for i in range(0, len(samples), bs):
        kps = np.stack(kp_all[i:i + bs]
                       + [np.zeros((maxp, 18, 3), np.float32)]
                       * (bs - len(kp_all[i:i + bs])))
        conf, paf = render(jax.numpy.asarray(kps))
        rendered.append((np.asarray(conf), np.asarray(paf)))

    print(f"bank={args.bank} tier={args.geometry} "
          f"({len(samples)} scenes, fidelity decoder):")
    for rel in (float(r) for r in args.rels.split(",")):
        pcfg = PostprocConfig().fidelity(upsample=stride)
        if rel > 0:
            pcfg = dataclasses.replace(pcfg, fragment_merge_rel=rel)
        decoder = build_decoder(pcfg)
        t0 = time.perf_counter()
        dets = []
        for bi, (conf, paf) in enumerate(rendered):
            humans = decoder(jax.numpy.asarray(conf),
                             jax.numpy.asarray(paf))
            jax.block_until_ready(humans)
            for j in range(min(bs, len(samples) - bi * bs)):
                s = samples[bi * bs + j]
                scale, pad = metas[bi * bs + j]
                dets.extend(humans_to_detections(
                    humans, j, s.image_id, scale, pad, hin, win))
        r = evaluate_detections_full(dets, gt_by_image)
        print(f"  rel={rel:g}: AP {r.ap:.4f} AP50 {r.ap50:.4f} "
              f"AR {r.ar:.4f} ({time.perf_counter() - t0:.0f}s)",
              flush=True)


if __name__ == "__main__":
    main()
