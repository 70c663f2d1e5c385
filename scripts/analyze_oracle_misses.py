"""Per-miss anatomy of the oracle-AP ceiling (BASELINE.md r5).

Decodes GROUND-TRUTH conf/paf maps for a tier's val bank through the
fidelity decoder (exactly like `ap_benchmark.py --oracle`), then audits
every GT person the decoder FAILED to match (best OKS < 0.5):

  * what fraction of the person's labeled keypoints were recovered by
    SOME detection (per-keypoint OKS term > 0.5 — i.e. localized, just
    not assembled into one skeleton),
  * across how many distinct detections those recovered keypoints are
    scattered (>= 2 -> the person was FRAGMENTED, not undetected),
  * whether the person's labeled parts form a DISCONNECTED subgraph of
    the limb tree (skeleton.COCO_PAIRS) — the structural condition under
    which NO bottom-up PAF decoder can assemble them into one skeleton
    (no limb candidate spans the components; SURVEY.md §2:106's
    algorithm family).

This turns the "ceiling is fragmentation, not resolution" attribution
into a reproducible measurement instead of prose. Run AFTER the banks
exist (any ap_benchmark invocation creates them):

    python scripts/analyze_oracle_misses.py --geometry serving
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import ap_benchmark as apb  # noqa: E402  (scripts/ sibling module)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--geometry", choices=tuple(apb.GEOMETRIES),
                    default="serving")
    ap.add_argument("--oks-miss", type=float, default=0.5,
                    help="a GT person is a miss when its best det OKS "
                         "is below this")
    ap.add_argument("--frag-merge", action="store_true",
                    help="analyze with the fragment-merge repair pass ON "
                         "(PostprocConfig.fragment_merge_rel=0.5)")
    ap.add_argument("--cpu", action="store_true",
                    help="decode on CPU (leave the accelerator to other jobs; "
                         "the decoder is platform-agnostic and the analysis "
                         "is offline)")
    args = ap.parse_args()

    import dataclasses

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from openpose_plus import skeleton
    from openpose_plus.config import PostprocConfig
    from openpose_plus.data.coco import CocoPoseDataset
    from openpose_plus.data.synthetic import make_scene_bank
    from openpose_plus.data.targets import make_targets
    from openpose_plus.eval_coco import compute_oks, humans_to_detections
    from openpose_plus.postproc import build_decoder

    from openpose_plus.utils.compile_cache import configure_compile_cache

    configure_compile_cache()

    geo = apb.GEOMETRIES[args.geometry]
    val_ann, val_imgs = make_scene_bank(
        apb.BANK_DIR, "val", geo["n_val"], geo["size"])
    val_set = CocoPoseDataset(val_ann, val_imgs)
    samples = [val_set[i] for i in range(len(val_set))]
    maxp = max(s.keypoints.shape[0] for s in samples)

    hin, win, stride = geo["hin"], geo["win"], 8
    hout, wout = hin // stride, win // stride
    pcfg = PostprocConfig().fidelity(upsample=stride)
    if args.frag_merge:
        pcfg = dataclasses.replace(pcfg, fragment_merge_rel=0.5)
    decoder = build_decoder(pcfg)
    render = jax.jit(jax.vmap(lambda kp: make_targets(
        kp, hout, wout, stride, geo["sigma"], geo["limb"])))

    metas = []
    for s in samples:
        scale = min(win / s.width, hin / s.height)
        pad = (win / 2 - scale * s.width / 2, hin / 2 - scale * s.height / 2)
        metas.append((scale, pad))

    def input_space_kp(s, scale, pad):
        kp = np.zeros((maxp, 18, 3), np.float32)
        k = s.keypoints
        kp[: k.shape[0], :, 0] = k[:, :, 0] * scale + pad[0]
        kp[: k.shape[0], :, 1] = k[:, :, 1] * scale + pad[1]
        kp[: k.shape[0], :, 2] = k[:, :, 2]
        return kp

    # decode GT maps -> per-image detection lists (original pixel space)
    dets_by_image: dict[int, list] = {s.image_id: [] for s in samples}
    bs = 8
    for i in range(0, len(samples), bs):
        chunk = samples[i:i + bs]
        kps = np.stack(
            [input_space_kp(s, *metas[i + j]) for j, s in enumerate(chunk)]
            + [np.zeros((maxp, 18, 3), np.float32)] * (bs - len(chunk)))
        conf, paf = render(jax.numpy.asarray(kps))
        humans = decoder(conf, paf)
        jax.block_until_ready(humans)
        for j, s in enumerate(chunk):
            scale, pad = metas[i + j]
            dets_by_image[s.image_id].extend(humans_to_detections(
                humans, j, s.image_id, scale, pad, hin, win))

    sig = skeleton.COCO_OKS_SIGMAS
    n_gt = n_miss = 0
    recov_fracs, frag_counts, disconnected, comp_counts = [], [], 0, []
    for s in samples:
        dets = dets_by_image[s.image_id]
        for g, area, kp18 in zip(s.keypoints_coco, s.areas, s.keypoints):
            g = np.asarray(g, np.float32)
            labeled = g[:, 2] > 0
            if not labeled.any():
                continue
            n_gt += 1
            best = max((compute_oks(d.keypoints, g, area) for d in dets),
                       default=0.0)
            if best >= args.oks_miss:
                continue
            n_miss += 1

            # per-keypoint recovery across ALL detections
            s2 = max(float(area), 1.0)
            rec_by_det = []
            for d in dets:
                d2 = ((d.keypoints[:, 0] - g[:, 0]) ** 2
                      + (d.keypoints[:, 1] - g[:, 1]) ** 2)
                term = np.exp(-d2 / (2.0 * s2 * (2.0 * sig) ** 2))
                rec_by_det.append(labeled & (d.keypoints[:, 2] > 0)
                                  & (term > 0.5))
            rec_any = (np.any(rec_by_det, axis=0) if rec_by_det
                       else np.zeros(17, bool))
            recov_fracs.append(rec_any.sum() / labeled.sum())
            frag_counts.append(sum(1 for r in rec_by_det if r.any()))

            # limb-tree connectivity of the GT's labeled 18-part set
            vis = kp18[:, 2] > 0
            parent = list(range(18))

            def find(a):
                while parent[a] != a:
                    parent[a] = parent[parent[a]]
                    a = parent[a]
                return a

            for a, b in skeleton.COCO_PAIRS:
                if vis[a] and vis[b]:
                    parent[find(a)] = find(b)
            comps = len({find(p) for p in range(18) if vis[p]})
            comp_counts.append(comps)
            if comps > 1:
                disconnected += 1

    fm = " (fragment-merge ON)" if args.frag_merge else ""
    print(f"tier={args.geometry}{fm}: {n_gt} GT people, "
          f"{n_miss} missed at OKS<{args.oks_miss}")
    if n_miss:
        fc = np.asarray(frag_counts)
        print(f"  mean keypoint recovery among misses: "
              f"{100 * float(np.mean(recov_fracs)):.0f}%")
        print(f"  scattered across >=2 detections: {(fc >= 2).sum()} "
              f"of {n_miss} (mean fragments {fc.mean():.2f})")
        print(f"  GT labeled-part set DISCONNECTED in the limb tree: "
              f"{disconnected} of {n_miss} "
              f"(mean components {np.mean(comp_counts):.2f})")


if __name__ == "__main__":
    main()
