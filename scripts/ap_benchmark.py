"""Standing synthetic AP benchmark — the quality axis of BASELINE.md.

Trains each zoo model on the seeded TRAIN scene bank and evaluates
keypoint AP on the HELD-OUT val bank (openpose_plus/data/synthetic.py
— crowds, overlap, 3x scale variation, truncation, clutter) under
cumulative inference settings, so the AP-improving machinery carries
MEASURED deltas instead of docstring claims:

  base        default PostprocConfig (upsample 2, subpixel refinement)
  fidelity    PostprocConfig.fidelity() (8x maps, 32-peak cap)
  +tta        fidelity + horizontal-flip TTA
  +multiscale fidelity + flip TTA + scale search (0.5, 1.0, 1.5)

Two geometry tiers (--geometry):

  small    256px scenes -> 128x128 input (16x16 maps). Cheap enough to
           train the whole zoo; the r3 table's regime.
  serving  736px scenes -> 368x432 input (46x54 maps) — the SAME engine
           geometry the FPS tables quote, so quality and perf are
           measured in one regime (r3 verdict item #1). Results keyed
           "<model>@368" in ap_benchmark.json.

Extra studies:
  --ms-study    also evaluate upper-only scale sets (1.0,1.5) and
                (1.0,1.5,2.0) — the r3 multiscale negative traced to the
                0.5x scale destroying small figures; these test that
                diagnosis' direct prediction.
  --large-bank  evaluate the small-tier weights on the val_large bank
                (few frame-filling figures) under +tta and both scale
                sets: the regime where down-scale TTA should win.
                Results keyed "<model>+large".
  --curve S1,S2,..  ONE continuous training run to max(S) with a
                stretched lr schedule, weight snapshots at each S,
                +tta AP per snapshot — the AP-vs-steps convergence
                curve ("floors, not ceilings" -> a measurement).
                Results keyed "<model>#curve".

Results accumulate in ap_benchmark.json (repo root); existing
(model, variant) entries are skipped unless --force, so tables fill
incrementally and any cell can be re-measured alone.

    python scripts/ap_benchmark.py --model vggtiny                # one row
    python scripts/ap_benchmark.py --all                          # all four
    python scripts/ap_benchmark.py --model mobilenet_thin --geometry serving
    python scripts/ap_benchmark.py --model vggtiny --curve 4000,16000,32000,64000
    python scripts/ap_benchmark.py --table                        # markdown

The val splits are NEVER trained on (disjoint generator seeds).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESULTS_PATH = os.path.join(HERE, "ap_benchmark.json")
BANK_DIR = os.path.join(HERE, ".ap_bench")

MODELS = ("mobilenet_thin", "vggtiny", "hao28", "vgg19")
VARIANTS = ("base", "fidelity", "fidelity_tta", "fidelity_tta_ms")
MS_STUDY_VARIANTS = ("fidelity_tta_ms15", "fidelity_tta_msup",
                     "fidelity_tta_msdd")
# fragment-merge repair pass (PostprocConfig.fragment_merge_rel=0.5, the
# train-bank-oracle-tuned setting) — opt-in via --frag-merge. The msdd_fm
# variant stacks the two r5 decoder fixes (per-scale decode + fixed
# OKS-dedup merge, fragment-merge inside each scale's decode) to measure
# whether their gains are additive.
FM_VARIANTS = ("fidelity_fm", "fidelity_tta_fm", "fidelity_tta_msdd_fm")
# val_large is the TRUNCATION regime (frame-filling, often-truncated
# figures) — the fragment-merge pass's target case, so its variants ride
# along here.
LARGE_VARIANTS = ("fidelity", "fidelity_tta", "fidelity_tta_ms",
                  "fidelity_tta_msup", "fidelity_tta_msdd",
                  "fidelity_fm", "fidelity_tta_fm")

# Per-variant scale sets for the multi-scale search study. The shipped
# default (0.5, 1.0, 1.5) measured NEGATIVE on the small-figure bank in
# r3; ms15/msup are the upper-only sets its diagnosis predicts should
# win there, and (0.5, 1.0, 1.5) is re-tested on val_large where the
# 0.5x scale has a job to do.
MS_SCALES = {
    "fidelity_tta_ms": (0.5, 1.0, 1.5),
    "fidelity_tta_ms15": (1.0, 1.5),
    "fidelity_tta_msup": (1.0, 1.5, 2.0),
    # same scale set as the shipped default, but per-scale decode +
    # OKS-dedup merge instead of map averaging (Engine combine="dedup"):
    # separates "the 0.5x scale hurts" from "the combiner hurts".
    "fidelity_tta_msdd": (0.5, 1.0, 1.5),
    "fidelity_tta_msdd_fm": (0.5, 1.0, 1.5),
}

# Geometry tiers. sigma/limb are GT label widths in input pixels: 5 px on
# a 128px input ~= the figure-relative width of the reference's 8 px at
# 368 (config.py DataConfig defaults).
GEOMETRIES = {
    "small": dict(size=256, hin=128, win=128, sigma=5.0, limb=5.0,
                  n_train=256, n_val=96, tag="", key_suffix=""),
    "serving": dict(size=736, hin=368, win=432, sigma=8.0, limb=8.0,
                    n_train=256, n_val=96, tag="_h368", key_suffix="@368"),
}


def _load_results() -> dict:
    if os.path.exists(RESULTS_PATH):
        with open(RESULTS_PATH) as f:
            return json.load(f)
    return {}


def _save_results(res: dict) -> None:
    with open(RESULTS_PATH, "w") as f:
        json.dump(res, f, indent=2, sort_keys=True)
        f.write("\n")


def build_config(model: str, ann: str, imgs: str, steps: int, lr: float,
                 geo: dict, lr_scaling: str = "none"):
    from openpose_plus.config import default_config

    cfg = default_config(model)
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, hin=geo["hin"], win=geo["win"]),
        data=dataclasses.replace(
            cfg.data, train_annotations=ann, train_images=imgs,
            num_workers=4, prefetch=4,
            # moderate augmentation: the bank already varies scale/rotation
            rotate_max_deg=15.0, scale_min=0.8, scale_max=1.15,
            shift_frac=0.1, sigma=geo["sigma"], limb_width=geo["limb"]),
        train=dataclasses.replace(
            cfg.train, batch_size=8, lr_init=lr, lr_scaling=lr_scaling,
            lr_decay_every=max(steps // 2, 1), lr_decay_factor=0.33,
            weight_decay=0.0, log_every=100, checkpoint_every=10 ** 9,
            checkpoint_dir=os.path.join(BANK_DIR, f"ck_{model}")),
    )
    return cfg


def train_model(model: str, steps: int, lr: float, ann: str, imgs: str,
                geo: dict, snapshots: tuple[int, ...] = (),
                lr_scaling: str = "none"):
    """Train on the train bank; returns (cfg, params). Caches params as
    .ap_bench/<model>_s<steps>_lr<lr><tag>.npz so eval variants never
    retrain; `snapshots` additionally saves mid-run weights at those step
    counts (for the convergence curve) under the same schedule tag."""
    import jax

    from openpose_plus import checkpoint as ckpt
    from openpose_plus import train as T
    from openpose_plus.data.coco import CocoPoseDataset
    from openpose_plus.data.pipeline import TrainPipeline

    # lr and geometry are part of the cache key: rerunning with a
    # different --lr/--geometry must retrain, not silently reuse weights.
    def snap_path(s: int) -> str:
        t = geo["tag"] + (f"_cv{steps}" if snapshots else "")
        if lr_scaling != "none":
            t += "_lrs"
        return os.path.join(BANK_DIR, f"{model}_s{s}_lr{lr:g}{t}.npz")

    cfg = build_config(model, ann, imgs, steps, lr, geo, lr_scaling)
    want = sorted(set(snapshots) | {steps})
    state = T.create_train_state(cfg, jax.random.PRNGKey(0))
    if all(os.path.exists(snap_path(s)) for s in want):
        print(f"[{model}] reusing trained weights {snap_path(steps)}",
              flush=True)
        return cfg, ckpt.load_npz(snap_path(steps), state.params)

    dataset = CocoPoseDataset(ann, imgs)
    pipeline = TrainPipeline(dataset, cfg, seed=0, cache_decoded=True)
    step_fn = T.make_train_step_on_batch(cfg)
    it = iter(pipeline)
    t0 = time.perf_counter()
    loss_first = loss_last = None
    for i in range(steps):
        state, metrics = step_fn(state, next(it))
        if i == 0 or i % 100 == 99:
            loss_last = float(metrics["loss"])
            if loss_first is None:
                loss_first = loss_last
            print(f"[{model}] step {i + 1}/{steps}: loss {loss_last:.2f} "
                  f"({time.perf_counter() - t0:.0f}s)", flush=True)
        if (i + 1) in want:
            ckpt.save_npz(snap_path(i + 1), state.params)
    pipeline.stop()
    print(f"[{model}] trained {steps} steps in "
          f"{time.perf_counter() - t0:.0f}s, loss {loss_first:.1f} -> "
          f"{loss_last:.1f}; saved {snap_path(steps)}", flush=True)
    return cfg, state.params


def eval_variant(cfg, params, variant: str, dataset) -> dict:
    from openpose_plus.engine import Engine
    from openpose_plus.eval_coco import evaluate_engine

    ecfg = cfg
    if variant != "base":
        ecfg = cfg.replace(postproc=cfg.postproc.fidelity())
    if variant.endswith("_fm"):
        ecfg = ecfg.replace(postproc=dataclasses.replace(
            ecfg.postproc, fragment_merge_rel=0.5))
    eng = Engine(ecfg, params=params)
    kwargs = {}
    if variant.startswith("fidelity_tta"):
        kwargs["flip_tta"] = True
    if variant in MS_SCALES:
        kwargs["scales"] = MS_SCALES[variant]
        if "msdd" in variant:
            kwargs["ms_combine"] = "dedup"
    t0 = time.perf_counter()
    r = evaluate_engine(eng, dataset, batch_size=8, **kwargs)
    out = {"ap": round(r.ap, 4), "ap50": round(r.ap50, 4),
           "ap75": round(r.ap75, 4), "ar": round(r.ar, 4),
           "eval_seconds": round(time.perf_counter() - t0, 1)}
    if variant in MS_SCALES:
        out["scales"] = list(MS_SCALES[variant])
    return out


def _stamp(out: dict, steps: int, lr: float, geo: dict) -> dict:
    out.update({"steps": steps, "lr": lr, "n_val": geo["n_val"],
                "hin": geo["hin"], "bank_size": geo["size"]})
    return out


def run_model(model: str, steps: int, lr: float, force: bool,
              geometry: str = "small",
              ms_study: bool = False, lr_scaling: str = "none",
              frag_merge: bool = False) -> None:
    from openpose_plus.data.coco import CocoPoseDataset
    from openpose_plus.data.synthetic import make_scene_bank

    geo = GEOMETRIES[geometry]
    train_ann, train_imgs = make_scene_bank(
        BANK_DIR, "train", geo["n_train"], geo["size"])
    val_ann, val_imgs = make_scene_bank(
        BANK_DIR, "val", geo["n_val"], geo["size"])

    key = model + geo["key_suffix"]
    if lr_scaling != "none":
        # the lr-rule proof runs live beside the hand-tuned rows
        key += "#lrrule"
    res = _load_results()
    row = res.get(key, {})
    ms_variants = MS_STUDY_VARIANTS
    if geometry == "serving":
        # msup's 2.0x scale at serving geometry means a 736x864 engine
        # per model — a long cold compile for a variant whose question (does upscaling buy resolution?)
        # the serving tier already answers by construction; ms15 covers
        # the upper-only hypothesis here. Studied at the small tier and
        # on val_large, where the engines are cheap.
        ms_variants = tuple(v for v in ms_variants
                            if v != "fidelity_tta_msup")
    pool = (VARIANTS + (ms_variants if ms_study else ())
            + (FM_VARIANTS if frag_merge else ()))
    # Single-engine variants first, multi-scale (ms*) last: ms variants
    # cold-compile one extra engine per scale, so an interrupted run
    # still lands every cheap cell before paying those compiles.
    variants = (tuple(v for v in pool if "ms" not in v)
                + tuple(v for v in pool if "ms" in v))
    missing = [v for v in variants
               if force or v not in row or row[v].get("steps") != steps
               or row[v].get("lr", lr) != lr]
    if not missing:
        print(f"[{key}] all variants recorded (use --force to redo)")
        return

    cfg, params = train_model(model, steps, lr, train_ann, train_imgs, geo,
                              lr_scaling=lr_scaling)
    val_set = CocoPoseDataset(val_ann, val_imgs)
    for variant in missing:
        out = _stamp(eval_variant(cfg, params, variant, val_set),
                     steps, lr, geo)
        row[variant] = out
        res = _load_results()
        res[key] = {**res.get(key, {}), **row}
        _save_results(res)  # incremental: survive interruption
        print(f"[{key}] {variant}: AP {out['ap']:.4f} "
              f"AP50 {out['ap50']:.4f} AR {out['ar']:.4f} "
              f"({out['eval_seconds']}s)", flush=True)


def run_oracle(force: bool, geometry: str = "small", out_stride: int = 8,
               label_sigma: float | None = None) -> None:
    """Quality-axis CEILING: decode GROUND-TRUTH conf/paf maps (rendered
    by data/targets.py at the tier's label geometry, exactly what training
    regresses toward) through the SAME decoder configs the model rows use.

    The oracle AP splits the gap to 1.0 into parts (r4 verdict item #2):

      perfect   GT keypoints straight into the evaluator — protocol
                sanity, must be ~1.0
      base      GT maps -> default decoder
      fidelity  GT maps -> fidelity decoder (the model rows' regime)

    oracle-fidelity is the ceiling any model can reach at this tier: the
    model rows' remaining gap BELOW it is model-limited; the ceiling's own
    gap to 1.0 is decoder+label-geometry-limited. Results keyed
    "oracle<tier>" in ap_benchmark.json; no training involved.

    Attribution probes (each a cheap oracle re-run, keyed with a suffix):
      out_stride=4    render GT maps at stride 4 (4x the map pixels; the
                      fidelity decoder upsample matches the stride) — how
                      much of the ceiling is MAP RESOLUTION ("#s4")
      label_sigma=X   override the tier's GT Gaussian sigma — how much is
                      the LABEL WIDTH (adjacent peaks max-merging)
                      ("#sig<X>")
    """
    import jax
    import numpy as np

    from openpose_plus.config import PostprocConfig
    from openpose_plus.data.coco import CocoPoseDataset
    from openpose_plus.data.synthetic import make_scene_bank
    from openpose_plus.data.targets import make_targets
    from openpose_plus.eval_coco import (Detection,
                                             evaluate_detections_full,
                                             humans_to_detections)
    from openpose_plus.postproc import build_decoder

    geo = GEOMETRIES[geometry]
    val_ann, val_imgs = make_scene_bank(
        BANK_DIR, "val", geo["n_val"], geo["size"])
    val_set = CocoPoseDataset(val_ann, val_imgs)

    sigma = geo["sigma"] if label_sigma is None else label_sigma
    key = "oracle" + geo["key_suffix"]
    if out_stride != 8:
        key += f"#s{out_stride}"
    if label_sigma is not None:
        key += f"#sig{label_sigma:g}"
    res = _load_results()
    row = res.get(key, {})
    variants = [v for v in ("perfect", "base", "fidelity", "fidelity_fm")
                if force or v not in row]
    if not variants:
        print(f"[{key}] all oracle variants recorded (use --force)")
        return

    hin, win, stride = geo["hin"], geo["win"], out_stride
    hout, wout = hin // stride, win // stride
    samples = [val_set[i] for i in range(len(val_set))]
    maxp = max(s.keypoints.shape[0] for s in samples)
    gt_by_image = {s.image_id: (s.keypoints_coco, s.areas, s.ignore_boxes)
                   for s in samples}

    # letterbox transforms (no pixel decode needed — dims are in the anno)
    metas = []
    for s in samples:
        scale = min(win / s.width, hin / s.height)
        pad = (win / 2 - scale * s.width / 2, hin / 2 - scale * s.height / 2)
        metas.append((s.image_id, scale, pad))

    def input_space_kp(s, scale, pad):
        kp = np.zeros((maxp, 18, 3), np.float32)
        k = s.keypoints
        kp[: k.shape[0], :, 0] = k[:, :, 0] * scale + pad[0]
        kp[: k.shape[0], :, 1] = k[:, :, 1] * scale + pad[1]
        kp[: k.shape[0], :, 2] = k[:, :, 2]
        return kp

    render = jax.jit(jax.vmap(lambda kp: make_targets(
        kp, hout, wout, stride, sigma, geo["limb"])))

    for variant in variants:
        t0 = time.perf_counter()
        if variant == "perfect":
            dets = []
            for s in samples:
                for g in s.keypoints_coco:
                    kp = np.asarray(g, np.float32).copy()
                    kp[:, 2] = np.where(kp[:, 2] > 0, 1.0, 0.0)
                    dets.append(Detection(image_id=s.image_id,
                                          keypoints=kp, score=1.0))
        else:
            pcfg = PostprocConfig()
            if variant != "base":
                pcfg = pcfg.fidelity(upsample=stride)
            if variant == "fidelity_fm":
                import dataclasses as _dc
                pcfg = _dc.replace(pcfg, fragment_merge_rel=0.5)
            decoder = build_decoder(pcfg)
            dets = []
            bs = 8
            for i in range(0, len(samples), bs):
                chunk = samples[i:i + bs]
                kps = np.stack([
                    input_space_kp(s, metas[i + j][1], metas[i + j][2])
                    for j, s in enumerate(chunk)]
                    + [np.zeros((maxp, 18, 3), np.float32)] * (bs - len(chunk)))
                conf, paf = render(jax.numpy.asarray(kps))
                humans = decoder(conf, paf)
                jax.block_until_ready(humans)
                for j in range(len(chunk)):
                    img_id, scale, pad = metas[i + j]
                    dets.extend(humans_to_detections(
                        humans, j, img_id, scale, pad, hin, win))
        r = evaluate_detections_full(dets, gt_by_image)
        out = {"ap": round(r.ap, 4), "ap50": round(r.ap50, 4),
               "ap75": round(r.ap75, 4), "ar": round(r.ar, 4),
               "n_val": geo["n_val"], "hin": hin, "stride": stride,
               "bank_size": geo["size"], "sigma": sigma,
               "eval_seconds": round(time.perf_counter() - t0, 1)}
        row[variant] = out
        res = _load_results()
        res[key] = {**res.get(key, {}), **row}
        _save_results(res)
        print(f"[{key}] {variant}: AP {out['ap']:.4f} "
              f"AP50 {out['ap50']:.4f} AP75 {out['ap75']:.4f} "
              f"AR {out['ar']:.4f} ({out['eval_seconds']}s)", flush=True)


def run_large(model: str, steps: int, lr: float, force: bool) -> None:
    """Evaluate small-tier weights on the val_large bank (few frame-
    filling figures): the regime slice of the multi-scale TTA study."""
    from openpose_plus.data.coco import CocoPoseDataset
    from openpose_plus.data.synthetic import make_scene_bank

    geo = GEOMETRIES["small"]
    train_ann, train_imgs = make_scene_bank(
        BANK_DIR, "train", geo["n_train"], geo["size"])
    large_ann, large_imgs = make_scene_bank(
        BANK_DIR, "val_large", geo["n_val"], geo["size"])

    key = model + "+large"
    res = _load_results()
    row = res.get(key, {})
    missing = [v for v in LARGE_VARIANTS
               if force or v not in row or row[v].get("steps") != steps
               or row[v].get("lr", lr) != lr]
    if not missing:
        print(f"[{key}] all variants recorded (use --force to redo)")
        return

    cfg, params = train_model(model, steps, lr, train_ann, train_imgs, geo)
    val_set = CocoPoseDataset(large_ann, large_imgs)
    for variant in missing:
        out = _stamp(eval_variant(cfg, params, variant, val_set),
                     steps, lr, geo)
        out["bank"] = "val_large"
        row[variant] = out
        res = _load_results()
        res[key] = {**res.get(key, {}), **row}
        _save_results(res)
        print(f"[{key}] {variant}: AP {out['ap']:.4f} "
              f"AP50 {out['ap50']:.4f} AR {out['ar']:.4f} "
              f"({out['eval_seconds']}s)", flush=True)


def run_curve(model: str, steps_list: tuple[int, ...], lr: float,
              force: bool, geometry: str = "small") -> None:
    """One continuous run to max(steps_list) with a stretched lr schedule;
    +tta AP at each snapshot -> the AP-vs-steps convergence curve."""
    from openpose_plus import checkpoint as ckpt
    from openpose_plus.data.coco import CocoPoseDataset
    from openpose_plus.data.synthetic import make_scene_bank

    geo = GEOMETRIES[geometry]
    train_ann, train_imgs = make_scene_bank(
        BANK_DIR, "train", geo["n_train"], geo["size"])
    val_ann, val_imgs = make_scene_bank(
        BANK_DIR, "val", geo["n_val"], geo["size"])

    total = max(steps_list)
    key = model + geo["key_suffix"] + "#curve"
    res = _load_results()
    row = res.get(key, {})
    missing = [s for s in sorted(steps_list)
               if force or str(s) not in row
               or row[str(s)].get("schedule_steps") != total]
    if not missing:
        print(f"[{key}] curve recorded (use --force to redo)")
        return

    cfg, params = train_model(model, total, lr, train_ann, train_imgs, geo,
                              snapshots=tuple(steps_list))
    val_set = CocoPoseDataset(val_ann, val_imgs)
    for s in missing:
        tag = geo["tag"] + f"_cv{total}"
        npz = os.path.join(BANK_DIR, f"{model}_s{s}_lr{lr:g}{tag}.npz")
        p = params if s == total else ckpt.load_npz(npz, params)
        out = _stamp(eval_variant(cfg, p, "fidelity_tta", val_set),
                     s, lr, geo)
        out["schedule_steps"] = total
        row[str(s)] = out
        res = _load_results()
        res[key] = {**res.get(key, {}), **row}
        _save_results(res)
        print(f"[{key}] {s} steps: AP {out['ap']:.4f} "
              f"AP50 {out['ap50']:.4f} ({out['eval_seconds']}s)", flush=True)


def print_table() -> None:
    res = _load_results()
    for suffix, title in (("", "small tier (128x128 input)"),
                          ("@368", "serving tier (368x432 input)"),
                          ("+large", "val_large bank (small tier weights)")):
        keys = [m for m in MODELS if (m + suffix) in res]
        if not keys:
            continue
        cols = VARIANTS + MS_STUDY_VARIANTS + FM_VARIANTS
        present = [c for c in cols
                   if any(c in res[m + suffix] for m in keys)]
        print(f"\n### {title}\n")
        print("| model | " + " | ".join(present) + " |")
        print("|---|" + "---|" * len(present))
        for m in keys:
            row = res[m + suffix]
            cells = [f"{row[c]['ap']:.3f}" if c in row else "—"
                     for c in present]
            print(f"| {m} | " + " | ".join(cells) + " |")
    oracles = {k: v for k, v in res.items() if k.startswith("oracle")}
    if oracles:
        cols = ("perfect", "base", "fidelity", "fidelity_fm")
        print("\n### oracle ceilings (GT maps through the decoder)\n")
        print("| key | " + " | ".join(cols) + " |")
        print("|---|" + "---|" * len(cols))
        for k in sorted(oracles):
            cells = [f"{oracles[k][c]['ap']:.3f}" if c in oracles[k] else "—"
                     for c in cols]
            print(f"| {k} | " + " | ".join(cells) + " |")
    rules = {k: v for k, v in res.items() if k.endswith("#lrrule")}
    if rules:
        print("\n### lr-rule validation (lr_scaling=inv-sqrt-area, "
              "zoo-default lr_init)\n")
        rcols = VARIANTS + FM_VARIANTS
        print("| key | " + " | ".join(rcols) + " |")
        print("|---|" + "---|" * len(rcols))
        for k in sorted(rules):
            cells = [f"{rules[k][c]['ap']:.3f}" if c in rules[k] else "—"
                     for c in rcols]
            print(f"| {k} | " + " | ".join(cells) + " |")
    curves = {k: v for k, v in res.items() if k.endswith("#curve")}
    for k, row in sorted(curves.items()):
        steps = sorted(int(s) for s in row)
        print(f"\n### {k}\n")
        print("| steps | " + " | ".join(str(s) for s in steps) + " |")
        print("|---|" + "---|" * len(steps))
        print("| AP (+tta) | "
              + " | ".join(f"{row[str(s)]['ap']:.3f}" for s in steps) + " |")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", choices=MODELS)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--table", action="store_true")
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--geometry", choices=tuple(GEOMETRIES), default="small")
    ap.add_argument("--lr-scaling", choices=("none", "inv-sqrt-area"),
                    default="none",
                    help="train with the geometry-transfer lr rule; results "
                         "record under <model><tier>#lrrule")
    ap.add_argument("--frag-merge", action="store_true",
                    help="also evaluate the fragment-merge repair pass "
                         "(fidelity_fm / fidelity_tta_fm variants)")
    ap.add_argument("--ms-study", action="store_true",
                    help="also evaluate upper-only multiscale sets "
                         "(1.0,1.5) and (1.0,1.5,2.0)")
    ap.add_argument("--large-bank", action="store_true",
                    help="evaluate on the val_large (frame-filling figures) "
                         "bank instead of the standard tier")
    ap.add_argument("--oracle", action="store_true",
                    help="decode GT maps through the decoder configs: the "
                         "quality-axis ceiling rows (no training)")
    ap.add_argument("--out-stride", type=int, default=8,
                    help="oracle probe: render GT maps at this stride")
    ap.add_argument("--label-sigma", type=float, default=None,
                    help="oracle probe: override the GT Gaussian sigma")
    ap.add_argument("--curve", type=str, default=None,
                    help="comma-separated step counts, e.g. "
                         "4000,16000,32000,64000: one continuous run, "
                         "AP at each snapshot")
    args = ap.parse_args()

    if args.table:
        print_table()
        return

    import jax

    from openpose_plus.utils.compile_cache import configure_compile_cache

    configure_compile_cache()
    os.makedirs(BANK_DIR, exist_ok=True)

    if args.oracle:
        run_oracle(args.force, args.geometry, out_stride=args.out_stride,
                   label_sigma=args.label_sigma)
        print_table()
        return

    models = MODELS if args.all else ((args.model,) if args.model else ())
    if not models:
        raise SystemExit("pass --model NAME, --all, or --table")
    for m in models:
        if args.curve:
            steps_list = tuple(int(s) for s in args.curve.split(","))
            run_curve(m, steps_list, args.lr, args.force, args.geometry)
        elif args.large_bank:
            run_large(m, args.steps, args.lr, args.force)
        else:
            run_model(m, args.steps, args.lr, args.force,
                      geometry=args.geometry, ms_study=args.ms_study,
                      lr_scaling=args.lr_scaling,
                      frag_merge=args.frag_merge)
    print_table()


if __name__ == "__main__":
    main()
