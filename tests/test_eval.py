"""OKS/AP evaluator tests: perfect, perturbed, and false-positive regimes."""

import numpy as np
import pytest

from openpose_plus import eval_coco as E


def _gt_person(rng, cx, cy, spread=40.0):
    kp = np.zeros((17, 3), np.float32)
    kp[:, 0] = cx + rng.uniform(-spread, spread, 17)
    kp[:, 1] = cy + rng.uniform(-spread, spread, 17)
    kp[:, 2] = 2
    return kp


def _make_scene(rng, n_images=4, people_per=3):
    gt = {}
    dets = []
    for img in range(n_images):
        ppl = [_gt_person(rng, 100 + 150 * p, 120) for p in range(people_per)]
        areas = np.full(people_per, 10000.0, np.float32)
        gt[img] = (np.stack(ppl), areas)
        for p, kp in enumerate(ppl):
            d = kp.copy()
            d[:, 2] = 0.9
            dets.append(E.Detection(image_id=img, keypoints=d,
                                    score=1.0 - 0.01 * p))
    return gt, dets


def test_perfect_detections_ap1(rng):
    gt, dets = _make_scene(rng)
    r = E.evaluate_detections(dets, gt)
    assert r.ap == pytest.approx(1.0, abs=1e-6)
    assert r.ap50 == pytest.approx(1.0, abs=1e-6)
    assert r.ar == pytest.approx(1.0, abs=1e-6)


def test_missing_people_reduce_recall(rng):
    gt, dets = _make_scene(rng, n_images=2, people_per=4)
    half = [d for i, d in enumerate(dets) if i % 2 == 0]
    r = E.evaluate_detections(half, gt)
    assert 0.4 < r.ap < 0.6
    assert r.ar == pytest.approx(0.5, abs=1e-6)


def test_false_positives_reduce_ap(rng):
    gt, dets = _make_scene(rng)
    # add confident junk detections far from anyone
    junk = []
    for img in gt:
        kp = np.full((17, 3), 5000.0, np.float32)
        kp[:, 2] = 0.95
        junk.append(E.Detection(image_id=img, keypoints=kp, score=2.0))
    r_clean = E.evaluate_detections(dets, gt)
    r_junk = E.evaluate_detections(dets + junk, gt)
    assert r_junk.ap < r_clean.ap


def test_perturbation_degrades_smoothly(rng):
    gt, dets = _make_scene(rng)
    last = 1.1
    for noise in (2.0, 12.0, 40.0):
        nd = []
        for d in dets:
            kp = d.keypoints.copy()
            kp[:, :2] += rng.normal(0, noise, (17, 2))
            nd.append(E.Detection(d.image_id, kp, d.score))
        r = E.evaluate_detections(nd, gt)
        assert r.ap < last + 1e-9
        last = r.ap
    assert last < 0.2  # 40px noise on ~100px people destroys AP


def test_oks_identity_and_scale(rng):
    kp = _gt_person(rng, 100, 100)
    assert E.compute_oks(kp, kp, 5000.0) == pytest.approx(1.0)
    shifted = kp.copy()
    shifted[:, 0] += 30
    small = E.compute_oks(shifted, kp, 1000.0)
    large = E.compute_oks(shifted, kp, 100000.0)
    assert small < large  # same pixel error hurts small people more


def test_detection_packing_roundtrip(rng):
    gt, dets = _make_scene(rng, n_images=2)
    packed = E._pack_detections(dets)
    out = E._unpack_detections(packed)
    assert len(out) == len(dets)
    np.testing.assert_allclose(out[0].keypoints, dets[0].keypoints, rtol=1e-6)
    gt2 = E._unpack_gt(E._pack_gt(gt))
    assert set(gt2) == set(gt)
    np.testing.assert_allclose(gt2[0][0], gt[0][0], rtol=1e-6)


def test_area_range_aps(rng):
    """Small people only hurt AP_M; detections matching ignored GTs are
    dropped rather than counted as false positives."""
    gt = {}
    dets = []
    # image 0: one medium person (area ~50^2), one large (area ~150^2)
    med = _gt_person(rng, 100, 100, spread=25.0)
    large = _gt_person(rng, 400, 400, spread=75.0)
    gt[0] = (np.stack([med, large]),
             np.asarray([2500.0, 22500.0], np.float32))
    for kp, sc in [(med, 0.9), (large, 0.8)]:
        d = kp.copy(); d[:, 2] = 0.9
        dets.append(E.Detection(image_id=0, keypoints=d, score=sc))
    full = E.evaluate_detections_full(dets, gt)
    assert full.ap == pytest.approx(1.0, abs=1e-6)
    assert full.ap_medium == pytest.approx(1.0, abs=1e-6)
    assert full.ap_large == pytest.approx(1.0, abs=1e-6)
    # drop the medium detection: AP_M collapses, AP_L unaffected
    partial = E.evaluate_detections_full(dets[1:], gt)
    assert partial.ap_medium == pytest.approx(0.0, abs=1e-6)
    assert partial.ap_large == pytest.approx(1.0, abs=1e-6)


def test_ignore_box_absorbs_detection(rng):
    """A detection inside a crowd/unlabeled annotation's box is DROPPED
    from the PR curve (COCOeval gtIg), not scored as a false positive."""
    gt, dets = _make_scene(rng, n_images=2, people_per=2)
    base_ap = E.evaluate_detections(dets, gt).ap
    # an extra detection far from all GTs, inside an ignore box
    junk = _gt_person(rng, 1000.0, 1000.0)
    junk[:, 2] = 0.9
    dets2 = dets + [E.Detection(image_id=0, keypoints=junk, score=0.99)]
    gt_ign = {img: (kps, areas,
                    np.asarray([[940.0, 940.0, 120.0, 120.0]], np.float32)
                    if img == 0 else np.zeros((0, 4), np.float32))
              for img, (kps, areas) in gt.items()}
    with_ignore = E.evaluate_detections(dets2, gt_ign).ap
    without = E.evaluate_detections(dets2, gt).ap
    assert with_ignore == pytest.approx(base_ap, abs=1e-6)
    assert without < base_ap  # sanity: it IS an FP without the ignore box


def test_empty_area_slice_returns_sentinel(rng):
    """Zero in-range GTs -> -1.0 (COCOeval not-applicable), never 0.0."""
    gt, dets = _make_scene(rng, n_images=1, people_per=1)  # area 10000
    r = E.evaluate_detections(dets, gt, area_range=(1.0, 2.0))
    assert r.ap == -1.0 and r.ar == -1.0


def test_full_matches_single_pass(rng):
    """evaluate_detections_full's cached-OKS passes == fresh computation."""
    gt, dets = _make_scene(rng)
    full = E.evaluate_detections_full(dets, gt)
    fresh = E.evaluate_detections(dets, gt)
    assert full.ap == pytest.approx(fresh.ap)
    assert full.ap_medium == pytest.approx(
        E.evaluate_detections(dets, gt, E.AREA_MEDIUM).ap)
    assert full.ap_large == pytest.approx(
        E.evaluate_detections(dets, gt, E.AREA_LARGE).ap)


def test_pack_unpack_gt_roundtrip(rng):
    """Variable-G/Q packing preserves every person, area and ignore box
    (no 32-person cap, no dropped images)."""
    gt = {}
    for img, g in [(7, 1), (9, 40), (11, 3)]:
        kps = np.stack([_gt_person(rng, 50.0 * p, 60.0) for p in range(g)])
        areas = rng.uniform(100, 5000, g).astype(np.float32)
        boxes = rng.uniform(0, 300, (img % 3, 4)).astype(np.float32)
        gt[img] = (kps, areas, boxes)
    back = E._unpack_gt(E._pack_gt(gt))
    assert set(back) == set(gt)
    for img in gt:
        np.testing.assert_allclose(back[img][0], gt[img][0])
        np.testing.assert_allclose(back[img][1], gt[img][1])
        np.testing.assert_allclose(back[img][2], gt[img][2])


def test_pack_unpack_detections_roundtrip(rng):
    dets = [E.Detection(image_id=i, keypoints=_gt_person(rng, 10, 20),
                        score=0.5 + 0.1 * i) for i in range(5)]
    back = E._unpack_detections(E._pack_detections(dets))
    assert len(back) == 5
    for a, b in zip(dets, back):
        assert a.image_id == b.image_id and a.score == pytest.approx(b.score)
        np.testing.assert_allclose(a.keypoints, b.keypoints)
    assert E._unpack_detections(E._pack_detections([])) == []


@pytest.mark.slow
def test_evaluate_engine_native_and_python_paths_agree(tmp_path, monkeypatch):
    """evaluate_engine through the native stream loader must produce the
    same detections/AP as the pure-Python loop (same letterbox math, same
    GT registration)."""
    import dataclasses

    import jax

    from openpose_plus import native
    from openpose_plus.config import default_config
    from openpose_plus.data.coco import CocoPoseDataset
    from openpose_plus.engine import Engine
    from openpose_plus.eval_coco import evaluate_engine
    from tests.test_train import _write_fake_dataset

    ann, imgs = _write_fake_dataset(tmp_path)
    ds = CocoPoseDataset(ann, imgs)
    cfg = default_config("mobilenet_thin")
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, hin=64, win=96, n_stages=2, compute_dtype="float32"))
    eng = Engine(cfg, seed=1)

    results = {}
    for use_native in ((True, False) if native.is_available()
                       else (False,)):
        if not use_native:
            monkeypatch.setattr(native, "is_available", lambda: False)
        results[use_native] = evaluate_engine(eng, ds, batch_size=4,
                                              limit=6)
    for r in results.values():
        assert np.isfinite(r.ap)
    if len(results) == 2:
        assert abs(results[True].ap - results[False].ap) < 1e-6
