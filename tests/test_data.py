"""Data layer tests: GT target synthesis, COCO parsing, masks, augmentation."""

import json
import os

import numpy as np
import pytest

from openpose_plus import skeleton
from openpose_plus.config import DataConfig, ModelConfig
from openpose_plus.data import augment as A
from openpose_plus.data import coco as C
from openpose_plus.data import targets as T


# ----------------------------------------------------------- GT targets ---

def _some_keypoints(rng, n_people=3, max_people=5, w=432, h=368):
    kp = np.zeros((max_people, 18, 3), np.float32)
    for p in range(n_people):
        kp[p, :, 0] = rng.uniform(0, w, 18)
        kp[p, :, 1] = rng.uniform(0, h, 18)
        kp[p, :, 2] = (rng.uniform(size=18) > 0.2).astype(np.float32)
    return kp


def test_targets_jnp_matches_numpy(rng):
    kp = _some_keypoints(rng)
    conf_j, paf_j = T.make_targets(kp, 46, 54, 8, 8.0, 8.0)
    conf_n, paf_n = T.make_targets_np(kp, 46, 54, 8, 8.0, 8.0)
    np.testing.assert_allclose(np.asarray(conf_j), conf_n, atol=1e-5)
    np.testing.assert_allclose(np.asarray(paf_j), paf_n, atol=1e-5)


def test_targets_background_and_range(rng):
    kp = _some_keypoints(rng)
    conf, paf = T.make_targets(kp, 46, 54, 8, 8.0, 8.0)
    conf = np.asarray(conf)
    assert conf.shape == (46, 54, 19)
    np.testing.assert_allclose(
        conf[..., 18], 1.0 - conf[..., :18].max(-1), atol=1e-6)
    assert np.asarray(paf).shape == (46, 54, 38)
    assert np.abs(np.asarray(paf)).max() <= 1.0 + 1e-6


def test_targets_peak_at_keypoint():
    kp = np.zeros((1, 18, 3), np.float32)
    # keypoint exactly at output cell (10, 20)'s center
    kp[0, 0] = (20 * 8 + 3.5, 10 * 8 + 3.5, 1)
    conf, _ = T.make_targets(kp, 46, 54, 8, 8.0, 8.0)
    conf = np.asarray(conf)
    assert conf[10, 20, 0] == pytest.approx(1.0, abs=1e-6)
    assert np.unravel_index(conf[..., 0].argmax(), (46, 54)) == (10, 20)


def test_paf_overlap_averaging():
    """Two people with identical opposite limbs -> vectors cancel to 0."""
    kp = np.zeros((2, 18, 3), np.float32)
    kp[0, 1] = (100, 100, 1)   # neck
    kp[0, 2] = (200, 100, 1)   # rshoulder: limb 0 points +x
    kp[1, 1] = (200, 100, 1)
    kp[1, 2] = (100, 100, 1)   # opposite direction
    _, paf = T.make_targets(kp, 46, 54, 8, 8.0, 8.0)
    cx = skeleton.COCO_PAIRS_NETWORK[0][0]
    band = np.abs(np.asarray(paf)[:, :, cx])
    assert band.max() == pytest.approx(0.0, abs=1e-6)


def test_targets_batch_shape(rng):
    kp = np.stack([_some_keypoints(rng) for _ in range(2)])
    conf, paf = T.make_targets_batch(kp, ModelConfig(), DataConfig())
    assert conf.shape == (2, 46, 54, 19)
    assert paf.shape == (2, 46, 54, 38)


# ----------------------------------------------------------------- COCO ---

def _fake_coco(tmp_path):
    anns = {
        "images": [
            {"id": 1, "file_name": "a.jpg", "width": 100, "height": 80},
            {"id": 2, "file_name": "b.jpg", "width": 64, "height": 64},
            {"id": 3, "file_name": "c.jpg", "width": 64, "height": 64},
        ],
        "annotations": [
            {  # normal person
                "id": 10, "image_id": 1, "category_id": 1, "iscrowd": 0,
                "area": 400.0,
                "keypoints": sum([[10 + i, 20 + i, 2] for i in range(17)], []),
                "segmentation": [[0, 0, 10, 0, 10, 10, 0, 10]],
            },
            {  # crowd region -> ignore mask (uncompressed RLE)
                "id": 11, "image_id": 1, "category_id": 1, "iscrowd": 1,
                "area": 100.0,
                "keypoints": [0] * 51,
                "segmentation": {"counts": [0, 80, 80 * 99], "size": [80, 100]},
            },
            {  # person with no keypoints -> ignore polygon
                "id": 12, "image_id": 1, "category_id": 1, "iscrowd": 0,
                "area": 50.0,
                "keypoints": [0] * 51,
                "segmentation": [[50, 50, 60, 50, 60, 60, 50, 60]],
            },
            {  # image 2: only unannotated -> image dropped
                "id": 13, "image_id": 2, "category_id": 1, "iscrowd": 0,
                "area": 10.0, "keypoints": [0] * 51, "segmentation": [],
            },
            {  # image 3: shoulders-only person (neck synthesis check)
                "id": 14, "image_id": 3, "category_id": 1, "iscrowd": 0,
                "area": 20.0,
                "keypoints": [0, 0, 0] * 5 + [10, 30, 2] + [30, 30, 1]
                + [0, 0, 0] * 10,
                "segmentation": [],
            },
        ],
    }
    p = os.path.join(tmp_path, "ann.json")
    with open(p, "w") as f:
        json.dump(anns, f)
    return p


def test_coco_loader(tmp_path):
    ds = C.CocoPoseDataset(_fake_coco(tmp_path), str(tmp_path))
    assert len(ds) == 2  # image 2 dropped (no annotated people)
    s = ds[0]
    assert s.image_id == 1
    assert s.keypoints.shape == (1, 18, 3)
    # nose at coco idx 0 = (10, 20)
    assert tuple(s.keypoints[0, skeleton.CocoPart.Nose, :2]) == (10, 20)
    # two ignore regions recorded
    assert len(s.ignore_segms) == 2
    mask = s.ignore_mask()
    assert mask.shape == (80, 100)
    assert mask[:, 0].sum() == 0          # RLE column 0 masked out
    assert mask[55, 55] == 0              # polygon region masked out
    assert mask[70, 90] == 1


def test_neck_synthesis(tmp_path):
    ds = C.CocoPoseDataset(_fake_coco(tmp_path), str(tmp_path))
    s = ds[1]
    kp = s.keypoints[0]
    assert kp[skeleton.CocoPart.LShoulder, 2] == 1  # coco v=2
    assert kp[skeleton.CocoPart.RShoulder, 2] == 1  # coco v=1 counts too
    np.testing.assert_allclose(kp[skeleton.CocoPart.Neck],
                               [20, 30, 1])


def test_rle_roundtrip():
    rng = np.random.default_rng(3)
    m = (rng.uniform(size=(13, 7)) > 0.5).astype(np.uint8)
    # encode column-major starting with a zero run
    flat = m.T.reshape(-1)
    counts, prev, run = [], 0, 0
    for v in flat:
        if v == prev:
            run += 1
        else:
            counts.append(run)
            prev, run = v, 1
    counts.append(run)
    out = C._decode_rle_counts(counts, 13, 7)
    np.testing.assert_array_equal(out, m)


def test_compressed_rle_roundtrip():
    # encoder = inverse of the decoder's LEB128-with-sign + delta scheme
    def encode(counts):
        s = bytearray()
        for i, x in enumerate(counts):
            if i > 2:
                x -= counts[i - 2]
            more = True
            while more:
                c = x & 0x1F
                x >>= 5
                more = not (x == 0 and not (c & 0x10)
                            or x == -1 and (c & 0x10))
                if more:
                    c |= 0x20
                s.append(c + 48)
        return bytes(s)

    rng = np.random.default_rng(5)
    m = (rng.uniform(size=(11, 9)) > 0.6).astype(np.uint8)
    flat = m.T.reshape(-1)
    counts, prev, run = [], 0, 0
    for v in flat:
        if v == prev:
            run += 1
        else:
            counts.append(run)
            prev, run = v, 1
    counts.append(run)
    out = C._decode_compressed_rle(encode(counts), 11, 9)
    np.testing.assert_array_equal(out, m)


# ------------------------------------------------------------- augment ---

def test_augment_flip_swaps_parts(rng):
    img = np.zeros((80, 100, 3), np.uint8)
    kp = np.zeros((1, 18, 3), np.float32)
    kp[0, skeleton.CocoPart.RShoulder] = (20, 40, 1)
    kp[0, skeleton.CocoPart.LShoulder] = (80, 40, 1)
    mask = np.ones((80, 100), np.uint8)
    cfg = DataConfig(rotate_max_deg=0.0, scale_min=1.0, scale_max=1.0,
                     flip_prob=1.0, shift_frac=0.0)
    out = A.augment_sample(img, kp, mask, cfg, 80, 100,
                           np.random.default_rng(0))
    r = out.keypoints[0, skeleton.CocoPart.RShoulder]
    l = out.keypoints[0, skeleton.CocoPart.LShoulder]
    # after mirroring + swap, RShoulder must still be on the left side of
    # the flipped image relative to LShoulder's new position
    assert r[2] == 1 and l[2] == 1
    assert r[0] < l[0]


def test_augment_keypoint_tracks_content():
    """A bright dot at a keypoint must land where the keypoint lands."""
    img = np.zeros((80, 100, 3), np.uint8)
    img[40, 30] = 255
    kp = np.zeros((1, 18, 3), np.float32)
    kp[0, 0] = (30, 40, 1)
    mask = np.ones((80, 100), np.uint8)
    cfg = DataConfig(rotate_max_deg=30.0, scale_min=0.9, scale_max=1.1,
                     flip_prob=0.0)
    out = A.augment_sample(img, kp, mask, cfg, 96, 112,
                           np.random.default_rng(4))
    x, y, v = out.keypoints[0, 0]
    assert v == 1
    ys, xs = np.nonzero(out.image[:, :, 0] > 60)
    assert len(xs) > 0
    d = np.hypot(xs - x, ys - y).min()
    assert d < 2.0


def test_letterbox_roundtrip():
    img = np.zeros((50, 200, 3), np.uint8)
    out, scale, (px, py) = A.letterbox(img, 368, 432)
    assert out.shape == (368, 432, 3)
    # original corner maps inside and inverts correctly
    x_net = 100 * scale + px
    assert 0 <= x_net <= 432
    assert (x_net - px) / scale == pytest.approx(100)
