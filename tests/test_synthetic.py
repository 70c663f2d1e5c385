"""Scene-bank generator (data/synthetic.py): determinism + schema."""

import json
import os

import numpy as np

from openpose_plus.data.coco import CocoPoseDataset
from openpose_plus.data.synthetic import make_scene_bank, render_scene


def test_bank_is_deterministic(tmp_path):
    a_ann, a_imgs = make_scene_bank(str(tmp_path / "a"), "val", 4, 128)
    b_ann, b_imgs = make_scene_bank(str(tmp_path / "b"), "val", 4, 128)
    assert json.load(open(a_ann)) == json.load(open(b_ann))
    for f in sorted(os.listdir(a_imgs)):
        with open(os.path.join(a_imgs, f), "rb") as fa, \
                open(os.path.join(b_imgs, f), "rb") as fb:
            assert fa.read() == fb.read(), f


def test_train_val_disjoint(tmp_path):
    t_ann, _ = make_scene_bank(str(tmp_path), "train", 4, 128)
    v_ann, _ = make_scene_bank(str(tmp_path), "val", 4, 128)
    assert json.load(open(t_ann)) != json.load(open(v_ann))


def test_bank_loads_as_coco_dataset(tmp_path):
    ann, imgs = make_scene_bank(str(tmp_path), "val", 6, 128)
    ds = CocoPoseDataset(ann, imgs)
    assert len(ds) == 6
    d = json.load(open(ann))
    assert len(d["annotations"]) >= 6  # at least one person per image
    for a in d["annotations"]:
        kp = np.asarray(a["keypoints"], np.float32).reshape(17, 3)
        vis = kp[:, 2] > 0
        assert vis.any()
        # visible joints are in frame
        assert (kp[vis, 0] >= 0).all() and (kp[vis, 0] < 128).all()
        assert (kp[vis, 1] >= 0).all() and (kp[vis, 1] < 128).all()


def test_scenes_have_crowding_and_scale_variation():
    rng = np.random.default_rng(7)
    heights, counts = [], []
    for _ in range(20):
        _, poses = render_scene(rng, 256)
        counts.append(len(poses))
        for p in poses:
            ys = [y for _, y in p.values()]
            heights.append(max(ys) - min(ys))
    assert max(counts) >= 4          # crowds occur
    assert min(counts) >= 1
    assert max(heights) / max(min(heights), 1e-6) > 2.0  # scale variation