"""CLI tests: infer and eval subcommands end-to-end on tiny fake data."""

import dataclasses
import json
import os

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from openpose_plus import cli


@pytest.fixture
def images(tmp_path):
    rng = np.random.default_rng(0)
    paths = []
    for i in range(3):
        p = str(tmp_path / f"img{i}.jpg")
        cv2.imwrite(p, rng.integers(0, 255, (100, 140, 3), dtype=np.uint8))
        paths.append(p)
    return paths


def test_cli_infer(images, tmp_path, monkeypatch, capsys):
    out_json = str(tmp_path / "out.json")
    draw_dir = str(tmp_path / "vis")
    rc = cli.main([
        "infer", "--model", "vggtiny", "--input-height", "64",
        "--input-width", "64", "--images", *images, "--batch", "2",
        "--json-out", out_json, "--draw-dir", draw_dir,
    ])
    assert rc == 0
    data = json.load(open(out_json))
    assert len(data) == 3
    assert all(os.path.exists(os.path.join(draw_dir, os.path.basename(p)))
               for p in images)
    assert "humans" in capsys.readouterr().out


def test_cli_eval(images, tmp_path):
    # fake coco annotations over the same images
    anns = {"images": [], "annotations": []}
    for i, p in enumerate(images):
        anns["images"].append({"id": i, "file_name": os.path.basename(p),
                               "width": 140, "height": 100})
        anns["annotations"].append({
            "id": 10 + i, "image_id": i, "category_id": 1, "iscrowd": 0,
            "area": 2000.0,
            "keypoints": sum([[20 + 3 * k, 30 + 2 * k, 2]
                              for k in range(17)], []),
            "segmentation": [],
        })
    ann_path = str(tmp_path / "ann.json")
    json.dump(anns, open(ann_path, "w"))
    rc = cli.main([
        "eval", "--model", "vggtiny", "--input-height", "64",
        "--input-width", "64", "--annotations", ann_path,
        "--images", str(tmp_path), "--batch", "2",
    ])
    assert rc == 0


def test_cli_missing_images(tmp_path):
    rc = cli.main(["infer", "--model", "vggtiny", "--input-height", "64",
                   "--input-width", "64", "--images",
                   str(tmp_path / "none*.jpg")])
    assert rc == 2


@pytest.mark.slow
def test_cli_export_then_infer_from_artifact(images, tmp_path):
    """export -> frozen StableHLO dir -> infer --engine-dir round trip."""
    eng_dir = str(tmp_path / "engine")
    rc = cli.main([
        "export", "--model", "vggtiny", "--input-height", "64",
        "--input-width", "64", "--out", eng_dir, "--batch", "2",
    ])
    assert rc == 0
    assert os.path.exists(os.path.join(eng_dir, "manifest.json"))

    out_json = str(tmp_path / "art.json")
    rc = cli.main([
        "infer", "--images", *images, "--engine-dir", eng_dir,
        "--json-out", out_json,
    ])
    assert rc == 0
    assert len(json.load(open(out_json))) == 3


def test_cli_stream_smoke(images):
    """stream subcommand end-to-end on the CPU backend (loop mode)."""
    rc = cli.main([
        "stream", "--model", "vggtiny", "--input-height", "64",
        "--input-width", "64", "--images", *images, "--batch", "2",
        "--workers", "2", "--loop", "--repeat", "3",
    ])
    assert rc == 0


@pytest.mark.slow
def test_cli_stream_video(tmp_path):
    """stream --video: the reference stream-detector's video-file source."""
    rng = np.random.default_rng(0)
    path = str(tmp_path / "clip.avi")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"),
                             5.0, (120, 90))
    if not writer.isOpened():
        pytest.skip("no MJPG encoder in this cv2 build")
    for _ in range(5):
        writer.write(rng.integers(0, 255, (90, 120, 3), dtype=np.uint8))
    writer.release()
    rc = cli.main([
        "stream", "--model", "vggtiny", "--input-height", "64",
        "--input-width", "64", "--video", path, "--batch", "2",
    ])
    assert rc == 0


def test_cli_stream_no_input():
    rc = cli.main(["stream", "--model", "vggtiny", "--input-height", "64",
                   "--input-width", "64"])
    assert rc == 2
