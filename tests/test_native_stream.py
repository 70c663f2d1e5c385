"""Native host runtime tests: decode, letterbox parity with cv2, the
threaded stream loader, tracer, and the stream estimator end-to-end."""

import dataclasses
import os

import numpy as np
import pytest

from openpose_plus import native

cv2 = pytest.importorskip("cv2")

pytestmark = pytest.mark.skipif(not native.is_available(),
                                reason="libpose_host.so not built")


def _gradient_image(h, w):
    """Smooth content: JPEG-decoder differences (IDCT variants) stay tiny,
    unlike random noise whose artifacts differ per decoder."""
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([xx * 255 // max(w - 1, 1),
                    yy * 255 // max(h - 1, 1),
                    (xx + yy) % 256], axis=-1)
    return img.astype(np.uint8)


@pytest.fixture
def image_dir(tmp_path):
    paths = []
    for i, (h, w) in enumerate([(120, 160), (300, 200), (80, 80),
                                (240, 320), (64, 400)]):
        p = str(tmp_path / f"img{i}.jpg")
        cv2.imwrite(p, cv2.cvtColor(_gradient_image(h, w), cv2.COLOR_RGB2BGR),
                    [cv2.IMWRITE_JPEG_QUALITY, 95])
        paths.append(p)
    png = str(tmp_path / "img_png.png")
    cv2.imwrite(png, cv2.cvtColor(_gradient_image(100, 150),
                                  cv2.COLOR_RGB2BGR))
    paths.append(png)
    return paths


def test_native_decode_matches_cv2(image_dir):
    for p in image_dir:
        out = native.load_image(p, 368, 432)
        assert out is not None, p
        img, scale, pads = out
        assert img.shape == (368, 432, 3)
        ref = cv2.cvtColor(cv2.imread(p), cv2.COLOR_BGR2RGB)
        from openpose_plus.data.augment import letterbox as lb
        ref_img, ref_scale, ref_pads = lb(ref, 368, 432)
        assert scale == pytest.approx(ref_scale, rel=1e-5)
        assert pads[0] == pytest.approx(ref_pads[0], abs=0.51)
        assert pads[1] == pytest.approx(ref_pads[1], abs=0.51)
        # content parity (different bilinear impls; compare loosely)
        diff = np.abs(img.astype(int) - ref_img.astype(int))
        assert np.median(diff) <= 2
        assert (diff > 30).mean() < 0.02


def test_dct_scaled_decode_preserves_letterbox_contract(tmp_path):
    """Large JPEGs decode DCT-downscaled (libjpeg scale_num/denom set from
    the target size — native/src/image.cpp), but the reported scale/pads
    MUST stay in ORIGINAL image pixels: r3 regression where the contract
    was computed against the decoded plane, silently shifting every
    detection (native-path eval AP collapsed to 0 while the python path
    scored 0.26)."""
    from openpose_plus.data.augment import letterbox as lb

    for h, w in [(1024, 1536), (513, 511), (2000, 600)]:
        p = str(tmp_path / f"big_{h}x{w}.jpg")
        # strictly smooth content: the reference full-decode path below
        # point-samples at ~1/12 scale (aliases any high-frequency
        # content), while DCT-scaled decode box-filters first — only on
        # smooth images do both pipelines agree closely
        yy, xx = np.mgrid[0:h, 0:w]
        img = np.stack([xx * 255 // max(w - 1, 1),
                        yy * 255 // max(h - 1, 1),
                        (xx * 127 // max(w - 1, 1)
                         + yy * 128 // max(h - 1, 1))], axis=-1)
        cv2.imwrite(p, cv2.cvtColor(img.astype(np.uint8),
                                    cv2.COLOR_RGB2BGR),
                    [cv2.IMWRITE_JPEG_QUALITY, 95])
        img, scale, pads = native.load_image(p, 128, 128)
        ref = cv2.cvtColor(cv2.imread(p), cv2.COLOR_BGR2RGB)
        ref_img, ref_scale, ref_pads = lb(ref, 128, 128)
        # scale/pads are vs the ORIGINAL dims, decoder-independent
        assert scale == pytest.approx(ref_scale, rel=1e-5), (h, w)
        assert pads[0] == pytest.approx(ref_pads[0], abs=0.51)
        assert pads[1] == pytest.approx(ref_pads[1], abs=0.51)
        # content parity through the scaled decode (gradients are smooth,
        # so DCT-scaled + bilinear stays close to full-decode + bilinear)
        diff = np.abs(img.astype(int) - ref_img.astype(int))
        assert np.median(diff) <= 3, (h, w, np.median(diff))
        assert (diff > 40).mean() < 0.02, (h, w)


def test_native_letterbox_raw_frame():
    frame = _gradient_image(90, 200)
    img, scale, pads = native.letterbox(frame, 368, 432)
    assert img.shape == (368, 432, 3)
    from openpose_plus.data.augment import letterbox as lb
    ref_img, ref_scale, _ = lb(frame, 368, 432)
    assert scale == pytest.approx(ref_scale, rel=1e-5)
    diff = np.abs(img.astype(int) - ref_img.astype(int))
    assert np.median(diff) <= 2


def test_stream_loader_yields_all(image_dir):
    loader = native.NativeStreamLoader(image_dir, 128, 160, batch=4,
                                       workers=3, queue_capacity=2)
    seen = []
    for b in loader:
        assert b["images"].shape[1:] == (128, 160, 3)
        seen.extend(b["indices"].tolist())
    loader.close()
    assert sorted(seen) == list(range(len(image_dir)))


def test_stream_loader_skips_bad_files(image_dir, tmp_path):
    bad = str(tmp_path / "broken.jpg")
    with open(bad, "wb") as f:
        f.write(b"\xff\xd8not a real jpeg")
    loader = native.NativeStreamLoader(image_dir + [bad, "/nonexistent.jpg"],
                                       64, 64, batch=3, workers=2,
                                       queue_capacity=2)
    seen = []
    for b in loader:
        seen.extend(b["indices"].tolist())
    loader.close()
    assert sorted(seen) == list(range(len(image_dir)))


def test_tracer_report(image_dir):
    native.load_image(image_dir[0], 64, 64)
    rep = native.tracer_report()
    assert "decode" in rep and "resize" in rep


def test_stream_estimator_end_to_end(image_dir):
    from openpose_plus.config import default_config
    from openpose_plus.engine import Engine
    from openpose_plus.stream import StreamEstimator

    cfg = default_config("vggtiny")
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, hin=64, win=64, n_stages=2, compute_dtype="float32"))
    eng = Engine(cfg)
    est = StreamEstimator(eng, batch=2, workers=2)
    results = list(est.run_files(image_dir))
    got = sorted(i for r in results for i in r.indices.tolist())
    assert got == list(range(len(image_dir)))
    for r in results:
        assert r.humans.coords.shape[0] == 2  # compiled batch shape


def test_stream_estimator_frames(image_dir):
    from openpose_plus.config import default_config
    from openpose_plus.engine import Engine
    from openpose_plus.stream import StreamEstimator

    cfg = default_config("vggtiny")
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, hin=64, win=64, n_stages=2, compute_dtype="float32"))
    eng = Engine(cfg)
    est = StreamEstimator(eng, batch=2)
    rng = np.random.default_rng(2)
    frames = [rng.integers(0, 255, (100, 120, 3), dtype=np.uint8)
              for _ in range(5)]
    results = list(est.run_frames(frames))
    got = sorted(i for r in results for i in r.indices.tolist())
    assert got == list(range(5))


def test_s2d_u8_matches_numpy():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (64, 96, 3), dtype=np.uint8)
    got = native.s2d_u8(img)
    ref = img.reshape(32, 2, 48, 2, 3).transpose(0, 2, 1, 3, 4).reshape(
        32, 48, 12)
    np.testing.assert_array_equal(got, ref)


def test_stream_loader_s2d_layout(image_dir):
    """s2d=True loader frames are exactly the block-permutation of the
    plain loader's letterboxed frames."""
    def collect(s2d):
        loader = native.NativeStreamLoader(
            image_dir, 64, 96, batch=2, workers=2, s2d=s2d)
        out = {}
        for b in loader:
            for i in range(b["images"].shape[0]):
                out[int(b["indices"][i])] = b["images"][i]
        loader.close()
        return out
    plain, packed = collect(False), collect(True)
    assert sorted(plain) == sorted(packed)
    for k, img in plain.items():
        assert packed[k].shape == (32, 48, 12)
        np.testing.assert_array_equal(packed[k], native.s2d_u8(img))


def test_stream_estimator_uses_s2d_for_mobilenet(image_dir):
    """End-to-end: the estimator auto-selects the s2d layout for the s2d
    stem and the engine consumes it."""
    from openpose_plus.config import default_config
    from openpose_plus.engine import Engine
    from openpose_plus.stream import StreamEstimator

    cfg = default_config("mobilenet_thin")
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, hin=64, win=96, n_stages=2, compute_dtype="float32"))
    eng = Engine(cfg)
    est = StreamEstimator(eng, batch=2, workers=2)
    assert est.s2d
    got = sum(r.n for r in est.run_files(image_dir))
    assert got == len(image_dir)


def test_s2d2_u8_matches_numpy():
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (64, 96, 3), dtype=np.uint8)
    got = native.s2d2_u8(img)
    a = img.reshape(32, 2, 48, 2, 3).transpose(0, 2, 1, 3, 4).reshape(
        32, 48, 12)
    ref = a.reshape(16, 2, 24, 2, 12).transpose(0, 2, 1, 3, 4).reshape(
        16, 24, 48)
    assert got.shape == (16, 24, 48)
    np.testing.assert_array_equal(got, ref)


def test_stream_loader_s2d2_layout(image_dir):
    loader = native.NativeStreamLoader(
        image_dir, 64, 96, batch=2, workers=2, s2d=2)
    assert loader.s2d == 2
    plain = native.NativeStreamLoader(
        image_dir, 64, 96, batch=2, workers=2)
    by_idx = {}
    for b in plain:
        for i in range(b["images"].shape[0]):
            by_idx[int(b["indices"][i])] = b["images"][i]
    plain.close()
    for b in loader:
        for i in range(b["images"].shape[0]):
            img = b["images"][i]
            assert img.shape == (16, 24, 48)
            np.testing.assert_array_equal(
                img, native.s2d2_u8(by_idx[int(b["indices"][i])]))
    loader.close()


def test_d2s_u8_inverts_both_levels():
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (64, 96, 3), dtype=np.uint8)
    np.testing.assert_array_equal(native.d2s_u8(native.s2d_u8(img)), img)
    np.testing.assert_array_equal(native.d2s_u8(native.s2d2_u8(img)), img)
    np.testing.assert_array_equal(native.d2s_u8(img), img)
