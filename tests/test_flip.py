"""Flip-TTA map mirroring: involution + GT-level consistency."""

import numpy as np

from openpose_plus import skeleton
from openpose_plus.data import targets as T
from openpose_plus.postproc import flip


def test_mirror_is_involution(rng):
    conf = rng.uniform(0, 1, (2, 8, 10, 19)).astype(np.float32)
    paf = rng.uniform(-1, 1, (2, 8, 10, 38)).astype(np.float32)
    c2, p2 = flip.mirror_maps(*flip.mirror_maps(conf, paf))
    np.testing.assert_allclose(np.asarray(c2), conf, atol=1e-6)
    np.testing.assert_allclose(np.asarray(p2), paf, atol=1e-6)


def test_mirror_matches_mirrored_scene(rng):
    """GT maps of a mirrored scene == mirror_maps of the original GT."""
    hout, wout, stride = 24, 32, 8
    win = wout * stride
    kp = np.zeros((2, 18, 3), np.float32)
    for p in range(2):
        kp[p, :, 0] = rng.uniform(10, win - 10, 18)
        kp[p, :, 1] = rng.uniform(10, hout * stride - 10, 18)
        kp[p, :, 2] = 1

    # mirrored scene: x -> win-1-x, left/right parts swapped
    kp_m = kp.copy()
    kp_m[:, :, 0] = win - 1 - kp[:, :, 0]
    for a, b in skeleton.FLIP_SWAP_PAIRS:
        kp_m[:, [a, b]] = kp_m[:, [b, a]]

    conf, paf = T.make_targets(kp, hout, wout, stride, 8.0, 8.0)
    conf_m, paf_m = T.make_targets(kp_m, hout, wout, stride, 8.0, 8.0)
    c_back, p_back = flip.mirror_maps(conf_m, paf_m)
    np.testing.assert_allclose(np.asarray(c_back), np.asarray(conf),
                               atol=1e-4)
    np.testing.assert_allclose(np.asarray(p_back), np.asarray(paf),
                               atol=1e-4)


def test_engine_flip_tta(rng):
    import dataclasses

    from openpose_plus.config import default_config
    from openpose_plus.engine import Engine

    cfg = default_config("vggtiny")
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, hin=64, win=64, n_stages=2, compute_dtype="float32"))
    eng = Engine(cfg)
    images = rng.integers(0, 255, (2, 64, 64, 3), dtype=np.uint8)
    out = eng.infer(images, flip_tta=True)
    assert out.coords.shape[0] == 2
    # TTA on a horizontally symmetric input must produce maps equal to
    # their own mirror -> decoding still works and stays finite
    sym = images // 2 + images[:, :, ::-1] // 2
    out_sym = eng.infer(sym, flip_tta=True)
    assert np.isfinite(np.asarray(out_sym.score)).all()
