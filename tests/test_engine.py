"""Engine tests: end-to-end infer, AOT compile, multi-chip data-parallel
inference on the 8-device mesh."""

import dataclasses

import jax
import numpy as np
import pytest

from openpose_plus.config import default_config
from openpose_plus.engine import Engine
from openpose_plus.parallel import sharding as S


def _tiny(model="vggtiny"):
    cfg = default_config(model)
    return cfg.replace(model=dataclasses.replace(
        cfg.model, hin=64, win=64, n_stages=2, compute_dtype="float32"))


def test_engine_infer_shapes(rng):
    cfg = _tiny()
    eng = Engine(cfg)
    images = rng.integers(0, 255, (2, 64, 64, 3), dtype=np.uint8)
    out = eng.infer(images)
    M = cfg.postproc.max_humans
    assert out.coords.shape == (2, M, 18, 2)
    assert out.valid.shape == (2, M)
    conf, paf = eng.forward(images)
    assert conf.shape == (2, 8, 8, 19)
    assert paf.shape == (2, 8, 8, 38)


def test_engine_aot_compile(rng):
    eng = Engine(_tiny())
    eng.compile(batch_size=4)  # must not raise
    images = rng.integers(0, 255, (4, 64, 64, 3), dtype=np.uint8)
    out = eng.infer(images)
    assert out.coords.shape[0] == 4


@pytest.mark.slow
def test_engine_mesh_inference_matches_single(rng):
    """Sharded inference over the 8-device mesh == single-device results."""
    cfg = _tiny()
    single = Engine(cfg, seed=0)
    mesh = S.build_mesh(cfg.parallel)
    sharded = Engine(cfg, params=jax.device_get(single.params), mesh=mesh)
    images = rng.integers(0, 255, (8, 64, 64, 3), dtype=np.uint8)
    a = single.infer(images)
    b = sharded.infer(images)
    np.testing.assert_array_equal(np.asarray(a.valid), np.asarray(b.valid))
    np.testing.assert_allclose(np.asarray(a.coords), np.asarray(b.coords),
                               atol=1e-5)


def test_engine_fast_init_structure():
    cfg = _tiny()
    a = Engine(cfg, seed=0)
    b = Engine(cfg, seed=0, fast_init=True)
    ta = jax.tree_util.tree_structure(a.params)
    tb = jax.tree_util.tree_structure(b.params)
    assert ta == tb
    for x, y in zip(jax.tree_util.tree_leaves(a.params),
                    jax.tree_util.tree_leaves(b.params)):
        assert x.shape == y.shape and x.dtype == y.dtype


def test_engine_chunked_infer_matches_unchunked(rng):
    """chunk=N serves the batch as lax.map over N-sized sub-batches in one
    program (bounds the large-batch working set); results must be identical
    to the plain batched lowering."""
    cfg = _tiny()
    a = Engine(cfg, seed=0)
    b = Engine(cfg, params=jax.device_get(a.params), chunk=2)
    images = rng.integers(0, 255, (4, 64, 64, 3), dtype=np.uint8)
    ra, rb = a.infer(images), b.infer(images)
    np.testing.assert_array_equal(np.asarray(ra.valid), np.asarray(rb.valid))
    np.testing.assert_allclose(np.asarray(ra.coords), np.asarray(rb.coords),
                               atol=1e-6)
    # non-multiple or small batches fall back to the plain path
    small = rng.integers(0, 255, (1, 64, 64, 3), dtype=np.uint8)
    rs = b.infer(small)
    assert rs.coords.shape[0] == 1


def test_engine_fast_init_same_program():
    """The benched program IS the served program: bench.py measures a
    fast_init engine (numpy-filled params), serving uses trained
    checkpoints — both must lower infer() to byte-identical (Stable)HLO,
    so the headline FPS describes the program users actually run.
    Params only enter the program as shapes/dtypes, so this is expected;
    the test pins it against e.g. value-dependent specializations."""
    cfg = _tiny()
    a = Engine(cfg, seed=0)                  # real-init (serving) params
    b = Engine(cfg, seed=0, fast_init=True)  # the bench path
    shape = jax.ShapeDtypeStruct((4, 64, 64, 3), np.uint8)
    ta = a._infer.lower(a.params, shape).as_text()
    tb = b._infer.lower(b.params, shape).as_text()
    assert ta == tb


@pytest.mark.slow
def test_engine_multiscale_single_scale_matches_infer(rng):
    """scales=(1.0,) multi-scale == plain infer (same maps, one decode)."""
    cfg = _tiny()
    eng = Engine(cfg, seed=0)
    images = rng.integers(0, 255, (2, 64, 64, 3), dtype=np.uint8)
    a = eng.infer(images)
    b = eng.infer_multiscale(images, scales=(1.0,))
    np.testing.assert_array_equal(np.asarray(a.valid), np.asarray(b.valid))
    np.testing.assert_allclose(np.asarray(a.coords), np.asarray(b.coords))


@pytest.mark.slow
def test_engine_multiscale_runs_and_averages(rng):
    """3-scale (+flip) search produces finite, well-formed results; the
    scaled passes snap input dims to the backbone stride."""
    cfg = _tiny()
    eng = Engine(cfg, seed=0)
    images = rng.integers(0, 255, (2, 64, 64, 3), dtype=np.uint8)
    out = eng.infer_multiscale(images, scales=(0.5, 1.0, 1.5),
                               flip_tta=True)
    assert out.coords.shape[0] == 2
    assert bool(np.isfinite(np.asarray(out.score)).all())


@pytest.mark.slow
def test_engine_s2d_input_layout_matches_plain(rng):
    """The space-to-depth input layout (B, hin/2, win/2, 12) — same bytes,
    block-permuted — must produce the same skeletons as the plain layout,
    in every serving mode (plain, flip-TTA, multiscale)."""
    from openpose_plus.models.common import space_to_depth

    cfg = _tiny("mobilenet_thin")
    eng = Engine(cfg, seed=2)
    images = rng.integers(0, 255, (2, 64, 64, 3), dtype=np.uint8)
    images_q = np.asarray(space_to_depth(jax.numpy.asarray(images)))
    images_q2 = np.asarray(space_to_depth(jax.numpy.asarray(images_q)))
    assert images_q.shape == (2, 32, 32, 12)
    assert images_q2.shape == (2, 16, 16, 48)
    for alt in (images_q, images_q2):
        for kw in ({}, {"flip_tta": True}):
            a = eng.infer(images, **kw)
            b = eng.infer(alt, **kw)
            np.testing.assert_allclose(np.asarray(a.coords),
                                       np.asarray(b.coords), atol=1e-4)
            np.testing.assert_array_equal(np.asarray(a.valid),
                                          np.asarray(b.valid))
        a = eng.infer_multiscale(images, scales=(0.5, 1.0))
        b = eng.infer_multiscale(alt, scales=(0.5, 1.0))
        np.testing.assert_allclose(np.asarray(a.coords),
                                   np.asarray(b.coords), atol=1e-4)
