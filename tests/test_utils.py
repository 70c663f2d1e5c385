"""Tracer, visualization, and HumanBatch host-view tests."""

import numpy as np
import pytest

from openpose_plus.utils.tracer import Tracer, timeit


def test_tracer_nested_scopes():
    t = Tracer()
    with t.scope("outer"):
        with t.scope("inner"):
            pass
        with t.scope("inner"):
            pass
    rep = t.report()
    assert "outer" in rep and "inner" in rep
    lines = [l for l in rep.splitlines() if "inner" in l]
    assert len(lines) == 1 and "2" in lines[0].split()[1]
    t.reset()
    assert "outer" not in t.report()


def test_timeit_returns_positive():
    import jax.numpy as jnp

    f = lambda x: jnp.sum(x * 2)
    dt = timeit(f, jnp.ones((64,)), warmup=1, iters=3)
    assert dt > 0


def test_draw_humans_and_to_list(rng):
    cv2 = pytest.importorskip("cv2")
    import dataclasses

    from openpose_plus.config import default_config
    from openpose_plus.engine import Engine
    from openpose_plus.utils.vis import draw_humans, draw_maps_overlay

    cfg = default_config("vggtiny")
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, hin=64, win=64, n_stages=2, compute_dtype="float32"))
    eng = Engine(cfg)
    images = rng.integers(0, 255, (1, 64, 64, 3), dtype=np.uint8)
    humans = eng.infer(images)
    # host list view
    lst = humans.to_list(0)
    assert isinstance(lst, list)
    for h in lst:
        assert set(h) == {"parts", "score"}
        for p, (x, y, s) in h["parts"].items():
            assert 0 <= x <= 1 and 0 <= y <= 1
    # drawing never crashes and returns a copy
    canvas = np.zeros((120, 160, 3), np.uint8)
    out = draw_humans(canvas, humans, 0)
    assert out.shape == canvas.shape
    conf, _ = eng.forward(images)
    ov = draw_maps_overlay(canvas, np.asarray(conf[0]))
    assert ov.shape == canvas.shape
