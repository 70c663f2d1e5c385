"""merge_dedup (per-scale decode + OKS-NMS multi-scale combiner) tests."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from openpose_plus.config import default_config
from openpose_plus.postproc import HumanBatch, merge_dedup


def _mk_batch(coords, scores, M=8):
    """HumanBatch with one image; coords: list of (18, 2) arrays or None."""
    B = 1
    c = np.zeros((B, M, 18, 2), np.float32)
    pv = np.zeros((B, M, 18), bool)
    ps = np.zeros((B, M, 18), np.float32)
    sc = np.zeros((B, M), np.float32)
    npart = np.zeros((B, M), np.int32)
    valid = np.zeros((B, M), bool)
    for i, (xy, s) in enumerate(zip(coords, scores)):
        c[0, i] = xy
        pv[0, i] = True
        ps[0, i] = s
        sc[0, i] = s
        npart[0, i] = 18
        valid[0, i] = True
    return HumanBatch(coords=jnp.asarray(c), part_scores=jnp.asarray(ps),
                      part_valid=jnp.asarray(pv), score=jnp.asarray(sc),
                      n_parts=jnp.asarray(npart), valid=jnp.asarray(valid))


def _person(cx, cy, s=0.1):
    """18-part skeleton around (cx, cy) with extent ~s (normalized)."""
    rng = np.random.default_rng(0)
    return np.stack([np.full(18, cx) + np.linspace(-s, s, 18),
                     np.full(18, cy) + rng.uniform(-s, s, 18)], -1
                    ).astype(np.float32)


def test_dedup_suppresses_duplicates():
    """The same person from two scales -> one survivor (the higher score)."""
    p = _person(0.5, 0.5)
    a = _mk_batch([p], [0.9])
    b = _mk_batch([p + 0.003], [0.6])   # near-identical skeleton
    out = merge_dedup([a, b])
    assert int(out.num_humans[0]) == 1
    assert float(out.score[0, 0]) == pytest.approx(0.9)


def test_dedup_lower_score_first_keeps_best():
    """Adversarial ordering (the r4 bug): the LOWER-scored duplicate
    arrives in the FIRST batch (concatenation order would give it
    suppression priority). Greedy NMS must still keep the 0.9 row —
    suppression runs in global score order, not input order."""
    p = _person(0.5, 0.5)
    lo = _mk_batch([p + 0.003], [0.6])
    hi = _mk_batch([p], [0.9])
    out = merge_dedup([lo, hi])
    assert int(out.num_humans[0]) == 1
    assert float(out.score[0, 0]) == pytest.approx(0.9)


def test_dedup_keeps_distinct_people():
    a = _mk_batch([_person(0.25, 0.3)], [0.8])
    b = _mk_batch([_person(0.75, 0.7)], [0.7])
    out = merge_dedup([a, b])
    assert int(out.num_humans[0]) == 2
    # compacted: higher score first
    assert float(out.score[0, 0]) >= float(out.score[0, 1])


def test_dedup_no_shared_parts_never_suppresses():
    """Two half-bodies (disjoint part sets) at the same location are NOT
    merged — OKS over zero common parts is defined as 0."""
    p = _person(0.5, 0.5)
    a = _mk_batch([p], [0.9])
    b = _mk_batch([p], [0.5])
    # restrict a to the first 9 parts, b to the last 9
    pv_a = np.asarray(a.part_valid).copy()
    pv_a[0, 0, 9:] = False
    pv_b = np.asarray(b.part_valid).copy()
    pv_b[0, 0, :9] = False
    a = a.replace(part_valid=jnp.asarray(pv_a),
                  n_parts=jnp.full((1, 8), 9, jnp.int32) * np.asarray(a.valid))
    b = b.replace(part_valid=jnp.asarray(pv_b),
                  n_parts=jnp.full((1, 8), 9, jnp.int32) * np.asarray(b.valid))
    out = merge_dedup([a, b])
    assert int(out.num_humans[0]) == 2


def test_dedup_jit_and_batched():
    """merge_dedup is jit-compatible and vmaps over the batch axis."""
    p1, p2 = _person(0.3, 0.3), _person(0.7, 0.7)
    a = _mk_batch([p1, p2], [0.9, 0.8])
    b = _mk_batch([p1], [0.4])
    f = jax.jit(lambda u, v: merge_dedup([u, v]))
    out = f(a, b)
    assert int(out.num_humans[0]) == 2
    assert out.coords.shape == (1, 16, 18, 2)   # capacity = sum of inputs


def test_engine_dedup_combiner_runs(rng):
    """Engine combine="dedup" end-to-end smoke: well-formed, compacted."""
    from openpose_plus.engine import Engine

    cfg = default_config("vggtiny")
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, hin=64, win=64, n_stages=2, compute_dtype="float32"))
    eng = Engine(cfg, seed=0)
    images = rng.integers(0, 255, (2, 64, 64, 3), dtype=np.uint8)
    out = eng.infer_multiscale(images, scales=(0.5, 1.0),
                               flip_tta=False, combine="dedup")
    M = 2 * cfg.postproc.max_humans
    assert out.coords.shape == (2, M, 18, 2)
    v = np.asarray(out.valid)
    s = np.asarray(out.score)
    for bi in range(2):
        k = v[bi].sum()
        assert not v[bi, int(k):].any()          # compacted
        assert (np.diff(s[bi, :int(k)]) <= 1e-6).all()  # score-sorted
