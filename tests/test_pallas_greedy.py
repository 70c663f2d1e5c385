"""Pallas (Triton route) greedy-assignment kernel vs the XLA reference —
bit-identical.

Interpret mode on the CPU test mesh; the same comparison on the GPU runs in
chip_smoke.py (phase 4) and tests/test_chip_smoke.py under `-m chip`.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from openpose_plus.ops.pallas.greedy import greedy_assign_pallas
from openpose_plus.postproc import paf as jpaf


def _scores(rng, k=16, density=0.3, ties=False):
    s = rng.uniform(0.01, 1.0, (19, k, k)).astype(np.float32)
    mask = rng.random((19, k, k)) < density
    s = np.where(mask, s, -np.inf).astype(np.float32)
    if ties:
        # exact duplicate scores across candidates: greedy order must break
        # ties by the lowest row-major index
        s[3, 1, 2] = s[3, 0, 5] = s[3, 4, 4] = 0.7
        s[7, :, :] = -np.inf
        s[9, 2, 2] = s[9, 2, 3] = 0.5
    return jnp.asarray(s)


@pytest.mark.parametrize("k", [16, 32])
@pytest.mark.parametrize("seed,ties", [(0, False), (1, False), (2, True),
                                       (3, True)])
def test_pallas_greedy_matches_xla(seed, ties, k):
    rng = np.random.default_rng(seed)
    scores = _scores(rng, k=k, ties=ties)
    ref = jax.jit(functools.partial(jpaf.greedy_assign, max_peaks=k))(scores)
    out = greedy_assign_pallas(scores, k, interpret=True)
    np.testing.assert_array_equal(np.asarray(ref.valid), np.asarray(out.valid))
    v = np.asarray(ref.valid)
    np.testing.assert_array_equal(np.asarray(ref.slot_a)[v],
                                  np.asarray(out.slot_a)[v])
    np.testing.assert_array_equal(np.asarray(ref.slot_b)[v],
                                  np.asarray(out.slot_b)[v])
    np.testing.assert_array_equal(np.asarray(ref.score), np.asarray(out.score))


def test_pallas_greedy_non_power_of_two_k():
    """K=12 pads to a 16-wide output block; the slice back is exact."""
    scores = _scores(np.random.default_rng(5), k=12, ties=True)
    ref = jax.jit(functools.partial(jpaf.greedy_assign, max_peaks=12))(scores)
    out = greedy_assign_pallas(scores, 12, interpret=True)
    assert out.slot_a.shape == (19, 12)
    np.testing.assert_array_equal(np.asarray(ref.valid), np.asarray(out.valid))
    np.testing.assert_array_equal(np.asarray(ref.score), np.asarray(out.score))


def test_pallas_greedy_vmaps(rng):
    scores = jnp.stack([_scores(np.random.default_rng(i)) for i in range(4)])
    fn = jax.vmap(functools.partial(greedy_assign_pallas, max_peaks=16,
                                    interpret=True))
    out = fn(scores)
    ref = jax.vmap(functools.partial(jpaf.greedy_assign, max_peaks=16))(scores)
    np.testing.assert_array_equal(np.asarray(ref.valid), np.asarray(out.valid))
    np.testing.assert_array_equal(np.asarray(ref.score), np.asarray(out.score))
