"""Broad randomized parity stress: many seeds x configs, JAX vs oracle.

Complements test_postproc_parity.py with coverage across upsample factors,
peak caps, smoothing settings, and adversarial map content — every case
must match the oracle exactly.
"""

import dataclasses

import numpy as np
import pytest

from openpose_plus.config import PostprocConfig
from openpose_plus.data import scenes
from tests.test_postproc_parity import (_assert_same_humans, _decode_both,
                                        _jax_humans)

CONFIGS = [
    PostprocConfig(upsample_factor=1, smooth_sigma=0.0, max_peaks=8,
                   max_humans=16),
    PostprocConfig(upsample_factor=1, smooth_sigma=0.8, max_peaks=8,
                   max_humans=16),
    PostprocConfig(upsample_factor=2, smooth_sigma=1.25, max_peaks=16,
                   max_humans=32),   # production defaults
]


@pytest.mark.parametrize("ci", range(len(CONFIGS)))
@pytest.mark.parametrize("seed", range(4))
def test_stress_parity(ci, seed):
    cfg = CONFIGS[ci]
    rng = np.random.default_rng(1000 * ci + seed)
    kind = seed % 4
    if kind == 0:    # sparse people + noise
        people = [scenes.standing_person(
            rng.uniform(10, 30), rng.uniform(14, 26), rng.uniform(0.7, 1.1))
            for _ in range(rng.integers(1, 4))]
        conf, paf = scenes.make_maps(people, 40, 48,
                                      noise=rng.uniform(0, 0.2),
                                      seed=int(rng.integers(1 << 30)))
    elif kind == 1:  # pure uniform noise
        conf = rng.uniform(0, 0.5, (40, 48, 19)).astype(np.float32)
        paf = rng.uniform(-1, 1, (40, 48, 38)).astype(np.float32)
    elif kind == 2:  # sparse spikes (many plateau ties at exact values)
        conf = np.zeros((40, 48, 19), np.float32)
        idx = rng.integers(0, 40 * 48, 200)
        conf.reshape(-1, 19)[idx % (40 * 48 - 1), rng.integers(0, 18, 200)] \
            = rng.choice([0.25, 0.5, 0.75], 200)
        paf = np.sign(rng.uniform(-1, 1, (40, 48, 38))).astype(np.float32) * 0.5
    else:            # saturated maps (every pixel above threshold)
        conf = rng.uniform(0.4, 0.6, (40, 48, 19)).astype(np.float32)
        paf = rng.uniform(0.3, 0.7, (40, 48, 38)).astype(np.float32)
    o_humans, batch = _decode_both(conf, paf, cfg)
    _assert_same_humans(o_humans, _jax_humans(batch))
