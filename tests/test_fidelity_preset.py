"""The high-fidelity grouping preset (reference-style 8x upsampled maps,
32-peak cap) must ALSO match the oracle exactly — it is the configuration
used for AP-parity evaluation."""

import numpy as np

from openpose_plus.config import PostprocConfig
from openpose_plus.postproc import decode, oracle

from openpose_plus.data import scenes
from tests.test_postproc_parity import (_assert_same_humans, _decode_both,
                                        _jax_humans)


def test_fidelity_decode_parity():
    cfg = PostprocConfig().fidelity()
    assert cfg.max_peaks == 32 and cfg.upsample_factor == 8
    people = [scenes.standing_person(12.3 + 14.6 * i, 20.2, 0.9 + 0.11 * i)
              for i in range(2)]
    conf, paf = scenes.make_maps(people, 46, 54, noise=0.05, seed=11)
    o_humans, batch = _decode_both(conf, paf, cfg)
    assert len(o_humans) >= 2
    _assert_same_humans(o_humans, _jax_humans(batch))
