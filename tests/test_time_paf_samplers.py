"""scripts/time_paf_samplers.py: the lowerings it times compute what the
decoder's gather sampler computes, on small maps."""

import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))

import time_paf_samplers as tps  # noqa: E402

CASES = tps.cases(h=12, w=20, batch=2, seed=3)


@pytest.mark.parametrize("case", CASES, ids=[c[0].split(":")[0]
                                             for c in CASES])
def test_lowering_agrees_with_gather(case):
    _, gather, alt, args, exact = case
    err = tps.agree(gather, alt, args, exact)
    assert err == 0.0 if exact else err >= 0.0


def test_agree_rejects_a_shifted_sampler():
    _, gather, _, args, _ = CASES[0]
    shifted = lambda p, y, x: gather(p, y, (x + 1) % (20 * 2))
    with pytest.raises(AssertionError, match="differ"):
        tps.agree(gather, shifted, args, exact=False)
