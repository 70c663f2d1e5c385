"""Pallas (Triton route) merge kernel vs the XLA reference merge —
bit-identical results.

Runs in Pallas interpret mode on the CPU test mesh; the same comparison on
the GPU runs in chip_smoke.py (phase 4) and tests/test_chip_smoke.py under
`-m chip`.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from openpose_plus.ops.pallas.merge import assemble_pallas
from openpose_plus.postproc import group
from openpose_plus.postproc.paf import Connections


def _random_conns(rng, n_limbs=19, k=8, density=0.5):
    """Random but structurally plausible connection sets."""
    slot_a = rng.integers(0, k, (n_limbs, k)).astype(np.int32)
    slot_b = rng.integers(0, k, (n_limbs, k)).astype(np.int32)
    # greedy output has distinct a-slots / b-slots among valid conns per limb
    for l in range(n_limbs):
        slot_a[l] = rng.permutation(k)
        slot_b[l] = rng.permutation(k)
    n_valid = rng.integers(0, k + 1, n_limbs)
    valid = np.zeros((n_limbs, k), bool)
    for l in range(n_limbs):
        valid[l, : n_valid[l]] = True
    score = rng.uniform(0.1, 1.0, (n_limbs, k)).astype(np.float32) * valid
    return Connections(
        slot_a=jnp.asarray(slot_a), slot_b=jnp.asarray(slot_b),
        score=jnp.asarray(score), valid=jnp.asarray(valid))


@pytest.mark.parametrize("seed,k,m", [(s, 8, 16) for s in range(8)]
                         + [(0, 32, 32), (1, 32, 32), (2, 32, 20)])
def test_pallas_merge_matches_xla(seed, k, m):
    rng = np.random.default_rng(seed)
    conns = _random_conns(rng, k=k)
    peak_score = jnp.asarray(
        rng.uniform(0.1, 1.0, (18, k)).astype(np.float32))

    ref = group.assemble(conns, peak_score.reshape(-1), k, m)
    out = assemble_pallas(conns, peak_score, k, m, interpret=True)

    np.testing.assert_array_equal(np.asarray(out.parts), np.asarray(ref.parts))
    np.testing.assert_array_equal(np.asarray(out.count), np.asarray(ref.count))
    # bit-exact: the kernel groups every scalar sub-sum exactly like
    # group.assemble (e.g. score + (b_ps + cscore))
    np.testing.assert_array_equal(np.asarray(out.score), np.asarray(ref.score))


def test_pallas_merge_vmaps(rng):
    k, m, b = 8, 16, 3
    conns = jax.tree.map(
        lambda *xs: jnp.stack(xs),
        *[_random_conns(np.random.default_rng(i), k=k) for i in range(b)])
    peak_score = jnp.asarray(
        rng.uniform(0.1, 1.0, (b, 18, k)).astype(np.float32))
    fn = jax.vmap(functools.partial(assemble_pallas, max_peaks=k,
                                    max_humans=m, interpret=True))
    out = fn(conns, peak_score)
    ref = jax.vmap(functools.partial(group.assemble, max_peaks=k,
                                     max_humans=m))(
        conns, peak_score.reshape(b, -1))
    np.testing.assert_array_equal(np.asarray(out.parts), np.asarray(ref.parts))
