"""Fragment-merge repair pass (postproc/decode.py ::
_merge_fragments_single): bottom-up PAF assembly structurally fragments
truncated people (visible parts = disconnected limb subgraph); the pass
greedily re-joins disjoint-part skeletons that sit closer than
rel x the larger fragment's bbox diagonal."""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from openpose_plus.postproc.decode import _merge_fragments_single

W, H = 432, 368
M = 8


def _mk(rows):
    """rows: list of dicts {parts: {idx: (x_px, y_px)}, score}."""
    coords = np.zeros((M, 18, 2), np.float32)
    ps = np.zeros((M, 18), np.float32)
    pv = np.zeros((M, 18), bool)
    sc = np.zeros((M,), np.float32)
    cnt = np.zeros((M,), np.int32)
    for i, r in enumerate(rows):
        for p, (x, y) in r["parts"].items():
            coords[i, p] = (x / W, y / H)
            pv[i, p] = True
            ps[i, p] = r.get("score", 1.0)
        sc[i] = r.get("score", 1.0)
        cnt[i] = len(r["parts"])
    return coords, ps, pv, sc, cnt


def _merge(rows, rel=0.5, rounds=8):
    args = tuple(jnp.asarray(a) for a in _mk(rows))
    fn = jax.jit(functools.partial(_merge_fragments_single, w=W, h=H,
                                   rel_threshold=rel, rounds=rounds))
    return [np.asarray(x) for x in fn(*args)]


def test_two_fragments_merge():
    """Head cluster + nearby leg cluster (disjoint parts) -> one person."""
    head = {0: (200, 80), 14: (185, 60), 15: (215, 60)}       # nose, eyes
    legs = {9: (195, 115), 10: (195, 185), 12: (215, 115)}    # knees/ankle
    coords, ps, pv, sc, cnt = _merge([
        dict(parts=head, score=0.9), dict(parts=legs, score=0.7)])
    assert cnt[0] == 6 and cnt[1] == 0
    assert pv[0].sum() == 6 and not pv[1].any()
    # weighted mean score
    assert np.isclose(sc[0], (0.9 * 3 + 0.7 * 3) / 6)
    # absorbed coords preserved
    assert np.isclose(coords[0, 9, 0] * W, 195)
    # geometry sits just inside the frozen rule: min part distance ~35 px
    # vs legs diag ~73 px -> rel ~0.49 < 0.5


def test_far_people_do_not_merge():
    a = {0: (50, 80), 14: (45, 70), 15: (55, 70)}
    b = {0: (380, 80), 14: (375, 70), 15: (385, 70)}
    _, _, _, _, cnt = _merge([dict(parts=a), dict(parts=b)])
    assert cnt[0] == 3 and cnt[1] == 3


def test_shared_parts_never_merge():
    """Rows sharing any part are competing hypotheses, not fragments."""
    a = {0: (200, 80), 1: (200, 100)}
    b = {0: (205, 82), 9: (195, 150)}
    _, _, _, _, cnt = _merge([dict(parts=a), dict(parts=b)])
    assert cnt[0] == 2 and cnt[1] == 2


def test_chain_merge_three_fragments():
    """A person split into 3 components joins over multiple rounds."""
    head = {0: (170, 60), 14: (230, 60)}
    torso = {2: (170, 100), 5: (230, 100)}
    legs = {9: (170, 150), 12: (230, 150)}
    # rel=1.0: the chain MECHANICS are under test (threshold semantics are
    # covered by the two-fragment / far-people tests)
    _, _, pv, _, cnt = _merge([dict(parts=head), dict(parts=torso),
                               dict(parts=legs)], rel=1.0)
    live = cnt > 0
    assert live.sum() == 1
    assert cnt[live.argmax()] == 6 and pv[live.argmax()].sum() == 6


def test_rel_zero_disables_in_decode():
    """PostprocConfig.fragment_merge_rel=0 keeps the decode graph
    unchanged (reference parity): decode_maps traces without the pass."""
    from openpose_plus.config import PostprocConfig
    from openpose_plus.postproc import decode_maps

    cfg = PostprocConfig(max_peaks=4, max_humans=4, upsample_factor=1)
    conf = np.zeros((1, 16, 16, 19), np.float32)
    paf = np.zeros((1, 16, 16, 38), np.float32)
    out = decode_maps(jnp.asarray(conf), jnp.asarray(paf), cfg)
    assert int(out.num_humans[0]) == 0


def test_merge_inside_decode_jit():
    """The pass traces inside the jitted batched decoder."""
    import dataclasses

    from openpose_plus.config import PostprocConfig
    from openpose_plus.postproc import build_decoder

    cfg = dataclasses.replace(
        PostprocConfig(max_peaks=4, max_humans=4, upsample_factor=1),
        fragment_merge_rel=0.5)
    dec = build_decoder(cfg)
    conf = np.zeros((2, 16, 16, 19), np.float32)
    paf = np.zeros((2, 16, 16, 38), np.float32)
    out = dec(jnp.asarray(conf), jnp.asarray(paf))
    assert out.coords.shape == (2, 4, 18, 2)


def test_quality_preset():
    """quality() = fidelity() + the frozen fragment-merge threshold."""
    from openpose_plus.config import PostprocConfig

    q = PostprocConfig().quality()
    f = PostprocConfig().fidelity()
    assert q.fragment_merge_rel == 0.5
    assert (q.max_peaks, q.upsample_factor, q.smooth_sigma) == \
        (f.max_peaks, f.upsample_factor, f.smooth_sigma)
    q4 = PostprocConfig().quality(upsample=4)
    assert q4.upsample_factor == 4
