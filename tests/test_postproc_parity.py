"""Exact-parity tests: JAX fixed-shape decoder vs the numpy oracle.

The oracle (postproc/oracle.py) is a faithful sequential implementation of
the reference grouping algorithm; the JAX pipeline must reproduce it exactly
(same peaks, same greedy order, same merge) on every input here — including
pure-noise maps that stress tie-breaks and conflicts.
"""

import dataclasses

import numpy as np
import pytest

from openpose_plus import skeleton
from openpose_plus.config import PostprocConfig
from openpose_plus.postproc import decode, nms, oracle, paf as jpaf

from openpose_plus.data import scenes

CFG = PostprocConfig(upsample_factor=2, smooth_sigma=1.0, max_peaks=16,
                     max_humans=32)


_PREP_CACHE = {}


def _prep(conf, paf_map, cfg):
    """Shared preprocessing (jitted JAX): both sides consume these floats.

    Peak detection compares floats for equality on plateaus, so the oracle
    must see bit-identical maps; oracle-vs-JAX preprocessing numerics are
    covered by test_preprocess_numerics instead.
    """
    import functools
    import jax
    if cfg not in _PREP_CACHE:
        _PREP_CACHE[cfg] = jax.jit(
            functools.partial(decode.preprocess_single, cfg=cfg))
    smoothed, paf_u = _PREP_CACHE[cfg](conf, paf_map)
    return np.asarray(smoothed), np.asarray(paf_u)


def test_preprocess_numerics():
    """Oracle upsample+smooth matches the JAX version to float tolerance."""
    conf, paf_map = _scene(noise=0.1, seed=7)
    smoothed_j, paf_u_j = _prep(conf, paf_map, CFG)
    conf_u_o = oracle.upsample_maps(conf, CFG.upsample_factor)
    paf_u_o = oracle.upsample_maps(paf_map, CFG.upsample_factor)
    smoothed_o = oracle.smooth_maps(conf_u_o, CFG.smooth_sigma)
    np.testing.assert_allclose(smoothed_j, smoothed_o, atol=2e-6)
    np.testing.assert_allclose(paf_u_j, paf_u_o, atol=2e-6)


def _scene(noise=0.0, seed=0, n_people=2):
    # Fractional centers: integer-grid keypoints create perfectly symmetric
    # Gaussians whose upsampled maxima are exact 2-pixel plateaus; the
    # lexicographic tie-break (one peak per plateau, lowest flat index)
    # must agree between both implementations either way, but fractional
    # centers also exercise the no-tie path.
    people = [scenes.standing_person(12.3 + 14.6 * i, 20.2, 0.9 + 0.11 * i)
              for i in range(n_people)]
    return scenes.make_maps(people, 46, 54, noise=noise, seed=seed)


# ---------------------------------------------------------------- peaks ---

def test_plateau_dedup():
    """Exactly symmetric inputs (integer-grid keypoints -> exact 2x2
    upsample plateaus) yield ONE peak per plateau, at the lowest flat
    index, identically in oracle and JAX. Regression: without the
    lexicographic tie-break every plateau pixel became a separate peak,
    saturating top-k and fragmenting assembly."""
    people = [scenes.standing_person(10, 8), scenes.standing_person(10, 30)]
    conf, paf_map = scenes.make_maps(people, 46, 54)
    smoothed, _ = _prep(conf, paf_map, CFG)
    o = oracle.find_peaks(smoothed, CFG.peak_threshold, CFG.max_peaks)
    j = nms.find_peaks(np.asarray(smoothed), CFG.peak_threshold,
                       CFG.max_peaks)
    total = int(np.asarray(j.valid).sum())
    assert total == 2 * skeleton.N_PARTS, total  # one peak per part/person
    for part in range(skeleton.N_PARTS):
        n = len(o.scores[part])
        assert int(np.asarray(j.valid)[part].sum()) == n
        np.testing.assert_array_equal(np.asarray(j.y)[part, :n], o.ys[part])
        np.testing.assert_array_equal(np.asarray(j.x)[part, :n], o.xs[part])


@pytest.mark.parametrize("noise,seed", [(0.0, 0), (0.05, 1), (0.2, 2)])
def test_peak_parity(noise, seed):
    conf, paf_map = _scene(noise=noise, seed=seed)
    smoothed, _ = _prep(conf, paf_map, CFG)

    o = oracle.find_peaks(smoothed, CFG.peak_threshold, CFG.max_peaks)
    j = nms.find_peaks(np.asarray(smoothed), CFG.peak_threshold, CFG.max_peaks)
    jy, jx = np.asarray(j.y), np.asarray(j.x)
    jscore, jvalid = np.asarray(j.score), np.asarray(j.valid)

    for part in range(skeleton.N_PARTS):
        n = len(o.scores[part])
        assert int(jvalid[part].sum()) == n, f"part {part} peak count"
        np.testing.assert_array_equal(jy[part, :n], o.ys[part])
        np.testing.assert_array_equal(jx[part, :n], o.xs[part])
        np.testing.assert_allclose(jscore[part, :n], o.scores[part],
                                   rtol=0, atol=1e-5)


# ----------------------------------------------------- candidate scoring ---

def test_candidate_and_greedy_parity():
    conf, paf_map = _scene(noise=0.1, seed=3, n_people=3)
    smoothed, paf_u = _prep(conf, paf_map, CFG)

    o_peaks = oracle.find_peaks(smoothed, CFG.peak_threshold, CFG.max_peaks)
    j_peaks = nms.find_peaks(np.asarray(smoothed), CFG.peak_threshold,
                             CFG.max_peaks)
    j_scores = np.asarray(jpaf.score_candidates(
        np.asarray(paf_u), j_peaks, CFG.paf_n_samples,
        CFG.paf_sample_threshold, CFG.paf_inlier_ratio))
    conns = jpaf.greedy_assign(j_scores, CFG.max_peaks)

    for limb in range(skeleton.N_LIMBS):
        ia, ib = skeleton.COCO_PAIRS[limb]
        cands = oracle.score_limb_candidates(
            paf_u, o_peaks, limb, CFG.paf_n_samples,
            CFG.paf_sample_threshold, CFG.paf_inlier_ratio)
        # dense score grid must match the oracle's valid candidate list
        dense = {(sa, sb): s for sa, sb, s in cands}
        for sa in range(len(o_peaks.scores[ia])):
            for sb in range(len(o_peaks.scores[ib])):
                js = j_scores[limb, sa, sb]
                if (sa, sb) in dense:
                    np.testing.assert_allclose(js, dense[(sa, sb)], atol=1e-4)
                else:
                    assert js == -np.inf, (limb, sa, sb, js)
        # greedy acceptance order must match
        accepted = oracle.greedy_assign(
            cands, len(o_peaks.scores[ia]), len(o_peaks.scores[ib]))
        jvalid = np.asarray(conns.valid[limb])
        jsa = np.asarray(conns.slot_a[limb])
        jsb = np.asarray(conns.slot_b[limb])
        jsc = np.asarray(conns.score[limb])
        assert int(jvalid.sum()) == len(accepted), f"limb {limb}"
        for t, (sa, sb, s) in enumerate(accepted):
            assert jsa[t] == sa and jsb[t] == sb, (limb, t)
            np.testing.assert_allclose(jsc[t], s, atol=1e-4)


# -------------------------------------------------------------- end2end ---

_DECODER_CACHE = {}


def _decode_both(conf, paf_map, cfg):
    smoothed, paf_u = _prep(conf, paf_map, cfg)
    o_humans = oracle.decode_oracle(smoothed, paf_u, cfg, preprocessed=True)
    if cfg not in _DECODER_CACHE:
        _DECODER_CACHE[cfg] = decode.build_decoder(cfg)
    batch = _DECODER_CACHE[cfg](conf[None], paf_map[None])
    return o_humans, batch


def _jax_humans(batch):
    out = []
    valid = np.asarray(batch.valid[0])
    for m in range(valid.shape[0]):
        if not valid[m]:
            continue
        pv = np.asarray(batch.part_valid[0, m])
        coords = np.asarray(batch.coords[0, m])
        scores = np.asarray(batch.part_scores[0, m])
        parts = {p: (coords[p, 0], coords[p, 1], scores[p])
                 for p in range(skeleton.N_PARTS) if pv[p]}
        out.append((parts, float(np.asarray(batch.score[0, m])),
                    int(np.asarray(batch.n_parts[0, m]))))
    return out


def _assert_same_humans(o_humans, j_humans):
    assert len(o_humans) == len(j_humans), (
        f"human count: oracle {len(o_humans)} vs jax {len(j_humans)}")
    unmatched = list(range(len(j_humans)))
    for oh in o_humans:
        omean = oh.score / oh.n_parts
        hit = None
        for i in unmatched:
            parts, score, cnt = j_humans[i]
            if cnt != oh.n_parts or set(parts) != set(oh.parts):
                continue
            if abs(score - omean) > 1e-3:
                continue
            ok = all(
                abs(parts[p][0] - oh.parts[p][0]) < 1e-3
                and abs(parts[p][1] - oh.parts[p][1]) < 1e-3
                and abs(parts[p][2] - oh.parts[p][2]) < 1e-3
                for p in oh.parts)
            if ok:
                hit = i
                break
        assert hit is not None, f"no JAX match for oracle human {oh}"
        unmatched.remove(hit)


@pytest.mark.parametrize("n_people", [1, 2, 3])
def test_decode_parity_clean(n_people):
    conf, paf_map = _scene(n_people=n_people)
    o_humans, batch = _decode_both(conf, paf_map, CFG)
    # Each person must produce a dominant skeleton (the grouping may split
    # off small fragments on synthetic PAFs — that is algorithm behavior,
    # and parity below still has to hold on it exactly).
    assert sum(1 for h in o_humans if h.n_parts >= 8) >= n_people
    _assert_same_humans(o_humans, _jax_humans(batch))


@pytest.mark.parametrize("seed", range(5))
def test_decode_parity_noisy(seed):
    conf, paf_map = _scene(noise=0.15, seed=seed, n_people=3)
    o_humans, batch = _decode_both(conf, paf_map, CFG)
    _assert_same_humans(o_humans, _jax_humans(batch))


@pytest.mark.parametrize("seed", range(5))
def test_decode_parity_pure_noise(seed):
    """Pure noise: spurious peaks everywhere, stresses ties and conflicts."""
    rng = np.random.default_rng(seed + 100)
    conf = rng.uniform(0, 0.4, (46, 54, 19)).astype(np.float32)
    paf_map = rng.uniform(-1, 1, (46, 54, 38)).astype(np.float32)
    cfg = dataclasses.replace(CFG, upsample_factor=1, smooth_sigma=0.0)
    o_humans, batch = _decode_both(conf, paf_map, cfg)
    _assert_same_humans(o_humans, _jax_humans(batch))


def test_empty_maps():
    conf = np.zeros((46, 54, 19), np.float32)
    paf_map = np.zeros((46, 54, 38), np.float32)
    o_humans, batch = _decode_both(conf, paf_map, CFG)
    assert len(o_humans) == 0
    assert int(np.asarray(batch.valid).sum()) == 0
