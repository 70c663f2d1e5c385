"""Equivalence of the decoder's lowerings vs plain references.

  * PAF sampling: XLA gather (on the raw and on the upsampled map) vs a
    plain numpy nearest-neighbour sampler
  * upsample+smooth: the fused operator vs the two-stage path
  * subpixel refine: one-hot patch extraction vs scalar taps
  * peak top-k: iterative argmax vs lax.top_k semantics
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from openpose_plus import skeleton
from openpose_plus.postproc import nms, oracle, paf as jpaf


def _numpy_sample(pafm, sy, sx):
    """Nearest-neighbour reads of each limb's (x, y) PAF channels."""
    chans = skeleton.paf_channels_array()
    cx = chans[:, 0][:, None, None, None]
    cy = chans[:, 1][:, None, None, None]
    return pafm[sy, sx, cx], pafm[sy, sx, cy]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("h,w", [(46, 54), (92, 164)])
def test_gather_sampling_matches_numpy(seed, h, w):
    rng = np.random.default_rng(seed)
    pafm = rng.random((h, w, 38), np.float32) - 0.5
    l, s, k = 19, 10, 8
    sy = rng.integers(0, h, (l, s, k, k)).astype(np.int32)
    sx = rng.integers(0, w, (l, s, k, k)).astype(np.int32)
    gx, gy = jax.jit(jpaf._sample_paf_gather)(jnp.asarray(pafm),
                                               jnp.asarray(sy),
                                               jnp.asarray(sx))
    nx, ny = _numpy_sample(pafm, sy, sx)
    np.testing.assert_array_equal(np.asarray(gx), nx)
    np.testing.assert_array_equal(np.asarray(gy), ny)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("factor", [2, 8])
@pytest.mark.parametrize("h,w", [(46, 54),   # net output aspect (wide)
                                 (64, 48),   # tall
                                 (48, 48)])  # square
def test_upsampled_sampling_matches_numpy(seed, factor, h, w):
    """score_candidates' lowres path (nms.upsample + gather) vs numpy NN
    sampling of the oracle's upsample, edge rows/cols included (single-tap
    renormalized weights). The two upsamples agree to float tolerance, as
    in test_postproc_parity.test_preprocess_numerics."""
    rng = np.random.default_rng(seed)
    pafm = rng.random((h, w, 38), np.float32) - 0.5
    hu, wu = h * factor, w * factor
    l, s, k = 19, 10, 8
    sy = rng.integers(0, hu, (l, s, k, k)).astype(np.int32)
    sx = rng.integers(0, wu, (l, s, k, k)).astype(np.int32)
    sy[:, 0, 0, :] = 0
    sy[:, 0, 1, :] = hu - 1
    sx[:, 1, 0, :] = 0
    sx[:, 1, 1, :] = wu - 1
    gx, gy = jax.jit(lambda p, a, b: jpaf._sample_paf_gather(
        nms.upsample(p, factor), a, b))(jnp.asarray(pafm), jnp.asarray(sy),
                                        jnp.asarray(sx))
    nx, ny = _numpy_sample(oracle.upsample_maps(pafm, factor), sy, sx)
    np.testing.assert_allclose(np.asarray(gx), nx, atol=2e-6)
    np.testing.assert_allclose(np.asarray(gy), ny, atol=2e-6)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("factor,sigma", [(2, 1.25), (8, 5.0), (2, 0.0)])
def test_fused_upsample_smooth_matches_sequential(seed, factor, sigma):
    """upsample_smooth == gaussian_smooth(upsample(x)) to a few ulp (the
    composed float64 operator associates differently than the two-stage
    f32 path; both are ~1-ulp faithful). Also checks the refine path is
    unperturbed: one-hot patch selection is exact under any reduction."""
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.random((46, 54, 19), np.float32))
    seq = nms.gaussian_smooth(nms.upsample(x, factor), sigma)
    fused = jax.jit(lambda m: nms.upsample_smooth(m, factor, sigma))(x)
    assert fused.shape == seq.shape
    np.testing.assert_allclose(np.asarray(fused), np.asarray(seq),
                               atol=5e-7)


@pytest.mark.parametrize("seed", [0, 1])
def test_subpixel_refine_matches_scalar_taps(seed):
    """One-hot patch extraction reproduces direct scalar indexing exactly
    (selection products are 1.0*v / 0.0*v — exact under FMA too)."""
    rng = np.random.default_rng(seed)
    h, w, p, k = 92, 164, 18, 16
    maps = jnp.asarray(rng.random((h, w, p), np.float32))
    y = rng.integers(0, h, (p, k)).astype(np.int32)
    x = rng.integers(0, w, (p, k)).astype(np.int32)
    y[:, 0] = 0; y[:, 1] = h - 1; x[:, 2] = 0; x[:, 3] = w - 1  # borders
    ry, rx = jax.jit(nms._subpixel_refine)(maps, jnp.asarray(y),
                                           jnp.asarray(x))
    m = np.asarray(maps)

    def offset(c, prev, nxt):
        den = 2.0 * np.float32(c) - np.float32(nxt) - np.float32(prev)
        if abs(den) <= 1e-6:
            return np.float32(0.0)
        return np.clip(np.float32(0.5) * (np.float32(nxt)
                                          - np.float32(prev)) / den,
                       -0.5, 0.5)

    for pi in range(p):
        for ki in range(k):
            yy, xx = int(y[pi, ki]), int(x[pi, ki])
            ox = offset(m[yy, xx, pi], m[yy, max(xx - 1, 0), pi],
                        m[yy, min(xx + 1, w - 1), pi])
            oy = offset(m[yy, xx, pi], m[max(yy - 1, 0), xx, pi],
                        m[min(yy + 1, h - 1), xx, pi])
            if not (0 < xx < w - 1):
                ox = np.float32(0.0)
            if not (0 < yy < h - 1):
                oy = np.float32(0.0)
            np.testing.assert_allclose(float(rx[pi, ki]), xx + ox,
                                       rtol=0, atol=1e-6)
            np.testing.assert_allclose(float(ry[pi, ki]), yy + oy,
                                       rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_topk_iterative_matches_lax_topk(seed):
    rng = np.random.default_rng(seed)
    flat = rng.random((18, 1000)).astype(np.float32)
    # inject plateaus (exact ties) and sub-threshold rows
    flat[3, 100] = flat[3, 500] = flat[3, 700] = 0.9
    flat[5, :] = -np.inf
    flat[7, 10:14] = 0.95
    flat = jnp.asarray(flat)
    k = 16
    s_ref, i_ref = jax.jit(lambda f: jax.lax.top_k(f, k))(flat)
    s_it, i_it = jax.jit(lambda f: nms._topk_iterative(f, k))(flat)
    finite = np.isfinite(np.asarray(s_ref))
    np.testing.assert_array_equal(np.asarray(s_ref)[finite],
                                  np.asarray(s_it)[finite])
    np.testing.assert_array_equal(np.asarray(i_ref)[finite],
                                  np.asarray(i_it)[finite])
    # -inf slots: scores agree (index may differ; consumers mask on score)
    np.testing.assert_array_equal(np.asarray(s_ref), np.asarray(s_it))
