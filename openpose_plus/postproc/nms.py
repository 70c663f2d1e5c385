"""Heatmap peak detection on-device: upsample -> smooth -> NMS -> top-K.

Replacement for the reference's get_peak_map / smoothed-NMS stage
(src/paf.cpp :: get_peak_map and the Python estimator's gaussian_filter +
local-max [MED file names; empty mount — SURVEY.md]). Everything is static
shape: each part channel keeps its top `max_peaks` peaks, invalid slots are
masked, and the whole stage jit-compiles and vmaps over the batch.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from openpose_plus import skeleton
from openpose_plus.postproc import common
from openpose_plus.utils.pytree import pytree_dataclass


@pytree_dataclass
class PeakSet:
    """Top-K peaks per part for one image (map-resolution coordinates)."""

    y: jax.Array          # (n_parts, K) int32 row coord
    x: jax.Array          # (n_parts, K) int32 col coord
    score: jax.Array      # (n_parts, K) float32 heatmap value at peak
    valid: jax.Array      # (n_parts, K) bool
    refined_y: jax.Array  # (n_parts, K) float32 subpixel row coord
    refined_x: jax.Array  # (n_parts, K) float32 subpixel col coord


def upsample(maps: jax.Array, factor: int) -> jax.Array:
    """Bilinear upsample (H, W, C) by an integer factor (half-pixel centers,
    matching oracle.upsample_maps / the reference's ~8x resize)."""
    if factor == 1:
        return maps
    h, w, c = maps.shape
    return jax.image.resize(maps, (h * factor, w * factor, c), method="linear")


@functools.lru_cache(maxsize=None)
def _upsample_smooth_matrix(n_in: int, factor: int, sigma: float
                            ) -> "np.ndarray":
    """(n_in*factor, n_in) combined operator: bilinear resize (half-pixel
    centers, jax.image.resize weight convention incl. edge renormalization)
    followed by zero-padded Gaussian blur — composed in float64."""
    import numpy as np

    n_out = n_in * factor
    src = (np.arange(n_out, dtype=np.float64) + 0.5) / factor - 0.5
    i0 = np.floor(src).astype(np.int64)
    d = src - i0
    r = np.zeros((n_out, n_in), dtype=np.float64)
    for tap, wt in ((i0, 1.0 - d), (i0 + 1, d)):
        ok = (tap >= 0) & (tap < n_in)
        r[np.arange(n_out)[ok], tap[ok]] += wt[ok]
    r /= r.sum(axis=1, keepdims=True)  # edge single-tap renormalization
    k = common.gaussian_kernel_1d(sigma).astype(np.float64)
    if k.size > 1:
        rad = k.size // 2
        g = np.zeros((n_out, n_out), dtype=np.float64)
        for j, kv in enumerate(k):
            off = j - rad
            idx = np.arange(max(0, -off), min(n_out, n_out - off))
            g[idx, idx + off] = kv
        r = g @ r
    return r.astype(np.float32)


def upsample_smooth(maps: jax.Array, factor: int, sigma: float) -> jax.Array:
    """Fused bilinear-upsample + Gaussian-smooth of (H, W, C) maps.

    Both stages are separable linear operators, so their composition is one
    (H*f, H) x (W*f, W) pair of per-axis contractions: the upsampled map is
    never materialized and the two conv passes disappear. Equals
    upsample+gaussian_smooth to ~1 ulp (composed in float64, applied at
    HIGHEST; association differs so FMA rounding differs in the last bit).
    preprocess_single feeds the oracle these exact floats, so peak-plateau
    parity is unaffected.
    """
    ay = jnp.asarray(_upsample_smooth_matrix(maps.shape[0], factor, sigma))
    ax = jnp.asarray(_upsample_smooth_matrix(maps.shape[1], factor, sigma))
    prec = jax.lax.Precision.HIGHEST
    t = jnp.einsum("Yh,hwc->Ywc", ay, maps, precision=prec)
    return jnp.einsum("Xw,Ywc->YXc", ax, t, precision=prec)


def gaussian_smooth(maps: jax.Array, sigma: float) -> jax.Array:
    """Separable zero-padded Gaussian blur over (H, W, C)."""
    k = common.gaussian_kernel_1d(sigma)
    if k.size == 1:
        return maps
    c = maps.shape[-1]
    kern = jnp.asarray(k)
    x = maps[None]  # NHWC
    # depthwise separable: rows then cols
    krow = jnp.tile(kern.reshape(k.size, 1, 1, 1), (1, 1, 1, c))
    kcol = jnp.tile(kern.reshape(1, k.size, 1, 1), (1, 1, 1, c))
    dn = jax.lax.conv_dimension_numbers(x.shape, krow.shape,
                                        ("NHWC", "HWIO", "NHWC"))
    r = k.size // 2
    # HIGHEST precision: the default conv path multiplies in reduced
    # precision (bf16-class) which breaks bit-parity with the numpy oracle;
    # this kernel is tiny so exact f32 costs nothing.
    x = jax.lax.conv_general_dilated(
        x, krow, (1, 1), [(r, r), (0, 0)], dimension_numbers=dn,
        feature_group_count=c, precision=jax.lax.Precision.HIGHEST)
    x = jax.lax.conv_general_dilated(
        x, kcol, (1, 1), [(0, 0), (r, r)], dimension_numbers=dn,
        feature_group_count=c, precision=jax.lax.Precision.HIGHEST)
    return x[0]


def _subpixel_refine(maps: jax.Array, y: jax.Array, x: jax.Array
                     ) -> tuple[jax.Array, jax.Array]:
    """Quadratic 3-tap refinement; zero offset at borders (matches oracle).

    The five taps around each peak are read with factored one-hot
    contractions instead of scalar gathers.
    One-hot selection is EXACT — each product is 1.0*v or 0.0*v, so any
    reduction order (FMA or not) returns v bit-identically, keeping the
    refine equal to the numpy oracle on every backend.

    maps: (h, w, P) part channels; y/x: (P, K) int32 peak coords.
    """
    h, w = maps.shape[0], maps.shape[1]
    d3 = jnp.arange(-1, 2)
    ry = jnp.clip(y[:, :, None] + d3, 0, h - 1)           # (P, K, 3)
    rx = jnp.clip(x[:, :, None] + d3, 0, w - 1)
    oy_sel = (ry[..., None] == jnp.arange(h)).astype(jnp.bfloat16)
    ox_sel = (rx[..., None] == jnp.arange(w)).astype(jnp.bfloat16)
    m = jnp.moveaxis(maps, -1, 0)                         # (P, h, w)
    prec = jax.lax.Precision.HIGHEST
    u = jnp.einsum("pkah,phw->pkaw", oy_sel, m, precision=prec,
                   preferred_element_type=jnp.float32)
    patch = jnp.einsum("pkaw,pkbw->pkab", u, ox_sel, precision=prec,
                       preferred_element_type=jnp.float32)  # (P, K, 3, 3)

    def axis_offset(center, prev, nxt):
        denom = 2.0 * center - nxt - prev
        off = jnp.where(jnp.abs(denom) > 1e-6, 0.5 * (nxt - prev) / denom, 0.0)
        return jnp.clip(off, -0.5, 0.5)

    c = patch[..., 1, 1]
    ox = axis_offset(c, patch[..., 1, 0], patch[..., 1, 2])
    oy = axis_offset(c, patch[..., 0, 1], patch[..., 2, 1])
    ox = jnp.where((x > 0) & (x < w - 1), ox, 0.0)
    oy = jnp.where((y > 0) & (y < h - 1), oy, 0.0)
    return y.astype(jnp.float32) + oy, x.astype(jnp.float32) + ox


def _topk_iterative(flat: jax.Array, k: int) -> tuple[jax.Array, jax.Array]:
    """Exact top-k via k rounds of (argmax, mask) — (P, N) -> (P, k).

    Matches lax.top_k ordering for all slots with finite scores: descending
    value, ties broken by ascending index (argmax returns the lowest index
    of the max). Exhausted slots (-inf) repeat
    index 0 where top_k would return distinct indices, but every consumer
    masks those slots via `score > threshold` first.
    """
    n = flat.shape[-1]
    iota = jnp.arange(n)[None, :]

    def body(t, carry):
        rem, scores, idxs = carry
        j = jnp.argmax(rem, axis=-1)
        s = jnp.max(rem, axis=-1)
        scores = scores.at[:, t].set(s)
        idxs = idxs.at[:, t].set(j.astype(jnp.int32))
        rem = jnp.where(iota == j[:, None], -jnp.inf, rem)
        return rem, scores, idxs

    p = flat.shape[0]
    init = (flat, jnp.zeros((p, k), flat.dtype), jnp.zeros((p, k), jnp.int32))
    _, scores, idxs = jax.lax.fori_loop(0, k, body, init)
    return scores, idxs


def _pool3x3(x: jax.Array) -> jax.Array:
    """3x3 max-pool of (H, W, C) via shifted maxes (-inf padding).

    Identical to reduce_window, written as elementwise maxes so that it
    fuses into the surrounding elementwise ops."""
    p = jnp.pad(x, ((1, 1), (0, 0), (0, 0)), constant_values=-jnp.inf)
    rows = jnp.maximum(jnp.maximum(p[:-2], p[1:-1]), p[2:])
    q = jnp.pad(rows, ((0, 0), (1, 1), (0, 0)), constant_values=-jnp.inf)
    return jnp.maximum(jnp.maximum(q[:, :-2], q[:, 1:-1]), q[:, 2:])


def find_peaks(smoothed: jax.Array, threshold: float, max_peaks: int
               ) -> PeakSet:
    """3x3 local-max NMS + per-part top-K on smoothed (H, W, >=18) maps.

    A pixel is a peak iff it equals the 3x3 max-pool (>= all 8 neighbors
    under -inf padding), is strictly above `threshold`, AND has the lowest
    flat index among equal-valued candidate neighbors (adjacent candidates
    are necessarily exact ties). The tie-break dedups the exact 2x2
    plateaus that symmetric inputs produce after upsampling (without it,
    every plateau pixel became a separate peak); plateaus wider than the
    3x3 window may still keep one representative per window — still
    deterministic and oracle-matched. Ordering is descending score with
    ties broken by ascending flat index (lax.top_k semantics), identical
    to oracle.find_peaks.
    """
    h, w = smoothed.shape[0], smoothed.shape[1]
    parts = smoothed[:, :, : skeleton.N_PARTS]
    pooled = _pool3x3(parts)
    cand = (parts >= pooled) & (parts > threshold)
    # Plateau tie-break. Any candidate adjacent to candidate p has exactly
    # p's value (each is >= the other via their own windows), so keeping
    # u == 3x3-max(u) with u = -flat_index selects the lowest index per
    # plateau. Indices < 2^24 are exact in f32.
    idx_f = jnp.arange(h * w, dtype=jnp.float32).reshape(h, w, 1)
    u = jnp.where(cand, -idx_f, -jnp.inf)
    is_peak = cand & (u >= _pool3x3(u))
    flat = jnp.where(is_peak, parts, -jnp.inf).reshape(h * w, skeleton.N_PARTS)
    flat = flat.T  # (n_parts, H*W)
    score, idx = _topk_iterative(flat, max_peaks)
    valid = score > threshold
    idx = jnp.where(valid, idx, 0)
    y = (idx // w).astype(jnp.int32)
    x = (idx % w).astype(jnp.int32)
    ry, rx = _subpixel_refine(parts, y, x)
    return PeakSet(
        y=y, x=x,
        score=jnp.where(valid, score, 0.0).astype(jnp.float32),
        valid=valid,
        refined_y=ry, refined_x=rx,
    )
