"""Shared numerics for the numpy oracle and the JAX grouping pipeline.

Both implementations must use bit-identical kernel weights and sampling
conventions or the parity tests cannot be exact, so every shared constant
lives here (host-side numpy; the JAX side converts once at trace time).
"""

from __future__ import annotations

import numpy as np


def gaussian_kernel_1d(sigma: float) -> np.ndarray:
    """Truncated, normalized 1-D Gaussian (radius = ceil(3*sigma)).

    Used to smooth heatmaps before peak NMS, matching the reference's
    gaussian_filter step (openpose_plus/inference estimator smoothing
    [MED]); applied separably with zero padding in both implementations.
    """
    if sigma <= 0:
        return np.ones((1,), dtype=np.float32)
    radius = int(np.ceil(3.0 * sigma))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k /= k.sum()
    return k.astype(np.float32)


def line_sample_fracs(n_samples: int) -> np.ndarray:
    """Interpolation fractions t for the PAF line integral.

    The reference samples `n` evenly spaced points from endpoint A to
    endpoint B inclusive (CMU-style np.linspace(0, 1, n)); PAF values are
    read with nearest-integer rounding, not bilinear, matching src/paf.cpp
    [MED] / the CMU python round().
    """
    return np.linspace(0.0, 1.0, n_samples).astype(np.float32)


def limb_score_with_prior(mean_dot: float | np.ndarray,
                          dist: float | np.ndarray,
                          map_height: int) -> np.ndarray:
    """Candidate-limb ranking score: mean PAF dot + height prior penalty.

    score = mean_dot + min(0.5 * H / dist - 1, 0) — penalizes limbs longer
    than half the map height (reference: score_with_dist_prior in the CMU
    grouping; same formula in src/paf.cpp [MED]).
    """
    dist = np.maximum(dist, 1e-4)
    prior = np.minimum(0.5 * map_height / dist - 1.0, 0.0)
    return mean_dot + prior


def refine_peak_1d(center: np.ndarray, prev: np.ndarray, nxt: np.ndarray) -> np.ndarray:
    """Quadratic subpixel offset in [-0.5, 0.5] from 3 samples along an axis.

    offset = 0.5 * (next - prev) / (2*center - next - prev); zero when the
    parabola is degenerate. Applied identically by oracle and JAX decoder.
    """
    denom = 2.0 * center - nxt - prev
    off = np.where(np.abs(denom) > 1e-6, 0.5 * (nxt - prev) / denom, 0.0)
    return np.clip(off, -0.5, 0.5)
