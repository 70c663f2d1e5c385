"""PAF line-integral limb scoring + greedy bipartite assignment, on-device.

Replacement for the candidate-generation/scoring/assignment part
of the reference grouping (src/paf.cpp connection scoring; Python estimator
equivalent [MED names; empty mount — SURVEY.md §2]). All limbs and all K x K
peak-pair candidates are scored densely in one fused computation (VPU-friendly
gathers, no data-dependent shapes); the greedy assignment is expressed as
max_peaks iterations of masked argmax, which is exactly equivalent to the
reference's scan-sorted-candidates-and-skip-conflicts greedy order.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from openpose_plus import skeleton
from openpose_plus.postproc import common
from openpose_plus.postproc import nms
from openpose_plus.postproc.nms import PeakSet
from openpose_plus.utils.pytree import pytree_dataclass


@pytree_dataclass
class Connections:
    """Accepted limb connections for one image, in greedy-accept order.

    Slot t of limb l is the t-th accepted connection (or invalid).
    """

    slot_a: jax.Array  # (n_limbs, K) int32 peak slot of endpoint A
    slot_b: jax.Array  # (n_limbs, K) int32 peak slot of endpoint B
    score: jax.Array   # (n_limbs, K) float32 prior-adjusted limb score
    valid: jax.Array   # (n_limbs, K) bool


def _sample_paf_gather(paf: jax.Array, sy: jax.Array, sx: jax.Array
                       ) -> tuple[jax.Array, jax.Array]:
    """NN-sample both PAF channels of every limb at (L, S, K, K) integer
    coords via XLA gather."""
    h, w = paf.shape[0], paf.shape[1]
    chans = jnp.asarray(skeleton.paf_channels_array())   # (L, 2)
    flat_idx = sy * w + sx                               # (L, S, K, K)
    paf_flat = paf.reshape(h * w, paf.shape[2])          # (HW, 38)
    px = jax.vmap(lambda idx, c: paf_flat[:, c][idx])(flat_idx, chans[:, 0])
    py = jax.vmap(lambda idx, c: paf_flat[:, c][idx])(flat_idx, chans[:, 1])
    return px, py


def score_candidates(paf: jax.Array, peaks: PeakSet, n_samples: int,
                     sample_threshold: float, inlier_ratio: float,
                     lowres_factor: int = 1) -> jax.Array:
    """Dense candidate scores, (n_limbs, K, K); invalid pairs -> -inf.

    Nearest-neighbor PAF sampling at `n_samples` points along each segment
    (reference convention), mean dot with the unit limb direction, height
    prior penalty, >=ceil(ratio*n) inlier samples above sample_threshold.

    With `lowres_factor > 1`, `paf` is the RAW network-resolution map and
    peak coords live on the `lowres_factor`-upsampled grid; the map is
    upsampled (nms.upsample) and sampled by gather.
    """
    paf = jnp.asarray(paf)
    h = paf.shape[0] * lowres_factor
    w = paf.shape[1] * lowres_factor
    pairs = jnp.asarray(skeleton.pairs_array())          # (L, 2)
    fracs = jnp.asarray(common.line_sample_fracs(n_samples))  # (S,)

    ax = peaks.x[pairs[:, 0]].astype(jnp.float32)  # (L, K)
    ay = peaks.y[pairs[:, 0]].astype(jnp.float32)
    bx = peaks.x[pairs[:, 1]].astype(jnp.float32)
    by = peaks.y[pairs[:, 1]].astype(jnp.float32)
    va = peaks.valid[pairs[:, 0]]
    vb = peaks.valid[pairs[:, 1]]

    dx = bx[:, None, :] - ax[:, :, None]   # (L, K, K)
    dy = by[:, None, :] - ay[:, :, None]
    dist = jnp.maximum(jnp.sqrt(dx * dx + dy * dy), 1e-4)
    ux, uy = dx / dist, dy / dist

    # Sample points: (L, S, K, K) integer coords.
    sx = jnp.round(ax[:, None, :, None]
                   + fracs[None, :, None, None] * dx[:, None]).astype(jnp.int32)
    sy = jnp.round(ay[:, None, :, None]
                   + fracs[None, :, None, None] * dy[:, None]).astype(jnp.int32)

    px, py = _sample_paf_gather(nms.upsample(paf, lowres_factor), sy, sx)

    dots = px * ux[:, None] + py * uy[:, None]                # (L, S, K, K)
    mean_dot = jnp.mean(dots, axis=1)
    inliers = jnp.sum(dots > sample_threshold, axis=1)
    prior = jnp.minimum(0.5 * h / dist - 1.0, 0.0)
    score = mean_dot + prior

    min_inliers = int(np.ceil(inlier_ratio * n_samples))
    ok = ((inliers >= min_inliers) & (score > 0)
          & va[:, :, None] & vb[:, None, :])
    return jnp.where(ok, score, -jnp.inf)


def greedy_assign(scores: jax.Array, max_peaks: int) -> Connections:
    """Greedy best-first assignment per limb via iterated masked argmax.

    Iteration t takes the global max over remaining candidates (ties ->
    lowest row-major (slot_a, slot_b) index, matching the oracle's stable
    sort) and masks its row and column; equivalent to scanning candidates in
    descending-score order and skipping used endpoints.
    """
    n_limbs, k, _ = scores.shape
    if k != max_peaks:
        raise ValueError(f"scores K={k} != max_peaks={max_peaks}")

    def per_limb(limb_scores):
        def body(t, carry):
            remaining, sa, sb, sc, ok = carry
            flat = remaining.reshape(-1)
            j = jnp.argmax(flat)
            best = flat[j]
            valid = best > -jnp.inf
            ja, jb = j // k, j % k
            remaining = jnp.where(
                valid,
                remaining.at[ja, :].set(-jnp.inf).at[:, jb].set(-jnp.inf),
                remaining)
            sa = sa.at[t].set(jnp.where(valid, ja, 0).astype(jnp.int32))
            sb = sb.at[t].set(jnp.where(valid, jb, 0).astype(jnp.int32))
            sc = sc.at[t].set(jnp.where(valid, best, 0.0))
            ok = ok.at[t].set(valid)
            return remaining, sa, sb, sc, ok

        init = (limb_scores,
                jnp.zeros((k,), jnp.int32), jnp.zeros((k,), jnp.int32),
                jnp.zeros((k,), jnp.float32), jnp.zeros((k,), bool))
        _, sa, sb, sc, ok = jax.lax.fori_loop(0, k, body, init)
        return sa, sb, sc, ok

    sa, sb, sc, ok = jax.vmap(per_limb)(scores)
    return Connections(slot_a=sa, slot_b=sb, score=sc, valid=ok)
