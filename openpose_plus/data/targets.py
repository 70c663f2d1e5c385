"""Ground-truth heatmap + PAF synthesis, vectorized and on-device.

Replaces the reference's per-sample numpy loops (openpose_plus/utils ::
get_heatmap / put_heatmap, get_vectormap / put_vectormap [HIGH behavior;
empty mount — SURVEY.md §2]) — the classic host-side input bottleneck
(SURVEY.md §3.1) — with a jnp implementation that runs inside the jit'd
train step on padded keypoint arrays, so GT synthesis runs on device.

Conventions:
  * keypoints are (x, y, valid) in INPUT pixel coordinates
  * output grids are (hout, wout) at stride s; cell (i, j)'s center sits at
    input coords (j*s + s/2 - 0.5, i*s + s/2 - 0.5)
  * heatmap channel p = max over people of exp(-d^2 / (2 sigma^2)),
    background channel = 1 - max over parts (reference formula)
  * PAF limb l = average over people of the unit limb direction over a band
    of half-width `limb_width` around the segment (count-normalized where
    people overlap, exactly like put_vectormap)

A numpy twin (`*_np`) exists for tests and host-side tools.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from openpose_plus import skeleton
from openpose_plus.config import DataConfig, ModelConfig


def _grid_centers(hout: int, wout: int, stride: int):
    ys = np.arange(hout, dtype=np.float32) * stride + stride / 2 - 0.5
    xs = np.arange(wout, dtype=np.float32) * stride + stride / 2 - 0.5
    return ys, xs


def make_targets(keypoints: jax.Array, hout: int, wout: int, stride: int,
                 sigma: float, limb_width: float
                 ) -> tuple[jax.Array, jax.Array]:
    """GT maps for ONE image from padded keypoints (P, 18, 3).

    Returns (conf (hout, wout, 19), paf (hout, wout, 38)) float32. Invalid
    keypoints (valid <= 0) contribute nothing. vmap over the batch.
    """
    kp = keypoints.astype(jnp.float32)
    kx, ky, kv = kp[..., 0], kp[..., 1], kp[..., 2] > 0   # (P, 18)

    ys, xs = _grid_centers(hout, wout, stride)
    gy = jnp.asarray(ys)[:, None]                          # (hout, 1)
    gx = jnp.asarray(xs)[None, :]                          # (1, wout)

    # ---- heatmaps: max of Gaussians ------------------------------------
    # (P, 18, hout, wout) distances -> max over P
    d2 = ((gx[None, None] - kx[..., None, None]) ** 2
          + (gy[None, None] - ky[..., None, None]) ** 2)
    g = jnp.exp(-d2 / (2.0 * sigma * sigma))
    g = jnp.where(kv[..., None, None], g, 0.0)
    heat = jnp.max(g, axis=0)                              # (18, hout, wout)
    heat = jnp.moveaxis(heat, 0, -1)                       # (hout, wout, 18)
    background = 1.0 - jnp.max(heat, axis=-1, keepdims=True)
    conf = jnp.concatenate([heat, background], axis=-1)

    # ---- PAFs: count-averaged unit vectors in limb bands ---------------
    pairs = skeleton.pairs_array()
    ia, ib = pairs[:, 0], pairs[:, 1]                      # (L,)
    ax, ay = kx[:, ia], ky[:, ia]                          # (P, L)
    bx, by = kx[:, ib], ky[:, ib]
    lv = kv[:, ia] & kv[:, ib]
    dx, dy = bx - ax, by - ay
    norm = jnp.maximum(jnp.sqrt(dx * dx + dy * dy), 1e-4)
    ux, uy = dx / norm, dy / norm

    relx = gx[None, None] - ax[..., None, None]            # (P, L, hout, wout)
    rely = gy[None, None] - ay[..., None, None]
    along = relx * ux[..., None, None] + rely * uy[..., None, None]
    perp = jnp.abs(-relx * uy[..., None, None] + rely * ux[..., None, None])
    band = ((along >= 0) & (along <= norm[..., None, None])
            & (perp <= limb_width) & lv[..., None, None])

    vec_x = jnp.sum(jnp.where(band, ux[..., None, None], 0.0), axis=0)
    vec_y = jnp.sum(jnp.where(band, uy[..., None, None], 0.0), axis=0)
    count = jnp.sum(band, axis=0).astype(jnp.float32)      # (L, hout, wout)
    denom = jnp.maximum(count, 1.0)
    vec_x, vec_y = vec_x / denom, vec_y / denom

    paf = jnp.zeros((hout, wout, skeleton.N_PAF_CHANNELS), jnp.float32)
    chans = skeleton.paf_channels_array()
    paf = paf.at[:, :, chans[:, 0]].set(jnp.moveaxis(vec_x, 0, -1))
    paf = paf.at[:, :, chans[:, 1]].set(jnp.moveaxis(vec_y, 0, -1))
    return conf, paf


def make_targets_batch(keypoints: jax.Array, model_cfg: ModelConfig,
                       data_cfg: DataConfig) -> tuple[jax.Array, jax.Array]:
    """Batched GT synthesis (B, P, 18, 3) -> ((B,h,w,19), (B,h,w,38));
    call inside the jit'd train step."""
    fn = lambda kp: make_targets(
        kp, model_cfg.hout, model_cfg.wout, model_cfg.stride,
        data_cfg.sigma, data_cfg.limb_width)
    return jax.vmap(fn)(keypoints)


# ------------------------------------------------------------------ numpy --

def make_targets_np(keypoints: np.ndarray, hout: int, wout: int, stride: int,
                    sigma: float, limb_width: float
                    ) -> tuple[np.ndarray, np.ndarray]:
    """Reference-style per-person loop twin of make_targets (tests/tools)."""
    kp = np.asarray(keypoints, np.float32)
    ys, xs = _grid_centers(hout, wout, stride)
    gy, gx = np.meshgrid(ys, xs, indexing="ij")

    heat = np.zeros((hout, wout, skeleton.N_PARTS), np.float32)
    for person in kp:
        for part in range(skeleton.N_PARTS):
            x, y, v = person[part]
            if v <= 0:
                continue
            g = np.exp(-((gx - x) ** 2 + (gy - y) ** 2)
                       / (2.0 * sigma * sigma))
            heat[:, :, part] = np.maximum(heat[:, :, part], g)
    conf = np.concatenate(
        [heat, 1.0 - heat.max(-1, keepdims=True)], axis=-1)

    paf = np.zeros((hout, wout, skeleton.N_PAF_CHANNELS), np.float32)
    count = np.zeros((hout, wout, skeleton.N_LIMBS), np.float32)
    for person in kp:
        for limb, (ia, ib) in enumerate(skeleton.COCO_PAIRS):
            xa, ya, va = person[ia]
            xb, yb, vb = person[ib]
            if va <= 0 or vb <= 0:
                continue
            dx, dy = xb - xa, yb - ya
            norm = max(np.hypot(dx, dy), 1e-4)
            ux, uy = dx / norm, dy / norm
            along = (gx - xa) * ux + (gy - ya) * uy
            perp = np.abs(-(gx - xa) * uy + (gy - ya) * ux)
            band = (along >= 0) & (along <= norm) & (perp <= limb_width)
            cx, cy = skeleton.COCO_PAIRS_NETWORK[limb]
            paf[:, :, cx] += band * ux
            paf[:, :, cy] += band * uy
            count[:, :, limb] += band
    for limb, (cx, cy) in enumerate(skeleton.COCO_PAIRS_NETWORK):
        d = np.maximum(count[:, :, limb], 1.0)
        paf[:, :, cx] /= d
        paf[:, :, cy] /= d
    return conf, paf
