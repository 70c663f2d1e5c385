#!/usr/bin/env python3
"""Time the decoder's PAF sampler (gather) against the matrix lowerings
it replaced, on the default device.

    python scripts/time_paf_samplers.py

score_candidates reads the PAF at every (limb, sample, peak A, peak B)
integer coordinate. It does so by gather (postproc/paf._sample_paf_gather)
on the upsampled map. The decoder once also had two contractions for it,
kept here only to be timed:

  one-hot  value(n) = sum_y sum_x onehot_y(n, y) onehot_x(n, x) paf[y, x]
  two-hot  the same on the raw map with bilinear-resize weights in place
           of the one-hot rows, so the upsample is never materialized

Cases, at the serving geometry (bs=8, 46x82 maps from a 368x656 input,
19 limbs x 10 samples x K x K coordinates, uniform over the upsampled
map): upsample 2 with K=16 (the default decoder) and upsample 8 with K=32
(fidelity()), each as gather-on-upsample vs two-hot on the raw map; and
gather vs one-hot on an already upsampled map. Each lowering is checked
against the gather before it is timed (one-hot bit-exact, two-hot within
1e-5 of the map's scale). Times are seconds per call inside one jitted
loop (chip_smoke.loop_seconds).
"""

from __future__ import annotations

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from openpose_plus import skeleton  # noqa: E402
from openpose_plus.postproc import nms  # noqa: E402
from openpose_plus.postproc.paf import _sample_paf_gather  # noqa: E402

HIGHEST = jax.lax.Precision.HIGHEST


def sample_onehot(paf, sy, sx):
    """Gather as two one-hot contractions; with HIGHEST precision every
    product has one nonzero term, so it equals the gather bit for bit."""
    h, w = paf.shape[:2]
    l, s, k, _ = sy.shape
    pairs = paf[:, :, jnp.asarray(skeleton.paf_channels_array())]
    oy = (sy.reshape(l, -1)[..., None] == jnp.arange(h)).astype(jnp.float32)
    ox = (sx.reshape(l, -1)[..., None] == jnp.arange(w)).astype(jnp.float32)
    t = jnp.einsum("lnh,hwlc->lnwc", oy, pairs, precision=HIGHEST)
    v = jnp.einsum("lnw,lnwc->lnc", ox, t, precision=HIGHEST)
    return v[..., 0].reshape(l, s, k, k), v[..., 1].reshape(l, s, k, k)


def _resize_taps(coords, size: int, factor: int):
    """Two bilinear taps per upsampled coordinate, with the weights of
    jax.image.resize('linear') (half-pixel centers, renormalized at the
    edges), as one (..., size) two-hot row."""
    src = (coords.astype(jnp.float32) + 0.5) / factor - 0.5
    i0 = jnp.floor(src)
    d = src - i0
    i0 = i0.astype(jnp.int32)
    ar = jnp.arange(size)
    rows = 0.0
    total = 0.0
    for tap, wt in ((i0, 1.0 - d), (i0 + 1, d)):
        ok = (tap >= 0) & (tap < size)
        wt = jnp.where(ok, wt, 0.0)
        rows = rows + wt[..., None] * (tap[..., None] == ar)
        total = total + wt
    return rows / total[..., None]


def sample_twohot(paf_lo, sy, sx, factor: int):
    """The `factor`-upsampled map's values at (sy, sx), contracted from
    the raw map without materializing the upsample."""
    h, w = paf_lo.shape[:2]
    l, s, k, _ = sy.shape
    pairs = paf_lo[:, :, jnp.asarray(skeleton.paf_channels_array())]
    oy = _resize_taps(sy.reshape(l, -1), h, factor)
    ox = _resize_taps(sx.reshape(l, -1), w, factor)
    t = jnp.einsum("lnw,hwlc->lnhc", ox, pairs, precision=HIGHEST)
    v = jnp.einsum("lnh,lnhc->lnc", oy, t, precision=HIGHEST)
    return v[..., 0].reshape(l, s, k, k), v[..., 1].reshape(l, s, k, k)


def inputs(h: int, w: int, k: int, factor: int, batch: int, seed: int):
    """Raw maps (B, h, w, 38) and upsampled-grid coords (B, 19, 10, K, K)."""
    rng = np.random.default_rng(seed)
    paf = rng.uniform(-1, 1, (batch, h, w, 38)).astype(np.float32)
    shape = (batch, skeleton.N_LIMBS, 10, k, k)
    sy = rng.integers(0, h * factor, shape).astype(np.int32)
    sx = rng.integers(0, w * factor, shape).astype(np.int32)
    return jnp.asarray(paf), jnp.asarray(sy), jnp.asarray(sx)


def cases(h: int = 46, w: int = 82, batch: int = 8, seed: int = 0):
    """(name, gather fn, alternative fn, args, exact) for each case; the
    fns take batched args."""
    out = []
    for factor, k in ((2, 16), (8, 32)):
        args = inputs(h, w, k, factor, batch, seed)
        gather = jax.vmap(lambda p, y, x, f=factor: _sample_paf_gather(
            nms.upsample(p, f), y, x))
        twohot = jax.vmap(functools.partial(sample_twohot, factor=factor))
        out.append((f"upsample {factor}, K={k}: gather on the upsampled map "
                    f"vs two-hot on the raw map", gather, twohot, args,
                    False))
        if factor == 2:
            up = jax.jit(jax.vmap(lambda p: nms.upsample(p, 2)))(args[0])
            out.append(("same coords on a materialized upsample: gather vs "
                        "one-hot", jax.vmap(_sample_paf_gather),
                        jax.vmap(sample_onehot), (up,) + args[1:], True))
    return out


def agree(gather, alt, args, exact: bool) -> float:
    """Max |alt - gather| over both channels; raises when they differ
    (beyond 1e-5 of the map's scale for the two-hot contraction)."""
    a = np.asarray(jnp.stack(jax.jit(gather)(*args)))
    b = np.asarray(jnp.stack(jax.jit(alt)(*args)))
    err = float(np.abs(a - b).max())
    tol = 0.0 if exact else 1e-5 * float(np.abs(a).max())
    if err > tol:
        raise AssertionError(f"lowerings differ by {err} (tolerance {tol})")
    return err


def main() -> int:
    from bench import card
    from chip_smoke import loop_seconds

    d = jax.devices()[0]
    print(card(), flush=True)
    print(f"backend {jax.default_backend()} device_kind {d.device_kind}",
          flush=True)
    for name, gather, alt, args, exact in cases():
        err = agree(gather, alt, args, exact)
        tg = loop_seconds(gather, *args)
        ta = loop_seconds(alt, *args)
        print(f"{name}: {1e6 * tg:.1f} us vs {1e6 * ta:.1f} us "
              f"(max diff {err:.2e})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
