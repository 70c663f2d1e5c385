"""Horizontal-flip map mirroring for test-time augmentation.

The reference estimator improves AP by averaging predictions over
transformed inputs (its inference path supports scale search [MED]); the
cheapest and most effective variant is horizontal flip. Mirroring the
OUTPUT maps back requires more than reversing the x axis:

  * confidence channels permute left<->right parts (FLIP_SWAP_PAIRS);
  * each limb's PAF channel pair moves to its mirrored limb (the limb
    whose endpoints are the part-swapped endpoints — every COCO_PAIRS
    limb has one);
  * PAF x components negate (direction mirrors), y components keep sign.

`mirror_maps` is an involution; tests verify that and GT-level
consistency (maps of a mirrored scene == mirrored maps of the scene).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from openpose_plus import skeleton


def _part_swap() -> np.ndarray:
    swap = np.arange(skeleton.N_HEATMAPS)
    for a, b in skeleton.FLIP_SWAP_PAIRS:
        swap[a], swap[b] = b, a
    return swap


def _limb_mirror() -> np.ndarray:
    """mirror[l] = limb index whose endpoints are the part-swapped
    endpoints of limb l (order-sensitive match, then orderless)."""
    swap = _part_swap()
    pairs = list(skeleton.COCO_PAIRS)
    mirror = np.zeros(skeleton.N_LIMBS, np.int64)
    for l, (a, b) in enumerate(pairs):
        sa, sb = int(swap[a]), int(swap[b])
        if (sa, sb) in pairs:
            mirror[l] = pairs.index((sa, sb))
        elif (sb, sa) in pairs:
            raise AssertionError(
                f"limb {l} mirrors to reversed pair; COCO_PAIRS should be "
                "closed under L/R swap with preserved orientation")
        else:
            raise AssertionError(f"no mirror limb for {l}")
    return mirror


_PART_SWAP = _part_swap()
_LIMB_MIRROR = _limb_mirror()


def paf_channel_permutation() -> tuple[np.ndarray, np.ndarray]:
    """(perm, sign): mirrored paf channel c comes from channel perm[c]
    scaled by sign[c]."""
    chans = skeleton.paf_channels_array()
    perm = np.zeros(skeleton.N_PAF_CHANNELS, np.int64)
    sign = np.ones(skeleton.N_PAF_CHANNELS, np.float32)
    for l in range(skeleton.N_LIMBS):
        ml = _LIMB_MIRROR[l]
        cx, cy = chans[l]
        mx, my = chans[ml]
        perm[cx] = mx
        perm[cy] = my
        sign[cx] = -1.0  # x component flips direction
    return perm, sign


_PAF_PERM, _PAF_SIGN = paf_channel_permutation()


def mirror_maps(conf: jax.Array, paf: jax.Array
                ) -> tuple[jax.Array, jax.Array]:
    """Mirror (..., H, W, C) maps produced from a horizontally flipped
    input back into original-image orientation."""
    conf_m = jnp.flip(conf, axis=-2)[..., jnp.asarray(_PART_SWAP)]
    paf_m = jnp.flip(paf, axis=-2)[..., jnp.asarray(_PAF_PERM)]
    paf_m = paf_m * jnp.asarray(_PAF_SIGN)
    return conf_m, paf_m
