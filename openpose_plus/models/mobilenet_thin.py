"""MobileNet-thin: depthwise-separable backbone, the fast model of the zoo.

Behavior-level match of the reference's models_mobilenet.py [HIGH behavior,
MED exact layer plan; empty mount — SURVEY.md §2 "MobileNet-thin model"]:
MobileNet v1 at a thin width multiplier (0.75), a multi-scale feature
concat (stride-4 features pooled onto the stride-8 grid), and smaller
separable-conv stage heads.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from openpose_plus.config import ModelConfig
from openpose_plus.models import common


def _w(width: float, c: int) -> int:
    """Width-multiplied channel count, rounded to a multiple of 8 (the
    reference rounds to arbitrary ints)."""
    return max(8, int(round(c * width / 8)) * 8)


def forward(s: common.Scope, cfg: ModelConfig, x):
    d = cfg.compute_dtype
    w = cfg.width_multiplier
    x = x.astype(common._dtype(d))
    # Stem + stride-2 region: conv1 (3x3 s2), dw1, dw2 (s2 -> stride 4).
    # With stem_s2d the SAME params lower via space-to-depth
    # (checkpoint-identical; see common.py deep-s2d notes). Tiers by
    # input shape: the DEEP tier keeps conv1/dw1/dw2 on the (H/4, W/4)
    # block grid (needs H,W % 4 == 0 or a pre-transformed s2d^2 input
    # (B,H/4,W/4,48)); the s2d-stem tier lowers only conv1 (H,W % 2 == 0
    # or s2d input (B,H/2,W/2,12)); otherwise the plain lowering.
    c = x.shape[-1]
    mod4 = x.shape[1] % 4 == 0 and x.shape[2] % 4 == 0
    even = x.shape[1] % 2 == 0 and x.shape[2] % 2 == 0
    deep = cfg.stem_s2d and (c == 48 or (c == 3 and mod4) or (c == 12 and even))
    if deep:
        if c == 3:
            x = common.space_to_depth(common.space_to_depth(x))
        elif c == 12:
            x = common.space_to_depth(x)
        x = common.stem_conv_relu(s.child("conv1"), x, _w(w, 32),
                                  compute_dtype=d)       # s2d-layout out
        x = common.sep_conv_relu(s.child("dw1"), x, _w(w, 64),
                                 compute_dtype=d, s2d_space=True)
        x = common.sep_conv_relu(s.child("dw2"), x, _w(w, 128), stride=2,
                                 compute_dtype=d, s2d_space=True)  # plain
    else:
        if c == 48:
            raise ValueError(
                "the s2d^2 input layout needs stem_s2d; feed plain "
                "(B, H, W, 3) images")
        if cfg.stem_s2d and (even or c == 12):
            x = common.stem_conv_relu(s.child("conv1"), x, _w(w, 32),
                                      compute_dtype=d)   # stride 2
        else:
            x = common.conv_relu(s.child("conv1"), x, _w(w, 32), stride=2,
                                 compute_dtype=d)        # stride 2
        x = common.sep_conv_relu(s.child("dw1"), x, _w(w, 64),
                                 compute_dtype=d)
        x = common.sep_conv_relu(s.child("dw2"), x, _w(w, 128), stride=2,
                                 compute_dtype=d)        # stride 4
    x = common.sep_conv_relu(s.child("dw3"), x, _w(w, 128), compute_dtype=d)
    feat_s4 = x
    x = common.sep_conv_relu(s.child("dw4"), x, _w(w, 256), stride=2,
                             compute_dtype=d)            # stride 8
    x = common.sep_conv_relu(s.child("dw5"), x, _w(w, 256), compute_dtype=d)
    x = common.sep_conv_relu(s.child("dw6"), x, _w(w, 512), compute_dtype=d)
    for i in range(3):
        x = common.sep_conv_relu(s.child(f"dw{7 + i}"), x, _w(w, 512),
                                 compute_dtype=d)
    # Multi-scale concat: pool the stride-4 features onto the stride-8
    # grid and fuse (reference concatenates multiple backbone taps).
    feature = jnp.concatenate([common.max_pool2(feat_s4), x], axis=-1)
    # Materialize once: `feature` has 7+ consumers (both stage-1 branches
    # and every later stage's input concat); without the barrier XLA may
    # re-gather (pooled, x) per consumer, as with the stage-input concat
    # in common.multi_stage_head (same batch gate).
    if feature.shape[0] <= 16:
        feature = jax.lax.optimization_barrier(feature)
    # 3x3 separable stage convs (the reference thin-model family's
    # choice): a depthwise 7x7 over the 441-ch stage input would cost
    # about 2.5x the stage for no capacity gain.
    confs, pafs = common.multi_stage_head(
        s.child("stages"), feature, n_heatmaps=cfg.n_heatmaps,
        n_pafs=cfg.n_pafs, n_stages=cfg.n_stages,
        stage1_convs=3, stage1_kernel=3, stage1_proj=256,
        refine_convs=3, refine_kernel=3, refine_mid=128,
        separable=True, remat=cfg.remat_stages, compute_dtype=d)
    return dict(conf=confs, paf=pafs, feature=feature)
