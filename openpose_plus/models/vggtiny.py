"""VGG-tiny: slimmed VGG backbone, same two-branch stage structure.

Behavior-level match of the reference's models_vggtiny.py [MED exact
channel plan; empty mount — SURVEY.md §2 "VGG-tiny model"]: roughly half
the channels and depth of VGG19, 3x3 refinement convs, fewer stages by
default — the mid-size speed/accuracy point of the zoo.
"""

from __future__ import annotations

from openpose_plus.config import ModelConfig
from openpose_plus.models import common


def forward(s: common.Scope, cfg: ModelConfig, x):
    d = cfg.compute_dtype
    x = x.astype(common._dtype(d))
    # conv1 block on the space-to-depth grid when the lowering is
    # available (same params; common.s2d_conv_relu — vgg_block gates
    # eligibility itself).
    x = common.vgg_block(s, x, (32, 32), d, "conv1", s2d_stem=cfg.stem_s2d)
    x = common.vgg_block(s, x, (64, 64), d, "conv2")
    x = common.vgg_block(s, x, (128, 128, 128), d, "conv3")
    feature = common.vgg_block(s, x, (256, 128), d, "conv4", pool=False)
    confs, pafs = common.multi_stage_head(
        s.child("stages"), feature, n_heatmaps=cfg.n_heatmaps,
        n_pafs=cfg.n_pafs, n_stages=cfg.n_stages, refine_kernel=3,
        refine_convs=5, remat=cfg.remat_stages, compute_dtype=d)
    return dict(conf=confs, paf=pafs, feature=feature)
