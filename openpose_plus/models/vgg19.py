"""VGG19-backbone OpenPose model (the CVPR'17 reference architecture).

Behavior-matches the reference's models_vgg.py [HIGH; empty mount —
SURVEY.md §2 "VGG19 full model"]: VGG19 conv1_1..conv4_2 backbone plus two
CPM convs producing the stride-8 feature F, then a 6-stage two-branch head
with 7x7 refinement convs and deep supervision.
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
    x = common.vgg_block(s, x, (64, 64), d, "conv1", s2d_stem=cfg.stem_s2d)
    x = common.vgg_block(s, x, (128, 128), d, "conv2")
    x = common.vgg_block(s, x, (256, 256, 256, 256), d, "conv3")
    x = common.vgg_block(s, x, (512, 512), d, "conv4", pool=False)
    x = common.conv_relu(s.child("conv4_3_cpm"), x, 256, compute_dtype=d)
    feature = common.conv_relu(s.child("conv4_4_cpm"), x, 128,
                               compute_dtype=d)
    confs, pafs = common.multi_stage_head(
        s.child("stages"), feature, n_heatmaps=cfg.n_heatmaps,
        n_pafs=cfg.n_pafs, n_stages=cfg.n_stages, refine_kernel=7,
        remat=cfg.remat_stages, compute_dtype=d)
    return dict(conf=confs, paf=pafs, feature=feature)
