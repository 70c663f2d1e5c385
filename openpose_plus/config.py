"""Typed configuration for the pose engine.

Replaces the reference's module-global EasyDict (reference: config.py ::
config [HIGH] — empty mount, see SURVEY.md) with frozen dataclasses so configs
are hashable and can be closed over by jit-compiled functions as static data.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Network architecture + map geometry.

    Mirrors reference config.MODEL: n_pos=19, hin/win=368/432,
    hout/wout=hin/8, model name.
    """

    name: str = "mobilenet_thin"
    n_heatmaps: int = 19
    n_pafs: int = 38
    hin: int = 368
    win: int = 432
    stride: int = 8            # backbone output stride
    n_stages: int = 6          # refinement stages (deep supervision)
    # "bfloat16" (params stay float32) or "float32".
    compute_dtype: str = "bfloat16"
    # MobileNet width multiplier ("thin" = 0.75 in the reference family).
    width_multiplier: float = 0.75
    # Lower the stride-2 stem conv via space-to-depth (MLPerf ResNet stem
    # trick): on the s2d grid the 3-channel conv is 2x2 s1 over 12
    # channels (models/common.py stem_conv_relu). Same params, same
    # checkpoint; also enables the (B, hin/2, win/2, 12) input layout.
    stem_s2d: bool = True
    # Rematerialize stage activations in the backward pass (jax.checkpoint):
    # trades ~1 extra stage forward for O(n_stages) less activation memory —
    # the memory-for-FLOPs lever for big batches / high-res training.
    remat_stages: bool = False

    def preferred_input_layout(self) -> int:
        """Space-to-depth level of the model's fastest uint8 input layout:
        0 = plain (B,hin,win,3), 1 = (B,hin/2,win/2,12),
        2 = (B,hin/4,win/4,48). The host sides (stream loader, train
        pipeline, bench) emit this; the stems consume it directly
        (models/common.py). Every current zoo model has an s2d-capable
        stem, so the gate is geometry, not a name list (registry aliases
        included)."""
        if not self.stem_s2d:
            return 0
        if (self.name in ("mobilenet_thin", "mobilenet")
                and self.hin % 4 == 0 and self.win % 4 == 0):
            return 2
        if self.hin % 2 == 0 and self.win % 2 == 0:
            return 1
        return 0

    def train_lowering(self) -> "ModelConfig":
        """The stem lowering TRAINING programs build against
        (create_train_state / make_train_step* / TrainPipeline) —
        parameter-compatible with the serving lowering, so checkpoints
        transfer either way (same module names, kernel shapes).

        VGG19 is the one exception to "s2d stem everywhere": at its 64-ch
        conv1 the block grid's 4x structural FLOPs, repaid in the forward
        by denser contractions, are charged twice more in the backward (dX
        and dW both run the 4x-FLOP convs), so training takes the plain
        stem while inference keeps s2d; vggtiny/hao28 (32-ch conv1) keep
        s2d for training too.
        """
        if self.name in ("vgg19", "vgg") and self.stem_s2d:
            return dataclasses.replace(self, stem_s2d=False)
        return self

    def input_shape(self, batch: int, level: int | None = None
                    ) -> tuple[int, int, int, int]:
        """uint8 input shape for a space-to-depth level (default: the
        model's preferred layout) — the ONE place the level-to-shape rule
        lives (bench, train bench, Engine.compile, export all use it)."""
        if level is None:
            level = self.preferred_input_layout()
        return {0: (batch, self.hin, self.win, 3),
                1: (batch, self.hin // 2, self.win // 2, 12),
                2: (batch, self.hin // 4, self.win // 4, 48)}[level]

    @property
    def hout(self) -> int:
        return self.hin // self.stride

    @property
    def wout(self) -> int:
        return self.win // self.stride


@dataclasses.dataclass(frozen=True)
class PostprocConfig:
    """On-device grouping parameters.

    Numeric thresholds follow the reference PAF pipeline (peak threshold
    ~0.05-0.1, 10 line-integral samples, >=80% inlier samples, humans need
    >=3 parts); static capacities (max_peaks/max_humans) replace the
    reference's dynamic shapes so the whole stage jit-compiles.
    """

    # Static capacities: decode cost scales ~K^2 (dense candidate scoring)
    # and linearly in merge iterations; 16 covers COCO-style crowd scenes
    # (peaks per part per image), 32+ is the high-fidelity setting.
    max_peaks: int = 16          # top-K peak cap per part channel
    max_humans: int = 32         # skeleton slots per image
    peak_threshold: float = 0.05
    paf_n_samples: int = 10      # points sampled along each candidate limb
    paf_sample_threshold: float = 0.05
    paf_inlier_ratio: float = 0.8
    min_parts_per_human: int = 3
    min_human_score: float = 0.0
    # Upsampling applied to the net output maps before peak finding.
    # 1 = group at feature resolution with subpixel (quadratic) refinement;
    # the reference upsamples ~8x and groups at image resolution. 2 keeps
    # the decoder's maps small, and subpixel refinement recovers the rest.
    upsample_factor: int = 2
    smooth_sigma: float = 1.25   # Gaussian smoothing before NMS (pixels)
    # Fragment-merge repair pass (postproc/decode.py ::
    # _merge_fragments_single): bottom-up assembly structurally fragments
    # truncated/occluded people (visible parts = disconnected limb
    # subgraph); this greedily re-joins disjoint-part skeletons closer
    # than rel x the larger fragment's bbox diagonal. 0 disables
    # (reference-parity default); 0.5 is the train-bank-oracle-tuned
    # setting (BASELINE.md r5 "quality ceiling").
    fragment_merge_rel: float = 0.0
    fragment_merge_rounds: int = 8

    def fidelity(self, upsample: int = 8) -> "PostprocConfig":
        """Reference-style high-fidelity settings (input-resolution maps,
        deep peak cap) for AP-parity evaluation. `upsample` should equal
        the model's output stride so grouping runs at input resolution
        (8 for the standard zoo; 4 for stride-4 output variants)."""
        import dataclasses as _dc
        return _dc.replace(self, max_peaks=32, upsample_factor=upsample,
                           smooth_sigma=5.0)

    def quality(self, upsample: int = 8) -> "PostprocConfig":
        """Best-measured-quality settings: fidelity() + the fragment-merge
        repair pass at the frozen rel=0.5. BEYOND reference parity — the
        pass repairs a structural failure of bottom-up PAF grouping
        (truncated people fragment into disjoint skeletons) that the
        reference algorithm cannot fix at any setting. Measured: +8 AP pt
        on serving-tier model rows, oracle ceiling 0.629 -> 0.706
        (BASELINE.md r5 "quality ceiling")."""
        import dataclasses as _dc
        return _dc.replace(self.fidelity(upsample),
                           fragment_merge_rel=0.5)


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Dataset paths and augmentation ranges (reference config.DATA +
    train.py :: _data_aug_fn ranges)."""

    train_images: str = "data/coco/train2017"
    train_annotations: str = "data/coco/annotations/person_keypoints_train2017.json"
    val_images: str = "data/coco/val2017"
    val_annotations: str = "data/coco/annotations/person_keypoints_val2017.json"
    rotate_max_deg: float = 40.0
    scale_min: float = 0.5
    scale_max: float = 1.1
    shift_frac: float = 0.25   # random-crop center shift, fraction of frame
    flip_prob: float = 0.5
    sigma: float = 8.0           # GT heatmap Gaussian sigma (input pixels)
    limb_width: float = 8.0      # GT PAF band half-width (input pixels)
    prefetch: int = 4
    num_workers: int = 8


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimization schedule (reference config.TRAIN: batch ~8, lr_init
    ~4e-5, ~600k steps, stepwise decay, weight decay on kernels)."""

    batch_size: int = 8          # per-host global batch (sharded over mesh)
    n_steps: int = 600_000
    lr_init: float = 4e-5
    lr_decay_every: int = 136_120
    lr_decay_factor: float = 0.333
    weight_decay: float = 5e-4
    optimizer: str = "adam"      # "adam" | "momentum"
    momentum: float = 0.9
    # Distributed strategy (reference --kf-optimizer): "sync-sgd" (gradient
    # all-reduce; the default), "sma" (local steps + global
    # model averaging), "pair-avg" (PairAveraging gossip as deterministic
    # hypercube rounds — parallel/kungfu.py).
    kf_optimizer: str = "sync-sgd"
    # lr x geometry transfer. The per-stage loss SUMS squared error over
    # map pixels, so its scale grows with output-map area — but Adam is
    # invariant to loss scale (test_train.py::test_adam_loss_scale_
    # invariance), so "area-normalize the loss" would change NOTHING about
    # stability. What does change with area is the loss curvature: more
    # pixel terms -> a sharper landscape -> a lower stable lr. Measured
    # (BASELINE.md r4/r5): vgg19 trains at lr 1e-3 on 16x16 maps but
    # diverges at 46x54, where ~3e-4 is stable — consistent with
    # lr ∝ 1/sqrt(out_area) (sqrt(2484/256) = 3.1x). "inv-sqrt-area"
    # applies that rule: effective lr = lr_init * sqrt(lr_ref_area /
    # (hout*wout)), so ONE lr_init transfers across geometry tiers.
    # "none" = reference parity (lr_init used as-is at every geometry).
    lr_scaling: str = "none"       # "none" | "inv-sqrt-area"
    lr_ref_area: int = 256         # out-map area lr_init was tuned at (16x16)
    log_every: int = 100
    checkpoint_every: int = 5000
    checkpoint_dir: str = "checkpoints"
    # Structured metrics: append one CSV row per log_every interval
    # (step, loss, branch losses, lr, imgs/s). "" disables. The
    # observability analogue of the reference's TL print logs (SURVEY.md §5).
    metrics_csv: str = ""
    # Periodic predicted-vs-GT heatmap renders (reference draw_results
    # dumps); 0 disables.
    vis_every: int = 0
    vis_dir: str = "vis"
    seed: int = 0
    donate_state: bool = True


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """Device-mesh layout. The reference's KungFu data-parallel training
    (train.py :: parallel_train [HIGH]) maps to a `data` mesh axis with
    compiler-inserted psum; a second `spatial` axis optionally shards the
    image height dim (XLA GSPMD spatial partitioning with halo exchange),
    which is the answer to very high-res frames."""

    data_axis: str = "data"
    spatial_axis: str = "spatial"
    spatial_parallelism: int = 1   # shards of the image H dimension
    multihost: bool = False        # call jax.distributed.initialize()


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    postproc: PostprocConfig = dataclasses.field(default_factory=PostprocConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    parallel: ParallelConfig = dataclasses.field(default_factory=ParallelConfig)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def default_config(model_name: Optional[str] = None) -> Config:
    cfg = Config()
    if model_name is not None:
        cfg = cfg.replace(model=dataclasses.replace(cfg.model, name=model_name))
    return cfg
