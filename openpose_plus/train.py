"""Training: deep-supervision loss, optimizer, jit'd sharded train step.

Rebuild of the reference training driver (train.py ::
single_train / parallel_train [HIGH; empty mount — SURVEY.md §2/§3]):

  * loss: sum over stages of masked L2 on (conf, paf) vs GT + weight decay
  * optimizer: Adam (or momentum SGD) with stepwise lr decay
  * single-device and multi-device training are the SAME jit'd step — the
    mesh sharding (parallel/sharding.py) turns it data-parallel, with
    XLA-inserted gradient psums replacing KungFu's all-reduce
  * checkpointing via orbax (reference: tl.files.save_npz_dict)
"""

from __future__ import annotations

from typing import Any, Optional

import jax
import jax.numpy as jnp
import optax

from openpose_plus.config import Config, TrainConfig
from openpose_plus.models import get_model
from openpose_plus.utils.pytree import pytree_dataclass


@pytree_dataclass
class TrainState:
    step: jax.Array
    params: Any
    opt_state: Any


def effective_lr_init(cfg: TrainConfig, out_area: Optional[int] = None
                      ) -> float:
    """lr_init after the geometry-transfer rule (TrainConfig.lr_scaling).

    "inv-sqrt-area" scales by sqrt(lr_ref_area / out_area): the pose loss
    sums over map pixels, so curvature grows ~linearly with output-map
    area and the stable lr shrinks ~1/sqrt(area) (Adam; loss NORMALIZATION
    is a no-op under Adam's scale invariance — see TrainConfig). Measured:
    the rule maps the zoo default 1e-3 at 16x16 maps to 3.2e-4 at 46x54,
    within 7% of the hand-tuned stable vgg19@368 lr (BASELINE.md)."""
    if cfg.lr_scaling == "none" or out_area is None:
        return cfg.lr_init
    if cfg.lr_scaling != "inv-sqrt-area":
        raise ValueError(f"unknown lr_scaling {cfg.lr_scaling!r}")
    return cfg.lr_init * float(cfg.lr_ref_area / out_area) ** 0.5


def lr_schedule(cfg: TrainConfig, out_area: Optional[int] = None
                ) -> optax.Schedule:
    """Stepwise-decay schedule (reference config.TRAIN: lr_init with
    factor decay every lr_decay_every steps, staircase)."""
    return optax.exponential_decay(
        init_value=effective_lr_init(cfg, out_area),
        transition_steps=cfg.lr_decay_every,
        decay_rate=cfg.lr_decay_factor,
        staircase=True)


def make_optimizer(cfg: TrainConfig, out_area: Optional[int] = None
                   ) -> optax.GradientTransformation:
    sched = lr_schedule(cfg, out_area)
    if cfg.optimizer == "adam":
        tx = optax.adam(sched)
    elif cfg.optimizer == "momentum":
        tx = optax.sgd(sched, momentum=cfg.momentum)
    else:
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
    if cfg.weight_decay:
        # reference applies L2 regularization to conv kernels only; masking
        # to >=2D leaves excludes biases.
        mask = lambda params: jax.tree.map(lambda p: p.ndim >= 2, params)
        tx = optax.chain(optax.add_decayed_weights(cfg.weight_decay, mask), tx)
    return tx


def pose_loss(outputs: dict, gt_conf: jax.Array, gt_paf: jax.Array,
              mask: Optional[jax.Array] = None) -> tuple[jax.Array, dict]:
    """Deep-supervision masked L2 (reference train.py loss [HIGH behavior]).

    total = sum over stages of mean_batch[ sum_pixels mask*(pred-gt)^2 ]
    for both branches. mask: (B, h, w, 1) with 0 over unannotated regions.
    """
    if mask is None:
        mask = jnp.ones_like(gt_conf[..., :1])
    total = 0.0
    last_conf = last_paf = 0.0
    for conf, paf in zip(outputs["conf"], outputs["paf"]):
        conf = conf.astype(jnp.float32)
        paf = paf.astype(jnp.float32)
        l_conf = jnp.mean(jnp.sum(
            ((conf - gt_conf) * mask) ** 2, axis=(1, 2, 3)))
        l_paf = jnp.mean(jnp.sum(
            ((paf - gt_paf) * mask) ** 2, axis=(1, 2, 3)))
        total = total + l_conf + l_paf
        last_conf, last_paf = l_conf, l_paf
    metrics = {"loss_conf_last": last_conf, "loss_paf_last": last_paf}
    return total, metrics


def create_train_state(config: Config, rng: jax.Array) -> TrainState:
    model = get_model(config.model.train_lowering())
    dummy = jnp.zeros((1, config.model.hin, config.model.win, 3), jnp.float32)
    params = model.init(rng, dummy)
    tx = make_optimizer(config.train, config.model.hout * config.model.wout)
    return TrainState(step=jnp.zeros((), jnp.int32), params=params,
                      opt_state=tx.init(params))


def make_train_step(config: Config):
    """Build the jit'd train step. Donates the state buffers (in-place
    update on device). Works identically on 1 device or a full mesh: give
    sharded inputs and XLA handles the gradient reduction."""
    model = get_model(config.model.train_lowering())
    tx = make_optimizer(config.train, config.model.hout * config.model.wout)

    def step_fn(state: TrainState, images, gt_conf, gt_paf, mask):
        def loss_fn(params):
            out = model.apply(params, images)
            return pose_loss(out, gt_conf, gt_paf, mask)

        (loss, metrics), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(state.params)
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        new_state = TrainState(step=state.step + 1, params=params,
                               opt_state=opt_state)
        metrics = dict(metrics, loss=loss,
                       lr=lr_schedule(config.train,
                                      config.model.hout
                                      * config.model.wout)(state.step))
        return new_state, metrics

    donate = (0,) if config.train.donate_state else ()
    return jax.jit(step_fn, donate_argnums=donate)


def make_train_step_on_batch(config: Config):
    """jit'd step over a raw pipeline batch {'images' u8, 'keypoints',
    'mask'}: uint8 normalize AND GT heatmap/PAF synthesis run on-device
    inside the step (the reference's host-side get_heatmap/get_vectormap
    bottleneck, eliminated — SURVEY.md §3.1)."""
    from openpose_plus.data.targets import make_targets_batch
    from openpose_plus.engine import preprocess_images

    model = get_model(config.model.train_lowering())
    tx = make_optimizer(config.train, config.model.hout * config.model.wout)

    def step_fn(state: TrainState, batch):
        images = preprocess_images(batch["images"])
        gt_conf, gt_paf = make_targets_batch(
            batch["keypoints"], config.model, config.data)
        mask = batch["mask"]

        def loss_fn(params):
            out = model.apply(params, images)
            return pose_loss(out, gt_conf, gt_paf, mask)

        (loss, metrics), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(state.params)
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        new_state = TrainState(step=state.step + 1, params=params,
                               opt_state=opt_state)
        metrics = dict(metrics, loss=loss,
                       lr=lr_schedule(config.train,
                                      config.model.hout
                                      * config.model.wout)(state.step))
        return new_state, metrics

    donate = (0,) if config.train.donate_state else ()
    return jax.jit(step_fn, donate_argnums=donate)


def train_loop(config: Config, n_steps: Optional[int] = None,
               resume: bool = True, log=print) -> TrainState:
    """Full training driver (reference train.py :: single_train /
    parallel_train): mesh setup, host pipeline, on-device GT synthesis,
    periodic logging + orbax checkpoints. Single-chip and multi-chip use
    the same code path — only the mesh size changes."""
    import time

    from openpose_plus import checkpoint as ckpt
    from openpose_plus.data.coco import CocoPoseDataset
    from openpose_plus.data.pipeline import TrainPipeline
    from openpose_plus.parallel import sharding as S

    S.init_multihost(config.parallel)
    mesh = S.build_mesh(config.parallel)
    n_data = mesh.shape[config.parallel.data_axis]
    if config.train.batch_size % n_data:
        raise ValueError(
            f"batch_size {config.train.batch_size} must be divisible by the "
            f"data mesh axis ({n_data} devices)")
    n_steps = n_steps or config.train.n_steps

    strategy = config.train.kf_optimizer
    state = create_train_state(config, jax.random.PRNGKey(config.train.seed))
    start_step = 0
    ckpt_dir = config.train.checkpoint_dir
    if resume and ckpt.latest_step(ckpt_dir) is not None:
        state = ckpt.restore(ckpt_dir, state)
        start_step = int(state.step)
        log(f"resumed from step {start_step}")

    if strategy == "sync-sgd":
        # Idiomatic sync DP: replicated params, sharded batch, XLA psum.
        state = jax.device_put(state, S.replicated(mesh))
        step_fns = [make_train_step_on_batch(config)]
    else:
        # Decentralized strategies: per-device replicas (parallel/kungfu.py).
        from openpose_plus.parallel import kungfu as kf

        n = mesh.shape[config.parallel.data_axis]
        state = TrainState(step=jnp.full((n,), start_step, jnp.int32),
                           params=kf.stack_for_devices(state.params, n),
                           opt_state=kf.stack_for_devices(state.opt_state, n))
        state = jax.device_put(state, kf.replica_sharding(mesh))
        step_fns = kf.make_kungfu_steps(config, mesh, strategy)

    dataset = CocoPoseDataset(config.data.train_annotations,
                              config.data.train_images)
    # rank-strided dataset shard per host (the reference's
    # dataset.shard(cluster_size, rank)): disjoint shards, every sample
    # seen once per global epoch
    pipeline = TrainPipeline(dataset, config,
                             seed=config.train.seed + jax.process_index(),
                             shard_index=jax.process_index(),
                             shard_count=jax.process_count())

    csv_writer = _metrics_csv_writer(config)
    it = iter(pipeline)
    t0 = time.perf_counter()
    imgs_since = 0
    try:
        for i in range(start_step, n_steps):
            batch = S.shard_batch(next(it), mesh)
            state, metrics = step_fns[i % len(step_fns)](state, batch)
            imgs_since += batch["images"].shape[0]
            if (i + 1) % config.train.log_every == 0:
                jax.block_until_ready(metrics)
                dt = time.perf_counter() - t0
                log(f"step {i + 1} loss {float(metrics['loss']):.2f} "
                    f"lr {float(metrics['lr']):.2e} "
                    f"{imgs_since / dt:.1f} img/s")
                csv_writer(i + 1, metrics, imgs_since / dt)
                t0 = time.perf_counter()
                imgs_since = 0
            if (i + 1) % config.train.checkpoint_every == 0:
                if jax.process_index() == 0:
                    ckpt.save(ckpt_dir,
                              jax.device_get(_single_replica(state, strategy)),
                              i + 1)
            if (config.train.vis_every
                    and (i + 1) % config.train.vis_every == 0
                    and jax.process_index() == 0):
                _dump_vis(config, _single_replica(state, strategy), batch,
                          i + 1)
    finally:
        pipeline.stop()
    return state


def _metrics_csv_writer(config: Config):
    """Row-per-log-interval CSV metrics (no-op when metrics_csv is empty);
    process 0 only. Columns: step, loss, loss_conf_last, loss_paf_last,
    lr, imgs_per_sec."""
    path = config.train.metrics_csv
    if not path or jax.process_index() != 0:
        return lambda *a: None
    import os

    if os.path.dirname(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
    if not os.path.exists(path):
        with open(path, "w") as f:
            f.write("step,loss,loss_conf_last,loss_paf_last,lr,"
                    "imgs_per_sec\n")

    def write(step, metrics, imgs_per_sec):
        # open-per-row: rows land every log_every steps, so reopening is
        # free, nothing leaks across train_loop calls, and a crash never
        # loses buffered rows.
        with open(path, "a") as f:
            f.write(f"{step},{float(metrics['loss']):.6g},"
                    f"{float(metrics['loss_conf_last']):.6g},"
                    f"{float(metrics['loss_paf_last']):.6g},"
                    f"{float(metrics['lr']):.6g},{imgs_per_sec:.2f}\n")

    return write


def _single_replica(state: TrainState, strategy: str) -> TrainState:
    """Rank-0 view of the state (KungFu checkpoints worker 0's replica);
    identity for sync-sgd where params are replicated."""
    if strategy == "sync-sgd":
        return state
    from openpose_plus.parallel import kungfu as kf

    return TrainState(step=state.step[0],
                      params=kf.unstack_replica(state.params),
                      opt_state=kf.unstack_replica(state.opt_state))


def _dump_vis(config: Config, state: TrainState, batch, step: int) -> None:
    """Render predicted vs GT heatmaps for the first batch image
    (reference train.py draw_results dumps [HIGH behavior])."""
    import os

    import numpy as np

    try:
        import cv2
    except ImportError:
        return
    from openpose_plus.data.targets import make_targets_batch
    from openpose_plus.engine import preprocess_images
    from openpose_plus.models import get_model
    from openpose_plus.utils.vis import draw_maps_overlay

    model = get_model(config.model.train_lowering())
    images = batch["images"][:1]
    out = jax.jit(model.apply)(state.params, preprocess_images(images))
    pred = np.asarray(out["conf"][-1][0], np.float32)
    gt, _ = make_targets_batch(batch["keypoints"][:1], config.model,
                               config.data)
    from openpose_plus.native import d2s_u8

    # pipeline may ship images in a space-to-depth layout; render plain
    img = d2s_u8(np.asarray(images[0], np.uint8))[:, :, ::-1]  # RGB->BGR
    os.makedirs(config.train.vis_dir, exist_ok=True)
    cv2.imwrite(os.path.join(config.train.vis_dir, f"step{step}_pred.jpg"),
                draw_maps_overlay(img, pred))
    cv2.imwrite(os.path.join(config.train.vis_dir, f"step{step}_gt.jpg"),
                draw_maps_overlay(img, np.asarray(gt[0])))


def main(argv: Optional[list[str]] = None) -> None:
    """CLI mirroring the reference `python train.py --model=... [--parallel]`."""
    import argparse
    import dataclasses

    p = argparse.ArgumentParser(description="Train a pose model")
    p.add_argument("--model", default="vgg19")
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--parallel", action="store_true",
                   help="multi-host: jax.distributed.initialize()")
    p.add_argument("--kf-optimizer", default="sync-sgd",
                   choices=["sync-sgd", "sma", "pair-avg"],
                   help="distributed strategy (reference --kf-optimizer; "
                        "async PairAveraging maps to hypercube gossip)")
    p.add_argument("--spatial", type=int, default=1,
                   help="spatial-parallel shards of the image height")
    p.add_argument("--train-images", default=None)
    p.add_argument("--train-annotations", default=None)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--metrics-csv", default=None,
                   help="append per-log-interval metrics rows here")
    p.add_argument("--lr-scaling", default=None,
                   choices=["none", "inv-sqrt-area"],
                   help="geometry-transfer lr rule: inv-sqrt-area scales "
                        "lr_init by sqrt(lr_ref_area/(hout*wout)) so one "
                        "lr transfers across input geometries")
    args = p.parse_args(argv)

    from openpose_plus.config import default_config

    cfg = default_config(args.model)
    tr = dataclasses.replace(cfg.train, kf_optimizer=args.kf_optimizer)
    if args.lr_scaling:
        tr = dataclasses.replace(tr, lr_scaling=args.lr_scaling)
    if args.batch_size:
        tr = dataclasses.replace(tr, batch_size=args.batch_size)
    if args.checkpoint_dir:
        tr = dataclasses.replace(tr, checkpoint_dir=args.checkpoint_dir)
    if args.metrics_csv:
        tr = dataclasses.replace(tr, metrics_csv=args.metrics_csv)
    da = cfg.data
    if args.train_images:
        da = dataclasses.replace(da, train_images=args.train_images)
    if args.train_annotations:
        da = dataclasses.replace(da, train_annotations=args.train_annotations)
    pa = dataclasses.replace(cfg.parallel, multihost=args.parallel,
                             spatial_parallelism=args.spatial)
    cfg = cfg.replace(train=tr, data=da, parallel=pa)
    train_loop(cfg, n_steps=args.steps)


if __name__ == "__main__":
    main()
