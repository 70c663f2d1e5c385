"""Training tests: loss descent, sharded step on the 8-device mesh,
checkpoint round-trips, and a real (tiny) end-to-end train_loop run."""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest

from openpose_plus import checkpoint as ckpt
from openpose_plus import train as T
from openpose_plus.config import default_config
from openpose_plus.data.targets import make_targets_batch
from openpose_plus.parallel import sharding as S


def _tiny_config(batch=4, spatial=1):
    cfg = default_config("vggtiny")
    return cfg.replace(
        model=dataclasses.replace(cfg.model, hin=64, win=64, n_stages=2,
                                  compute_dtype="float32"),
        train=dataclasses.replace(cfg.train, batch_size=batch,
                                  lr_init=3e-4, weight_decay=0.0),
        parallel=dataclasses.replace(cfg.parallel,
                                     spatial_parallelism=spatial),
    )


def _fake_batch(cfg, rng, batch=None):
    b = batch or cfg.train.batch_size
    m = cfg.model
    images = rng.integers(0, 255, (b, m.hin, m.win, 3), dtype=np.uint8)
    kp = np.zeros((b, 4, 18, 3), np.float32)
    kp[:, 0, :, 0] = rng.uniform(5, m.win - 5, (b, 18))
    kp[:, 0, :, 1] = rng.uniform(5, m.hin - 5, (b, 18))
    kp[:, 0, :, 2] = 1
    mask = np.ones((b, m.hout, m.wout, 1), np.float32)
    return {"images": images, "keypoints": kp, "mask": mask}


def test_loss_decreases(rng):
    cfg = _tiny_config()
    state = T.create_train_state(cfg, jax.random.PRNGKey(0))
    step = T.make_train_step_on_batch(cfg)
    batch = _fake_batch(cfg, rng)  # fixed batch -> should overfit fast
    losses = []
    for _ in range(8):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] * 0.9
    assert int(state.step) == 8


def test_sharded_step_matches_mesh(rng):
    """Full-batch step over the 8-device (4 data x 2 spatial) mesh."""
    cfg = _tiny_config(batch=8, spatial=2)
    mesh = S.build_mesh(cfg.parallel)
    assert dict(mesh.shape) == {"data": 4, "spatial": 2}
    state = T.create_train_state(cfg, jax.random.PRNGKey(0))
    state = jax.device_put(state, S.replicated(mesh))
    step = T.make_train_step_on_batch(cfg)
    batch = S.shard_batch(_fake_batch(cfg, rng), mesh)
    state, metrics = step(state, batch)
    assert np.isfinite(float(metrics["loss"]))


@pytest.mark.slow
def test_sharded_equals_single_device(rng):
    """DP sharding must not change the math (same loss as unsharded)."""
    cfg = _tiny_config(batch=8, spatial=1)
    batch = _fake_batch(cfg, rng)
    state = T.create_train_state(cfg, jax.random.PRNGKey(0))
    step = T.make_train_step_on_batch(cfg)
    _, m_single = step(state, batch)

    mesh = S.build_mesh(cfg.parallel)
    state2 = T.create_train_state(cfg, jax.random.PRNGKey(0))
    state2 = jax.device_put(state2, S.replicated(mesh))
    _, m_mesh = step(state2, S.shard_batch(batch, mesh))
    # rtol accommodates cross-shard reduction-order float differences
    np.testing.assert_allclose(float(m_single["loss"]),
                               float(m_mesh["loss"]), rtol=1e-4)


def test_checkpoint_roundtrip(rng, tmp_path):
    cfg = _tiny_config()
    state = T.create_train_state(cfg, jax.random.PRNGKey(0))
    step = T.make_train_step_on_batch(cfg)
    state, _ = step(state, _fake_batch(cfg, rng))
    path = str(tmp_path / "ckpt")
    ckpt.save(path, jax.device_get(state), int(state.step))
    assert ckpt.latest_step(path) == 1
    template = T.create_train_state(cfg, jax.random.PRNGKey(1))
    restored = ckpt.restore(path, template)
    a = jax.tree_util.tree_leaves(state.params)
    b = jax.tree_util.tree_leaves(restored.params)
    for x, y in zip(a, b):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y))


def test_npz_roundtrip(tmp_path):
    cfg = _tiny_config()
    state = T.create_train_state(cfg, jax.random.PRNGKey(0))
    path = str(tmp_path / "w.npz")
    ckpt.save_npz(path, state.params)
    template = T.create_train_state(cfg, jax.random.PRNGKey(1))
    loaded = ckpt.load_npz(path, template.params)
    for x, y in zip(jax.tree_util.tree_leaves(state.params),
                    jax.tree_util.tree_leaves(loaded)):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y))


def test_npz_legacy_convrelu_layout(tmp_path):
    """Checkpoints from before the ConvRelu param flattening (conv params
    under an nn.Conv child 'Conv_0') still load via the shim in load_npz."""
    cfg = _tiny_config()
    state = T.create_train_state(cfg, jax.random.PRNGKey(0))
    flat = ckpt._flatten(jax.device_get(state.params))
    legacy = {}
    for k, v in flat.items():
        parts = k.split("/")
        if parts[-1] in ("kernel", "bias") and "ConvRelu" in parts[-2]:
            k = "/".join(parts[:-1] + ["Conv_0", parts[-1]])
        legacy[k] = v
    assert legacy.keys() != flat.keys()
    path = str(tmp_path / "legacy.npz")
    np.savez(path, **legacy)
    loaded = ckpt.load_npz(path, state.params)
    for x, y in zip(jax.tree_util.tree_leaves(state.params),
                    jax.tree_util.tree_leaves(loaded)):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y))


def _write_fake_dataset(tmp_path, n_images=4):
    import cv2
    img_dir = tmp_path / "imgs"
    os.makedirs(img_dir, exist_ok=True)
    rng = np.random.default_rng(0)
    images, annotations = [], []
    for i in range(n_images):
        name = f"im{i}.jpg"
        cv2.imwrite(str(img_dir / name),
                    rng.integers(0, 255, (120, 160, 3), dtype=np.uint8))
        images.append({"id": i, "file_name": name,
                       "width": 160, "height": 120})
        kps = []
        for k in range(17):
            kps += [int(rng.uniform(10, 150)), int(rng.uniform(10, 110)), 2]
        annotations.append({
            "id": 100 + i, "image_id": i, "category_id": 1, "iscrowd": 0,
            "area": 5000.0, "keypoints": kps, "segmentation": [],
        })
    ann_path = tmp_path / "ann.json"
    with open(ann_path, "w") as f:
        json.dump({"images": images, "annotations": annotations}, f)
    return str(ann_path), str(img_dir)


def test_train_loop_end_to_end(tmp_path):
    """3 real steps through pipeline + loop + checkpoint on fake data."""
    ann, imgs = _write_fake_dataset(tmp_path)
    cfg = _tiny_config(batch=8)  # divisible by the 8-device CPU mesh
    cfg = cfg.replace(
        data=dataclasses.replace(cfg.data, train_annotations=ann,
                                 train_images=imgs, num_workers=1,
                                 prefetch=2),
        train=dataclasses.replace(cfg.train, batch_size=8, log_every=2,
                                  checkpoint_every=3,
                                  checkpoint_dir=str(tmp_path / "ck"),
                                  metrics_csv=str(tmp_path / "metrics.csv")),
    )
    logs = []
    state = T.train_loop(cfg, n_steps=3, log=logs.append)
    assert int(state.step) == 3
    assert ckpt.latest_step(str(tmp_path / "ck")) == 3
    assert any("loss" in l for l in logs)
    rows = open(tmp_path / "metrics.csv").read().strip().splitlines()
    assert rows[0].startswith("step,loss,") and len(rows) >= 2
    # resume picks up from the checkpoint
    state2 = T.train_loop(cfg, n_steps=3, log=logs.append)
    assert int(state2.step) == 3
    assert any("resumed from step 3" in l for l in logs)


def test_pipeline_skips_corrupt_images(tmp_path):
    """A corrupt/missing image file must not kill the workers (which would
    hang training forever on q.get); it is skipped with a warning."""
    from openpose_plus.data.coco import CocoPoseDataset
    from openpose_plus.data.pipeline import TrainPipeline

    ann, imgs = _write_fake_dataset(tmp_path, n_images=6)
    # corrupt two of the files
    open(os.path.join(imgs, "im1.jpg"), "wb").write(b"not a jpeg")
    os.remove(os.path.join(imgs, "im3.jpg"))
    ds = CocoPoseDataset(ann, imgs)
    cfg = _tiny_config(batch=4)
    pipe = TrainPipeline(ds, cfg, seed=0, num_workers=2)
    it = iter(pipe)
    for _ in range(3):
        batch = next(it)
        assert batch["images"].shape[0] == 4
    pipe.stop()


def test_pipeline_raises_when_workers_die(tmp_path):
    """If every sample is unreadable the iterator raises instead of
    hanging forever."""
    from openpose_plus.data.coco import CocoPoseDataset
    from openpose_plus.data.pipeline import TrainPipeline
    import pytest

    ann, imgs = _write_fake_dataset(tmp_path, n_images=2)
    for i in range(2):
        os.remove(os.path.join(imgs, f"im{i}.jpg"))
    ds = CocoPoseDataset(ann, imgs)
    cfg = _tiny_config(batch=2)
    pipe = TrainPipeline(ds, cfg, seed=0, num_workers=1)
    # the consecutive-skip bound trips, the worker records the error and
    # dies, and the iterator raises instead of blocking forever
    with pytest.raises(RuntimeError):
        next(iter(pipe))


def test_pipeline_shards_are_disjoint(tmp_path):
    """Rank-strided sharding: two hosts' pipelines draw from disjoint
    sample sets covering the dataset (reference dataset.shard)."""
    from openpose_plus.data.coco import CocoPoseDataset
    from openpose_plus.data.pipeline import TrainPipeline

    ann, imgs = _write_fake_dataset(tmp_path, n_images=6)
    ds = CocoPoseDataset(ann, imgs)
    cfg = _tiny_config(batch=2)
    a = TrainPipeline(ds, cfg, seed=0, shard_index=0, shard_count=2)
    b = TrainPipeline(ds, cfg, seed=1, shard_index=1, shard_count=2)
    sa, sb = set(a._indices.tolist()), set(b._indices.tolist())
    assert sa.isdisjoint(sb)
    assert sa | sb == set(range(6))


def test_pipeline_emits_model_preferred_layout(tmp_path):
    """The train pipeline ships images in the model's fastest input
    layout (saves ~1.2 ms/step of on-device relayout); the jit step
    consumes it unchanged."""
    from openpose_plus.data.coco import CocoPoseDataset
    from openpose_plus.data.pipeline import TrainPipeline

    ann, imgs = _write_fake_dataset(tmp_path)
    cfg = _tiny_config(batch=4)
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, name="mobilenet_thin"),
        data=dataclasses.replace(cfg.data, train_annotations=ann,
                                 train_images=imgs, num_workers=1,
                                 prefetch=2))
    assert cfg.model.preferred_input_layout() == 2
    pipe = TrainPipeline(CocoPoseDataset(ann, imgs), cfg, seed=0,
                         num_workers=1)
    try:
        batch = next(iter(pipe))
        m = cfg.model
        assert batch["images"].shape == (4, m.hin // 4, m.win // 4, 48)
        state = T.create_train_state(cfg, jax.random.PRNGKey(0))
        step = T.make_train_step_on_batch(cfg)
        state, metrics = step(state, batch)
        assert bool(np.isfinite(float(metrics["loss"])))
    finally:
        pipe.stop()


def test_train_lowering_plain_stem_for_vgg19():
    """Training builds VGG19 with the PLAIN conv1 stem (the s2d block
    grid's 4x structural FLOPs cost more in dX/dW than lane starvation
    costs forward — measured 84.1 -> 81.3 ms/step at bs=8 368x656),
    while serving keeps s2d. The lowerings are parameter-compatible, so
    a state trained plain serves through the s2d engine unchanged."""
    cfg = default_config("vgg19")
    low = cfg.model.train_lowering()
    assert not low.stem_s2d and cfg.model.stem_s2d
    # train-side input layout is plain -> the pipeline must not s2d-pack
    assert low.preferred_input_layout() == 0
    assert low.input_shape(2) == (2, cfg.model.hin, cfg.model.win, 3)
    # every other zoo model keeps its serving lowering for training
    for name in ("mobilenet_thin", "vggtiny", "hao28"):
        m = default_config(name).model
        assert m.train_lowering() == m


def test_train_lowering_step_runs_plain_batch_vgg19(rng):
    """make_train_step_on_batch(vgg19) consumes the plain-layout batch
    the (train_lowering-aware) pipeline now emits."""
    cfg = default_config("vgg19")
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, hin=64, win=64, n_stages=2,
                                  compute_dtype="float32"),
        train=dataclasses.replace(cfg.train, batch_size=2, lr_init=3e-4,
                                  weight_decay=0.0))
    state = T.create_train_state(cfg, jax.random.PRNGKey(0))
    step = T.make_train_step_on_batch(cfg)
    state, metrics = step(state, _fake_batch(cfg, rng))
    assert np.isfinite(float(metrics["loss"]))


def test_effective_lr_init_rule():
    """lr_scaling="inv-sqrt-area": one lr_init transfers across geometry.
    At the reference area the rule is identity; at the serving tier's
    46x54 maps the zoo default 1e-3 maps to ~3.2e-4 — within 7% of the
    hand-tuned stable vgg19@368 lr (BASELINE.md)."""
    cfg = default_config().train
    cfg = dataclasses.replace(cfg, lr_init=1e-3,
                              lr_scaling="inv-sqrt-area", lr_ref_area=256)
    assert T.effective_lr_init(cfg, 256) == pytest.approx(1e-3)
    assert T.effective_lr_init(cfg, 46 * 54) == pytest.approx(
        1e-3 * (256 / 2484) ** 0.5)
    # default mode is reference parity: lr_init used as-is
    plain = dataclasses.replace(cfg, lr_scaling="none")
    assert T.effective_lr_init(plain, 46 * 54) == 1e-3
    with pytest.raises(ValueError):
        T.effective_lr_init(
            dataclasses.replace(cfg, lr_scaling="bogus"), 100)


def test_adam_loss_scale_invariance(rng):
    """Area-NORMALIZING the pose loss would be a no-op under Adam: scaling
    the loss by any constant c scales m by c and v by c^2, leaving
    m/sqrt(v) unchanged (up to eps). This is why the geometry-transfer
    fix is an lr rule (effective_lr_init), not a loss-normalization flag —
    dividing by hout*wout would change NOTHING about the vgg19@368
    divergence. Verified over several steps of the real train step."""
    cfg = _tiny_config(batch=2)
    batch = _fake_batch(cfg, rng)

    def run(loss_scale):
        import jax.numpy as jnp
        import optax

        model_cfg = cfg.model.train_lowering()
        from openpose_plus.models import get_model
        model = get_model(model_cfg)
        # eps=1e-12: the invariance m/sqrt(v) is exact as eps -> 0. At the
        # default eps=1e-8 the scaled run deviates ONLY on near-zero-
        # gradient parameters (g/area ~ eps suppresses their update;
        # measured max |delta| 1e-3 on 0.2-magnitude weights) — not the
        # large-gradient regime that decides stability/divergence.
        tx = optax.adam(cfg.train.lr_init, eps=1e-12)
        state = T.create_train_state(cfg, jax.random.PRNGKey(0))
        params, opt_state = state.params, tx.init(state.params)
        from openpose_plus.engine import preprocess_images
        images = preprocess_images(jnp.asarray(batch["images"]))
        gt_conf, gt_paf = make_targets_batch(
            jnp.asarray(batch["keypoints"]), cfg.model, cfg.data)

        @jax.jit
        def step(params, opt_state):
            def loss_fn(p):
                out = model.apply(p, images)
                l, _ = T.pose_loss(out, gt_conf, gt_paf,
                                   jnp.asarray(batch["mask"]))
                return l * loss_scale

            grads = jax.grad(loss_fn)(params)
            updates, opt_state = tx.update(grads, opt_state, params)
            return optax.apply_updates(params, updates), opt_state

        for _ in range(3):
            params, opt_state = step(params, opt_state)
        return params

    p_sum = run(1.0)
    p_mean = run(1.0 / (cfg.model.hout * cfg.model.wout))  # "area-normalized"
    flat_sum = np.concatenate([np.ravel(x) for x in jax.tree.leaves(p_sum)])
    flat_mean = np.concatenate([np.ravel(x) for x in jax.tree.leaves(p_mean)])
    # identical trajectories to float32 tolerance: loss normalization is a
    # no-op for Adam. A ~1e-5-fraction tail of near-zero-gradient elements
    # differs by up to ~lr (float32 rounding of m/sqrt(v) on tiny v) —
    # noise, not a systematic trajectory change.
    diff = np.abs(flat_sum - flat_mean)
    assert np.mean(diff > 5e-5) < 1e-4
    assert diff.max() < 2 * cfg.train.lr_init * 3   # << any real divergence
