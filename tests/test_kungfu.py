"""KungFu-strategy analogues (parallel/kungfu.py) on the 8-device CPU mesh.

Pins the semantics of each reference --kf-optimizer mapping:
  sync-sgd: replicas stay identical and match the idiomatic replicated path
  sma:      local steps then global model averaging -> replicas identical
  pair-avg: hypercube gossip -> XOR partners equal, global mean preserved
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from openpose_plus import train as T
from openpose_plus.config import default_config
from openpose_plus.parallel import kungfu as kf
from openpose_plus.parallel import sharding as S

from tests.test_train import _fake_batch, _tiny_config


def _mesh(cfg):
    return S.build_mesh(cfg.parallel)


def _stacked_state(cfg, mesh, seed=0):
    return kf.create_kungfu_state(cfg, mesh, jax.random.PRNGKey(seed))


def _max_replica_spread(params):
    spread = jax.tree.map(
        lambda p: float(jnp.max(jnp.abs(p - p[:1]))), params)
    return max(jax.tree.leaves(spread))


@pytest.mark.slow
def test_sync_sgd_matches_idiomatic_path(rng):
    cfg = _tiny_config(batch=8)
    mesh = _mesh(cfg)
    batch = _fake_batch(cfg, rng)

    state_ref = T.create_train_state(cfg, jax.random.PRNGKey(0))
    step_ref = T.make_train_step_on_batch(cfg)
    state_ref, m_ref = step_ref(state_ref, S.shard_batch(batch, mesh))

    state_kf = _stacked_state(cfg, mesh)
    (fn,) = kf.make_kungfu_steps(cfg, mesh, "sync-sgd")
    state_kf, m_kf = fn(state_kf, S.shard_batch(batch, mesh))

    assert _max_replica_spread(state_kf.params) == 0.0
    np.testing.assert_allclose(float(m_kf["loss"]), float(m_ref["loss"]),
                               rtol=1e-5)
    ref_leaves = jax.tree.leaves(state_ref.params)
    kf_leaves = jax.tree.leaves(kf.unstack_replica(state_kf.params))
    for a, b in zip(ref_leaves, kf_leaves):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=1e-6, rtol=1e-5)


@pytest.mark.slow
def test_sma_averages_replicas(rng):
    cfg = _tiny_config(batch=8)
    mesh = _mesh(cfg)
    state = _stacked_state(cfg, mesh)
    (fn,) = kf.make_kungfu_steps(cfg, mesh, "sma")
    state, metrics = fn(state, S.shard_batch(_fake_batch(cfg, rng), mesh))
    # after global model averaging every replica is identical...
    assert _max_replica_spread(state.params) == 0.0
    # ...but the optimizer state stays local (per-worker moments diverge).
    assert np.isfinite(float(metrics["loss"]))
    state, _ = fn(state, S.shard_batch(_fake_batch(cfg, rng), mesh))
    assert _max_replica_spread(state.params) == 0.0


def test_pair_avg_gossip_round(rng):
    """lr=0 isolates the averaging: XOR partners equal, mean preserved."""
    cfg = _tiny_config(batch=8)
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, lr_init=0.0, optimizer="momentum"))
    mesh = _mesh(cfg)
    n = mesh.shape["data"]
    state = _stacked_state(cfg, mesh)
    # distinct replicas: small per-replica offsets (small enough that the
    # forward pass stays finite — NaN grads would poison even lr=0 updates)
    state = state.replace(params=jax.tree.map(
        lambda p: p + 1e-3 * jnp.arange(n, dtype=p.dtype).reshape(
            (n,) + (1,) * (p.ndim - 1)),
        state.params))
    before = jax.device_get(state.params)

    fns = kf.make_kungfu_steps(cfg, mesh, "pair-avg")
    assert len(fns) == 3  # log2(8) hypercube rounds
    state, _ = fns[0](state, S.shard_batch(_fake_batch(cfg, rng), mesh))
    after = jax.device_get(state.params)

    for b, a in zip(jax.tree.leaves(before), jax.tree.leaves(after)):
        for i in range(n):
            np.testing.assert_allclose(
                a[i], (b[i] + b[i ^ 1]) / 2, atol=1e-6)
        np.testing.assert_allclose(a.mean(0), b.mean(0), atol=1e-6)


@pytest.mark.slow
def test_pair_avg_mixes_all_replicas(rng):
    """After log2(n) gossip rounds (lr=0) every replica equals the mean."""
    cfg = _tiny_config(batch=8)
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, lr_init=0.0, optimizer="momentum"))
    mesh = _mesh(cfg)
    n = mesh.shape["data"]
    state = _stacked_state(cfg, mesh)
    state = state.replace(params=jax.tree.map(
        lambda p: p + 1e-3 * jnp.arange(n, dtype=p.dtype).reshape(
            (n,) + (1,) * (p.ndim - 1)),
        state.params))
    mean_before = jax.tree.map(lambda p: np.asarray(p).mean(0), state.params)

    fns = kf.make_kungfu_steps(cfg, mesh, "pair-avg")
    for i in range(len(fns)):
        state, _ = fns[i](state, S.shard_batch(_fake_batch(cfg, rng), mesh))
    assert _max_replica_spread(state.params) < 1e-5
    for m, a in zip(jax.tree.leaves(mean_before),
                    jax.tree.leaves(jax.device_get(state.params))):
        np.testing.assert_allclose(a[0], m, atol=1e-5)


def test_pair_avg_requires_power_of_two():
    cfg = _tiny_config(batch=6)
    devs = jax.devices()[:6]
    mesh = S.build_mesh(cfg.parallel, devices=devs)
    with pytest.raises(ValueError, match="power-of-two"):
        kf.make_kungfu_steps(cfg, mesh, "pair-avg")


@pytest.mark.slow
def test_strategies_learn(rng):
    """Loss decreases under each strategy on a fixed batch.

    Decentralized strategies converge slower than sync-sgd on 1-image local
    shards (the averaging damps per-worker overfitting), so this needs more
    steps than test_loss_decreases; raising lr instead destabilizes local
    Adam on single-image shards.
    """
    for strategy in ("sma", "pair-avg"):
        cfg = _tiny_config(batch=8)
        mesh = _mesh(cfg)
        state = _stacked_state(cfg, mesh)
        fns = kf.make_kungfu_steps(cfg, mesh, strategy)
        batch = S.shard_batch(_fake_batch(cfg, rng), mesh)
        losses = []
        for i in range(24):
            state, metrics = fns[i % len(fns)](state, batch)
            losses.append(float(metrics["loss"]))
        assert losses[-1] < losses[0] * 0.9, (strategy, losses)


@pytest.mark.slow
def test_train_loop_with_sma_strategy(tmp_path):
    """train_loop end-to-end under a decentralized strategy: per-device
    replicas, checkpointing worker 0's replica, resume restacking."""
    from openpose_plus import checkpoint as ckpt
    from tests.test_train import _write_fake_dataset

    ann, imgs = _write_fake_dataset(tmp_path)
    cfg = _tiny_config(batch=8)
    cfg = cfg.replace(
        data=dataclasses.replace(cfg.data, train_annotations=ann,
                                 train_images=imgs, num_workers=1,
                                 prefetch=2),
        train=dataclasses.replace(cfg.train, batch_size=8, log_every=2,
                                  checkpoint_every=2, kf_optimizer="sma",
                                  checkpoint_dir=str(tmp_path / "ck")),
    )
    logs = []
    state = T.train_loop(cfg, n_steps=2, log=logs.append)
    # per-device replicas: step has the replica axis, all replicas advanced
    assert state.step.shape == (8,) and int(state.step[0]) == 2
    assert _max_replica_spread(state.params) == 0.0  # sma equalizes
    # checkpoint holds a single (worker-0) replica and resume restacks it
    assert ckpt.latest_step(str(tmp_path / "ck")) == 2
    state2 = T.train_loop(cfg, n_steps=2, log=logs.append)
    assert any("resumed from step 2" in l for l in logs)
    assert int(state2.step[0]) == 2
