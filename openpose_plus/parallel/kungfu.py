"""KungFu-equivalent decentralized training strategies.

The reference's distributed trainer exposes three KungFu optimizer wrappers
via `--kf-optimizer` (train.py :: parallel_train [HIGH; empty mount —
SURVEY.md §2 "Distributed trainer"]):

  * sync-sgd  -> SynchronousSGDOptimizer: gradients all-reduced every step;
    every worker holds identical parameters.
  * sma       -> SynchronousAveragingOptimizer: each worker applies its own
    local gradients, then parameters are averaged across all workers.
  * pair-avg  -> PairAveragingOptimizer: asynchronous gossip — each worker
    applies local gradients and averages parameters with one peer at a time.

Async gossip has no compiled analogue (collectives are compiled into the
program), so pair-avg maps to deterministic HYPERCUBE GOSSIP: at round r,
every device averages parameters with partner `idx XOR 2^(r mod log2 n)`
via a static `ppermute`. One peer per step, like PairAveraging; after
log2(n) rounds every worker's information has mixed into every other — the
same mixing PairAveraging achieves in expectation, without host-side
asynchrony that XLA cannot express.

Implementation is the KungFu model exactly: PER-DEVICE parameter and
optimizer-state replicas (leading axis of size n sharded over the `data`
mesh axis) inside `shard_map`, local steps, explicit collectives. The
default sync-sgd path in train.py (replicated params + sharded batch +
XLA-inserted psum) is the idiomatic equivalent of KungFu sync-sgd; this
module exists for the other two strategies and for sync-sgd parity testing.
"""

from __future__ import annotations

import functools
from typing import Any, Callable

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from openpose_plus.config import Config

STRATEGIES = ("sync-sgd", "sma", "pair-avg")


def stack_for_devices(tree: Any, n: int) -> Any:
    """Replicate a pytree n times along a new leading axis (KungFu's
    BroadcastGlobalVariablesOp: every worker starts from the same values)."""
    return jax.tree.map(lambda x: jnp.broadcast_to(x[None], (n,) + x.shape),
                        tree)


def unstack_replica(tree: Any, index: int = 0) -> Any:
    """Extract one worker's replica (KungFu checkpoints rank 0's)."""
    return jax.tree.map(lambda x: x[index], tree)


def replica_sharding(mesh: Mesh) -> NamedSharding:
    """Leading replica axis over the data mesh axis."""
    return NamedSharding(mesh, P(mesh.axis_names[0]))


def make_kungfu_steps(config: Config, mesh: Mesh, strategy: str
                      ) -> list[Callable]:
    """Build the jit'd per-round step functions for a strategy.

    Returns a list; the train loop cycles `fns[step % len(fns)]`. sync-sgd
    and sma need one compiled program; pair-avg needs log2(n) (one per
    hypercube dimension — the partner permutation is static per program).

    State trees must carry a leading replica axis of size n (see
    stack_for_devices) sharded over the data axis; batches are sharded over
    the same axis on their leading batch dimension.
    """
    from openpose_plus.data.targets import make_targets_batch
    from openpose_plus.engine import preprocess_images
    from openpose_plus.models import get_model
    from openpose_plus.train import (TrainState, lr_schedule,
                                         make_optimizer, pose_loss)

    if strategy not in STRATEGIES:
        raise ValueError(f"unknown kf strategy {strategy!r}; "
                         f"choose from {STRATEGIES}")
    axis = mesh.axis_names[0]
    n = mesh.shape[axis]
    for other in mesh.axis_names[1:]:
        if mesh.shape[other] != 1:
            raise ValueError(
                f"kf strategy {strategy!r} shards over {axis!r} only; mesh "
                f"axis {other!r} has size {mesh.shape[other]} — spatial "
                f"partitioning is not supported with decentralized "
                f"strategies (use kf_optimizer='sync-sgd')")
    if strategy == "pair-avg" and (n & (n - 1) or n < 2):
        raise ValueError(f"pair-avg hypercube gossip needs a power-of-two "
                         f"device count, got {n}")
    # same lowering contract as train.py: training programs build against
    # train_lowering() (vgg19 trains plain-stem), so kungfu strategies run
    # the same program as the default trainer they parity-test
    model = get_model(config.model.train_lowering())
    out_area = config.model.hout * config.model.wout
    tx = make_optimizer(config.train, out_area)

    def step_fn(state: TrainState, batch, *, rnd: int):
        # shard_map keeps the mapped replica axis as a size-1 leading dim;
        # strip it so the body is one worker's local step.
        state = jax.tree.map(lambda x: x[0], state)
        images = preprocess_images(batch["images"])
        gt_conf, gt_paf = make_targets_batch(
            batch["keypoints"], config.model, config.data)
        mask = batch["mask"]

        def loss_fn(params):
            out = model.apply(params, images)
            return pose_loss(out, gt_conf, gt_paf, mask)

        (loss, metrics), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(state.params)
        if strategy == "sync-sgd":
            grads = jax.lax.pmean(grads, axis)
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        if strategy == "sma":
            params = jax.lax.pmean(params, axis)
        elif strategy == "pair-avg":
            shift = 1 << rnd
            perm = [(i, i ^ shift) for i in range(n)]
            peer = jax.tree.map(
                lambda p: jax.lax.ppermute(p, axis, perm), params)
            params = jax.tree.map(lambda a, b: (a + b) * 0.5, params, peer)
        new_state = TrainState(step=state.step + 1, params=params,
                               opt_state=opt_state)
        new_state = jax.tree.map(lambda x: x[None], new_state)  # replica axis
        # metrics are per-worker; average for logging (out_spec is P()).
        metrics = jax.lax.pmean(dict(metrics, loss=loss), axis)
        metrics["lr"] = lr_schedule(config.train, out_area)(state.step)
        return new_state, metrics

    n_rounds = max(1, n.bit_length() - 1) if strategy == "pair-avg" else 1
    state_spec = P(axis)
    batch_spec = P(axis)
    fns = []
    for rnd in range(n_rounds):
        body = functools.partial(step_fn, rnd=rnd)
        mapped = jax.shard_map(
            body, mesh=mesh,
            in_specs=(state_spec, batch_spec),
            out_specs=(state_spec, P()),
            check_vma=False)
        donate = (0,) if config.train.donate_state else ()
        fns.append(jax.jit(mapped, donate_argnums=donate))
    return fns


def create_kungfu_state(config: Config, mesh: Mesh, rng: jax.Array):
    """Per-device replicated TrainState, placed with the replica sharding."""
    from openpose_plus.train import TrainState, create_train_state

    n = mesh.shape[mesh.axis_names[0]]
    state = create_train_state(config, rng)
    # step stays per-replica too (shard_map maps every leaf).
    stacked = TrainState(
        step=jnp.zeros((n,), jnp.int32),
        params=stack_for_devices(state.params, n),
        opt_state=stack_for_devices(state.opt_state, n))
    return jax.device_put(stacked, replica_sharding(mesh))
