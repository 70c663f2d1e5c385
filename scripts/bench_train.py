"""Training-step throughput on the real chip (images/sec).

The training analogue of bench.py: times the FULL on-device train step —
uint8 normalize, GT heatmap/PAF synthesis (make_targets_batch), forward,
deep-supervision loss, backward, optimizer update — with the jitted
fori-loop two-point-slope methodology (see bench.fori_slope_seconds:
iterations chained through the loss scalar inside ONE device program, so
the number is independent of the rig's per-dispatch latency).

    python scripts/bench_train.py [--model mobilenet_thin] [--batch 8]
                                  [--hin 368] [--win 656] [--remat]

Prints one JSON line per config: {"metric": "train_imgs_per_sec_...",
"value": N, "unit": "imgs/s"}.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="mobilenet_thin")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--hin", type=int, default=368)
    ap.add_argument("--win", type=int, default=656)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--remat", action="store_true",
                    help="rematerialize stage activations (jax.checkpoint)")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from openpose_plus.utils.compile_cache import configure_compile_cache

    configure_compile_cache()

    from openpose_plus import train as T
    from openpose_plus.config import default_config

    cfg = default_config(args.model)
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, hin=args.hin, win=args.win,
                                  remat_stages=args.remat),
        train=dataclasses.replace(cfg.train, batch_size=args.batch))

    from bench import fori_slope_seconds

    state = T.create_train_state(cfg, jax.random.PRNGKey(0))
    tstep = T.make_train_step_on_batch(cfg)

    rng = np.random.default_rng(0)
    max_people = 8
    # images in the model's preferred input layout — exactly what the
    # train pipeline ships (host-side space-to-depth; data/pipeline.py)
    img_shape = cfg.model.train_lowering().input_shape(args.batch)
    batch = {
        "images": jnp.asarray(rng.integers(
            0, 255, img_shape, dtype=np.uint8)),
        "keypoints": jnp.asarray(np.concatenate([
            rng.uniform(0, args.win, (args.batch, max_people, 18, 1)),
            rng.uniform(0, args.hin, (args.batch, max_people, 18, 1)),
            (rng.random((args.batch, max_people, 18, 1)) < 0.7),
        ], axis=-1).astype(np.float32)),
        "mask": jnp.ones(
            (args.batch, args.hin // cfg.model.stride,
             args.win // cfg.model.stride, 1), jnp.float32),
    }

    # n chained steps in ONE device program: each iteration's mask is
    # perturbed by the previous loss, so the device must run them in
    # order; only the final loss scalar leaves the chip. The state is
    # DONATED (params + opt state would otherwise be double-buffered
    # across the call boundary — peak-memory headroom risk on VGG19 /
    # large batches) and threaded across passes through a host-side
    # holder, since donation invalidates the input buffers.
    @functools.partial(jax.jit, donate_argnums=1)
    def loop(n, state, batch, carry):
        def body(_, sc):
            st, c = sc
            b = dict(batch)
            b["mask"] = batch["mask"] + c * 1e-12
            st, metrics = tstep(st, b)
            return (st, metrics["loss"])
        return jax.lax.fori_loop(0, n, body, (state, carry))

    holder = {"state": state}

    def loop_fn(n, c):
        holder["state"], loss = loop(n, holder["state"], batch, c)
        return loss

    best = fori_slope_seconds(loop_fn, jnp.float32(0.0),
                              repeats=args.repeats)

    name = (f"train_imgs_per_sec_{args.model}_{args.hin}x{args.win}"
            f"_bs{args.batch}" + ("_remat" if args.remat else ""))
    print(json.dumps({"metric": name,
                      "value": round(args.batch / best, 2),
                      "unit": "imgs/s",
                      "ms_per_step": round(best * 1e3, 2)}), flush=True)


if __name__ == "__main__":
    main()
