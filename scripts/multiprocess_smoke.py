"""Multi-host smoke test: 2 processes on localhost, one global mesh.

The reference validates its KungFu distributed path by launching
`kungfu-run -np N` on one box — "multi-node-without-a-cluster" (SURVEY.md
§4). Analogue here: two processes call jax.distributed.initialize()
against a localhost coordinator, each owning 4 virtual CPU devices, and
run the SAME jit'd train step over the global (8-device) data mesh; XLA
inserts the cross-process gradient reductions.

Run directly (spawns its own children):   python scripts/multiprocess_smoke.py
Child mode (internal):                    ... --child <rank> --port <p>
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

N_PROC = 2
LOCAL_DEVICES = 4


def child(rank: int, port: int) -> None:
    import jax

    jax.config.update("jax_num_cpu_devices", LOCAL_DEVICES)
    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=N_PROC,
        process_id=rank,
    )
    assert jax.process_count() == N_PROC
    assert jax.device_count() == N_PROC * LOCAL_DEVICES

    import dataclasses

    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from openpose_plus import train as T
    from openpose_plus.config import default_config
    from openpose_plus.parallel import sharding as S

    cfg = default_config("vggtiny")
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, hin=64, win=64, n_stages=2,
                                  compute_dtype="float32"),
        train=dataclasses.replace(cfg.train, batch_size=8,
                                  weight_decay=0.0))
    mesh = S.build_mesh(cfg.parallel)

    state = T.create_train_state(cfg, jax.random.PRNGKey(0))
    state = jax.device_put(state, S.replicated(mesh))

    # Global batch assembled from per-process local shards (each process
    # contributes batch/N samples) — the dataset.shard() analogue.
    rng = np.random.default_rng(0)   # same stream; slice differs per rank
    m = cfg.model
    g = cfg.train.batch_size
    images = rng.uniform(0, 255, (g, m.hin, m.win, 3)).astype(np.float32)
    kp = np.zeros((g, 4, 18, 3), np.float32)
    kp[:, 0, :, 0] = rng.uniform(5, m.win - 5, (g, 18))
    kp[:, 0, :, 1] = rng.uniform(5, m.hin - 5, (g, 18))
    kp[:, 0, :, 2] = 1
    mask = np.ones((g, m.hout, m.wout, 1), np.float32)

    lo, hi = rank * g // N_PROC, (rank + 1) * g // N_PROC

    def to_global(arr, sharding):
        return jax.make_array_from_process_local_data(
            sharding, np.ascontiguousarray(arr[lo:hi]), arr.shape)

    batch = {
        "images": to_global(images.astype(np.uint8),
                            NamedSharding(mesh, P("data"))),
        "keypoints": to_global(kp, NamedSharding(mesh, P("data"))),
        "mask": to_global(mask, NamedSharding(mesh, P("data"))),
    }
    step = T.make_train_step_on_batch(cfg)
    state, metrics = step(state, batch)
    loss = float(metrics["loss"])
    assert np.isfinite(loss)

    # Distributed-eval merge: detection/GT payload SHAPES vary per rank
    # (different counts and row widths); _allgather_padded must agree on
    # the global max dims first — process_allgather itself requires
    # identical shapes on every host.
    from openpose_plus import eval_coco as E

    n_local = 3 + rank * 2
    rows = np.zeros((n_local, 53), np.float32)
    rows[:, 0] = np.arange(n_local) + 100 * rank
    rows[:, 1] = 0.5
    dets = E._unpack_detections(E._allgather_padded(rows))
    want = sum(3 + r * 2 for r in range(N_PROC))
    assert len(dets) == want, (len(dets), want)

    g = 1 + rank  # different people counts -> different row widths
    gt_local = {1000 + rank: (np.ones((g, 17, 3), np.float32),
                              np.ones((g,), np.float32),
                              np.ones((rank, 4), np.float32))}
    gt_all = E._unpack_gt(E._allgather_padded(E._pack_gt(gt_local)))
    assert set(gt_all) == {1000 + r for r in range(N_PROC)}, gt_all.keys()
    for r in range(N_PROC):
        kps, areas, ign = gt_all[1000 + r]
        assert kps.shape == (1 + r, 17, 3) and ign.shape == (r, 4)

    # Distributed eval IN ANGER (not just pack/unpack round-trips): the
    # full evaluate_engine(distributed=True) path — per-process dataset
    # slice -> real Engine.infer -> detection/GT gather across the two
    # processes -> AP — must equal the single-process AP bit-for-bit,
    # since both ranks hold identical params and an identical seeded
    # scene bank. Permissive grouping thresholds guarantee the untrained
    # net still emits detections, so the gather carries real payloads.
    import tempfile

    from openpose_plus.data.coco import CocoPoseDataset
    from openpose_plus.data.synthetic import make_scene_bank
    from openpose_plus.engine import Engine

    bank_dir = os.path.join(tempfile.gettempdir(), f"mp_eval_bank_r{rank}")
    ann, imgs = make_scene_bank(bank_dir, "val", 12, 128)
    ds = CocoPoseDataset(ann, imgs)
    ecfg = cfg.replace(postproc=dataclasses.replace(
        cfg.postproc, peak_threshold=0.0, paf_sample_threshold=-1.0,
        paf_inlier_ratio=0.0, min_parts_per_human=1))
    eng = Engine(ecfg, params=state.params)
    r_single = E.evaluate_engine(eng, ds, batch_size=4, distributed=False)
    r_dist = E.evaluate_engine(eng, ds, batch_size=4, distributed=True)
    assert r_dist.n_images == r_single.n_images == 12, (
        r_dist.n_images, r_single.n_images)
    assert r_dist.n_dets == r_single.n_dets > 0, (
        r_dist.n_dets, r_single.n_dets)
    assert abs(r_dist.ap - r_single.ap) < 1e-9, (r_dist.ap, r_single.ap)
    assert abs(r_dist.ar - r_single.ar) < 1e-9, (r_dist.ar, r_single.ar)

    print(f"RANK{rank} OK loss={loss:.6f} evalgather=ok "
          f"dist_eval_ap={r_dist.ap:.6f} dist_eval_dets={r_dist.n_dets}",
          flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--child", type=int, default=None)
    ap.add_argument("--port", type=int, default=12421)
    args = ap.parse_args()
    if args.child is not None:
        child(args.child, args.port)
        return 0

    # Children run on the CPU: each JAX process would otherwise claim most
    # of a card's memory, and one card serves one process.
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__),
             "--child", str(r), "--port", str(args.port)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        for r in range(N_PROC)
    ]
    ok = True
    losses, aps = [], []
    for r, p in enumerate(procs):
        out, _ = p.communicate(timeout=900)
        text = out.decode()
        if p.returncode != 0 or f"RANK{r} OK" not in text:
            ok = False
            print(f"--- rank {r} FAILED ---\n{text}")
        else:
            for line in text.splitlines():
                if line.startswith(f"RANK{r} OK"):
                    losses.append(float(line.split("loss=")[1].split()[0]))
                    aps.append(line.split("dist_eval_ap=")[1].split()[0])
    if (ok and len(set(f"{l:.6f}" for l in losses)) == 1
            and len(set(aps)) == 1):
        print(f"MULTIPROCESS OK: {N_PROC} procs, loss={losses[0]:.6f}, "
              f"dist_eval_ap={aps[0]}")
        return 0
    print("MULTIPROCESS FAILED", losses)
    return 1


if __name__ == "__main__":
    sys.exit(main())
