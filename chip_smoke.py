#!/usr/bin/env python3
"""Bring-up check of the pose engine on a GPU: the quickest proof that the
system starts on the card and computes the right thing.

    python chip_smoke.py            # one card: phases 0-6 below
    python chip_smoke.py --four     # four cards: the multi-card path only

One process drives every card. Phases, in order; the first failure ends the
run with a non-zero exit code:

  0. device   a GPU must be JAX's default backend (no CPU fallback)
  1. serve    Engine(mobilenet_thin) at 368x656, bs=8, seeded uint8 frames:
              s2d^2 and plain layouts give bit-equal maps and the same
              skeletons (RANDOM_WEIGHT_DECODER, non-empty); final maps
              vs a float32 plain-lowering reference; the decoder vs the
              numpy oracle on synthetic scenes (one crowd fills K=16)
  2. zoo      vgg19, vggtiny, hao28 at 368x656, bs=8, each vs its own
              float32 plain-lowering reference
  3. presets  fidelity() (K=32, upsample 8) vs the oracle; quality()
              (fragment merge) vs the same decoder on the CPU
  4. kernels  the Triton greedy/merge kernels vs their XLA twins, bit-exact
              at K in {16, 32}, 32 humans, batch 8, with times; the engine
              step timed with the kernels and with the twins
  5. train    make_train_step_on_batch, mobilenet_thin 368x656 bs=8, three
              steps on synthetic scenes; step-1 loss vs a float32 plain step
  6. export   export.save_engine at bs=8, reload: same skeletons as the
              Exported it was written from; vs phase 1's engine, a
              well-formed table with as many humans within 10%

The last line of standard output is one JSON object with "ok" and the
device; everything else comes before it. The comparison functions are also
called by tests/test_chip_smoke.py (small shapes on the CPU; full checks
on the card under `-m chip`).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import sys
import tempfile
import time
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np

from openpose_plus import skeleton
from openpose_plus.config import PostprocConfig, default_config
from openpose_plus.engine import Engine, infer_step, preprocess_images
from openpose_plus.models import get_model
from openpose_plus.postproc import decode, group, oracle, paf as jpaf
from openpose_plus.utils.compile_cache import configure_compile_cache
from openpose_plus.data import scenes as synth

HIN, WIN, BATCH = 368, 656, 8
# bf16 serving vs the float32 plain-lowering reference, as max|got - ref|
# over max|ref| of the final-stage maps: bf16 keeps 8 mantissa bits and
# the error compounds over ~30 conv layers.
CNN_TOL = 5e-2
# Step-1 training loss, bf16 step vs float32 plain step (relative).
LOSS_TOL = 2e-2
# Gradients of one float32 step (HIGHEST precision) on several cards vs
# one card, read from Adam's first moment (mu = (1 - b1) g after one
# step) as the worst leaf's ||got - ref|| / ||ref||: the same sums in
# another order. A missing or wrong all-reduce is off by O(1). bf16
# gradients depend on how the backend sums bf16 (on the CPU the bias
# gradients, sums over every pixel that cancel, differ by O(1) between
# batch splits), so bf16 steps are held to their loss only.
GRAD_TOL = 1e-3
# Random weights give maps of about 1e-3, below every default threshold,
# so the default decoder finds nobody in them. This one keeps every local
# maximum and every limb of positive score: the checks that follow one
# engine's output across input layouts, export and shards then compare
# crowds of skeletons, not empty tables.
RANDOM_WEIGHT_DECODER = PostprocConfig(
    peak_threshold=-1.0, paf_sample_threshold=-1.0, min_human_score=-1.0)


class SmokeFailure(AssertionError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def rel_err(got, ref) -> float:
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-12))


def model_config(name: str, **kw):
    cfg = default_config(name)
    kw = {"hin": HIN, "win": WIN, **kw}
    return cfg.replace(model=dataclasses.replace(cfg.model, **kw))


def frames(cfg, batch: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (batch, cfg.model.hin, cfg.model.win, 3),
                        dtype=np.uint8)


def to_layout(images: np.ndarray, level: int) -> np.ndarray:
    from openpose_plus.models.common import space_to_depth

    x = jnp.asarray(images)
    for _ in range(level):
        x = space_to_depth(x)
    return np.asarray(x)


# ------------------------------------------------------------ comparisons --

def same_skeletons(a, b) -> int:
    """Two HumanBatches from the same maps must agree exactly, and hold
    somebody. Returns the number of humans."""
    for f in ("valid", "n_parts", "part_valid", "coords", "score",
              "part_scores"):
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        check(x.shape == y.shape and np.array_equal(x, y),
              f"skeletons differ in {f}")
    n = int(np.asarray(a.valid).sum())
    check(n > 0, "no humans to compare")
    return n


def same_maps(a, b) -> None:
    """Two (conf, paf) pairs must be bit for bit equal."""
    for name, x, y in zip(("conf", "paf"), a, b):
        x, y = np.asarray(x), np.asarray(y)
        check(x.shape == y.shape and np.array_equal(x, y),
              f"{name} maps differ")


def cnn_error(cfg, params, images: np.ndarray) -> float:
    """Final-stage maps of the served lowering (the model's preferred input
    layout, its compute dtype) vs the float32 plain-lowering reference
    built from the same params, under HIGHEST matmul/conv precision."""
    m = cfg.model
    served = get_model(m)
    level = m.preferred_input_layout()
    got = jax.jit(lambda p, x: _final_maps(served, p, x))(
        params, to_layout(images, level))
    ref_model = get_model(dataclasses.replace(m, stem_s2d=False,
                                              compute_dtype="float32"))
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(lambda p, x: _final_maps(ref_model, p, x))(
            params, images)
    return max(rel_err(got[0], ref[0]), rel_err(got[1], ref[1]))


def _final_maps(model, params, images):
    out = model.apply(params, preprocess_images(images))
    return out["conf"][-1], out["paf"][-1]


def decoder_scenes(h: int, w: int, batch: int, seed: int):
    """Synthetic (conf, paf) maps at the network's output size: a crowd
    wider than K=16 people, clean and noisy groups, pure noise. Every
    position is jittered, so no two people are exact copies: exact
    distance ties would let the last bit of a sum decide a merge order."""
    out = []
    rng = np.random.default_rng(seed)
    for i in range(batch):
        kind = i % 4
        if kind == 0:      # crowd: 2 rows of people, more than K
            cols = max(2, (w - 4) // 5)
            people = [synth.standing_person(
                3.3 + 5.0 * c + rng.uniform(-0.3, 0.3),
                11.2 + 21.0 * r + rng.uniform(-0.3, 0.3),
                rng.uniform(0.43, 0.49)) for r in range(2) for c in range(cols)]
            out.append(synth.make_maps(people, h, w, sigma=1.2,
                                         limb_width=0.8))
        elif kind == 3:    # pure noise: ties and conflicts everywhere
            out.append((rng.uniform(0, 0.4, (h, w, 19)).astype(np.float32),
                        rng.uniform(-1, 1, (h, w, 38)).astype(np.float32)))
        else:
            n = 2 + i % 3
            people = [synth.standing_person(
                8.3 + (w - 16) * j / max(n - 1, 1) + rng.uniform(-0.3, 0.3),
                h * 0.45 + 1.7 * j + rng.uniform(-0.3, 0.3),
                0.9 + 0.13 * j) for j in range(n)]
            out.append(synth.make_maps(people, h, w, noise=0.1 * (kind - 1),
                                       seed=seed + i))
    return np.stack([c for c, _ in out]), np.stack([p for _, p in out])


def _oracle_humans(smoothed, paf_u, cfg):
    return oracle.decode_oracle(smoothed, paf_u, cfg, preprocessed=True)


def _device_humans(batch, i):
    out = []
    for m in np.nonzero(np.asarray(batch.valid[i]))[0]:
        pv = np.asarray(batch.part_valid[i, m])
        coords = np.asarray(batch.coords[i, m])
        scores = np.asarray(batch.part_scores[i, m])
        out.append(({p: tuple(float(v) for v in (*coords[p], scores[p]))
                     for p in range(skeleton.N_PARTS) if pv[p]},
                    float(np.asarray(batch.score[i, m])),
                    int(np.asarray(batch.n_parts[i, m]))))
    return out


def match_humans(ref, got, tol: float = 1e-3) -> None:
    """Same people, same parts, coords/scores within `tol` (the oracle is
    float64 numpy; the device is float32). `ref` rows are oracle humans
    or _device_humans tuples."""
    check(len(ref) == len(got), f"human count {len(ref)} vs {len(got)}")
    unmatched = list(range(len(got)))
    for r in ref:
        if isinstance(r, tuple):
            r_parts, r_mean, r_n = r
        else:
            r_parts, r_mean, r_n = r.parts, r.score / r.n_parts, r.n_parts
        hit = None
        for i in unmatched:
            parts, score, n = got[i]
            if (n == r_n and set(parts) == set(r_parts)
                    and abs(score - r_mean) <= tol
                    and all(abs(a - b) <= tol for p in r_parts
                            for a, b in zip(parts[p], r_parts[p]))):
                hit = i
                break
        check(hit is not None, f"no match for human with {r_n} parts")
        unmatched.remove(hit)


def oracle_check(conf: np.ndarray, paf: np.ndarray, cfg: PostprocConfig
                 ) -> list[int]:
    """Decode a batch on the default device and compare every image with
    the numpy oracle fed the exact floats the device consumed. Returns the
    human count per image."""
    batch = decode.build_decoder(cfg)(jnp.asarray(conf), jnp.asarray(paf))
    prep = jax.jit(jax.vmap(functools.partial(decode.preprocess_single,
                                              cfg=cfg)))
    smoothed, paf_u = (np.asarray(a) for a in prep(conf, paf))
    counts = []
    for i in range(conf.shape[0]):
        got = _device_humans(batch, i)
        match_humans(_oracle_humans(smoothed[i], paf_u[i], cfg), got)
        counts.append(len(got))
    return counts


def cpu_check(conf: np.ndarray, paf: np.ndarray, cfg: PostprocConfig
              ) -> list[int]:
    """Decode on the default device and on the CPU (the XLA twins, which
    the oracle tests pin); the skeletons must match."""
    dec = decode.build_decoder(cfg)
    batch = dec(jnp.asarray(conf), jnp.asarray(paf))
    cpu = jax.devices("cpu")[0]
    ref = dec(jax.device_put(conf, cpu), jax.device_put(paf, cpu))
    counts = []
    for i in range(conf.shape[0]):
        got = _device_humans(batch, i)
        match_humans(_device_humans(ref, i), got)
        counts.append(len(got))
    return counts


def tail_inputs(k: int, batch: int, seed: int):
    """Candidate scores shaped like score_candidates' output, with exact
    ties, plus peak scores."""
    rng = np.random.default_rng(seed)
    s = rng.uniform(0.01, 1.0, (batch, 19, k, k)).astype(np.float32)
    s = np.where(rng.random(s.shape) < 0.3, s, -np.inf).astype(np.float32)
    s[:, 3, 1, 2] = s[:, 3, 0, 5] = s[:, 3, 4, 4] = 0.7
    s[:, 7] = -np.inf
    ps = rng.uniform(0.1, 1.0, (batch, 18, k)).astype(np.float32)
    return jnp.asarray(s), jnp.asarray(ps)


def kernel_check(k: int, m: int = 32, batch: int = BATCH, seed: int = 0,
                 interpret: bool = False, timed: bool = False) -> dict:
    """The Triton greedy and merge kernels vs paf.greedy_assign and
    group.assemble: bit-exact on every field. With `timed`, each side's
    seconds per call inside one jitted loop."""
    from openpose_plus.ops.pallas.greedy import greedy_assign_pallas
    from openpose_plus.ops.pallas.merge import assemble_pallas

    scores, ps = tail_inputs(k, batch, seed)
    g_kernel = jax.vmap(functools.partial(greedy_assign_pallas, max_peaks=k,
                                          interpret=interpret))
    g_twin = jax.vmap(functools.partial(jpaf.greedy_assign, max_peaks=k))
    m_kernel = jax.vmap(functools.partial(assemble_pallas, max_peaks=k,
                                          max_humans=m, interpret=interpret))
    m_twin = jax.vmap(lambda c, p: group.assemble(c, p.reshape(-1), k, m))
    conns, ref = jax.jit(g_kernel)(scores), jax.jit(g_twin)(scores)
    for f in ("slot_a", "slot_b", "score", "valid"):
        check(np.array_equal(np.asarray(getattr(conns, f)),
                             np.asarray(getattr(ref, f))),
              f"greedy kernel K={k}: {f} differs from paf.greedy_assign")
    sub, sub_ref = jax.jit(m_kernel)(ref, ps), jax.jit(m_twin)(ref, ps)
    for f in ("parts", "score", "count"):
        check(np.array_equal(np.asarray(getattr(sub, f)),
                             np.asarray(getattr(sub_ref, f))),
              f"merge kernel K={k}: {f} differs from group.assemble")
    res = {"connections": int(np.asarray(ref.valid).sum()),
           "humans": int((np.asarray(sub_ref.count) > 0).sum())}
    if timed:
        res.update({
            "greedy_kernel_us": 1e6 * loop_seconds(g_kernel, scores),
            "greedy_xla_us": 1e6 * loop_seconds(g_twin, scores),
            "merge_kernel_us": 1e6 * loop_seconds(m_kernel, ref, ps),
            "merge_xla_us": 1e6 * loop_seconds(m_twin, ref, ps)})
    return res


def loop_seconds(fn, *args, n1: int = 20, n2: int = 120) -> float:
    """Seconds per call of `fn(*args)` inside one jitted fori_loop: each
    iteration's inputs depend on the previous result (so nothing is
    hoisted), and the slope between two trip counts cancels the fixed
    cost of the call."""
    @functools.partial(jax.jit, static_argnums=0)
    def loop(n, c, args):
        def body(_, c):
            a = jax.tree.map(
                lambda x: jnp.where(c > 1e30, jnp.zeros_like(x), x), args)
            out = fn(*a)
            return c + 1e-30 * sum(jnp.sum(l.astype(jnp.float32))
                                   for l in jax.tree.leaves(out))
        return jax.lax.fori_loop(0, n, body, c)

    best = {}
    for n in (n1, n2, n1, n2, n1, n2):
        t0 = time.perf_counter()
        float(loop(n, jnp.float32(0), args))
        best[n] = min(best.get(n, np.inf), time.perf_counter() - t0)
    return (best[n2] - best[n1]) / (n2 - n1)


def engine_step_seconds(engine, images, twins: bool, n: int = 30) -> float:
    """Seconds per engine step (preprocess -> CNN -> decode), dispatched
    back to back and waited for once. With `twins` the decoder's serial
    tail is traced with the XLA twins in place of the kernels."""
    patch = (mock.patch.object(decode, "_serial_tail_kernels",
                               decode._serial_tail_xla) if twins
             else contextlib.nullcontext())
    with patch:
        step = jax.jit(functools.partial(
            infer_step, model=engine.model,
            postproc_cfg=engine.config.postproc))
        jax.block_until_ready(step(engine.params, images))
    best = np.inf
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(n):
            out = step(engine.params, images)
        jax.block_until_ready(out)
        best = min(best, (time.perf_counter() - t0) / n)
    return best


def train_batch(cfg, batch: int, seed: int) -> dict:
    """Synthetic scenes (data/synthetic.render_scene) cropped to the
    model's input, with their keypoints; GT maps are made on device."""
    from openpose_plus.data.synthetic import render_scene

    m = cfg.model
    rng = np.random.default_rng(seed)
    size = max(m.hin, m.win)
    top = (size - m.hin) // 2
    images = np.zeros((batch, m.hin, m.win, 3), np.uint8)
    kp = np.zeros((batch, 8, 18, 3), np.float32)
    for b in range(batch):
        img, poses = render_scene(rng, size)
        images[b] = img[top:top + m.hin, :m.win]
        for p, pose in enumerate(poses[:8]):
            for part, (x, y) in pose.items():
                inside = 0 <= x < m.win and 0 <= y - top < m.hin
                kp[b, p, part] = (x, y - top, float(inside))
    return {"images": images, "keypoints": kp,
            "mask": np.ones((batch, m.hout, m.wout, 1), np.float32)}


def train_check(cfg, batch: dict, steps: int = 3, seed: int = 0
                ) -> tuple[list[float], float]:
    """`steps` train steps through train.make_train_step_on_batch, and the
    step-1 loss of the float32 plain-lowering step on the same batch."""
    from openpose_plus import train as T

    cfg = cfg.replace(train=dataclasses.replace(cfg.train,
                                                donate_state=False))
    state0 = T.create_train_state(cfg, jax.random.PRNGKey(seed))
    step = T.make_train_step_on_batch(cfg)
    state, losses = state0, []
    for _ in range(steps):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    check(all(np.isfinite(losses)), f"non-finite loss {losses}")
    ref_cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, stem_s2d=False, compute_dtype="float32"))
    with jax.default_matmul_precision("highest"):
        _, ref = T.make_train_step_on_batch(ref_cfg)(state0, batch)
    return losses, float(ref["loss"])


def shared_humans(a, b) -> float:
    """Share of skeletons found identically (every part, coordinate and
    score) in the same image of both batches, over the larger count."""
    matched = total = 0
    for i in range(np.asarray(a.valid).shape[0]):
        ha, hb = _device_humans(a, i), _device_humans(b, i)
        total += max(len(ha), len(hb))
        for h in hb:
            if h in ha:
                ha.remove(h)
                matched += 1
    return matched / max(total, 1)


def well_formed(batch, cfg: PostprocConfig) -> None:
    """What every decoded table satisfies: valid rows first, each with
    at least one valid part and n_parts (the merge's count, which a
    replaced part increments again) >= its valid parts and >=
    min_parts_per_human; coordinates in [0, 1], finite scores; invalid
    rows empty."""
    valid = np.asarray(batch.valid)
    pv = np.asarray(batch.part_valid)
    n_parts = np.asarray(batch.n_parts)
    coords = np.asarray(batch.coords)
    check(np.all(np.diff(valid.astype(int), axis=1) <= 0),
          "valid rows are not first")
    parts = pv.sum(-1)
    check(np.all((parts[valid] >= 1) & (parts[valid] <= n_parts[valid])),
          "n_parts below the valid parts")
    check(np.all(n_parts[valid] >= cfg.min_parts_per_human),
          "a human has too few parts")
    check(not np.any(pv[~valid]), "an invalid row has parts")
    c = coords[pv]
    check(np.all((c >= 0) & (c <= 1)), "coordinates outside [0, 1]")
    check(np.all(np.isfinite(np.asarray(batch.score)[valid])),
          "non-finite score")


def export_check(engine, images: np.ndarray, batch_ref
                 ) -> tuple[dict, int, float]:
    """export.save_engine -> load_engine -> infer. The artifact read back
    runs the module of the Exported it was written from, so it must give
    the same skeletons exactly: this holds the manifest's signature and
    output mapping. The engine is another program: with the weights baked
    in as constants XLA compiles the CNN otherwise, and its bf16 maps
    differ in the last bits, which moves the near-tied decisions of
    random-weight maps. Against the engine, the artifact's table must be
    well formed and hold as many humans within 10%. Returns the
    manifest, the number of humans and the share of the engine's
    skeletons found identically."""
    from openpose_plus.export import load_engine, save_engine
    from openpose_plus.postproc import HumanBatch

    with tempfile.TemporaryDirectory() as d:
        exported = save_engine(engine, d, batch_size=images.shape[0])
        loaded = load_engine(d)
        got = loaded.infer(images)
    n = same_skeletons(got, HumanBatch(**jax.jit(exported.call)(images)))
    well_formed(got, engine.config.postproc)
    n_ref = int(np.asarray(batch_ref.valid).sum())
    check(abs(n - n_ref) <= 0.1 * n_ref,
          f"artifact finds {n} humans, the engine {n_ref}")
    return loaded.manifest, n, shared_humans(got, batch_ref)


# ------------------------------------------------------------------ phases --

def log(msg: str) -> None:
    print(msg, flush=True)


def device_info() -> dict:
    """Phase 0: a GPU or nothing."""
    backend = jax.default_backend()
    if backend != "gpu":
        raise SmokeFailure(
            f"no GPU: JAX's default backend is {backend!r}; chip_smoke.py "
            f"runs only on a GPU")
    import jaxlib

    from bench import card

    d = jax.devices()[0]
    log(card())                # "<name>, <power limit>" as nvidia-smi says
    log(f"jax {jax.__version__} jaxlib {jaxlib.__version__} "
        f"device_kind {d.device_kind} count {len(jax.devices())} "
        f"compile cache {jax.config.jax_compilation_cache_dir}")
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def phase_serve(seed: int) -> tuple:
    cfg = model_config("mobilenet_thin").replace(
        postproc=RANDOM_WEIGHT_DECODER)
    eng = Engine(cfg, seed=seed)
    images = frames(cfg, BATCH, seed)
    level = cfg.model.preferred_input_layout()
    packed = jnp.asarray(to_layout(images, level))
    plain = jnp.asarray(images)
    compiled = eng._infer.lower(eng.params, packed).compile()
    log(f"  memory_analysis(_infer, bs={BATCH}): "
        f"{compiled.memory_analysis()}")
    same_maps(eng.forward(packed), eng.forward(plain))
    out_plain = eng.infer(plain)
    n = same_skeletons(eng.infer(packed), out_plain)
    log(f"  layouts s2d^{level} and plain: bit-equal maps, same skeletons "
        f"({n} humans, random-weight decoder)")
    err = cnn_error(cfg, eng.params, images)
    log(f"  CNN vs float32 plain reference: rel err {err:.3e} "
        f"(tolerance {CNN_TOL})")
    check(err <= CNN_TOL, "mobilenet_thin maps off the reference")
    conf, paf = decoder_scenes(cfg.model.hout, cfg.model.wout, BATCH, seed)
    default = PostprocConfig()
    counts = oracle_check(conf, paf, default)
    log(f"  decoder vs numpy oracle (K={default.max_peaks}): "
        f"identical skeletons, humans per image {counts}")
    return eng, plain, out_plain


def phase_zoo(seed: int) -> None:
    for name in ("vgg19", "vggtiny", "hao28"):
        cfg = model_config(name)
        eng = Engine(cfg, seed=seed)
        images = frames(cfg, BATCH, seed)
        level = cfg.model.preferred_input_layout()
        out = eng.infer(jnp.asarray(to_layout(images, level)))
        err = cnn_error(cfg, eng.params, images)
        log(f"  {name}: {int(np.asarray(out.num_humans).sum())} humans, "
            f"CNN vs float32 plain reference rel err {err:.3e} "
            f"(tolerance {CNN_TOL})")
        check(err <= CNN_TOL, f"{name} maps off the reference")


def phase_presets(eng, images, seed: int) -> None:
    conf, paf = eng.forward(images)
    conf, paf = np.asarray(conf), np.asarray(paf)
    scenes = decoder_scenes(conf.shape[1], conf.shape[2], BATCH, seed + 1)
    fid = PostprocConfig().fidelity()
    for what, (c, p) in (("mobilenet maps", (conf, paf)),
                         ("synthetic scenes", scenes)):
        counts = oracle_check(c, p, fid)
        log(f"  fidelity (K={fid.max_peaks}, upsample "
            f"{fid.upsample_factor}) on {what} vs oracle: identical, "
            f"humans per image {counts}")
    qual = PostprocConfig().quality()
    counts = cpu_check(scenes[0], scenes[1], qual)
    log(f"  quality (fragment merge {qual.fragment_merge_rel}) vs the same "
        f"decoder on the CPU: identical, humans per image {counts}")


def phase_kernels(eng, images, seed: int) -> None:
    for k in (16, 32):
        r = kernel_check(k, 32, BATCH, seed, timed=True)
        log(f"  K={k} M=32 bs={BATCH}: bit-exact ({r['connections']} "
            f"connections, {r['humans']} humans); greedy kernel "
            f"{r['greedy_kernel_us']:.1f} us vs XLA "
            f"{r['greedy_xla_us']:.1f} us; merge kernel "
            f"{r['merge_kernel_us']:.1f} us vs XLA {r['merge_xla_us']:.1f} us")
    packed = jnp.asarray(to_layout(np.asarray(images),
                                   eng.config.model.preferred_input_layout()))
    t_k = engine_step_seconds(eng, packed, twins=False)
    t_x = engine_step_seconds(eng, packed, twins=True)
    log(f"  engine step mobilenet_thin bs={BATCH} {HIN}x{WIN} "
        f"(random-weight decoder, K={eng.config.postproc.max_peaks}): "
        f"kernels {1e3 * t_k:.3f} ms, XLA twins {1e3 * t_x:.3f} ms")


def phase_train(seed: int) -> None:
    cfg = model_config("mobilenet_thin")
    batch = train_batch(cfg, BATCH, seed)
    losses, ref = train_check(cfg, batch, seed=seed)
    err = abs(losses[0] - ref) / abs(ref)
    log(f"  losses {losses}; step-1 vs float32 plain step {ref:.6g}: rel "
        f"err {err:.3e} (tolerance {LOSS_TOL})")
    check(err <= LOSS_TOL, "step-1 loss off the float32 reference")


def phase_export(eng, images, out) -> None:
    manifest, n, share = export_check(eng, np.asarray(images), out)
    log(f"  artifact platforms {manifest['platforms']}, Triton call "
        f"{manifest['triton_call']}, jaxlib {manifest['jaxlib_version']}: "
        f"same skeletons as the in-memory Exported ({n} humans), well "
        f"formed; the engine finds {int(np.asarray(out.valid).sum())}, "
        f"{share:.4f} of them identical")


def run_one(seed: int) -> None:
    t0 = time.perf_counter()

    def phase(name, fn, *a):
        log(f"phase {name}")
        t = time.perf_counter()
        r = fn(*a)
        log(f"  ({time.perf_counter() - t:.1f} s; "
            f"{time.perf_counter() - t0:.1f} s total)")
        return r

    eng, images, out = phase("1 serve", phase_serve, seed)
    phase("2 zoo", phase_zoo, seed)
    phase("3 presets", phase_presets, eng, images, seed)
    phase("4 kernels", phase_kernels, eng, images, seed)
    phase("5 train", phase_train, seed)
    phase("6 export", phase_export, eng, images, out)


def adam_mu(opt_state):
    """Adam's first moment: after one step from zero it is (1 - b1) times
    the gradient the step applied."""
    import optax

    is_adam = lambda x: isinstance(x, optax.ScaleByAdamState)
    found = [x.mu for x in jax.tree.leaves(opt_state, is_leaf=is_adam)
             if is_adam(x)]
    check(len(found) == 1, f"expected one Adam state, found {len(found)}")
    return found[0]


def worst_leaf_rel(got, ref) -> float:
    """max over leaves of ||got - ref|| / ||ref||."""
    worst = 0.0
    for x, y in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
        x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
        worst = max(worst, float(np.linalg.norm(x - y)
                                 / max(np.linalg.norm(y), 1e-30)))
    return worst


def tree_rel(got, ref) -> float:
    """||got - ref|| / ||ref|| over all leaves at once."""
    diff = sum(float(np.sum((np.asarray(x, np.float64)
                             - np.asarray(y, np.float64)) ** 2))
               for x, y in zip(jax.tree.leaves(got), jax.tree.leaves(ref)))
    norm = sum(float(np.sum(np.asarray(y, np.float64) ** 2))
               for y in jax.tree.leaves(ref))
    return (diff / max(norm, 1e-60)) ** 0.5


def params_diff(a, b) -> float:
    return max(float(np.abs(np.asarray(x, np.float64)
                            - np.asarray(y, np.float64)).max())
               for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)))


def four_card_check(seed: int, n: int = 4) -> None:
    """The multi-card paths vs one card: sync-sgd data parallelism over a
    (data=n) mesh, one step on a (data=n/2, spatial=2) mesh, sharded
    serving (Engine(mesh=...)) and one pair-avg round (parallel/kungfu).

    The first Adam step moves each parameter by about lr * sign(g),
    whatever the size of g, so parameters say little of the gradient:
    the gradients are read from Adam's first moment instead, in float32
    steps; the served bf16 step is held to its loss."""
    from openpose_plus import train as T
    from openpose_plus.parallel import kungfu as kf
    from openpose_plus.parallel import sharding as S

    devices = jax.devices()[:n]
    per_card = BATCH
    cfg = model_config("mobilenet_thin").replace(
        postproc=RANDOM_WEIGHT_DECODER)
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, batch_size=n * per_card, donate_state=False))
    f32 = cfg.replace(model=dataclasses.replace(cfg.model,
                                                compute_dtype="float32"))
    batch = train_batch(cfg, n * per_card, seed)
    state0 = T.create_train_state(cfg, jax.random.PRNGKey(seed))
    one = jax.device_put(state0, devices[0])
    mesh = S.build_mesh(dataclasses.replace(cfg.parallel,
                                            spatial_parallelism=1), devices)

    def loss_err(a, b):
        return abs(float(a["loss"]) - float(b["loss"])) / float(b["loss"])

    step = T.make_train_step_on_batch(cfg)
    s1, m1 = step(one, jax.device_put(batch, devices[0]))
    sn, mn = step(jax.device_put(state0, S.replicated(mesh)),
                  S.shard_batch(batch, mesh))
    lerr = loss_err(mn, m1)
    log(f"  sync-sgd bf16 (data={n}) global bs={n * per_card}: loss rel err "
        f"{lerr:.3e} (tolerance 1e-3); gradient (Adam mu) worst-leaf rel "
        f"err {worst_leaf_rel(adam_mu(sn.opt_state), adam_mu(s1.opt_state)):.3e}"
        f" (not held: bf16)")
    check(lerr <= 1e-3, f"bf16 (data={n}) step off one card")

    with jax.default_matmul_precision("highest"):
        step32 = T.make_train_step_on_batch(f32)
        r1, q1 = step32(one, jax.device_put(batch, devices[0]))
        mu1 = adam_mu(r1.opt_state)
        for data, spatial in ((n, 1), (n // 2, 2)):
            pc = dataclasses.replace(cfg.parallel,
                                     spatial_parallelism=spatial)
            m = S.build_mesh(pc, devices)
            rn, qn = step32(jax.device_put(state0, S.replicated(m)),
                            S.shard_batch(batch, m))
            lerr = loss_err(qn, q1)
            gerr = worst_leaf_rel(adam_mu(rn.opt_state), mu1)
            log(f"  sync-sgd float32 (data={data}, spatial={spatial}) global "
                f"bs={n * per_card}: loss rel err {lerr:.3e} (tolerance "
                f"1e-3), gradient (Adam mu) worst-leaf rel err {gerr:.3e} "
                f"(tolerance {GRAD_TOL})")
            check(lerr <= 1e-3 and gerr <= GRAD_TOL,
                  f"(data={data}, spatial={spatial}) step off one card")

        kstate = kf.create_kungfu_state(f32, mesh, jax.random.PRNGKey(seed))
        kstate, _ = kf.make_kungfu_steps(f32, mesh, "pair-avg")[0](
            kstate, S.shard_batch(batch, mesh, spatial_leaves=()))
        local = [step32(one, jax.device_put(
            jax.tree.map(lambda x: x[i * per_card:(i + 1) * per_card],
                         batch), devices[0]))[0] for i in range(n)]
    replicas = [kf.unstack_replica(kstate, i) for i in range(n)]
    gerr = max(worst_leaf_rel(adam_mu(r.opt_state), adam_mu(l.opt_state))
               for r, l in zip(replicas, local))
    # each replica's move from state0 vs the mean of its own and its
    # partner's one-card moves
    move = lambda p: jax.tree.map(lambda a, b: a - b, p, state0.params)
    perr = max(tree_rel(move(replicas[i].params), move(jax.tree.map(
        lambda a, b: (a + b) * 0.5, local[i].params, local[i ^ 1].params)))
        for i in range(n))
    partner = max(params_diff(replicas[i].params, replicas[i ^ 1].params)
                  for i in range(n))
    other = params_diff(replicas[0].params, replicas[2].params)
    log(f"  pair-avg round 0 (float32): local gradients (Adam mu) vs one "
        f"card: worst-leaf rel err {gerr:.3e} (tolerance {GRAD_TOL}); each "
        f"replica's move vs the mean of its and its partner's one-card "
        f"moves: rel err {perr:.3e} (tolerance 1e-2); partners' params "
        f"differ by {partner:.3e} (must be 0), the two pairs by "
        f"{other:.3e} (must be > 0)")
    check(gerr <= GRAD_TOL, "pair-avg local gradients off one card")
    check(perr <= 1e-2 and partner == 0.0 and other > 0.0,
          "pair-avg round did not average each replica with its partner")

    images = jnp.asarray(frames(cfg, n * per_card, seed))
    eng1 = Engine(cfg, params=s1.params)
    engn = Engine(cfg, params=s1.params, mesh=mesh)
    maps1, mapsn = eng1.forward(images), engn.forward(
        jax.device_put(images, S.batch_sharding(mesh, spatial=False)))
    err = max(rel_err(a, b) for a, b in zip(mapsn, maps1))
    log(f"  Engine(mesh) bs={n * per_card} maps vs one card: rel err "
        f"{err:.3e} (tolerance 1e-2)")
    check(err <= 1e-2, "sharded serving maps off one card")
    dec = decode.build_decoder(cfg.postproc)
    humans = same_skeletons(dec(*jax.device_put(maps1, S.map_sharding(mesh))),
                            dec(*maps1))
    served = int(np.asarray(engn.infer(images).num_humans).sum())
    check(served > 0, "Engine(mesh).infer found nobody")
    log(f"  sharded decode of the one-card maps: same skeletons ({humans} "
        f"humans, random-weight decoder); Engine(mesh).infer: {served} "
        f"humans over {n * per_card} images")


def run_four(seed: int) -> None:
    log("phase four-card")
    t = time.perf_counter()
    four_card_check(seed)
    log(f"  ({time.perf_counter() - t:.1f} s)")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card path and its one-card "
                         "comparison")
    args = ap.parse_args()
    configure_compile_cache()
    try:
        device = device_info()
        if args.four:
            if device["count"] < 4:
                raise SmokeFailure(f"--four needs 4 GPUs, found "
                                   f"{device['count']}")
            run_four(args.seed)
        else:
            run_one(args.seed)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
