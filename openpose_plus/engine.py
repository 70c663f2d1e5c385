"""Inference engine: preprocess -> CNN forward -> on-device grouping, one jit.

Replacement for BOTH reference inference paths (SURVEY.md §2/§3):
  * Python TfPoseEstimator (openpose_plus/inference/estimator.py):
    sess.run for maps + host-side Python grouping
  * C++ PoseDetector facade (src/pose_detector.cpp + src/uff-runner.cpp):
    TensorRT engine + C++ paf.cpp grouping

Here the entire pipeline — uint8 normalize, backbone+stages, upsample, NMS,
PAF scoring, greedy grouping — is ONE XLA program: no host round-trip
between the CNN and the parser, and `compile()` is the analogue of the
reference's offline TensorRT engine build (AOT jit lowering).
"""

from __future__ import annotations

import functools
from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np

from openpose_plus.config import Config, default_config
from openpose_plus.models import get_model
from openpose_plus.postproc import HumanBatch, decode_maps


def preprocess_images(images: jax.Array) -> jax.Array:
    """uint8 (B, H, W, 3) RGB -> float32 in [-0.5, 0.5] (reference
    normalization: /255 - 0.5; src/input.cpp equivalent, but on device).

    Also accepts the space-to-depth input layout (B, H/2, W/2, 12) — the
    same bytes block-permuted (models/common.py space_to_depth); the host
    loader can emit it during letterbox for free, and the stem conv then
    skips the on-device relayout (see StemConvRelu)."""
    return images.astype(jnp.float32) / 255.0 - 0.5


INPUT_LAYOUTS = ("plain", "s2d", "s2d2")


def check_input_layout(model_cfg, input_layout: str) -> int:
    """Validate a named input layout against the model's geometry and
    supported lowerings; returns the s2d level. Rejects layouts the stem
    cannot consume (e.g. s2d2 on a VGG-family model, s2d on odd dims)
    instead of silently flooring dimensions."""
    try:
        level = INPUT_LAYOUTS.index(input_layout)
    except ValueError:
        raise ValueError(f"input_layout must be one of {INPUT_LAYOUTS}, "
                         f"got {input_layout!r}") from None
    if level > model_cfg.preferred_input_layout():
        raise ValueError(
            f"input_layout {input_layout!r} is not supported by model "
            f"{model_cfg.name!r} at {model_cfg.hin}x{model_cfg.win} "
            f"({model_cfg.compute_dtype}); max supported level is "
            f"{INPUT_LAYOUTS[model_cfg.preferred_input_layout()]!r}")
    return level


class Engine:
    """End-to-end pose estimator.

    Parameters
    ----------
    config: full Config (model + postproc sections are used).
    params: optional pretrained parameter pytree; random init otherwise.
    mesh: optional jax.sharding.Mesh — inference batches shard over the
        mesh's data axis with params replicated (multi-chip serving; the
        reference's only batching was single-GPU TensorRT max_batch).
    """

    def __init__(self, config: Optional[Config] = None,
                 params: Optional[Any] = None, seed: int = 0,
                 fast_init: bool = False, mesh=None, chunk: int = 0):
        self.config = config or default_config()
        self.model = get_model(self.config.model)
        self.mesh = mesh
        # chunk > 0: large batches run as lax.map over `chunk`-sized
        # sub-batches inside the same jit (see infer_step).
        self.chunk = chunk
        if params is None:
            dummy = jnp.zeros(
                (1, self.config.model.hin, self.config.model.win, 3),
                jnp.float32)
            if fast_init:
                # Benchmark path: numpy-filled params of the right
                # structure, no initializer program; NOT for serving.
                shapes = jax.eval_shape(
                    lambda: self.model.init(jax.random.PRNGKey(seed), dummy))
                rng = np.random.default_rng(seed)
                params = jax.tree.map(
                    lambda s: jnp.asarray(
                        rng.normal(0.0, 0.05, s.shape).astype(s.dtype)),
                    shapes)
            else:
                params = self.model.init(jax.random.PRNGKey(seed), dummy)
        if mesh is not None:
            from openpose_plus.parallel.sharding import replicated

            params = jax.device_put(params, replicated(mesh))
        self.params = params
        jit_kw = {}
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            # batch over the mesh's first (data) axis; params replicated.
            jit_kw = dict(in_shardings=(
                NamedSharding(mesh, P()),
                NamedSharding(mesh, P(mesh.axis_names[0]))))
        self._infer = jax.jit(functools.partial(
            infer_step, model=self.model, postproc_cfg=self.config.postproc,
            chunk=self.chunk), **jit_kw)
        self._infer_tta = jax.jit(functools.partial(
            _infer_tta_impl, model=self.model,
            postproc_cfg=self.config.postproc), **jit_kw)
        self._forward = jax.jit(functools.partial(_forward_impl,
                                                  model=self.model),
                                **jit_kw)
        self._jit_kw = jit_kw
        self._multiscale_cache: dict = {}

    # ------------------------------------------------------------- API ---

    def infer(self, images: np.ndarray | jax.Array,
              flip_tta: bool = False) -> HumanBatch:
        """images: (B, hin, win, 3) uint8 RGB -> skeletons.

        The analogue of TfPoseEstimator.inference / PoseDetector::detect,
        but batched and fully on-device. flip_tta averages predictions
        with the horizontally-flipped input (maps mirrored back with
        part/limb channel permutation) — ~2x cost, higher AP.
        """
        images = jnp.asarray(images)
        fn = self._infer_tta if flip_tta else self._infer
        return fn(self.params, images)

    def infer_multiscale(self, images: np.ndarray | jax.Array,
                         scales: tuple[float, ...] = (0.5, 1.0, 1.5),
                         flip_tta: bool = False,
                         combine: str = "avg") -> HumanBatch:
        """Scale-search TTA (the reference estimator's scale search): run
        the CNN at several input scales — all inside one jit. Combiners:

          "avg"    resize every map stack back to the base output grid,
                   average, decode ONCE (the reference's combiner).
          "dedup"  decode EACH scale at its own resolution and merge the
                   skeletons by greedy OKS-NMS (postproc.decode.
                   merge_dedup): each person is kept from whichever scale
                   detects them best, instead of blurring all scales'
                   maps together — avoids the map-average washing out
                   figures only one scale resolves.

        ~len(scales)x (2x more with flip_tta) the single-scale cost."""
        if combine not in ("avg", "dedup"):
            raise ValueError(f"combine must be 'avg' or 'dedup', "
                             f"got {combine!r}")
        images = jnp.asarray(images)
        key = (tuple(scales), bool(flip_tta), combine)
        if key not in self._multiscale_cache:
            impl = (_infer_multiscale_impl if combine == "avg"
                    else _infer_multiscale_dedup_impl)
            self._multiscale_cache[key] = jax.jit(functools.partial(
                impl, model=self.model,
                postproc_cfg=self.config.postproc, scales=key[0],
                flip=key[1], stride=self.config.model.stride),
                **self._jit_kw)
        return self._multiscale_cache[key](self.params, images)

    def forward(self, images: np.ndarray | jax.Array):
        """images -> (conf, paf) final-stage maps (no grouping)."""
        return self._forward(self.params, jnp.asarray(images))

    def compile(self, batch_size: int, input_layout: str = "plain") -> None:
        """AOT-compile for a fixed batch size (the reference's TensorRT
        "engine build" step; subsequent infer() calls at this shape hit the
        compile cache). input_layout: "plain" (B,hin,win,3), "s2d"
        (B,hin/2,win/2,12) or "s2d2" (B,hin/4,win/4,48) — the
        space-to-depth layouts the host loader can emit."""
        shape = self.config.model.input_shape(
            batch_size, check_input_layout(self.config.model, input_layout))
        self._infer.lower(self.params,
                          jax.ShapeDtypeStruct(shape, jnp.uint8)).compile()


def _forward_impl(params, images, *, model):
    x = preprocess_images(images)
    out = model.apply(params, x)
    return out["conf"][-1], out["paf"][-1]


def _infer_impl(params, images, *, model, postproc_cfg) -> HumanBatch:
    conf, paf = _forward_impl(params, images, model=model)
    return decode_maps(conf, paf, postproc_cfg)


def infer_step(params, images, *, model, postproc_cfg,
               chunk: int = 0) -> HumanBatch:
    """The full engine step (preprocess -> CNN -> decode) as one traceable
    function — shared by Engine.infer and bench.py so the benched program
    is exactly the served one.

    chunk > 0 and batch a larger multiple of it: the batch runs as a
    `lax.map` over chunk-sized sub-batches INSIDE the same XLA program,
    which bounds the step's working set at the chunk's without paying a
    dispatch per sub-batch."""
    b = images.shape[0]
    if chunk and b > chunk and b % chunk == 0:
        im = images.reshape(b // chunk, chunk, *images.shape[1:])
        res = jax.lax.map(
            lambda t: _infer_impl(params, t, model=model,
                                  postproc_cfg=postproc_cfg), im)
        return jax.tree.map(lambda a: a.reshape(-1, *a.shape[2:]), res)
    return _infer_impl(params, images, model=model, postproc_cfg=postproc_cfg)


def _to_plain(images):
    """s2d input layouts -> plain (B, H, W, 3): scale search resizes the
    plain image, so convert once up front."""
    if images.shape[-1] in (12, 48):
        from openpose_plus.models.common import depth_to_space

        if images.shape[-1] == 48:
            images = depth_to_space(images, 12)
        images = depth_to_space(images, 3)
    return images


def _infer_multiscale_impl(params, images, *, model, postproc_cfg, scales,
                           flip, stride) -> HumanBatch:
    """Average final-stage maps over input scales (+ optional flip) on the
    base output grid, then decode once. Scaled input dims snap to the
    backbone stride so every scale traces a valid static shape."""
    from openpose_plus.postproc.flip import mirror_maps

    images = _to_plain(images)
    b, base_h, base_w = images.shape[0], images.shape[1], images.shape[2]
    hout, wout = base_h // stride, base_w // stride
    x0 = preprocess_images(images)

    def maps_at(x):
        out = model.apply(params, x)
        return out["conf"][-1].astype(jnp.float32), \
            out["paf"][-1].astype(jnp.float32)

    conf_acc = None
    paf_acc = None
    n = 0
    for s in scales:
        h = max(stride, int(round(base_h * s / stride)) * stride)
        w = max(stride, int(round(base_w * s / stride)) * stride)
        xi = x0 if (h, w) == (base_h, base_w) else jax.image.resize(
            x0, (b, h, w, 3), method="linear")
        variants = [xi] + ([xi[:, :, ::-1]] if flip else [])
        for i, xv in enumerate(variants):
            conf, paf = maps_at(xv)
            if i == 1:
                conf, paf = mirror_maps(conf, paf)
            if conf.shape[1] != hout or conf.shape[2] != wout:
                conf = jax.image.resize(
                    conf, (b, hout, wout, conf.shape[-1]), method="linear")
                paf = jax.image.resize(
                    paf, (b, hout, wout, paf.shape[-1]), method="linear")
            conf_acc = conf if conf_acc is None else conf_acc + conf
            paf_acc = paf if paf_acc is None else paf_acc + paf
            n += 1
    inv = 1.0 / n
    return decode_maps(conf_acc * inv, paf_acc * inv, postproc_cfg)


def _infer_multiscale_dedup_impl(params, images, *, model, postproc_cfg,
                                 scales, flip, stride,
                                 oks_threshold: float = 0.5) -> HumanBatch:
    """Per-scale decode + OKS-dedup merge (combine="dedup"): each scale's
    maps are decoded AT THAT SCALE's resolution (within-scale flip TTA
    still averages maps — mirror symmetry shares a geometry, scales do
    not), then merge_dedup keeps each person from the best-detecting
    scale. Normalized coords make the per-scale HumanBatches directly
    comparable."""
    from openpose_plus.postproc import merge_dedup
    from openpose_plus.postproc.flip import mirror_maps

    images = _to_plain(images)
    b, base_h, base_w = images.shape[0], images.shape[1], images.shape[2]
    x0 = preprocess_images(images)

    def maps_at(x):
        out = model.apply(params, x)
        return out["conf"][-1].astype(jnp.float32), \
            out["paf"][-1].astype(jnp.float32)

    batches = []
    for s in scales:
        h = max(stride, int(round(base_h * s / stride)) * stride)
        w = max(stride, int(round(base_w * s / stride)) * stride)
        xi = x0 if (h, w) == (base_h, base_w) else jax.image.resize(
            x0, (b, h, w, 3), method="linear")
        conf, paf = maps_at(xi)
        if flip:
            conf_m, paf_m = mirror_maps(*maps_at(xi[:, :, ::-1]))
            conf, paf = (conf + conf_m) * 0.5, (paf + paf_m) * 0.5
        batches.append(decode_maps(conf, paf, postproc_cfg))
    return merge_dedup(batches, oks_threshold)


def _infer_tta_impl(params, images, *, model, postproc_cfg) -> HumanBatch:
    """Flip test-time augmentation: average original and mirrored-back
    predictions before the (single) decode."""
    from openpose_plus.postproc.flip import mirror_maps

    conf, paf = _forward_impl(params, images, model=model)
    if images.shape[-1] == 12:  # s2d layout: flip = block-reverse + wx swap
        from openpose_plus.models.common import s2d_flip_w

        flipped = s2d_flip_w(images, 3)
    elif images.shape[-1] == 48:  # s2d^2: same at both block levels
        from openpose_plus.models.common import s2d2_flip_w

        flipped = s2d2_flip_w(images, 3)
    else:
        flipped = images[:, :, ::-1]
    conf_f, paf_f = _forward_impl(params, flipped, model=model)
    conf_m, paf_m = mirror_maps(conf_f, paf_f)
    return decode_maps((conf + conf_m) * 0.5, (paf + paf_m) * 0.5,
                       postproc_cfg)
