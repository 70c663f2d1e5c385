"""Shared building blocks for the pose model zoo, as plain JAX functions.

Every model follows the reference's two-branch multi-stage layout
(openpose_plus/models/*.py [HIGH behavior; empty mount — SURVEY.md]): a
backbone produces a stride-8 feature map F; stage 1 predicts (conf, paf)
from F; each later stage refines from concat(F, conf_{t-1}, paf_{t-1}).
All per-stage outputs are returned for deep supervision.

Layers are functions of a `Scope`, which hands each one its parameters by
module path. A model is a `PoseModel`: `init(rng, x)` builds the variable
tree {"params": {...}} and `apply(variables, x)` runs the forward pass. The
tree's paths, leaf names and shapes are a checkpoint format
(checkpoint.py, released .npz files), so the auto-names below ("ConvRelu_0",
"SepConvRelu_1", "Conv_0") are part of it; tests/test_models.py holds them
to a recorded fixture.

Layout is NHWC end to end; compute is bfloat16 (or float32) with float32
params, and the final prediction of each stage is float32 because the
decoder compares map values.
"""

from __future__ import annotations

import hashlib
from typing import Any, Callable, Sequence

import jax
import jax.numpy as jnp
import numpy as np

_lecun_normal = jax.nn.initializers.lecun_normal()
_zeros = jax.nn.initializers.zeros


class Scope:
    """Parameters of one module path.

    In apply mode it reads the leaves of a params subtree. In shape mode
    (PoseModel.init, run under jax.eval_shape) it records each leaf's path,
    shape and initializer and hands back zeros of that shape.
    """

    def __init__(self, params: dict | None, records: list | None = None,
                 path: tuple[str, ...] = ()):
        self._params = params
        self._records = records
        self._path = path
        self._counts: dict[str, int] = {}

    def child(self, name: str | None = None, kind: str | None = None
              ) -> "Scope":
        """Sub-scope `name`, or the next auto-name `{kind}_{i}`."""
        if name is None:
            i = self._counts.get(kind, 0)
            self._counts[kind] = i + 1
            name = f"{kind}_{i}"
        sub = None if self._params is None else self._params[name]
        return Scope(sub, self._records, self._path + (name,))

    def param(self, name: str, shape: Sequence[int],
              init: Callable = _lecun_normal) -> jax.Array:
        if self._records is not None:
            self._records.append((self._path + (name,), tuple(shape), init))
            return jnp.zeros(shape, jnp.float32)
        return self._params[name]

    @property
    def params(self) -> dict | None:
        return self._params

    def rebind(self, params: dict | None) -> "Scope":
        """This path with `params` (e.g. as passed through jax.checkpoint)."""
        return Scope(params, self._records, self._path)


class PoseModel:
    """A zoo model: `init(rng, x) -> {"params": tree}` and
    `apply(variables, x) -> {"conf": [...], "paf": [...], "feature": F}`."""

    def __init__(self, cfg, body: Callable[[Scope, Any, jax.Array], dict]):
        self.cfg = cfg
        self._body = body

    def init(self, rng: jax.Array, x: jax.Array) -> dict:
        """Initialize every parameter for input `x`'s shape.

        The i-th parameter (1-based, in creation order) of the layer at
        path (p1, ..., pn) draws from `rng` folded with the first 4 bytes
        of SHA-1(p1 ... pn i): the derivation of the Flax layer this
        replaced, so a seed gives the same weights as before, and two
        lowerings with the same parameter tree get the same values."""
        records: list = []
        jax.eval_shape(lambda x: self._body(Scope(None, records), self.cfg,
                                            x), x)
        params: dict = {}
        counters: dict = {}
        for path, shape, init in records:
            node = params
            for p in path[:-1]:
                node = node.setdefault(p, {})
            n = counters[path[:-1]] = counters.get(path[:-1], 0) + 1
            h = hashlib.sha1()
            for part in path[:-1]:
                h.update(part.encode())
            h.update(n.to_bytes((n.bit_length() + 7) // 8, "big"))
            key = jax.random.fold_in(
                rng, jnp.uint32(int.from_bytes(h.digest()[:4], "big")))
            node[path[-1]] = init(key, shape, jnp.float32)
        return {"params": params}

    def apply(self, variables: dict, x: jax.Array) -> dict:
        return self._body(Scope(variables["params"]), self.cfg, x)


# Model output convention: a plain dict {'conf': [per-stage
# (N,H/8,W/8,19)], 'paf': [per-stage (N,H/8,W/8,38)], 'feature':
# (N,H/8,W/8,C)} — a plain dict so it is a JAX pytree.
def _dtype(name: str):
    return {"bfloat16": jnp.bfloat16, "float32": jnp.float32}[name]


_DN = ("NHWC", "HWIO", "NHWC")


def _conv(x, kernel, strides=(1, 1), padding="SAME", groups: int = 1):
    return jax.lax.conv_general_dilated(
        x, kernel, strides, padding, dimension_numbers=_DN,
        feature_group_count=groups)


def max_pool2(x: jax.Array) -> jax.Array:
    """2x2 stride-2 max pool (VALID), NHWC."""
    return jax.lax.reduce_window(x, -jnp.inf, jax.lax.max, (1, 2, 2, 1),
                                 (1, 2, 2, 1), "VALID")


def conv_relu(s: Scope, x, features: int, kernel: int = 3, stride: int = 1,
              compute_dtype: str = "bfloat16"):
    """kxk conv + ReLU (the reference's tl.layers.Conv2d+relu)."""
    w = s.param("kernel", (kernel, kernel, x.shape[-1], features))
    b = s.param("bias", (features,), _zeros)
    dt = _dtype(compute_dtype)
    y = _conv(x.astype(dt), w.astype(dt), (stride, stride)) + b.astype(dt)
    return jax.nn.relu(y)


def space_to_depth(x: jax.Array) -> jax.Array:
    """(B, H, W, C) -> (B, H/2, W/2, 4C); channel = (wy*2+wx)*C + c.

    Pure data movement (reshape+transpose) — the MLPerf ResNet stem trick:
    a 3x3 stride-2 conv on C channels re-expressed on the s2d grid uses a
    2x2 stride-1 kernel over 4C channels, a denser contraction than the
    3-channel original.
    """
    b, h, w, c = x.shape
    x = x.reshape(b, h // 2, 2, w // 2, 2, c)
    return x.transpose(0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2, 4 * c)


def depth_to_space(x: jax.Array, c: int) -> jax.Array:
    """Inverse of space_to_depth: (B, H, W, 4C) -> (B, 2H, 2W, C)."""
    b, h, w, _ = x.shape
    x = x.reshape(b, h, w, 2, 2, c).transpose(0, 1, 3, 2, 4, 5)
    return x.reshape(b, 2 * h, 2 * w, c)


def s2d_flip_w(x: jax.Array, c: int) -> jax.Array:
    """Horizontal flip of an s2d-layout image, without leaving the layout.

    For even W, flipping columns is: reverse the block axis, then swap the
    wx=0/wx=1 channel groups (exact; see engine flip-TTA)."""
    b, h, w, c4 = x.shape
    x = x[:, :, ::-1].reshape(b, h, w, 2, 2, c)
    return x[:, :, :, :, ::-1].reshape(b, h, w, c4)


def s2d2_flip_w(x: jax.Array, c: int) -> jax.Array:
    """Horizontal flip of an s2d^2-layout image (W % 4 == 0): reverse the
    outer block axis, swap the vx groups, swap the wx groups."""
    b, h, w, c16 = x.shape
    x = x[:, :, ::-1].reshape(b, h, w, 2, 2, 2, 2, c)
    return x[:, :, :, :, ::-1, :, ::-1].reshape(b, h, w, c16)


# ---------------------------------------------------------------------
# Deep space-to-depth lowerings (MobileNet-thin early stage).
#
# The stride-2/4 region (conv1, dw1, dw2) has 3-48 channels, so its convs
# are thin contractions with poor arithmetic density. The lowering stays
# on the (H/4, W/4) block grid with 4x/16x the channels, where every conv
# below is a dense contraction of the SAME original parameters, rearranged
# at trace time:
#
#   conv1 k3 s2 (3->C)       => dense 2x2, 16*3 -> 4C   [s2d^2 in, s2d out]
#   dw 3x3 s1 depthwise (C)  => dense 3x3, 4C -> 4C     [block-sparse]
#   pw 1x1 (C->F)            => dense 1x1, 4C -> 4F     [block-diagonal]
#   dw 3x3 s2 depthwise (C)  => dense 2x2, 4C -> C      [s2d in, PLAIN out]
#
# Zero-filled slots cost FLOPs, which is free where a stage is bound by
# memory traffic. Whether it pays on a given device is a measurement.
# s2d-layout channel order everywhere: m-major, block position minor
# (m*4 + wy*2 + wx); the s2d^2 INPUT uses nested position-major order
# (space_to_depth applied twice).

def _stem_s2d2_kernel(kernel: jax.Array, cin: int, cout: int) -> jax.Array:
    """(3,3,cin,cout) k3-s2 kernel -> (2,2,16*cin,4*cout) on the s2d^2
    grid. In channel ((vy*2+vx)*4 + wy*2+wx)*cin + c; out o*4 + uy*2+ux:
    output row 2I+uy reads original rows 4I+2uy..+2 = block rows I, I+1."""
    ind = np.zeros((2, 2, 16, 4, 3, 3), np.float32)
    for P in range(2):
        for Q in range(2):
            for uy, ux, vy, vx, wy, wx in np.ndindex(2, 2, 2, 2, 2, 2):
                ky = 4 * P + 2 * vy + wy - 2 * uy
                kx = 4 * Q + 2 * vx + wx - 2 * ux
                if 0 <= ky < 3 and 0 <= kx < 3:
                    ind[P, Q, (vy * 2 + vx) * 4 + wy * 2 + wx,
                        uy * 2 + ux, ky, kx] = 1.0
    k = jnp.einsum("PQjukl,klcO->PQjcOu", jnp.asarray(ind), kernel)
    return k.reshape(2, 2, 16 * cin, cout * 4)


def _s1_block_indicator() -> np.ndarray:
    """(3,3, in-pos, out-pos, ky, kx) 0/1 geometry of a 3x3 STRIDE-1 conv
    on the 2x2 block grid (shared by every s1 deep-s2d lowering): output
    row 2I+uy reads rows 2I+uy-1..+1 = block rows I-1..I+1, pad 1, with
    tap ky = 2P + vy - uy - 1."""
    ind = np.zeros((3, 3, 4, 4, 3, 3), np.float32)
    for P in range(3):
        for Q in range(3):
            for uy, ux, vy, vx in np.ndindex(2, 2, 2, 2):
                ky = 2 * P + vy - uy - 1
                kx = 2 * Q + vx - ux - 1
                if 0 <= ky < 3 and 0 <= kx < 3:
                    ind[P, Q, vy * 2 + vx, uy * 2 + ux, ky, kx] = 1.0
    return ind


def _dw_s2d_kernel(dwk: jax.Array, c: int) -> jax.Array:
    """Depthwise (3,3,1,c) s1 -> dense (3,3,4c,4c) on the s2d grid
    (channel m*4+pos): see _s1_block_indicator for the geometry."""
    ind = _s1_block_indicator()
    t = jnp.einsum("PQiokl,klm->PQmio", jnp.asarray(ind), dwk[:, :, 0, :])
    e = t[:, :, :, :, None, :] * jnp.eye(c, dtype=dwk.dtype)[
        None, None, :, None, :, None]
    return e.reshape(3, 3, 4 * c, 4 * c)


def _dw_s2d_stride2_kernel(dwk: jax.Array, c: int) -> jax.Array:
    """Depthwise (3,3,1,c) s2 -> dense (2,2,4c,c): consumes the s2d grid,
    emits the PLAIN stride-2 grid (out pixel P reads rows 2P..2P+2 =
    block rows P, P+1; pad (0,1))."""
    ind = np.zeros((2, 2, 4, 3, 3), np.float32)
    for p in range(2):
        for q in range(2):
            for vy, vx in np.ndindex(2, 2):
                ky, kx = 2 * p + vy, 2 * q + vx
                if ky < 3 and kx < 3:
                    ind[p, q, vy * 2 + vx, ky, kx] = 1.0
    t = jnp.einsum("pqikl,kln->pqni", jnp.asarray(ind), dwk[:, :, 0, :])
    e = t[:, :, :, :, None] * jnp.eye(c, dtype=dwk.dtype)[
        None, None, :, None, :]
    return e.reshape(2, 2, 4 * c, c)


def _pw_s2d_kernel(pwk: jax.Array, c: int, f: int) -> jax.Array:
    """Pointwise (1,1,c,f) -> block-diagonal (1,1,4c,4f) on the s2d grid
    (each block position uses the same weights)."""
    e = pwk[0, 0, :, None, :, None] * jnp.eye(4, dtype=pwk.dtype)[
        None, :, None, :]
    return e.reshape(1, 1, 4 * c, 4 * f)


def _s1_s2d_kernel(kernel: jax.Array) -> jax.Array:
    """(3,3,cin,cout) k3-STRIDE-1 DENSE kernel -> (3,3,4cin,4cout) on the
    block grid, position-MAJOR channels on both sides (ch = pos*C + c);
    geometry shared with the depthwise lowering (_s1_block_indicator)."""
    cin, cout = kernel.shape[2], kernel.shape[3]
    ind = _s1_block_indicator()
    k = jnp.einsum("PQiukl,klcd->PQicud", jnp.asarray(ind), kernel)
    return k.reshape(3, 3, 4 * cin, 4 * cout)


def s2d_maxpool_to_plain(x: jax.Array, c: int) -> jax.Array:
    """2x2 stride-2 maxpool of the underlying image, computed on a
    pos-major s2d-layout tensor as the max over its 4 contiguous position
    chunks — EXACT (each block holds one pool window) and free (no
    depth-to-space, and the chunk maxes fuse into the producer)."""
    p = x[..., :c]
    for i in range(1, 4):
        p = jnp.maximum(p, x[..., i * c:(i + 1) * c])
    return p


def s2d_conv_relu(s: Scope, x, features: int, in_channels: int,
                  compute_dtype: str = "bfloat16"):
    """3x3 STRIDE-1 conv + ReLU on the space-to-depth block grid.

    Parameter-compatible with conv_relu (same "kernel"/"bias" names and
    shapes). Input and output are pos-major s2d layouts (4*cin / 4*cout
    channels); the raw s2d image (B,H/2,W/2,12) is already pos-major, so
    the first stem conv consumes it directly. The dense rearranged kernel
    does 4x structurally-zero FLOPs in exchange for 4x the channels of a
    thin early conv. Followed by s2d_maxpool_to_plain, the usual VGG conv1
    block [conv, conv, pool2] never materializes the full-res grid at all.
    """
    cin = in_channels
    kernel = s.param("kernel", (3, 3, cin, features))
    bias = s.param("bias", (features,), _zeros)
    if x.shape[-1] != 4 * cin:
        raise ValueError(
            f"s2d_conv_relu expects {4 * cin} channels, got {x.shape}")
    dt = _dtype(compute_dtype)
    y = _conv(x.astype(dt), _s1_s2d_kernel(kernel).astype(dt), (1, 1),
              [(1, 1), (1, 1)])
    return jax.nn.relu(y + jnp.tile(bias, 4).astype(dt))


def stem_conv_relu(s: Scope, x, features: int, in_channels: int = 3,
                   compute_dtype: str = "bfloat16"):
    """3x3 stride-2 stem conv + ReLU, lowered via space-to-depth.

    Parameter-compatible with conv_relu (same "kernel" (3,3,cin,cout) and
    "bias" names/shapes — one checkpoint serves every lowering). Three
    input forms, selected by shape:

      (B,H,W,cin)        plain — s2d applied on device, then the k2 path
      (B,H/2,W/2,4cin)   s2d — 2x2 kernel over 4cin channels, PLAIN out
      (B,H/4,W/4,16cin)  s2d^2 — 2x2 kernel over 16cin channels, and the
                         OUTPUT stays on the block grid ((B,H/4,W/4,4cout),
                         channel o*4+pos) feeding s2d-space sep_conv_relu
                         blocks.

    Numerics: the same 9 tap products per output, contracted in another
    order — bf16-accumulation-order differences only (exact in f32). SAME
    padding parity: k3 s2 on even dims pads (0,1); on the block grid that
    is exactly k2 s1 with padding ((0,1),(0,1)).
    """
    cin = in_channels
    kernel = s.param("kernel", (3, 3, cin, features))
    bias = s.param("bias", (features,), _zeros)
    dt = _dtype(compute_dtype)
    if x.shape[-1] == 16 * cin:  # s2d^2: emit s2d-layout output
        wq = _stem_s2d2_kernel(kernel, cin, features)
        b = jnp.repeat(bias, 4)
    else:
        if x.shape[-1] == cin:
            x = space_to_depth(x)
        elif x.shape[-1] != 4 * cin:
            raise ValueError(f"stem expects {cin}, {4 * cin} or "
                             f"{16 * cin} channels, got {x.shape}")
        wq = jnp.zeros((2, 2, 4 * cin, features), kernel.dtype)
        for ky in range(3):
            for kx in range(3):
                p, wy = divmod(ky, 2)
                q, wx = divmod(kx, 2)
                g = (wy * 2 + wx) * cin
                wq = wq.at[p, q, g:g + cin].set(kernel[ky, kx])
        b = bias
    y = _conv(x.astype(dt), wq.astype(dt), (1, 1), [(0, 1), (0, 1)])
    return jax.nn.relu(y + b.astype(dt))


def sep_conv_relu(s: Scope, x, features: int, kernel: int = 3,
                  stride: int = 1, compute_dtype: str = "bfloat16",
                  s2d_space: bool = False):
    """Depthwise-separable conv (MobileNet-style): DW kxk + PW 1x1, ReLU.

    s2d_space: input (and for stride 1, output) live on the space-to-depth
    block grid with 4x channels (m*4+pos order); the SAME depthwise and
    pointwise params are rearranged into dense kernels at trace time (see
    the deep-s2d lowering notes above). Stride 2 emits the plain grid.
    Requires kernel == 3.
    """
    c_in = x.shape[-1] // 4 if s2d_space else x.shape[-1]
    k = kernel
    dt = _dtype(compute_dtype)
    dwk = s.param("dw_kernel", (k, k, 1, c_in))
    dwb = s.param("dw_bias", (c_in,), _zeros)
    pwk = s.param("pw_kernel", (1, 1, c_in, features))
    pwb = s.param("pw_bias", (features,), _zeros)

    if s2d_space:
        if k != 3 or stride not in (1, 2):
            raise ValueError("s2d_space needs a 3x3 kernel, stride 1 or 2")
        if stride == 1:
            y = _conv(x.astype(dt), _dw_s2d_kernel(dwk, c_in).astype(dt),
                      (1, 1), [(1, 1), (1, 1)])
            y = jax.nn.relu(y + jnp.repeat(dwb, 4).astype(dt))
            y = _conv(y, _pw_s2d_kernel(pwk, c_in, features).astype(dt))
            return jax.nn.relu(y + jnp.repeat(pwb, 4).astype(dt))
        y = _conv(x.astype(dt), _dw_s2d_stride2_kernel(dwk, c_in).astype(dt),
                  (1, 1), [(0, 1), (0, 1)])
        y = jax.nn.relu(y + dwb.astype(dt))  # plain grid from here on
        y = _conv(y, pwk.astype(dt))
        return jax.nn.relu(y + pwb.astype(dt))

    y = _conv(x.astype(dt), dwk.astype(dt), (stride, stride), groups=c_in)
    y = jax.nn.relu(y + dwb.astype(dt))
    y = _conv(y, pwk.astype(dt))
    return jax.nn.relu(y + pwb.astype(dt))


def stage_branch(s: Scope, x, out_features: int, mid_features: int = 128,
                 n_convs: int = 3, kernel: int = 3, proj_features: int = 512,
                 separable: bool = False, compute_dtype: str = "bfloat16"):
    """One branch (conf or paf) of one refinement stage.

    Stage 1 (reference models_vgg.py stage1): 3x [3x3, mid] + [1x1, proj]
    + [1x1, out]. Stages 2+: 5x [kxk, mid] + [1x1, mid] + [1x1, out] with
    k=7 in the VGG models.
    """
    for _ in range(n_convs):
        if separable:
            x = sep_conv_relu(s.child(kind="SepConvRelu"), x, mid_features,
                              kernel=kernel, compute_dtype=compute_dtype)
        else:
            x = conv_relu(s.child(kind="ConvRelu"), x, mid_features,
                          kernel=kernel, compute_dtype=compute_dtype)
    x = conv_relu(s.child(kind="ConvRelu"), x, proj_features, kernel=1,
                  compute_dtype=compute_dtype)
    # Final prediction in float32: the decoder compares map values.
    out = s.child(kind="Conv")
    w = out.param("kernel", (1, 1, x.shape[-1], out_features))
    b = out.param("bias", (out_features,), _zeros)
    return _conv(x.astype(jnp.float32), w) + b


def multi_stage_head(s: Scope, feature, n_heatmaps: int = 19,
                     n_pafs: int = 38, n_stages: int = 6,
                     stage1_convs: int = 3, stage1_kernel: int = 3,
                     stage1_proj: int = 512, refine_convs: int = 5,
                     refine_kernel: int = 7, refine_mid: int = 128,
                     separable: bool = False,
                     compute_dtype: str = "bfloat16", remat: bool = False):
    """The full stage stack shared by every backbone.

    Returns per-stage (conf, paf) lists; later stages see
    concat(F, conf_{t-1}, paf_{t-1}) exactly as in the reference. With
    `remat`, each branch is rematerialized in the backward pass
    (jax.checkpoint): about one extra stage forward for O(n_stages) less
    activation memory.
    """
    confs, pafs = [], []
    x = feature
    for stage in range(n_stages):
        if stage == 0:
            kw: dict[str, Any] = dict(
                n_convs=stage1_convs, kernel=stage1_kernel,
                proj_features=stage1_proj)
        else:
            kw = dict(n_convs=refine_convs, kernel=refine_kernel,
                      mid_features=refine_mid, proj_features=refine_mid)
            x = jnp.concatenate(
                [feature, confs[-1].astype(feature.dtype),
                 pafs[-1].astype(feature.dtype)], axis=-1)
            # Materialize the stage input once for the separable heads at
            # serving and training batches: without the barrier XLA may
            # fuse this 4-piece concat into every consumer (both branches'
            # first depthwise conv and, in training, their transposes),
            # re-gathering the pieces each time.
            if separable and x.shape[0] <= 16:
                x = jax.lax.optimization_barrier(x)
        for branch, n_out in (("conf", n_heatmaps), ("paf", n_pafs)):
            sub = s.child(f"stage{stage + 1}_{branch}")

            def run(p, x, sub=sub, n_out=n_out, kw=kw):
                return stage_branch(sub.rebind(p), x, n_out,
                                    separable=separable,
                                    compute_dtype=compute_dtype, **kw)

            if remat:
                run = jax.checkpoint(run)
            (confs if branch == "conf" else pafs).append(run(sub.params, x))
    return confs, pafs


def vgg_block(s: Scope, x, features: Sequence[int], compute_dtype: str,
              prefix: str, pool: bool = True, s2d_stem: bool = False):
    """n stacked 3x3 conv+relu, optional 2x2 max pool.

    s2d_stem runs the whole block on the space-to-depth grid (same
    params, rearranged at trace time — see s2d_conv_relu) and pools via
    the free channel-chunk max; accepts a plain even-dim input (s2d
    applied on device) or a pre-transformed (B, H/2, W/2, 12) one. Used
    for the thin conv1 blocks of the VGG-family models. The block decides
    eligibility from the input (even dims or a pre-permuted 12-channel
    input), so the gate lives here once, not in every model.
    """
    if s2d_stem:
        even = x.shape[1] % 2 == 0 and x.shape[2] % 2 == 0
        s2d_stem = even or x.shape[-1] == 12
    if x.shape[-1] == 12 and not s2d_stem:
        raise ValueError("s2d input layout needs stem_s2d")
    if s2d_stem:
        if not pool:
            raise ValueError("s2d_stem emits the pooled plain grid")
        if x.shape[-1] == 3:
            x = space_to_depth(x)
        elif x.shape[-1] != 12:
            raise ValueError(f"s2d_stem expects an RGB image (plain or "
                             f"s2d layout), got {x.shape}")
        cin = 3
        for i, f in enumerate(features):
            x = s2d_conv_relu(s.child(f"{prefix}_{i + 1}"), x, f,
                              in_channels=cin, compute_dtype=compute_dtype)
            cin = f
        return s2d_maxpool_to_plain(x, features[-1])
    for i, f in enumerate(features):
        x = conv_relu(s.child(f"{prefix}_{i + 1}"), x, f,
                      compute_dtype=compute_dtype)
    return max_pool2(x) if pool else x
