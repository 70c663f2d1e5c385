"""Pallas (Triton route) kernel for the per-limb greedy candidate assignment.

postproc/paf.py :: greedy_assign expresses the reference's
scan-sorted-candidates greedy (src/paf.cpp connection selection [MED; empty
mount — SURVEY.md §2]) as max_peaks rounds of masked argmax. Lowered through
XLA on a GPU that is a K-iteration device loop of tiny kernels; here the
whole assignment is ONE program per image: all limbs advance together as
rows of a (limbs, K*K) score block held in registers, the K rounds are
unrolled, and the (limbs, K) outputs are built in registers and stored once.

Triton blocks are powers of two, so the wrapper pads the limb axis (19 ->
32) and the candidate axis (K*K -> next power of two) with -inf, which no
round ever selects, and the kernel pads its (limbs, K) outputs likewise.

First-max selection uses max + masked min-iota, so ties go to the lowest
row-major candidate index exactly as in paf.greedy_assign. Bit-identical to
it; pinned by tests/test_pallas_greedy.py in interpret mode and on the GPU
by chip_smoke.py.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from openpose_plus.postproc.paf import Connections


def _pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _greedy_kernel(scores_ref, sa_ref, sb_ref, sc_ref, ok_ref, *, k: int):
    rows, kk = scores_ref.shape
    kp = sa_ref.shape[1]
    rem = scores_ref[...]                                  # (R, KKp) f32
    col = jax.lax.broadcasted_iota(jnp.int32, (rows, kk), 1)
    col_a = col // k                                       # candidate A slot
    col_b = col % k                                        # candidate B slot
    out_col = jax.lax.broadcasted_iota(jnp.int32, (rows, kp), 1)
    sa = jnp.zeros((rows, kp), jnp.int32)
    sb = jnp.zeros((rows, kp), jnp.int32)
    sc = jnp.zeros((rows, kp), jnp.float32)
    ok = jnp.zeros((rows, kp), jnp.int32)
    for t in range(k):                                     # static unroll
        best = jnp.max(rem, axis=1, keepdims=True)         # (R, 1)
        valid = best > -jnp.inf
        j = jnp.min(jnp.where(rem == best, col, kk), axis=1, keepdims=True)
        ja = j // k
        jb = j % k
        rem = jnp.where(valid & ((col_a == ja) | (col_b == jb)), -jnp.inf,
                        rem)
        at_t = out_col == t
        sa = jnp.where(at_t, jnp.where(valid, ja, 0), sa)
        sb = jnp.where(at_t, jnp.where(valid, jb, 0), sb)
        sc = jnp.where(at_t, jnp.where(valid, best, 0.0), sc)
        ok = jnp.where(at_t, valid.astype(jnp.int32), ok)
    sa_ref[...] = sa
    sb_ref[...] = sb
    sc_ref[...] = sc
    ok_ref[...] = ok


def greedy_assign_pallas(scores: jax.Array, max_peaks: int,
                         interpret: bool = False) -> Connections:
    """Single-image greedy assignment: scores (n_limbs, K, K) -> Connections.

    vmap over the batch (vmap adds the grid axis: one program per image);
    semantics identical to paf.greedy_assign.
    """
    n_limbs, k, _ = scores.shape
    if k != max_peaks:
        raise ValueError(f"scores K dim {k} != max_peaks {max_peaks}")
    rows, kk, kp = _pow2(n_limbs), _pow2(k * k), _pow2(k)
    flat = jnp.pad(scores.reshape(n_limbs, k * k),
                   ((0, rows - n_limbs), (0, kk - k * k)),
                   constant_values=-jnp.inf)
    out = jax.ShapeDtypeStruct((rows, kp), jnp.int32)
    sa, sb, sc, ok = pl.pallas_call(
        functools.partial(_greedy_kernel, k=k),
        out_shape=(out, out, jax.ShapeDtypeStruct((rows, kp), jnp.float32),
                   out),
        backend="triton",
        compiler_params=pl_triton.CompilerParams(
            num_warps=max(4, min(16, rows * kk // 2048))),
        interpret=interpret,
        name="greedy_assign",
    )(flat)
    return Connections(slot_a=sa[:n_limbs, :k], slot_b=sb[:n_limbs, :k],
                       score=sc[:n_limbs, :k], valid=ok[:n_limbs, :k] > 0)
