"""Pallas (Triton route) kernel for the sequential subset merge.

The human-assembly merge (postproc/group.py) is inherently serial: each
connection sees the subsets produced by all earlier ones. On a GPU the XLA
twin is a device loop over every one of the n_limbs * K connection slots,
at least one kernel launch per slot. Here it is ONE program per image whose
state — a (max_humans, 18) table of global peak ids plus running score and
count vectors — lives in registers, padded to a (32, 32) int32 block (18
parts -> 32 columns; Triton blocks are powers of two). Per-connection
scalars are loaded from global memory inside the loop. This is the
replacement for the reference's pointer-chasing C++ assembly loop
(src/human.cpp [MED; empty mount — SURVEY.md §2]).

Invalid connection slots are exact no-ops in the merge semantics, so the
wrapper compacts the (n_limbs * K) slot grid down to the valid prefix
(stable, preserving the limb-major processing order) and the kernel runs a
dynamic-trip-count loop over only those.

Semantics are bit-identical to group.assemble (the CMU merge, including its
overwrite-and-count quirk): "first row where mask" is the min of a masked
row iota, and every scalar sub-sum is grouped as group.assemble groups it.
Parity is pinned by tests/test_pallas_merge.py in interpret mode and on
the GPU by chip_smoke.py. The kernel is written per image; vmap adds the
grid axis.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from openpose_plus import skeleton
from openpose_plus.ops.pallas.greedy import _pow2
from openpose_plus.postproc.group import Subsets
from openpose_plus.postproc.paf import Connections

_N_PARTS = skeleton.N_PARTS


def _merge_kernel(n_valid_ref, ia_ref, ib_ref, a_gid_ref, b_gid_ref,
                  cscore_ref, a_ps_ref, b_ps_ref, can_create_ref,
                  parts_out, score_out, count_out, *, max_humans: int):
    rows, cols = parts_out.shape
    row_ids = jax.lax.broadcasted_iota(jnp.int32, (rows, cols), 0)
    col_ids = jax.lax.broadcasted_iota(jnp.int32, (rows, cols), 1)
    rvec = jax.lax.broadcasted_iota(jnp.int32, (rows,), 0)
    cvec = jax.lax.broadcasted_iota(jnp.int32, (cols,), 0)
    neg = jnp.int32(-(2 ** 30))
    real_row = rvec < max_humans

    def first_row(mask):
        return jnp.min(jnp.where(mask, rvec, rows))

    def conn_step(i, state):
        parts, score, count = state      # (R, C) i32, (R,) f32, (R,) i32
        ia = ia_ref[i]
        ib = ib_ref[i]
        a_gid = a_gid_ref[i]
        b_gid = b_gid_ref[i]
        cscore = cscore_ref[i]
        a_ps = a_ps_ref[i]
        b_ps = b_ps_ref[i]
        can_create = can_create_ref[i] > 0

        col_is_b = col_ids == ib
        col_a = jnp.max(jnp.where(col_ids == ia, parts, neg), axis=1)
        col_b = jnp.max(jnp.where(col_is_b, parts, neg), axis=1)
        found = (col_a == a_gid) | (col_b == b_gid)          # (R,)
        nfound = jnp.sum(found.astype(jnp.int32))
        j1 = first_row(found)
        j2 = first_row(found & (rvec != j1))

        is_j1 = row_ids == j1
        is_j2 = row_ids == j2
        row1 = jnp.max(jnp.where(is_j1, parts, neg), axis=0)  # (C,)
        row2 = jnp.max(jnp.where(is_j2, parts, neg), axis=0)
        overlap = jnp.max(((row1 >= 0) & (row2 >= 0)).astype(jnp.int32)) > 0

        empty = (count == 0) & real_row
        jnew = first_row(empty)
        has_empty = jnew < rows

        r1_ib = jnp.max(jnp.where(cvec == ib, row1, neg))
        attach = (((nfound == 1) & (r1_ib != b_gid))
                  | ((nfound == 2) & overlap))
        merge = (nfound == 2) & jnp.logical_not(overlap)
        create = (nfound == 0) & has_empty & can_create

        on1 = rvec == j1
        on2 = rvec == j2
        onn = rvec == jnew

        # attach: parts[j1, ib] = b_gid
        parts_att = jnp.where(is_j1 & col_is_b, b_gid, parts)
        score_att = jnp.where(on1, score + (b_ps + cscore), score)
        count_att = jnp.where(on1, count + 1, count)

        # merge j1 <- j2, clear j2
        merged_row = jnp.where(row2 >= 0, row2, row1)[None, :]
        parts_mrg = jnp.where(is_j1, merged_row, parts)
        parts_mrg = jnp.where(is_j2, -1, parts_mrg)
        s2 = jnp.sum(jnp.where(on2, score, 0.0))
        c2 = jnp.sum(jnp.where(on2, count, 0))
        score_mrg = jnp.where(on1, score + (s2 + cscore), score)
        score_mrg = jnp.where(on2, 0.0, score_mrg)
        count_mrg = jnp.where(on1, count + c2, count)
        count_mrg = jnp.where(on2, 0, count_mrg)

        # create at jnew
        new_row = jnp.where(col_ids == ia, a_gid,
                            jnp.where(col_is_b, b_gid, -1))
        parts_new = jnp.where(row_ids == jnew, new_row, parts)
        score_new = jnp.where(onn, a_ps + b_ps + cscore, score)
        count_new = jnp.where(onn, 2, count)

        parts = jnp.where(attach, parts_att,
                          jnp.where(merge, parts_mrg,
                                    jnp.where(create, parts_new, parts)))
        score = jnp.where(attach, score_att,
                          jnp.where(merge, score_mrg,
                                    jnp.where(create, score_new, score)))
        count = jnp.where(attach, count_att,
                          jnp.where(merge, count_mrg,
                                    jnp.where(create, count_new, count)))
        return parts, score, count

    state = (jnp.full((rows, cols), -1, jnp.int32),
             jnp.zeros((rows,), jnp.float32),
             jnp.zeros((rows,), jnp.int32))
    parts, score, count = jax.lax.fori_loop(0, n_valid_ref[0], conn_step,
                                            state)
    parts_out[...] = parts
    score_out[...] = score
    count_out[...] = count


def assemble_pallas(conns: Connections, peak_score: jax.Array,
                    max_peaks: int, max_humans: int,
                    interpret: bool = False) -> Subsets:
    """Single-image merge: conns fields (L, K) + peak_score (18, K).

    vmap over the batch; semantics identical to group.assemble.
    """
    n_limbs, k = conns.slot_a.shape
    nc = n_limbs * k
    ncp = _pow2(nc)

    # Per-connection endpoint data, gathered in XLA.
    pairs = jnp.asarray(skeleton.pairs_array())
    a_ps = jnp.take_along_axis(peak_score[pairs[:, 0]], conns.slot_a, axis=1)
    b_ps = jnp.take_along_axis(peak_score[pairs[:, 1]], conns.slot_b, axis=1)
    ia_full = jnp.repeat(pairs[:, 0], k)                      # (nc,)
    ib_full = jnp.repeat(pairs[:, 1], k)
    limb_full = jnp.repeat(jnp.arange(n_limbs, dtype=jnp.int32), k)
    a_gid_full = ia_full * max_peaks + conns.slot_a.reshape(-1)
    b_gid_full = ib_full * max_peaks + conns.slot_b.reshape(-1)

    # Stable compaction of valid slots to the prefix (limb-major order
    # preserved); invalid slots scatter out of bounds and are dropped.
    v = conns.valid.reshape(-1)
    tgt = jnp.where(v, jnp.cumsum(v.astype(jnp.int32)) - 1, ncp)
    n_valid = jnp.sum(v.astype(jnp.int32)).reshape(1)

    def compact(x):
        return jnp.zeros((ncp,), x.dtype).at[tgt].set(x, mode="drop")

    rows = _pow2(max_humans)
    parts, score, count = pl.pallas_call(
        functools.partial(_merge_kernel, max_humans=max_humans),
        out_shape=(
            jax.ShapeDtypeStruct((rows, _pow2(_N_PARTS)), jnp.int32),
            jax.ShapeDtypeStruct((rows,), jnp.float32),
            jax.ShapeDtypeStruct((rows,), jnp.int32),
        ),
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=4),
        interpret=interpret,
        name="assemble",
    )(n_valid, compact(ia_full), compact(ib_full), compact(a_gid_full),
      compact(b_gid_full), compact(conns.score.reshape(-1)),
      compact(a_ps.reshape(-1)), compact(b_ps.reshape(-1)),
      compact((limb_full < 17).astype(jnp.int32)))
    return Subsets(parts=parts[:max_humans, :_N_PARTS],
                   score=score[:max_humans], count=count[:max_humans])
