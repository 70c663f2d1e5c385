"""Human assembly: sequential subset merge of accepted limb connections.

Replacement for the reference's human-assembly stage
(src/human.cpp / the subset loop in the Python estimator [MED names; empty
mount — SURVEY.md §2 "C++ PAF grouping"]). The reference algorithm is
inherently sequential (each connection sees the subsets produced by all
earlier ones, including cycle limbs 17/18 that can merge two subsets), so it
is expressed as ONE lax.fori_loop over all n_limbs * K connection slots with
fully static state: a (max_humans, 18) table of global peak ids plus running
score/count vectors. Each step is a handful of tiny VPU ops; the loop vmaps
over the batch so all images advance together.

Semantics are bit-for-bit those of oracle.assemble_humans (the CMU merge,
including its overwrite-and-count quirk); parity is enforced by tests.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from openpose_plus import skeleton
from openpose_plus.postproc.paf import Connections
from openpose_plus.utils.pytree import pytree_dataclass


@pytree_dataclass
class Subsets:
    """Raw human table for one image (before filtering/compaction)."""

    parts: jax.Array  # (M, 18) int32 global peak id (part*K + slot), -1 empty
    score: jax.Array  # (M,) float32 running score (peaks + connections)
    count: jax.Array  # (M,) int32 number of assigned parts (0 = empty row)


def assemble(conns: Connections, peak_score_flat: jax.Array,
             max_peaks: int, max_humans: int) -> Subsets:
    """Merge accepted connections into subsets.

    peak_score_flat: (n_parts * K,) float32 peak scores indexed by gid.
    """
    n_limbs = conns.slot_a.shape[0]
    k = conns.slot_a.shape[1]
    m = max_humans
    pairs = jnp.asarray(skeleton.pairs_array())  # (L, 2)

    def step(i, state):
        parts, score, count = state
        limb = i // k
        t = i % k
        ia = pairs[limb, 0]
        ib = pairs[limb, 1]
        a_gid = ia * max_peaks + conns.slot_a[limb, t]
        b_gid = ib * max_peaks + conns.slot_b[limb, t]
        cscore = conns.score[limb, t]
        cvalid = conns.valid[limb, t]
        a_pscore = peak_score_flat[a_gid]
        b_pscore = peak_score_flat[b_gid]

        col_a = jnp.take(parts, ia, axis=1)  # (M,)
        col_b = jnp.take(parts, ib, axis=1)
        found = (col_a == a_gid) | (col_b == b_gid)
        nfound = jnp.sum(found)

        ridx = jnp.arange(m)
        j1 = jnp.argmax(found)                       # first found row
        found2 = found & (ridx != j1)
        j2 = jnp.argmax(found2)                      # second found row
        row1, row2 = parts[j1], parts[j2]
        overlap = jnp.any((row1 >= 0) & (row2 >= 0))

        empty = count == 0
        jnew = jnp.argmax(empty)
        has_empty = jnp.any(empty)

        attach1 = cvalid & (nfound == 1) & (row1[ib] != b_gid)
        merge = cvalid & (nfound == 2) & ~overlap
        attach2 = cvalid & (nfound == 2) & overlap
        create = cvalid & (nfound == 0) & (limb < 17) & has_empty
        attach = attach1 | attach2  # both target row j1

        # --- attach endpoint B to row j1 (CMU overwrite-and-count quirk:
        # count/score bump even if the slot held a different gid) ---
        parts_att = parts.at[j1, ib].set(b_gid)
        score_att = score.at[j1].add(b_pscore + cscore)
        count_att = count.at[j1].add(1)

        # --- merge rows j1 <- j2 (disjoint), clear j2 ---
        merged_row = jnp.where(row2 >= 0, row2, row1)
        parts_mrg = parts.at[j1].set(merged_row).at[j2].set(
            jnp.full((skeleton.N_PARTS,), -1, jnp.int32))
        score_mrg = score.at[j1].add(score[j2] + cscore).at[j2].set(0.0)
        count_mrg = count.at[j1].add(count[j2]).at[j2].set(0)

        # --- create new row at first empty slot ---
        new_row = jnp.full((skeleton.N_PARTS,), -1, jnp.int32)
        new_row = new_row.at[ia].set(a_gid).at[ib].set(b_gid)
        parts_new = parts.at[jnew].set(new_row)
        score_new = score.at[jnew].set(a_pscore + b_pscore + cscore)
        count_new = count.at[jnew].set(2)

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

    init = (jnp.full((m, skeleton.N_PARTS), -1, jnp.int32),
            jnp.zeros((m,), jnp.float32),
            jnp.zeros((m,), jnp.int32))
    parts, score, count = jax.lax.fori_loop(0, n_limbs * k, step, init)
    return Subsets(parts=parts, score=score, count=count)
