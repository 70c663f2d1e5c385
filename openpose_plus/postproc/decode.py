"""End-to-end on-device decoding: (conf, paf) maps -> fixed-size skeletons.

This is the single JAX pipeline that replaces the reference's host-side
grouping on BOTH its paths (Python estimator and src/paf.cpp; SURVEY.md §2).
It is pure, static-shape, jit-compiled and vmapped over the batch, so the
whole post-processing stage fuses into the same XLA program as the CNN
forward pass — zero host round-trips.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from openpose_plus.config import PostprocConfig
from openpose_plus.postproc import group, nms, paf
from openpose_plus.utils.pytree import pytree_dataclass


@pytree_dataclass
class HumanBatch:
    """Fixed-capacity skeleton results for a batch of images.

    Coordinates are normalized to [0, 1] in network-input space using the
    pixel-center convention (px + 0.5) / extent, so they rescale to any
    original image size. Rows are compacted: valid humans first, sorted by
    descending mean score.
    """

    coords: jax.Array       # (B, M, 18, 2) float32 — (x, y) normalized
    part_scores: jax.Array  # (B, M, 18) float32 peak score (0 if absent)
    part_valid: jax.Array   # (B, M, 18) bool
    score: jax.Array        # (B, M) float32 mean score (peaks+connections)/count
    n_parts: jax.Array      # (B, M) int32
    valid: jax.Array        # (B, M) bool

    @property
    def num_humans(self) -> jax.Array:
        return jnp.sum(self.valid, axis=-1)

    def to_list(self, batch_index: int = 0) -> list[dict]:
        """Host-side list-of-humans view (the reference's [Human] result
        type): [{'parts': {part: (x, y, score)}, 'score': float}]."""
        import numpy as np

        out = []
        valid = np.asarray(self.valid[batch_index])
        coords = np.asarray(self.coords[batch_index])
        pvalid = np.asarray(self.part_valid[batch_index])
        pscore = np.asarray(self.part_scores[batch_index])
        score = np.asarray(self.score[batch_index])
        for m in np.nonzero(valid)[0]:
            parts = {
                int(p): (float(coords[m, p, 0]), float(coords[m, p, 1]),
                         float(pscore[m, p]))
                for p in np.nonzero(pvalid[m])[0]
            }
            out.append({"parts": parts, "score": float(score[m])})
        return out


def preprocess_single(conf: jax.Array, paf_map: jax.Array,
                      cfg: PostprocConfig) -> tuple[jax.Array, jax.Array]:
    """Upsample both map stacks and smooth the confidence maps.

    Exposed separately so parity tests can feed the numpy oracle the exact
    floats the JAX pipeline consumes (peak plateaus compare floats for
    equality, so shared inputs are required for bit-exact parity).
    """
    smoothed = nms.upsample_smooth(conf, cfg.upsample_factor,
                                   cfg.smooth_sigma)
    paf_u = nms.upsample(paf_map, cfg.upsample_factor)
    return smoothed, paf_u


def _decode_single(conf: jax.Array, paf_map: jax.Array,
                   cfg: PostprocConfig) -> HumanBatch:
    """Decode one image's (H, W, 19) conf + (H, W, 38) paf maps."""
    # upsample+smooth of the conf maps run as ONE fused pair of
    # contractions; score_candidates upsamples the raw PAF itself.
    smoothed = nms.upsample_smooth(conf, cfg.upsample_factor,
                                   cfg.smooth_sigma)
    peaks = nms.find_peaks(smoothed, cfg.peak_threshold, cfg.max_peaks)
    cand_scores = paf.score_candidates(
        paf_map, peaks, cfg.paf_n_samples, cfg.paf_sample_threshold,
        cfg.paf_inlier_ratio, lowres_factor=cfg.upsample_factor)

    peak_score_flat = peaks.score.reshape(-1)           # (18*K,)
    subsets = serial_tail(cand_scores, peaks.score, cfg.max_peaks,
                          cfg.max_humans)

    h, w = smoothed.shape[0], smoothed.shape[1]
    rx_flat = ((peaks.refined_x + 0.5) / w).reshape(-1)
    ry_flat = ((peaks.refined_y + 0.5) / h).reshape(-1)

    gids = subsets.parts                                 # (M, 18)
    part_valid = gids >= 0
    safe = jnp.where(part_valid, gids, 0)
    # Look up (x, y, score) per assigned peak as ONE one-hot matmul instead
    # of three scalar gathers (a one-hot row selects exactly one value, so
    # this is bit-identical at HIGHEST).
    table = jnp.stack([rx_flat, ry_flat, peak_score_flat], axis=-1)
    onehot = (safe.reshape(-1)[:, None]
              == jnp.arange(table.shape[0])).astype(table.dtype)
    vals = jnp.matmul(onehot, table,
                      precision=jax.lax.Precision.HIGHEST)  # (M*18, 3)
    vals = vals.reshape(*safe.shape, 3)
    coords = jnp.where(part_valid[..., None], vals[..., :2], 0.0)
    part_scores = jnp.where(part_valid, vals[..., 2], 0.0)

    count = subsets.count
    mean_score = jnp.where(count > 0, subsets.score / jnp.maximum(count, 1), 0.0)
    if cfg.fragment_merge_rel > 0:
        # repair structural fragmentation BEFORE the min-parts filter so
        # sub-threshold fragments can combine into a valid person
        coords, part_scores, part_valid, mean_score, count = \
            _merge_fragments_single(
                coords, part_scores, part_valid, mean_score, count,
                w=w, h=h, rel_threshold=cfg.fragment_merge_rel,
                rounds=cfg.fragment_merge_rounds)
    valid = ((count >= cfg.min_parts_per_human)
             & (mean_score > cfg.min_human_score))

    # Compact: valid humans first, by descending mean score.
    order = jnp.argsort(-jnp.where(valid, mean_score, -jnp.inf))
    return HumanBatch(
        coords=coords[order].astype(jnp.float32),
        part_scores=part_scores[order].astype(jnp.float32),
        part_valid=part_valid[order] & valid[order, None],
        score=mean_score[order].astype(jnp.float32),
        n_parts=count[order].astype(jnp.int32),
        valid=valid[order],
    )


def _serial_tail_xla(cand_scores, peak_score, *, k: int, m: int):
    conns = paf.greedy_assign(cand_scores, k)
    return group.assemble(conns, peak_score.reshape(-1), k, m)


def _serial_tail_kernels(cand_scores, peak_score, *, k: int, m: int):
    from openpose_plus.ops.pallas.greedy import greedy_assign_pallas
    from openpose_plus.ops.pallas.merge import assemble_pallas

    conns = greedy_assign_pallas(cand_scores, k)
    return assemble_pallas(conns, peak_score, k, m)


def serial_tail(cand_scores: jax.Array, peak_score: jax.Array, k: int,
                m: int) -> group.Subsets:
    """Greedy limb assignment + sequential subset merge of one image.

    The choice follows the platform being lowered for: the GPU runs the
    two Pallas (Triton) kernels, one program per image each; the CPU runs
    their XLA twins (paf.greedy_assign, group.assemble). Both give the
    same bits (tests/test_pallas_*.py, chip_smoke.py)."""
    return jax.lax.platform_dependent(
        cand_scores, peak_score,
        cpu=functools.partial(_serial_tail_xla, k=k, m=m),
        cuda=functools.partial(_serial_tail_kernels, k=k, m=m))


def decode_maps(conf: jax.Array, paf_map: jax.Array,
                cfg: PostprocConfig) -> HumanBatch:
    """Batched decode: (B, H, W, 19) + (B, H, W, 38) -> HumanBatch.

    Call inside jit (cfg is static); maps should be float32 — upstream
    bfloat16 model outputs are upcast here to keep peak ordering stable.
    """
    conf = conf.astype(jnp.float32)
    paf_map = paf_map.astype(jnp.float32)
    return jax.vmap(functools.partial(_decode_single, cfg=cfg))(conf, paf_map)


def build_decoder(cfg: PostprocConfig):
    """jit-compiled standalone decoder fn(conf, paf) -> HumanBatch."""
    return jax.jit(functools.partial(decode_maps, cfg=cfg))


# ----------------------------------------------------- fragment merge ---

def _merge_fragments_single(coords, part_scores, part_valid, score, count,
                            *, w: int, h: int, rel_threshold: float,
                            rounds: int):
    """Greedy fragment merge over one image's assembled skeletons.

    Bottom-up PAF assembly structurally FRAGMENTS truncated/occluded
    people: when the visible parts form a disconnected subgraph of the
    limb tree (e.g. head + lower legs with the hips out of frame), no
    limb candidate can ever join the components, so they surface as
    separate low-part skeletons whose OKS vs the whole person is capped
    at parts/17 (< 0.5) — measured as 37 of the 55 oracle-ceiling misses
    on the serving val bank (BASELINE.md r5 "quality ceiling").

    Repair pass: up to `rounds` times, merge the spatially closest pair
    of skeletons whose part sets are DISJOINT and whose minimum
    part-to-part distance is <= rel_threshold x the larger fragment's
    bbox diagonal (scale-relative, so big and small figures use the
    same rule). The threshold was tuned on the TRAIN bank's GT-map
    oracle (+4.8 AP there) and frozen before touching val. Runs before
    the min-parts validity filter so sub-threshold fragments can
    combine into a valid person.
    """
    m = coords.shape[0]
    px = coords * jnp.asarray([w, h], coords.dtype)        # (M, 18, 2)

    def body(_, state):
        px_, psc, pvd, sc, cnt = state
        # pairwise min part distance over currently-valid part pairs
        d = jnp.linalg.norm(px_[:, None, :, None] - px_[None, :, None, :],
                            axis=-1)                        # (M, M, 18, 18)
        pair_ok = pvd[:, None, :, None] & pvd[None, :, None, :]
        mind = jnp.min(jnp.where(pair_ok, d, jnp.inf), axis=(2, 3))
        big = jnp.where(pvd[..., None], px_, -jnp.inf)
        small = jnp.where(pvd[..., None], px_, jnp.inf)
        ext = jnp.max(big, axis=1) - jnp.min(small, axis=1)  # (M, 2)
        diag = jnp.sqrt(jnp.maximum(
            jnp.sum(jnp.where(cnt[:, None] > 0, ext, 0.0) ** 2, -1), 1e-6))
        rel = mind / jnp.maximum(jnp.maximum(diag[:, None], diag[None, :]),
                                 1e-3)
        shared = jnp.any(pvd[:, None] & pvd[None, :], axis=-1)
        live = cnt > 0
        iu = jnp.triu(jnp.ones((m, m), bool), k=1)
        elig = (iu & ~shared & live[:, None] & live[None, :]
                & (rel <= rel_threshold))
        rel = jnp.where(elig, rel, jnp.inf)
        flat = jnp.argmin(rel)
        i, j = flat // m, flat % m
        do = jnp.isfinite(rel.reshape(-1)[flat])
        # merge j into i (masked no-op when nothing is eligible)
        oi = (jnp.arange(m) == i)
        oj = (jnp.arange(m) == j)
        take = pvd[j]                                        # (18,)
        upd = oi[:, None] & take[None, :] & do
        px_ = jnp.where(upd[..., None], px_[j][None], px_)
        psc = jnp.where(upd, psc[j][None], psc)
        pvd = pvd | upd
        tot = cnt[i] + cnt[j]
        sc_i = (sc[i] * cnt[i] + sc[j] * cnt[j]) / jnp.maximum(tot, 1)
        sc = jnp.where(oi & do, sc_i, sc)
        cnt = jnp.where(oi & do, tot, jnp.where(oj & do, 0, cnt))
        pvd = jnp.where(oj[:, None] & do, False, pvd)
        return px_, psc, pvd, sc, cnt

    px, part_scores, part_valid, score, count = jax.lax.fori_loop(
        0, rounds, body, (px, part_scores, part_valid, score, count))
    coords = px / jnp.asarray([w, h], px.dtype)
    coords = jnp.where(part_valid[..., None], coords, 0.0)
    part_scores = jnp.where(part_valid, part_scores, 0.0)
    return coords, part_scores, part_valid, score, count


# --------------------------------------------------------------- dedup ---
# Per-part OKS falloff in OPENPOSE-18 ordering (COCO-17 sigmas routed
# through skeleton.COCO_FROM_OPENPOSE; the neck, absent from COCO, gets
# the shoulder-class sigma). Used by merge_dedup's greedy OKS-NMS.

def _oks_sigmas_18():
    import numpy as np

    from openpose_plus import skeleton

    sig = np.full(18, 0.079, np.float32)          # neck default
    for c17, part in enumerate(skeleton.COCO_FROM_OPENPOSE):
        sig[part] = skeleton.COCO_OKS_SIGMAS[c17]
    return sig


def _dedup_single(coords, part_scores, part_valid, score, n_parts, valid,
                  *, thresh: float):
    """Greedy OKS-NMS over one image's human rows (score-descending).

    Rows are re-sorted by descending score FIRST: each input batch is
    sorted (HumanBatch contract), but merge_dedup concatenates several
    batches, and greedy NMS run in concatenation order would give the
    first scale suppression priority over better-scored rows from later
    scales (the r4 ordering bug — a 0.6-scored duplicate could kill the
    0.9 original). A row is suppressed when a higher-scored kept row
    overlaps it with skeleton-OKS > thresh. OKS uses the keeper's
    valid-part bounding-box area as the scale (the COCOeval convention of
    normalizing by the reference object's area), averaged over parts BOTH
    rows carry; rows sharing no parts never suppress each other (two
    half-bodies of one person are left for the caller's score ranking to
    sort out)."""
    pre = jnp.argsort(-jnp.where(valid, score, -jnp.inf))
    coords, part_scores, part_valid, score, n_parts, valid = (
        coords[pre], part_scores[pre], part_valid[pre], score[pre],
        n_parts[pre], valid[pre])
    n = coords.shape[0]
    sig = jnp.asarray(_oks_sigmas_18())
    var = (2.0 * sig) ** 2                                    # (18,)

    d2 = jnp.sum((coords[:, None] - coords[None, :]) ** 2, -1)  # (N,N,18)
    big = jnp.where(part_valid[..., None], coords, -jnp.inf)
    small = jnp.where(part_valid[..., None], coords, jnp.inf)
    ext = jnp.max(big, axis=1) - jnp.min(small, axis=1)         # (N,2)
    has = n_parts > 0
    area = jnp.where(has, ext[:, 0] * ext[:, 1], 0.0)
    area = jnp.maximum(area, 1e-4)                              # (N,)

    both = part_valid[:, None] & part_valid[None, :]            # (N,N,18)
    e = d2 / (2.0 * area[:, None, None] * var + 1e-12)
    oks = (jnp.sum(jnp.exp(-e) * both, -1)
           / jnp.maximum(jnp.sum(both, -1), 1))                 # (N,N)

    idx = jnp.arange(n)

    def body(i, supp):
        keep_i = valid[i] & ~supp[i]
        row = (oks[i] > thresh) & (idx > i)
        return jnp.where(keep_i, supp | row, supp)

    supp = jax.lax.fori_loop(0, n, body, jnp.zeros(n, bool))
    keep = valid & ~supp
    order = jnp.argsort(-jnp.where(keep, score, -jnp.inf))
    return HumanBatch(
        coords=coords[order], part_scores=part_scores[order],
        part_valid=part_valid[order] & keep[order, None],
        score=jnp.where(keep, score, 0.0)[order],
        n_parts=jnp.where(keep, n_parts, 0)[order],
        valid=keep[order])


def merge_dedup(batches, oks_threshold: float = 0.5) -> HumanBatch:
    """Merge HumanBatches (e.g. one per TTA scale) by per-scale decode +
    greedy OKS-NMS — the alternative multi-scale combiner to map
    averaging: each person is taken from whichever scale detects them
    best instead of blurring all scales' maps together. Coordinates are
    normalized to input space, so rows from different scales are directly
    comparable. Call inside jit (oks_threshold is static)."""
    cat = HumanBatch(
        coords=jnp.concatenate([b.coords for b in batches], axis=1),
        part_scores=jnp.concatenate([b.part_scores for b in batches], 1),
        part_valid=jnp.concatenate([b.part_valid for b in batches], 1),
        score=jnp.concatenate([b.score for b in batches], 1),
        n_parts=jnp.concatenate([b.n_parts for b in batches], 1),
        valid=jnp.concatenate([b.valid for b in batches], 1))
    return jax.vmap(functools.partial(_dedup_single, thresh=oks_threshold))(
        cat.coords, cat.part_scores, cat.part_valid, cat.score,
        cat.n_parts, cat.valid)
