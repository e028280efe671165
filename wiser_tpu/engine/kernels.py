"""Batched device search kernels (the L3 hot core, redesigned for an
accelerator: batched, static-shape XLA programs).

The reference processes one query at a time with pointer-chasing DAAT
iterators (ProcessQueryDelta, query_processing.h:956-979: zigzag +
SkipForward + min-heap). Here a whole batch of queries executes as one XLA
program over global CSR posting columns:

  1. load each query's *candidate* posting block — the postings of its
     least-frequent term — as a contiguous dynamic_slice (a sliced load,
     not an element gather),
  2. score candidates from a precomputed per-posting partial-score column
     (idf * lossy tfnorm baked at index-load time — the BM25 cache idea of
     scoring.h:85-90 taken one step further: the whole per-(term,doc)
     f32 term score is the cache),
  3. for multi-term queries, intersect by vectorized binary search of the
     candidates into every other term's CSR slice (replaces SkipForward's
     skip-list hops, query_processing.h:742-763),
  4. mask non-matching lanes to -inf and `lax.top_k` (replaces the
     min-heap, query_processing.h:897-945). On the CPU and on the H100
     (chip_smoke.py probes it) top_k returns equal values lowest index =
     lowest doc id first; the count-based boundary guards keep results
     exact whatever the backend's tie order,
  5. gather the per-term tfs only for the winning M lanes (tiny gather),
     for the host's exact f64 re-rank (engine/topk.py).

Slot convention (set up by host assembly): slot 0 is ALWAYS the candidate
(min-df) term; remaining query terms occupy slots 1..T-1; padded slots
repeat slot 0's list with partial scores ignored via idf-0 baking — the
host supplies per-slot start/end plus a `use_score` mask. The host keeps
the slot->query-term permutation to restore exact term order for f64
re-scoring.

Kernels are specialized (jit-cached) per (T, L, M, n_bs_iters) bucket.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np


NEG_INF = np.float32(-np.inf)
INT32_MAX = np.int32(2**31 - 1)
K1_PLUS_1 = np.float32(2.2)

# -- compressed (tc) posting columns ----------------------------------------
#
# The raw device layout spends 8 bytes/posting on (score f32, tf i32). The
# "tc" mode replaces both with ONE uint16 lane: tc = doc_len_code << 8 |
# min(tf, 255) — the reference's storage story (tf varints + the 1-byte
# lossy length code, packed_value.h:87-274 + utils.h:301-330) mapped to a
# fixed-width device lane. The f32 selection score is RECONSTRUCTED
# in-kernel with ~12 elementwise ops (CHAR4 decode is pure arithmetic — no
# table gathers):
#   score = idf32[slot] * (tf * (k1+1)) / (tf + k1*(1 - b + b*len/avg))
#
# Exactness: the reconstruction differs from the host's f64->f32 score by
# a few ulps; the engine widens the truncation guard's rel_eps accordingly
# (device.py TC_REL_EPS) so every possible cross-boundary inversion is
# still flagged to the exact host path. A tf byte of 255 means "tf >=
# 255": the scorer substitutes the OPTIMISTIC bound idf*(k1+1) (tfnorm's
# supremum), which can only keep such lanes IN the candidate buffer, and
# any query whose kept lanes include one is flagged (bit 2) for the exact
# host path — so arbitrarily large tfs stay bit-exact with no term-level
# routing.
K1_F32 = np.float32(1.2)
B_F32 = np.float32(0.75)
ONE_MINUS_B_F32 = np.float32(0.25)
TF_SAT = 255
FLAG_TRUNC = 1  # f32 boundary class truncated
FLAG_OVERFLOW = 2  # windowed-kernel window overflow (lanes missing)
FLAG_TF_SAT = 4  # a kept lane's tf byte saturated (tc mode)
FLAG_PRUNE_MISS = 8  # pruned-dense: an unexamined block could beat the kept set


def tc_score(tc_i32, idf32, avg32):
    """Reconstruct the f32 selection score from tc lanes (code8<<8 | tf8).

    tc_i32: int32 lanes; idf32: broadcastable f32 per-slot idf (0 on
    padded slots); avg32: 0-d f32 average field length. tf byte 0
    (sentinel/pad lanes) scores exactly 0.0; tf byte 255 scores the
    optimistic upper bound idf*(k1+1) (see module note)."""
    tf_i = tc_i32 & 0xFF
    tf = tf_i.astype(jnp.float32)
    code = (tc_i32 >> 8) & 0xFF
    bits = code & 7
    shift = jnp.minimum((code >> 3) - 1, 27)  # valid CHAR4 codes shift <= 27
    length = jnp.where(shift < 0, bits, (bits | 8) << jnp.maximum(shift, 0))
    cache = K1_F32 * (ONE_MINUS_B_F32
                      + B_F32 * length.astype(jnp.float32) / avg32)
    norm = (tf * K1_PLUS_1) / (tf + cache)
    norm = jnp.where(tf_i >= TF_SAT, K1_PLUS_1, norm)
    return idf32 * norm


def tc_saturated(top_tc_i32, top_docs):
    """(B,) bool: some KEPT valid lane carries a saturated tf byte (its
    true tf exceeds the 8-bit field, so its score was the optimistic
    bound and its returned tf is wrong — the query must take the exact
    host path). top_tc_i32: (B, M) or (B, T, M); top_docs: (B, M)."""
    sat = (top_tc_i32 & 0xFF) >= TF_SAT
    if sat.ndim == 3:
        sat = jnp.any(sat, axis=1)
    return jnp.any(sat & (top_docs >= 0), axis=1)


def _gather1d(arr, idx):
    """arr[idx] with idx clipped into range (callers mask separately)."""
    return jnp.take(arr, jnp.clip(idx, 0, arr.shape[0] - 1), axis=0)


def _dense_gather(plane, slots_t, doc_idx):
    """plane[slot, doc] element gather from an (H, N_pad) dense plane,
    broadcasting slots_t (B, 1) against doc_idx (B, L). Flat int32
    (slot * N_pad + doc) while the plane fits 2^31 elements — the
    historical form, bit-identical and compile-cache warm. Past that, a
    2D advanced-index gather whose per-dimension indices stay int32, so
    there is NO flat-product cap: this unlocks dense tiers wider than
    ~213 rows at 10M padded docs (device._build_dense_rows). (jnp int64
    index math is NOT an option: x64 is disabled, so int64 silently
    truncates to int32.)"""
    H, N_pad = plane.shape
    if H * N_pad < _FLAT_IDX_INT32_MAX:
        idx = slots_t.astype(jnp.int32) * np.int32(N_pad) + doc_idx
        return _gather1d(plane.reshape(-1), idx)
    return plane[jnp.clip(slots_t.astype(jnp.int32), 0, H - 1),
                 jnp.clip(doc_idx, 0, N_pad - 1)]


# tests lower this to force the 2D-gather branch on small planes
_FLAT_IDX_INT32_MAX = 2**31


def _pos_gather(positions, idx):
    """Position-column gather as int32: the device positions column may be
    uint16 (half the HBM of int32 when max position < 2^16 - MAX_T, which
    holds for any real corpus — the reference stores positions as varint
    deltas for the same reason, posting.h:130-151). Cast-at-load keeps
    every kernel dtype-agnostic and costs nothing (fused)."""
    return _gather1d(positions, idx).astype(jnp.int32)


def _slice_rows(arr, starts, L):
    """Contiguous (B, L) loads: arr[starts[b] : starts[b]+L] per row.

    vmap(dynamic_slice) lowers to a sliced load, not an element
    gather."""
    n = arr.shape[0]
    s = jnp.minimum(starts.astype(jnp.int32), np.int32(max(0, n - L)))
    s = jnp.maximum(s, 0)
    return jax.vmap(lambda st: jax.lax.dynamic_slice(arr, (st,), (L,)))(s)


def _binary_search(postings_doc, targets, lo0, hi0, n_iters):
    """Vectorized lower-bound search.

    targets: (..., L) values to locate; lo0/hi0: (...,) or (..., L)
    int32 CSR bounds. Returns the first position in [lo0, hi0) whose
    value is >= target.
    """
    lo = jnp.broadcast_to(lo0, targets.shape).astype(jnp.int32)
    hi = jnp.broadcast_to(hi0, targets.shape).astype(jnp.int32)

    def body(_, carry):
        lo, hi = carry
        mid = (lo + hi) >> 1
        v = _gather1d(postings_doc, mid)
        less = v < targets
        return jnp.where(less, mid + 1, lo), jnp.where(less, hi, mid)

    lo, hi = jax.lax.fori_loop(0, n_iters, body, (lo, hi))
    return lo


def _candidates(postings_doc, postings_score, starts, ends, L):
    """Slot-0 contiguous candidate load -> (cdocs, cscore, cvalid, cs)."""
    cs = starts[:, 0]
    ce = ends[:, 0]
    lane = jnp.arange(L, dtype=jnp.int32)
    n_valid = ce - cs  # (B,)
    cvalid = lane[None, :] < n_valid[:, None]
    cdocs = jnp.where(cvalid, _slice_rows(postings_doc, cs, L), INT32_MAX)
    cscore = _slice_rows(postings_score, cs, L)
    return cdocs, cscore, cvalid, cs


def boundary_truncated(score, top_score, M: int):
    """(B,) bool: the f32 selection's boundary CLASS extends past the
    M-lane buffer — some lane with score == the kept minimum was dropped.

    This is the device half of the bit-exactness guard: the host exact
    fallback provably covers every possible parity break when combined
    with the near-tie arithmetic-slop check (engine/topk.py). f32 rounding
    is monotone, so an excluded lane with f32 score STRICTLY below the
    boundary has strictly smaller f64 score too (up to the f32-arithmetic
    slop the host check covers); equal-f32 lanes are exactly what this
    counts."""
    boundary = top_score[:, M - 1]
    full = boundary > NEG_INF
    n_ge = jnp.sum((score >= boundary[:, None]).astype(jnp.int32), axis=1)
    return full & (n_ge > M)


def search_body(postings_doc, postings_score, postings_tf,
                starts, ends, use_score, *, T, L, M, n_bs_iters,
                tc=None, idf32=None, avg32=None):
    """The batched AND/single-term search step (traceable; shared by the
    single-device jitted kernel and the shard_map'd sharded engine).

    use_score: (B, T) f32 0/1 — padded slots contribute no score.
    Compressed-column mode: pass tc (uint16 column), idf32 ((B, T) f32 in
    SLOT order, 0 on padded slots) and avg32 instead of
    postings_score/postings_tf (see tc_score).
    Returns (top_docs (B,M) i32, top_score (B,M) f32,
             top_tfs (B,T,M) i32, top_pidx (B,T,M) i32, flags (B,) i32).
    """
    B = starts.shape[0]
    tc_mode = tc is not None
    if tc_mode:
        cdocs, ctc, cvalid, cs = _candidates(postings_doc, tc, starts, ends, L)
        ctc = ctc.astype(jnp.int32)
        cscore = tc_score(ctc, idf32[:, 0:1], avg32)
    else:
        cdocs, cscore, cvalid, cs = _candidates(
            postings_doc, postings_score, starts, ends, L)
    lane = jnp.arange(L, dtype=jnp.int32)
    cpidx = cs[:, None] + lane[None, :]  # (B, L)

    if T == 1:
        score = jnp.where(cvalid, cscore, NEG_INF)
        top_score, top_l = two_level_top_m(score, M)
        top_docs = jnp.take_along_axis(cdocs, top_l, axis=1)
        top_docs = jnp.where(top_score > NEG_INF, top_docs, -1)
        top_pidx = jnp.take_along_axis(cpidx, top_l, axis=1)[:, None, :]
        flags = boundary_truncated(score, top_score, M).astype(jnp.int32)
        if tc_mode:
            top_tc = jnp.take_along_axis(ctc, top_l, axis=1)
            top_tfs = jnp.where(
                top_docs[:, None, :] >= 0, (top_tc & 0xFF)[:, None, :], 0)
            flags = flags | (tc_saturated(top_tc, top_docs).astype(jnp.int32)
                             * FLAG_TF_SAT)
        else:
            top_tfs = jnp.where(
                top_docs[:, None, :] >= 0, _gather1d(postings_tf, top_pidx), 0)
        return top_docs, top_score, top_tfs, top_pidx, flags

    Tr = T - 1  # searched slots
    targets = jnp.broadcast_to(cdocs[:, None, :], (B, Tr, L))
    lo = _binary_search(postings_doc, targets,
                        starts[:, 1:, None], ends[:, 1:, None], n_bs_iters)
    hit = _gather1d(postings_doc, lo)
    found = (lo < ends[:, 1:, None]) & (hit == targets)  # (B, Tr, L)
    match = jnp.all(found, axis=1) & cvalid

    if tc_mode:
        hit_tc = _gather1d(tc, lo).astype(jnp.int32)
        partial = jnp.where(
            found, tc_score(hit_tc, idf32[:, 1:, None], avg32), 0.0)
        score = cscore + jnp.sum(partial, axis=1)
    else:
        partial = jnp.where(found, _gather1d(postings_score, lo), 0.0)
        score = cscore * use_score[:, 0:1] + jnp.sum(
            partial * use_score[:, 1:, None], axis=1)
    score = jnp.where(match, score, NEG_INF)

    top_score, top_l = two_level_top_m(score, M)
    top_docs = jnp.take_along_axis(cdocs, top_l, axis=1)
    top_docs = jnp.where(top_score > NEG_INF, top_docs, -1)
    pidx = jnp.concatenate([cpidx[:, None, :], lo], axis=1)  # (B, T, L)
    top_pidx = jnp.take_along_axis(pidx, top_l[:, None, :].repeat(T, 1), axis=2)
    flags = boundary_truncated(score, top_score, M).astype(jnp.int32)
    if tc_mode:
        top_tc = _gather1d(tc, top_pidx).astype(jnp.int32)  # (B, T, M)
        top_tfs = jnp.where(top_docs[:, None, :] >= 0, top_tc & 0xFF, 0)
        flags = flags | (tc_saturated(top_tc, top_docs).astype(jnp.int32)
                         * FLAG_TF_SAT)
    else:
        top_tfs = jnp.where(
            top_docs[:, None, :] >= 0, _gather1d(postings_tf, top_pidx), 0)
    return top_docs, top_score, top_tfs, top_pidx, flags


def two_level_top_m(score_flat, M: int):
    """Exact top-M lane selection over (B, NBLK*128) f32 lanes via
    per-128-block maxima: top_k(block maxima, M+1) -> row-gather the
    selected blocks -> top_k over (M+1)*128 lanes. Returns (top_score,
    top_lane) with top_lane indexing score_flat — a drop-in for the
    flat lax.top_k(score, M) whose cost scales with the full lane count
    (for M ~ 16 the gathered surface is 544x smaller than a 1M-doc
    plane).

    Exactness (same doctrine as _full_phrase_body's two-level top-KV):
    let s_M be the flat M-th best value. Lanes > s_M number <= M-1, so
    blocks whose max > s_M number <= M-1 and all rank above any tie
    block — selected regardless of the backend top_k's tie order.
    Blocks with max ==
    s_M: if the boundary class fits in M lanes overall, such blocks
    number <= M < M+1 and are all selected; if it does not, the
    count-based boundary_truncated flag (computed by callers over the
    FULL plane) fires exactly as it does for the flat selection —
    identical flag semantics, no new parity surface. Selected block ids
    are re-emitted ascending (ids < 2^24 exact in f32), so gathered
    lane order == doc order and the final top_k sees lanes in the same
    relative order as the flat selection."""
    B, NL = score_flat.shape
    NBLK = NL // 128
    if NBLK < M + 1 or NL % 128:
        return jax.lax.top_k(score_flat, M)
    s3 = score_flat.reshape(B, NBLK, 128)
    bm = jnp.max(s3, axis=2)
    _, blk = jax.lax.top_k(bm, M + 1)
    nbs, _ = jax.lax.top_k(-blk.astype(jnp.float32), M + 1)
    blk = (-nbs).astype(jnp.int32)
    rows3 = jnp.take_along_axis(s3, blk[:, :, None], axis=1)
    flat = rows3.reshape(B, (M + 1) * 128)
    top_score, fl = jax.lax.top_k(flat, M)
    top_lane = (jnp.take_along_axis(blk, fl // 128, axis=1) * 128
                + fl % 128)
    return top_score, top_lane


def pack_with_flags(top_docs, top_tfs, flags_int32):
    """(B, T+2, M) int32: row 0 docs, rows 1..T per-slot tfs, row T+1 =
    per-query flag word (bit 0 = boundary-class truncation, bit 1 =
    window overflow) — one fetchable array per dispatch."""
    B, _, M = top_tfs.shape
    flag_row = jnp.broadcast_to(flags_int32[:, None, None], (B, 1, M))
    return jnp.concatenate([top_docs[:, None, :], top_tfs, flag_row], axis=1)


@lru_cache(maxsize=128)
def make_search_kernel(T: int, L: int, M: int, n_bs_iters: int,
                       mode: str = "raw"):
    """Jitted single-device wrapper over search_body.

    Returns ONE packed int32 (B, T+2, M) array — row 0 = top docs, rows
    1..T = per-slot tfs, row T+1 = flags — so the host pays a single
    device->host transfer per group. mode="tc" takes the compressed
    uint16 column + per-slot idf32 instead of the score/tf columns."""

    if mode == "tc":
        def kernel(postings_doc, postings_tc, avg32, starts, ends, idf32):
            top_docs, _, top_tfs, _, flags = search_body(
                postings_doc, None, None, starts, ends, None,
                T=T, L=L, M=M, n_bs_iters=n_bs_iters,
                tc=postings_tc, idf32=idf32, avg32=avg32)
            return pack_with_flags(top_docs, top_tfs, flags)
    else:
        def kernel(postings_doc, postings_score, postings_tf,
                   starts, ends, use_score):
            top_docs, _, top_tfs, _, flags = search_body(
                postings_doc, postings_score, postings_tf, starts, ends,
                use_score, T=T, L=L, M=M, n_bs_iters=n_bs_iters)
            return pack_with_flags(top_docs, top_tfs, flags)

    return jax.jit(kernel)


@lru_cache(maxsize=64)
def make_match_kernel_tc(T: int, L: int, n_bs_iters: int):
    """tc-mode variant of make_match_kernel: score reconstructed from the
    compressed column; returns an extra (B, L) int32 `sat_lane` mask so
    the select stage can flag saturated kept lanes."""

    def kernel(postings_doc, postings_tc, avg32, starts, ends, idf32,
               bloom_rows, bloom_bitmap, bloom_rank,
               probe_slot, probe_begins, probe_mask, probe_active):
        B = starts.shape[0]
        cdocs, ctc, cvalid, cs = _candidates(
            postings_doc, postings_tc, starts, ends, L)
        ctc = ctc.astype(jnp.int32)
        cscore = tc_score(ctc, idf32[:, 0:1], avg32)
        lane = jnp.arange(L, dtype=jnp.int32)
        cpidx = cs[:, None] + lane[None, :]

        Tr = T - 1
        targets = jnp.broadcast_to(cdocs[:, None, :], (B, Tr, L))
        lo = _binary_search(postings_doc, targets,
                            starts[:, 1:, None], ends[:, 1:, None], n_bs_iters)
        hit = _gather1d(postings_doc, lo)
        found = (lo < ends[:, 1:, None]) & (hit == targets)
        match = jnp.all(found, axis=1) & cvalid
        pidx = jnp.concatenate([cpidx[:, None, :], lo], axis=1)  # (B, T, L)

        hit_tc = _gather1d(postings_tc, lo).astype(jnp.int32)
        score = cscore + jnp.sum(
            jnp.where(found, tc_score(hit_tc, idf32[:, 1:, None], avg32), 0.0),
            axis=1)
        sat_lane = ((ctc & 0xFF) >= TF_SAT) | jnp.any(
            found & ((hit_tc & 0xFF) >= TF_SAT), axis=1)

        bloom_pass = _bloom_gate(pidx, bloom_rows, bloom_bitmap,
                                 bloom_rank, probe_slot, probe_begins,
                                 probe_mask, probe_active, B=B, L=L)
        return match, bloom_pass, cdocs, pidx, score, sat_lane

    return jax.jit(kernel)


def _bloom_gate(pidx, bloom_rows, bloom_bitmap, bloom_rank, probe_slot,
                probe_begins, probe_mask, probe_active, *, B, L):
    """Chained bi-bloom probes over per-lane posting indices (the
    IsPossibleToPresent analog, query_processing.h:784-807) against the
    SPARSE folded bloom columns (the BloomBoxWriter presence-bitmap
    layout, flash_containers.h:532-561):

      bloom_bitmap: (2*P/32,) uint32 — presence bits, ends half then
                    begins half; bit set = a filter row is stored
      bloom_rank:   (2*P/32,) int32 — stored rows before each 32-group
      bloom_rows:   (NNZ,) uint32 — single-word folded filter rows
      probe_mask:   (B, C) uint32 — folded probe masks (bloom.py
                    probe_mask_folded); pass iff (row & m) == m

    An absent row is BLM_NOT_PRESENT — prune (flash_iterators.h:1045-49);
    the host disables probes (probe_active=False) for slots whose rows
    were deliberately not stored (df ceiling), so absence here always
    means an empty filter. 3 element gathers per (probe, lane) vs the
    2-side dense layout's 6, and ~24x fewer filter bytes in HBM.
    Returns (B, L) pass flags; a failing lane has no phrase match."""
    Pw = bloom_bitmap.shape[0] // 2  # bitmap words per side
    slot_pidx = jnp.take_along_axis(pidx, probe_slot[:, :, None], axis=1)
    sp = slot_pidx + jnp.where(probe_begins[:, :, None],
                               np.int32(Pw) * 32, 0)  # (B, C, L)
    w_idx = sp >> 5
    word = _gather1d(bloom_bitmap, w_idx)  # (B, C, L) uint32
    bit = (sp & 31).astype(jnp.uint32)
    present = ((word >> bit) & 1).astype(bool)
    below = word & ((jnp.uint32(1) << bit) - 1)
    rank = (_gather1d(bloom_rank, w_idx)
            + jax.lax.population_count(below).astype(jnp.int32))
    row = _gather1d(bloom_rows, rank)
    m = probe_mask[:, :, None]
    probe_pass = present & ((row & m) == m)  # (B, C, L)
    probe_pass = probe_pass | ~probe_active[:, :, None]
    return jnp.all(probe_pass, axis=1)  # (B, L)


@lru_cache(maxsize=64)
def make_select_topk_kernel_tc(T: int, L: int, M: int):
    """tc-mode variant of make_select_topk_kernel: tfs come from a tc
    gather at the winning posting indices; kept saturated lanes raise
    FLAG_TF_SAT."""

    def kernel(postings_tc, cdocs, pidx, score, match, sat_lane):
        score = jnp.where(match, score, NEG_INF)
        top_score, top_l = two_level_top_m(score, M)
        top_docs = jnp.take_along_axis(cdocs, top_l, axis=1)
        top_docs = jnp.where(top_score > NEG_INF, top_docs, -1)
        top_pidx = jnp.take_along_axis(pidx, top_l[:, None, :].repeat(T, 1), axis=2)
        top_tc = _gather1d(postings_tc, top_pidx).astype(jnp.int32)
        top_tfs = jnp.where(top_docs[:, None, :] >= 0, top_tc & 0xFF, 0)
        top_sat = jnp.take_along_axis(sat_lane, top_l, axis=1)
        sat = jnp.any(top_sat & (top_docs >= 0), axis=1)
        flags = (boundary_truncated(score, top_score, M).astype(jnp.int32)
                 | sat.astype(jnp.int32) * FLAG_TF_SAT)
        return pack_with_flags(top_docs, top_tfs, flags)

    return jax.jit(kernel)


@lru_cache(maxsize=64)
def make_match_kernel(T: int, L: int, n_bs_iters: int):
    """Intersection-only kernel (phase 1 of phrase execution, and the
    bloom pre-check site): returns per-lane match flags, posting indices,
    and bloom-gate pass flags. T >= 2; slot 0 = candidate.

    Bloom probes (the IsPossibleToPresent analog, query_processing.h:
    784-807): per query, up to T-1 chained probes; probe c tests filter
    row `bloom[probe_slot_c's posting]` for precomputed word/mask pairs.
    The host encodes the cost-aware side choice into
    (probe_slot, probe_begins, probe_mask, probe_active).
    """

    def kernel(postings_doc, postings_score, starts, ends, use_score,
               bloom_rows, bloom_bitmap, bloom_rank,
               probe_slot, probe_begins, probe_mask, probe_active):
        B = starts.shape[0]
        cdocs, cscore, cvalid, cs = _candidates(
            postings_doc, postings_score, starts, ends, L)
        lane = jnp.arange(L, dtype=jnp.int32)
        cpidx = cs[:, None] + lane[None, :]

        Tr = T - 1
        targets = jnp.broadcast_to(cdocs[:, None, :], (B, Tr, L))
        lo = _binary_search(postings_doc, targets,
                            starts[:, 1:, None], ends[:, 1:, None], n_bs_iters)
        hit = _gather1d(postings_doc, lo)
        found = (lo < ends[:, 1:, None]) & (hit == targets)
        match = jnp.all(found, axis=1) & cvalid
        pidx = jnp.concatenate([cpidx[:, None, :], lo], axis=1)  # (B, T, L)

        partial = jnp.where(found, _gather1d(postings_score, lo), 0.0)
        score = cscore * use_score[:, 0:1] + jnp.sum(
            partial * use_score[:, 1:, None], axis=1)

        bloom_pass = _bloom_gate(pidx, bloom_rows, bloom_bitmap,
                                 bloom_rank, probe_slot, probe_begins,
                                 probe_mask, probe_active, B=B, L=L)
        return match, bloom_pass, cdocs, pidx, score

    return jax.jit(kernel)


@lru_cache(maxsize=64)
def make_phrase_verify_kernel(T: int, L: int, PP: int, n_pos_iters: int):
    """Phrase position verification over matched lanes.

    The adjusted-position rule (PhraseQueryProcessor2,
    query_processing.h:266-362): a phrase occurs at base position x iff
    term i appears at x + i for all i. Base positions come from slot 0's
    posting bag; membership of x+i in slot i's bag is a vectorized binary
    search over the global positions column (second-level CSR, the
    "posting bag" of flash_iterators.h:558-664).

    NOTE: here slots are in QUERY-TERM order, not candidate-first order
    (phrase adjacency depends on term order); the host passes pidx
    re-permuted accordingly.

    fn(positions, pos_starts_i32, pidx (B,T,L), active (B,L)) ->
      n_matches (B, L) int32
    """

    def kernel(positions, pos_starts, pidx, active):
        B = pidx.shape[0]
        ps = _gather1d(pos_starts, pidx.reshape(B, -1)).reshape(B, T, L)
        pe = _gather1d(pos_starts, pidx.reshape(B, -1) + 1).reshape(B, T, L)

        # position-lane tensors are (B, PP, L): L in the minor (128-lane)
        # dim — a (B, L, PP) layout pads PP up to the 128-lane tile and
        # blew memory 16x at PP=8 (observed OOM on the 1M corpus)
        lane = jnp.arange(PP, dtype=jnp.int32)
        base_idx = ps[:, 0, None, :] + lane[None, :, None]  # (B, PP, L)
        base_valid = base_idx < pe[:, 0, None, :]
        base_pos = jnp.where(base_valid, _pos_gather(positions, base_idx), INT32_MAX - T)

        ok = base_valid
        for t in range(1, T):
            tgt = base_pos + t
            lo = _binary_search(
                positions, tgt, ps[:, t, None, :], pe[:, t, None, :], n_pos_iters
            )
            hit = _pos_gather(positions, lo)
            ok = ok & (lo < pe[:, t, None, :]) & (hit == tgt)

        n_matches = jnp.sum(ok & active[:, None, :], axis=1).astype(jnp.int32)
        return n_matches

    return jax.jit(kernel)


def phrase_body(postings_doc, postings_score, postings_tf, positions,
                pos_starts, starts, ends, use_score, slot_of,
                *, T, L, PP, M, n_bs_iters, n_pos_iters,
                tc=None, idf32=None, avg32=None):
    """Self-contained phrase pipeline (intersect -> adjusted-position
    verify -> top-k), bloom-less — used by the sharded engine inside
    shard_map (per-shard bloom columns aren't materialized; the bloom
    gate is a pruning optimization and never changes results).

    slot_of: (B, T) query-term order -> kernel slot (slot 0 = candidate).
    Compressed-column mode: pass tc (uint16 column), idf32 ((B, T) f32 in
    SLOT order, 0 on padded slots) and avg32 instead of
    postings_score/postings_tf (see tc_score); the flag row then also
    carries FLAG_TF_SAT for kept lanes whose tf byte saturated.
    Returns (packed (B, T+1, M) int32 [docs; slot tfs], top_score (B, M)).
    """
    B = starts.shape[0]
    tc_mode = tc is not None
    if tc_mode:
        cdocs, ctc, cvalid, cs = _candidates(
            postings_doc, tc, starts, ends, L)
        ctc = ctc.astype(jnp.int32)
        cscore = tc_score(ctc, idf32[:, 0:1], avg32)
    else:
        cdocs, cscore, cvalid, cs = _candidates(
            postings_doc, postings_score, starts, ends, L)
    lane = jnp.arange(L, dtype=jnp.int32)
    cpidx = cs[:, None] + lane[None, :]

    targets = jnp.broadcast_to(cdocs[:, None, :], (B, T - 1, L))
    lo = _binary_search(postings_doc, targets,
                        starts[:, 1:, None], ends[:, 1:, None], n_bs_iters)
    hit = _gather1d(postings_doc, lo)
    found = (lo < ends[:, 1:, None]) & (hit == targets)
    match = jnp.all(found, axis=1) & cvalid
    pidx = jnp.concatenate([cpidx[:, None, :], lo], axis=1)  # (B, T, L)
    if tc_mode:
        hit_tc = _gather1d(tc, lo).astype(jnp.int32)
        score = cscore + jnp.sum(
            jnp.where(found, tc_score(hit_tc, idf32[:, 1:, None], avg32),
                      0.0), axis=1)
        sat_lane = ((ctc & 0xFF) >= TF_SAT) | jnp.any(
            found & ((hit_tc & 0xFF) >= TF_SAT), axis=1)
    else:
        partial = jnp.where(found, _gather1d(postings_score, lo), 0.0)
        score = cscore * use_score[:, 0:1] + jnp.sum(
            partial * use_score[:, 1:, None], axis=1)

    # position verify in query-term order
    pidx_q = jnp.take_along_axis(
        pidx, slot_of[:, :, None].astype(jnp.int32).repeat(L, 2), axis=1)
    ps = _gather1d(pos_starts, pidx_q.reshape(B, -1)).reshape(B, T, L)
    pe = _gather1d(pos_starts, pidx_q.reshape(B, -1) + 1).reshape(B, T, L)
    # (B, PP, L): keep L minor — see make_phrase_verify_kernel layout note
    plane = jnp.arange(PP, dtype=jnp.int32)
    base_idx = ps[:, 0, None, :] + plane[None, :, None]
    base_valid = base_idx < pe[:, 0, None, :]
    base_pos = jnp.where(base_valid, _pos_gather(positions, base_idx),
                         INT32_MAX - T)
    ok = base_valid
    for t in range(1, T):
        tgt = base_pos + t
        plo = _binary_search(positions, tgt, ps[:, t, None, :],
                             pe[:, t, None, :], n_pos_iters)
        phit = _pos_gather(positions, plo)
        ok = ok & (plo < pe[:, t, None, :]) & (phit == tgt)
    n_matches = jnp.sum(ok & match[:, None, :], axis=1)

    final = match & (n_matches > 0)
    score = jnp.where(final, score, NEG_INF)
    top_score, top_l = two_level_top_m(score, M)
    top_docs = jnp.take_along_axis(cdocs, top_l, axis=1)
    top_docs = jnp.where(top_score > NEG_INF, top_docs, -1)
    top_pidx = jnp.take_along_axis(pidx, top_l[:, None, :].repeat(T, 1), axis=2)
    flags = boundary_truncated(score, top_score, M).astype(jnp.int32)
    if tc_mode:
        top_tc = _gather1d(tc, top_pidx).astype(jnp.int32)
        top_tfs = jnp.where(top_docs[:, None, :] >= 0, top_tc & 0xFF, 0)
        top_sat = jnp.take_along_axis(sat_lane, top_l, axis=1)
        flags = flags | (jnp.any(top_sat & (top_docs >= 0), axis=1)
                         .astype(jnp.int32) * FLAG_TF_SAT)
    else:
        top_tfs = jnp.where(
            top_docs[:, None, :] >= 0, _gather1d(postings_tf, top_pidx), 0)
    packed = pack_with_flags(top_docs, top_tfs, flags)
    return packed, top_score


@lru_cache(maxsize=64)
def make_phrase_kernel(T: int, L: int, PP: int, M: int, n_bs_iters: int,
                       n_pos_iters: int):
    """Jitted self-contained bloomless phrase pipeline (phrase_body) —
    used where per-batch scratch columns replace the resident index (the
    staged cold tier) and bloom columns aren't materialized."""

    def kernel(postings_doc, postings_score, postings_tf, positions,
               pos_starts, starts, ends, use_score, slot_of):
        packed, _ = phrase_body(
            postings_doc, postings_score, postings_tf, positions,
            pos_starts, starts, ends, use_score, slot_of,
            T=T, L=L, PP=PP, M=M,
            n_bs_iters=n_bs_iters, n_pos_iters=n_pos_iters)
        return packed

    return jax.jit(kernel)


@lru_cache(maxsize=64)
def make_select_topk_kernel(T: int, L: int, M: int):
    """Top-k over precomputed (score, match) lanes — phase 2 of phrase
    execution after position verification. Returns packed (B, T+1, M)
    int32 (docs; per-slot tfs) for a single host fetch."""

    def kernel(postings_tf, cdocs, pidx, score, match):
        score = jnp.where(match, score, NEG_INF)
        top_score, top_l = two_level_top_m(score, M)
        top_docs = jnp.take_along_axis(cdocs, top_l, axis=1)
        top_docs = jnp.where(top_score > NEG_INF, top_docs, -1)
        top_pidx = jnp.take_along_axis(pidx, top_l[:, None, :].repeat(T, 1), axis=2)
        top_tfs = jnp.where(
            top_docs[:, None, :] >= 0, _gather1d(postings_tf, top_pidx), 0)
        trunc = boundary_truncated(score, top_score, M)
        return pack_with_flags(top_docs, top_tfs, trunc.astype(jnp.int32))

    return jax.jit(kernel)


def n_iters_for(max_len: int) -> int:
    """Binary-search iteration count covering lists up to max_len."""
    return max(1, int(np.ceil(np.log2(max(2, int(max_len) + 1)))))


def compact_phrase_body(postings_doc, postings_score, postings_tf,
                        postings_tc, avg32, positions, pos_starts,
                        starts, ends, use_score, idf32, slot_of, ks,
                        bloom_rows, bloom_bitmap, bloom_rank,
                        probe_slot, probe_begins, probe_mask,
                        probe_active, *, T, L, KV, PP, PW, M,
                        n_bs_iters, eps3, tc_mode):
    """Module-level compact phrase pipeline (bloom gate -> KV score
    compaction -> window verify -> top-k) shared by the single-chip
    fused kernel (make_compact_phrase_kernel) and the sharded
    per-shard local step (shard.py make_sharded_compact_phrase_kernel
    -- round 4: the mesh phrase path gains the cost-aware bi-bloom
    gate, query_processing.h:796-807). Returns (packed (B, T+2, M),
    top_score (B, M))."""
    B = starts.shape[0]
    if tc_mode:
        cdocs, ctc, cvalid, cs = _candidates(
            postings_doc, postings_tc, starts, ends, L)
        ctc = ctc.astype(jnp.int32)
        cscore = tc_score(ctc, idf32[:, 0:1], avg32)
    else:
        cdocs, cscore, cvalid, cs = _candidates(
            postings_doc, postings_score, starts, ends, L)
    lane = jnp.arange(L, dtype=jnp.int32)
    cpidx = cs[:, None] + lane[None, :]

    Tr = T - 1
    targets = jnp.broadcast_to(cdocs[:, None, :], (B, Tr, L))
    lo = _binary_search(postings_doc, targets, starts[:, 1:, None],
                        ends[:, 1:, None], n_bs_iters)
    hit = _gather1d(postings_doc, lo)
    found = (lo < ends[:, 1:, None]) & (hit == targets)
    match = jnp.all(found, axis=1) & cvalid
    pidx = jnp.concatenate([cpidx[:, None, :], lo], axis=1)  # (B,T,L)
    if tc_mode:
        hit_tc = _gather1d(postings_tc, lo).astype(jnp.int32)
        score = cscore + jnp.sum(
            jnp.where(found,
                      tc_score(hit_tc, idf32[:, 1:, None], avg32), 0.0),
            axis=1)
        sat_lane = ((ctc & 0xFF) >= TF_SAT) | jnp.any(
            found & ((hit_tc & 0xFF) >= TF_SAT), axis=1)
    else:
        partial = jnp.where(found, _gather1d(postings_score, lo), 0.0)
        score = cscore * use_score[:, 0:1] + jnp.sum(
            partial * use_score[:, 1:, None], axis=1)
        sat_lane = None
    bloom_pass = _bloom_gate(pidx, bloom_rows, bloom_bitmap,
                             bloom_rank, probe_slot, probe_begins,
                             probe_mask, probe_active, B=B, L=L)

    # compaction: KV best-scored surviving lanes
    active = match & bloom_pass
    mscore = jnp.where(active, score, NEG_INF)
    top_cs, top_cl = jax.lax.top_k(mscore, KV + 1)
    unseen = top_cs[:, KV]  # bounds every unverified lane
    sel_score = top_cs[:, :KV]  # score desc, doc asc on ties
    sel_l = top_cl[:, :KV]
    sel_docs = jnp.take_along_axis(cdocs, sel_l, axis=1)
    sel_pidx = jnp.take_along_axis(
        pidx, sel_l[:, None, :].repeat(T, 1), axis=2)  # (B, T, KV)
    sel_valid = sel_score > NEG_INF

    # adjusted-position window verify in query-term order over KV
    # lanes, anchored on query term 0 (slot_of re-permutes pidx)
    pidx_q = jnp.take_along_axis(
        sel_pidx, slot_of[:, :, None].astype(jnp.int32).repeat(KV, 2),
        axis=1)
    ps = _gather1d(pos_starts, pidx_q.reshape(B, -1)).reshape(B, T, KV)
    pe = _gather1d(pos_starts,
                   pidx_q.reshape(B, -1) + 1).reshape(B, T, KV)
    n_matches = _verify_pos_windows(
        positions, ps, pe, jnp.zeros((B,), dtype=jnp.int32),
        T=T, NL=KV, PP=PP, PW=PW)

    final_score = jnp.where(sel_valid & (n_matches > 0), sel_score,
                            NEG_INF)
    top_score, top_l = jax.lax.top_k(final_score, M)
    top_docs = jnp.take_along_axis(sel_docs, top_l, axis=1)
    top_docs = jnp.where(top_score > NEG_INF, top_docs, -1)
    top_pidx = jnp.take_along_axis(
        sel_pidx, top_l[:, None, :].repeat(T, 1), axis=2)
    flags = (boundary_truncated(final_score, top_score, M)
             .astype(jnp.int32)
             | prune_guard_flag(top_score, unseen, ks, M=M, eps3=eps3))
    if tc_mode:
        top_tc = _gather1d(postings_tc, top_pidx).astype(jnp.int32)
        top_tfs = jnp.where(top_docs[:, None, :] >= 0, top_tc & 0xFF, 0)
        top_sat = jnp.take_along_axis(
            jnp.take_along_axis(sat_lane, sel_l, axis=1), top_l, axis=1)
        sat = jnp.any(top_sat & (top_docs >= 0), axis=1)
        flags = flags | sat.astype(jnp.int32) * FLAG_TF_SAT
    else:
        top_tfs = jnp.where(top_docs[:, None, :] >= 0,
                            _gather1d(postings_tf, top_pidx), 0)
    return pack_with_flags(top_docs, top_tfs, flags), top_score


@lru_cache(maxsize=64)
def make_compact_phrase_kernel(T: int, L: int, KV: int, PP: int, PW: int,
                               M: int, n_bs_iters: int,
                               eps3: float, mode: str = "raw"):
    """Fused list-path phrase pipeline with score compaction — ONE
    dispatch replacing the match -> verify -> select chain, and the
    (B, PP, L) position-verify tensors shrink to (B, PP, KV): only the
    KV best-scored bloom-surviving AND matches are position-verified,
    so the element gathers of the verify scale with KV, not L.

    Exactness: bloom-failing lanes are proven non-matches (bi-bloom
    may-contain semantics) and need no bound; the (KV+1)-th surviving
    score bounds every unverified lane, so FLAG_PRUNE_MISS fires when it
    could reach the per-query k-th kept phrase score (same proof as the
    pruned dense guard). top_k's index-ascending tie order keeps the
    compacted lanes (score desc, doc asc) — the tie canon survives.

    raw: fn(postings_doc, postings_score, postings_tf, positions,
            pos_starts, starts, ends, use_score, slot_of, ks,
            bloom_ends, bloom_begins, *probes) -> packed (B, T+2, M).
    tc:  postings_tc+avg32+idf32 replace score/tf/use_score columns.
    Verify is anchored on QUERY term 0 (slot_of re-permutes pidx), like
    make_phrase_verify_kernel."""
    tc_mode = mode == "tc"

    def body(*a):
        packed, _ = compact_phrase_body(
            *a, T=T, L=L, KV=KV, PP=PP, PW=PW, M=M,
            n_bs_iters=n_bs_iters, eps3=eps3, tc_mode=tc_mode)
        return packed

    if tc_mode:
        def kernel(postings_doc, postings_tc, avg32, positions, pos_starts,
                   starts, ends, idf32, slot_of, ks, bloom_rows,
                   bloom_bitmap, bloom_rank, probe_slot, probe_begins,
                   probe_mask, probe_active):
            return body(postings_doc, None, None, postings_tc, avg32,
                        positions, pos_starts, starts, ends, None, idf32,
                        slot_of, ks, bloom_rows, bloom_bitmap, bloom_rank,
                        probe_slot, probe_begins, probe_mask, probe_active)
    else:
        def kernel(postings_doc, postings_score, postings_tf, positions,
                   pos_starts, starts, ends, use_score, slot_of, ks,
                   bloom_rows, bloom_bitmap, bloom_rank, probe_slot,
                   probe_begins, probe_mask, probe_active):
            return body(postings_doc, postings_score, postings_tf, None,
                        None, positions, pos_starts, starts, ends,
                        use_score, None, slot_of, ks, bloom_rows,
                        bloom_bitmap, bloom_rank, probe_slot, probe_begins,
                        probe_mask, probe_active)

    return jax.jit(kernel)


@lru_cache(maxsize=32)
def make_semidense_phrase_kernel(T: int, L: int, KV: int, PP: int, PW: int,
                                 M: int, N_pad: int, n_rec_iters: int,
                                 eps3: float, mode: str = "raw"):
    """List-path phrase pipeline whose MATCH stage is semidense: every
    non-candidate term is a dense-tier head, so membership+score per
    candidate lane is ONE doc-indexed gather from the (H, N_pad) dense
    plane instead of log2(df) binary-search probes — and, following the
    pruned dense phrase scan (_pruned_phrase_body), the candidate lanes
    COMPACT to the KV best AND scores BEFORE any element-gather stage:
    posting-index recovery (binary search, KV lanes only) and the window
    position verify. The L-wide bloom gate of make_compact_phrase_kernel
    disappears with the L-wide stages it guarded; exactness never needed
    it (bloom passes are only ever a pruning hint — the position verify
    is the ground truth, flash_iterators.h:994-1058).

    Exactness: the (KV+1)-th AND-match score bounds every unverified
    lane (a superset of the bloom-surviving bound the compact kernel
    uses — same guard, weaker bound, identical proof shape), so
    FLAG_PRUNE_MISS fires whenever it could reach the per-query k-th
    kept phrase score. top_k's index-ascending tie order keeps the
    compacted lanes (score desc, doc asc) — the tie canon survives.

    raw: fn(postings_doc, postings_score, postings_tf, dense_sc,
            positions, pos_starts, starts, ends, use_score,
            slots, slot_of, ks) -> packed (B, T+2, M); tfs for every
            slot come from postings_tf at the recovered pidx.
    tc:  fn(postings_doc, postings_tc, avg32, dense_tf (uint8 tf plane;
            len codes recomposed from the candidate's tc lanes), positions,
            pos_starts, starts, ends, idf32, slots, slot_of, ks).
    slots: (B, T) dense rows for slots 1.. (slot 0 = candidate term,
    unused); verify is anchored on QUERY term 0 (slot_of re-permutes)."""
    tc_mode = mode == "tc"

    def body(postings_doc, postings_score, postings_tf, postings_tc,
             avg32, dense_a, positions, pos_starts, starts,
             ends, use_score, idf32, slots, slot_of, ks):
        B = starts.shape[0]
        if tc_mode:
            cdocs, ctc, cvalid, cs = _candidates(
                postings_doc, postings_tc, starts, ends, L)
            ctc = ctc.astype(jnp.int32)
            cscore = tc_score(ctc, idf32[:, 0:1], avg32)
        else:
            cdocs, cscore, cvalid, cs = _candidates(
                postings_doc, postings_score, starts, ends, L)
        lane = jnp.arange(L, dtype=jnp.int32)
        cpidx = cs[:, None] + lane[None, :]

        doc_idx = jnp.clip(cdocs, 0, np.int32(N_pad - 1))
        match = cvalid
        score = cscore if tc_mode else cscore * use_score[:, 0:1]
        if tc_mode:  # lane doc's len code from the candidate's tc value
            ccode = ctc & 0xFF00
        payloads = []
        for t in range(1, T):
            if tc_mode:
                # dense_a is the uint8 tf plane; recompose the tc lane
                # (bit-identical to the former uint16 dense_tc lane)
                p_tf = _dense_gather(dense_a, slots[:, t : t + 1],
                                     doc_idx).astype(jnp.int32)
                p = jnp.where(p_tf > 0, ccode | p_tf, 0)  # (B, L) tc
                payloads.append(p)
                match = match & (p > 0)
                score = score + tc_score(p, idf32[:, t : t + 1], avg32)
            else:
                p = _dense_gather(dense_a, slots[:, t : t + 1],
                                  doc_idx)  # (B, L) score f32
                payloads.append(p)
                match = match & (p > 0)
                score = score + p * use_score[:, t : t + 1]
        mscore = jnp.where(match, score, NEG_INF)

        # compaction: KV best-scored AND matches (score desc, doc asc)
        top_cs, top_cl = jax.lax.top_k(mscore, KV + 1)
        unseen = top_cs[:, KV]  # bounds every unverified lane
        sel_score = top_cs[:, :KV]
        sel_l = top_cl[:, :KV]
        sel_docs = jnp.take_along_axis(cdocs, sel_l, axis=1)
        sel_valid = sel_score > NEG_INF

        # per-term posting-index recovery over KV lanes only: matched
        # docs are guaranteed present in every term's CSR run (the dense
        # rows are built from those runs), so lower_bound IS the posting
        # index; invalid lanes yield in-range garbage masked below
        sel_cpidx = cs[:, None] + sel_l  # (B, KV)
        targets = jnp.broadcast_to(sel_docs[:, None, :], (B, T - 1, KV))
        lo = _binary_search(postings_doc, targets, starts[:, 1:, None],
                            ends[:, 1:, None], n_rec_iters)
        sel_pidx = jnp.concatenate([sel_cpidx[:, None, :], lo], axis=1)

        # adjusted-position window verify in query-term order, anchored
        # on query term 0 (slot_of re-permutes pidx)
        pidx_q = jnp.take_along_axis(
            sel_pidx, slot_of[:, :, None].astype(jnp.int32).repeat(KV, 2),
            axis=1)
        ps = _gather1d(pos_starts, pidx_q.reshape(B, -1)).reshape(B, T, KV)
        pe = _gather1d(pos_starts,
                       pidx_q.reshape(B, -1) + 1).reshape(B, T, KV)
        n_matches = _verify_pos_windows(
            positions, ps, pe, jnp.zeros((B,), dtype=jnp.int32),
            T=T, NL=KV, PP=PP, PW=PW)

        final_score = jnp.where(sel_valid & (n_matches > 0), sel_score,
                                NEG_INF)
        top_score, top_l = jax.lax.top_k(final_score, M)
        top_docs = jnp.take_along_axis(sel_docs, top_l, axis=1)
        top_docs = jnp.where(top_score > NEG_INF, top_docs, -1)
        flags = (boundary_truncated(final_score, top_score, M)
                 .astype(jnp.int32)
                 | prune_guard_flag(top_score, unseen, ks, M=M, eps3=eps3))
        if tc_mode:
            top_ctc = jnp.take_along_axis(
                jnp.take_along_axis(ctc, sel_l, axis=1), top_l, axis=1)
            tfs = [jnp.where(top_docs >= 0, top_ctc & 0xFF, 0)]
            sat = tc_saturated(top_ctc, top_docs)
            for t in range(1, T):
                p_i = jnp.take_along_axis(
                    jnp.take_along_axis(payloads[t - 1], sel_l, axis=1),
                    top_l, axis=1).astype(jnp.int32)
                tfs.append(jnp.where(top_docs >= 0, p_i & 0xFF, 0))
                sat = sat | tc_saturated(p_i, top_docs)
            flags = flags | sat.astype(jnp.int32) * FLAG_TF_SAT
        else:
            top_pidx = jnp.take_along_axis(
                sel_pidx, top_l[:, None, :].repeat(T, 1), axis=2)
            top_tfs = jnp.where(top_docs[:, None, :] >= 0,
                                _gather1d(postings_tf, top_pidx), 0)
            return pack_with_flags(top_docs, top_tfs, flags)
        return pack_with_flags(
            top_docs, jnp.stack(tfs, axis=1), flags)

    if tc_mode:
        def kernel(postings_doc, postings_tc, avg32, dense_tf, positions,
                   pos_starts, starts, ends, idf32, slots, slot_of, ks):
            return body(postings_doc, None, None, postings_tc, avg32,
                        dense_tf, positions, pos_starts, starts,
                        ends, None, idf32, slots, slot_of, ks)
    else:
        def kernel(postings_doc, postings_score, postings_tf, dense_sc,
                   positions, pos_starts, starts, ends,
                   use_score, slots, slot_of, ks):
            return body(postings_doc, postings_score, postings_tf, None,
                        None, dense_sc, positions, pos_starts,
                        starts, ends, use_score, None, slots, slot_of, ks)

    return jax.jit(kernel)


@lru_cache(maxsize=32)
def make_semidense_kernel_tc(T: int, L: int, M: int, N_pad: int,
                             n_bs: int = 0, n_bs_iters: int = 0):
    """tc-mode variant of make_semidense_kernel: dense head rows are a
    (H, N_pad) uint8 TF plane — 8x the head-term capacity per byte of
    HBM budget. The doc's len code is NOT stored per head row (it is a
    doc property, identical across rows): each candidate lane's own tc
    value carries it, so the full tc lane is recomposed in-kernel as
    (ctc & 0xFF00) | tf, masked to 0 where tf == 0 — bit-identical to
    the former uint16 dense_tc lane at an eighth of the raw bytes and
    the SAME single element gather per (lane, dense other). Scores
    reconstructed via tc_score. Slots 1..n_bs are non-dense others
    resolved by small-span binary search (see the raw variant's note)."""

    def kernel(postings_doc, postings_tc, avg32, dense_tf,
               starts, ends, idf32, slots):
        B = starts.shape[0]
        cdocs, ctc, cvalid, cs = _candidates(
            postings_doc, postings_tc, starts, ends, L)
        ctc = ctc.astype(jnp.int32)
        cscore = tc_score(ctc, idf32[:, 0:1], avg32)
        lane = jnp.arange(L, dtype=jnp.int32)
        cpidx = cs[:, None] + lane[None, :]
        ccode = ctc & 0xFF00  # the lane doc's len code, pre-shifted
        doc_idx = jnp.clip(cdocs, 0, np.int32(N_pad - 1))
        match = cvalid
        score = cscore
        lanes_tc = []
        if n_bs:
            targets = jnp.broadcast_to(cdocs[:, None, :], (B, n_bs, L))
            lo = _binary_search(postings_doc, targets,
                                starts[:, 1 : 1 + n_bs, None],
                                ends[:, 1 : 1 + n_bs, None], n_bs_iters)
            hit = _gather1d(postings_doc, lo)
            found = (lo < ends[:, 1 : 1 + n_bs, None]) & (hit == targets)
            match = match & jnp.all(found, axis=1)
            hit_tc = _gather1d(postings_tc, lo).astype(jnp.int32)
            score = score + jnp.sum(
                jnp.where(found,
                          tc_score(hit_tc, idf32[:, 1 : 1 + n_bs, None],
                                   avg32), 0.0), axis=1)
        for t in range(1 + n_bs, T):
            p_tf = _dense_gather(dense_tf, slots[:, t : t + 1],
                                 doc_idx).astype(jnp.int32)  # (B, L)
            p_tc = jnp.where(p_tf > 0, ccode | p_tf, 0)
            lanes_tc.append(p_tc)
            match = match & (p_tc > 0)
            score = score + tc_score(p_tc, idf32[:, t : t + 1], avg32)
        score = jnp.where(match, score, NEG_INF)
        top_score, top_l = two_level_top_m(score, M)
        top_docs = jnp.take_along_axis(cdocs, top_l, axis=1)
        top_docs = jnp.where(top_score > NEG_INF, top_docs, -1)
        top_ctc = jnp.take_along_axis(ctc, top_l, axis=1)
        sat = tc_saturated(top_ctc, top_docs)
        tfs = [jnp.where(top_docs >= 0, top_ctc & 0xFF, 0)[:, None, :]]
        for t in range(1, 1 + n_bs):
            top_lo = jnp.take_along_axis(lo[:, t - 1, :], top_l, axis=1)
            top_t = _gather1d(postings_tc, top_lo).astype(jnp.int32)
            sat = sat | tc_saturated(top_t, top_docs)
            tfs.append(jnp.where(top_docs >= 0, top_t & 0xFF, 0)[:, None, :])
        for t in range(1 + n_bs, T):
            top_t = jnp.take_along_axis(lanes_tc[t - 1 - n_bs], top_l,
                                        axis=1)
            sat = sat | tc_saturated(top_t, top_docs)
            tfs.append(jnp.where(top_docs >= 0, top_t & 0xFF, 0)[:, None, :])
        flags = (boundary_truncated(score, top_score, M).astype(jnp.int32)
                 | sat.astype(jnp.int32) * FLAG_TF_SAT)
        return pack_with_flags(top_docs, jnp.concatenate(tfs, axis=1), flags)

    return jax.jit(kernel)


@lru_cache(maxsize=32)
def make_dense_search_kernel_tc(T: int, N_pad: int, M: int):
    """tc-mode variant of make_dense_search_kernel over (H, N_pad) uint8
    TF rows + one shared (N_pad,) uint8 len-code row (the len code is a
    doc property — storing it once instead of per head row halves the
    dense tier, the direct storage-economy analog of the reference's
    per-doc 1-byte length store, doc_length_store.h:102). The composed
    lane (code<<8 | tf, 0 where absent) is bit-identical to the former
    uint16 dense_tc lane; scores reconstructed via tc_score, padded
    slots idf 0."""

    def kernel(dense_tf, len_code, avg32, slots, idf32):
        B = slots.shape[0]
        code_row = len_code.astype(jnp.int32)[None, :] << 8  # (1, N_pad)
        score = jnp.zeros((B, N_pad), dtype=jnp.float32)
        match = jnp.ones((B, N_pad), dtype=bool)
        rows = []
        for t in range(T):
            tf_t = jnp.take(dense_tf, slots[:, t], axis=0).astype(jnp.int32)
            tc_t = jnp.where(tf_t > 0, code_row | tf_t, 0)
            rows.append(tc_t)
            match = match & (tc_t > 0)
            score = score + tc_score(tc_t, idf32[:, t : t + 1], avg32)
        score = jnp.where(match, score, NEG_INF)
        top_score, top_docs = two_level_top_m(score, M)  # lane = doc id
        top_docs = jnp.where(top_score > NEG_INF, top_docs, -1)
        sat = jnp.zeros((B,), dtype=bool)
        tfs = []
        for t in range(T):
            top_t = jnp.take_along_axis(
                rows[t], jnp.maximum(top_docs, 0), axis=1)
            sat = sat | tc_saturated(top_t, top_docs)
            tfs.append(jnp.where(top_docs >= 0, top_t & 0xFF, 0))
        flags = (boundary_truncated(score, top_score, M).astype(jnp.int32)
                 | sat.astype(jnp.int32) * FLAG_TF_SAT)
        return pack_with_flags(
            top_docs, jnp.concatenate([x[:, None, :] for x in tfs], axis=1),
            flags)

    return jax.jit(kernel)


@lru_cache(maxsize=32)
def make_semidense_kernel(T: int, L: int, M: int, N_pad: int,
                          n_bs: int = 0, n_bs_iters: int = 0):
    """Tail-candidate x head-others conjunctions: the candidate list
    loads contiguously as usual; every DENSE non-candidate slot is a
    head term with a (N_pad,) score row — membership+score per lane is
    ONE doc-indexed gather (ascending cdocs -> near-sequential access)
    instead of log2(df) binary-search probes. Slots 1..n_bs are
    NON-dense others resolved by binary search over their (small, <
    dense_min) CSR runs — short spans keep those gathers cache-local,
    unlike the full-column searches of the plain bs kernel. This
    replaces the
    bs kernel and the host merge for every multi-term query with at
    least one dense term.

    fn(postings_doc, postings_score, postings_tf, dense_sc (H, N_pad),
       dense_tf (H, N_pad), starts (B,T), ends (B,T), use_score (B,T),
       slots (B,T) dense rows for slots 1+n_bs.. ; slots 0..n_bs ignored)
      -> packed (B, T+2, M). Slot layout: 0 = candidate, 1..n_bs = bs
    others (CSR bounds in starts/ends), n_bs+1.. = dense others.
    """

    def kernel(postings_doc, postings_score, postings_tf, dense_sc,
               dense_tf, starts, ends, use_score, slots):
        B = starts.shape[0]
        cdocs, cscore, cvalid, cs = _candidates(
            postings_doc, postings_score, starts, ends, L)
        lane = jnp.arange(L, dtype=jnp.int32)
        cpidx = cs[:, None] + lane[None, :]
        # sentinel cdocs clip to lane N_pad-1; cvalid masks them out of
        # match regardless of what that lane holds
        doc_idx = jnp.clip(cdocs, 0, np.int32(N_pad - 1))
        match = cvalid
        score = cscore * use_score[:, 0:1]
        if n_bs:
            targets = jnp.broadcast_to(cdocs[:, None, :], (B, n_bs, L))
            lo = _binary_search(postings_doc, targets,
                                starts[:, 1 : 1 + n_bs, None],
                                ends[:, 1 : 1 + n_bs, None], n_bs_iters)
            hit = _gather1d(postings_doc, lo)
            found = (lo < ends[:, 1 : 1 + n_bs, None]) & (hit == targets)
            match = match & jnp.all(found, axis=1)
            partial = jnp.where(found, _gather1d(postings_score, lo), 0.0)
            score = score + jnp.sum(
                partial * use_score[:, 1 : 1 + n_bs, None], axis=1)
        for t in range(1 + n_bs, T):
            p = _dense_gather(dense_sc, slots[:, t : t + 1],
                              doc_idx)  # (B, L)
            match = match & (p > 0)
            score = score + p * use_score[:, t : t + 1]
        score = jnp.where(match, score, NEG_INF)
        top_score, top_l = two_level_top_m(score, M)
        top_docs = jnp.take_along_axis(cdocs, top_l, axis=1)
        top_docs = jnp.where(top_score > NEG_INF, top_docs, -1)
        top_cpidx = jnp.take_along_axis(cpidx, top_l, axis=1)
        cand_tf = jnp.where(top_docs >= 0, _gather1d(postings_tf, top_cpidx), 0)
        tfs = [cand_tf[:, None, :]]
        for t in range(1, 1 + n_bs):
            top_lo = jnp.take_along_axis(lo[:, t - 1, :], top_l, axis=1)
            tfs.append(jnp.where(top_docs >= 0,
                                 _gather1d(postings_tf, top_lo),
                                 0)[:, None, :])
        for t in range(1 + n_bs, T):
            p_tf = _dense_gather(dense_tf, slots[:, t : t + 1],
                                 jnp.maximum(top_docs, 0))
            tfs.append(jnp.where(top_docs >= 0, p_tf, 0)[:, None, :])
        trunc = boundary_truncated(score, top_score, M)
        return pack_with_flags(top_docs, jnp.concatenate(tfs, axis=1),
                               trunc.astype(jnp.int32))

    return jax.jit(kernel)


# ---------------------------------------------------------------------------
# Block-max pruned dense scan — the reference-scale fix for all-head
# conjunctions. The plain dense kernel (below) is df-independent but
# N-DEPENDENT: T·N lane-ops + top_k over N per query (~16 MB of HBM
# traffic per query at 1M docs). This variant is the block-max WAND idea
# (the literature's skip-list upper-bound pruning) mapped to dense device
# lanes with a PROVABLE device-side guard instead of data-dependent
# control flow:
#
#   1. ub_j = Σ_t blockmax_t[j]  — per-128-doc-block score upper bound,
#      from precomputed (H, N/128) per-term block maxima (row gathers);
#   2. take the C highest-ub blocks via one lax.top_k; re-emit their ids
#      in ASCENDING BLOCK ORDER via a second top_k over -id (ids < 2^24
#      are exact in f32; no lax.sort) — doc-ascending candidate order
#      preserves the tie canon for the final boundary class;
#   3. gather only those C·128 lanes, score + match exactly, one top_k
#      over C·128.
#
# Exactness: every lane's f32 score ≤ its block's ub — the engine builds
# blockmax so each addend dominates elementwise (raw: exact f32 column
# max, 0/1 weights; tc: f64 reconstruction × (1+1e-6) covers in-kernel
# rounding), and f32 add/rounding is monotone, so the accumulated ub
# dominates the accumulated score in the same summation order. Every
# unexamined block has ub ≤ next_ub (the (C+1)-th largest).
#
# The guard compares next_ub against the PER-QUERY k-th kept score (not
# the M-th): the final answer is the host f64 re-rank's top k, so an
# unexamined lane only matters if it could reach or tie the true f64
# k-th. Unflagged means next_ub < κ·(1−3·rel_eps) where κ is the k-th
# best f32 among examined lanes; then every unexamined lane L_u has
# f64(L_u) ≤ f32(L_u)(1+eps) ≤ next_ub(1+eps) < κ(1−eps) ≤ f64 of each
# of the k kept-by-f32 docs — at least k docs strictly beat L_u in f64,
# so L_u is outside the true top-k and cannot tie its boundary (strict).
# Within-examined selection correctness is the existing machinery's job
# (boundary_truncated + topk.truncation_suspects). FLAG_PRUNE_MISS is
# raised when the bound cannot prove this (incl. fewer than k matches
# found with nonzero unexamined ub); the engine re-runs flagged queries
# exactly (memoized host path). Ties at the selection cut need no flag:
# any C-subset of tied blocks is fine unless the tied ub itself clears
# the check. For head×head conjunctions (the mega case) matches are
# plentiful and the flag is rare (on the 1M-doc corpus, Zipf
# head pairs: 6.9% at C=512 / 12.7% at C=256, vs 17-22% for an M-based
# guard — and the memoized host path absorbs repeats); the win is
# ~N/(C·128) in both lane-ops and HBM traffic.
# ---------------------------------------------------------------------------


def _select_ub_blocks(blockmax, slots, weights, *, T, NB, C,
                      blockmax2=None, argpos=None):
    """Per-query block-max upper bounds and top-C block selection.

    Conjunction feasibility: a match needs EVERY live term present in
    the doc (the kernel bodies AND `p > 0` across terms), and a term is
    present somewhere in a 128-doc block iff its blockmax is > 0 (BM25
    scores are strictly positive; absent lanes are exactly 0 in both
    column modes). So a block missing any live term (weight > 0) cannot
    contain a match and its joint ub is 0 — not the sum of the terms it
    does have. This both spends the C-block budget on feasible blocks
    only and tightens next_ub, which is what the FLAG_PRUNE_MISS guard
    compares against: at 1M docs a 3-term Zipf conjunction's joint
    presence per block is ~0.3-0.5, so the unmasked sum-of-maxima was
    flagging 10-30%% of all-head queries to the host path.

    Second-order refinement (blockmax2 + argpos given): the plain
    sum-of-maxima ub assumes every term peaks at the SAME doc of the
    block, which for head pairs is almost never true — measured on the
    1M index, 67.5%% of random head pairs flagged at C=512 under sum-max
    vs 3.3%% under the (unknowable) true joint block max. The refinement
    uses each term's per-block 2nd-largest score (WITH multiplicity, so
    max ties keep bm2 == bm — tie-safety) and the argmax doc position:
    for any doc d, score(d) <= sum_t (bm_t if argpos_t == d else bm2_t),
    so ub = max over t* of sum_t (bm_t if argpos_t == argpos_t* else
    bm2_t) bounds every doc in the block (docs at no term's argmax are
    covered because each bound_t* >= sum_t bm2_t). Measured flag rate on
    head pairs: 67.5%% -> 13.3%%. Cost: T extra row gathers + a (T x T)
    argpos compare per block — trivial next to the payload scan.

    Returns (blk (B, C) int32 ascending block ids, next_ub (B,) f32 —
    the best unexamined block's ub)."""
    B = slots.shape[0]
    feas = jnp.ones((B, NB), dtype=bool)
    bms, bm2s, aps = [], [], []
    for t in range(T):
        bm = jnp.take(blockmax, slots[:, t], axis=0)
        w = weights[:, t : t + 1]
        bms.append(bm * w)
        feas = feas & ((bm > 0.0) | (w == 0.0))
        if blockmax2 is not None:
            bm2s.append(jnp.take(blockmax2, slots[:, t], axis=0) * w)
            aps.append(jnp.take(argpos, slots[:, t], axis=0)
                       .astype(jnp.int32))
    if blockmax2 is None:
        ub = bms[0]
        for t in range(1, T):
            ub = ub + bms[t]
    else:
        ub = jnp.full((B, NB), -jnp.inf, dtype=jnp.float32)
        for ts in range(T):
            bound = bms[ts]  # ap_ts == ap_ts: full max for the anchor
            for t in range(T):
                if t == ts:
                    continue
                bound = bound + jnp.where(aps[t] == aps[ts],
                                          bms[t], bm2s[t])
            ub = jnp.maximum(ub, bound)
    ub = jnp.where(feas, ub, 0.0)
    top_ub, top_idx = jax.lax.top_k(ub, C + 1)
    next_ub = top_ub[:, C]  # best unexamined block's ub
    # re-emit the selected ids in ascending block order (tie canon):
    # top_k over -id sorts descending by -id = ascending by id; block
    # ids < 2^24 are exact in f32
    neg_sorted, _ = jax.lax.top_k(-top_idx[:, :C].astype(jnp.float32), C)
    blk = (-neg_sorted).astype(jnp.int32)  # (B, C) ascending block ids
    return blk, next_ub


def _verify_pos_windows(positions, ps, pe, anchor, *, T, NL, PP, PW):
    """Adjusted-position phrase verification with NO element gathers:
    each (term, lane) position bag loads as ONE contiguous
    vmap(dynamic_slice) window instead of ~PP element gathers per lane,
    then matching is a dense (PP x PW) equality compare per lane.

    ps/pe: (B, T, NL) int32 position-bag bounds; anchor: (B,) int32 —
    base lanes come from the anchor term's window, y = pos - anchor,
    term i must hold y + i (the anchor's own check is trivially true).
    PP bounds the ANCHOR bag; PW bounds EVERY term's bag — both are
    group-keyed buckets >= the true per-term max_tf, so no position is
    missed (unlike the anchor-only PP of the gather-based verify, the
    caller must key PW on the max over ALL terms). positions must carry
    >= PW trailing pad entries of -1 (never equal to a target >= 0).

    Returns (B, NL) int32 phrase-occurrence counts."""
    B = ps.shape[0]
    win = jax.vmap(
        lambda s: jax.lax.dynamic_slice(positions, (s,), (PW,)))(
        ps.reshape(-1))
    win = win.reshape(B, T, NL, PW).astype(jnp.int32)
    j = jnp.arange(PW, dtype=jnp.int32)
    cnt = pe - ps
    valid = j[None, None, None, :] < cnt[:, :, :, None]  # (B, T, NL, PW)
    a4 = jnp.broadcast_to(anchor.astype(jnp.int32)[:, None, None, None],
                          (B, 1, NL, PW))
    win_a = jnp.take_along_axis(win, a4, axis=1)[:, 0]  # (B, NL, PW)
    valid_a = jnp.take_along_axis(valid, a4, axis=1)[:, 0]
    y = win_a[:, :, :PP] - anchor[:, None, None].astype(jnp.int32)
    ok = valid_a[:, :, :PP]  # (B, NL, PP)
    for t in range(T):
        tgt = y + t
        eq = (tgt[:, :, :, None] == win[:, t][:, :, None, :]) \
            & valid[:, t][:, :, None, :]
        ok = ok & jnp.any(eq, axis=3)
    return jnp.sum(ok, axis=2).astype(jnp.int32)


def prune_guard_flag(top_score, next_ub, ks, *, M, eps3):
    """FLAG_PRUNE_MISS word: κ = per-query k-th kept f32 score (NEG_INF
    when fewer than k matches -> any nonzero unexamined ub flags)."""
    k_idx = jnp.clip(ks.astype(jnp.int32) - 1, 0, M - 1)
    kth = jnp.take_along_axis(top_score, k_idx[:, None], axis=1)[:, 0]
    miss = (next_ub > 0) & (next_ub >= kth * np.float32(1.0 - eps3))
    return miss.astype(jnp.int32) * FLAG_PRUNE_MISS


def _pruned_dense_body(get_row_f32, get_tf, blockmax, slots, weights, ks,
                       *, T, NB, C, M, eps3, tc_mode, idf32=None,
                       avg32=None, blockmax2=None, argpos=None):
    """Shared body: get_row_f32(t, rows_idx) -> (B, C, 128) f32 payload
    lanes (score in raw mode, tc-as-int in tc mode); weights (B, T) f32
    multipliers for ub (use_score in raw, 1.0 presence in tc — the
    blockmax planes are already idf-scaled in both modes)."""
    B = slots.shape[0]
    blk, next_ub = _select_ub_blocks(blockmax, slots, weights,
                                     T=T, NB=NB, C=C,
                                     blockmax2=blockmax2, argpos=argpos)

    lane = jnp.arange(128, dtype=jnp.int32)
    cand_docs = (blk[:, :, None] * 128 + lane[None, None, :]).reshape(B, -1)
    match = jnp.ones((B, C, 128), dtype=bool)
    score = jnp.zeros((B, C, 128), dtype=jnp.float32)
    payloads = []
    for t in range(T):
        p = get_row_f32(t, blk)  # (B, C, 128)
        payloads.append(p)
        match = match & (p > 0)
        if tc_mode:
            score = score + tc_score(p.astype(jnp.int32),
                                     idf32[:, t, None, None], avg32)
        else:
            score = score + p * weights[:, t, None, None]
    score = jnp.where(match, score, NEG_INF).reshape(B, -1)
    top_score, top_l = two_level_top_m(score, M)
    top_docs = jnp.take_along_axis(cand_docs, top_l, axis=1)
    top_docs = jnp.where(top_score > NEG_INF, top_docs, -1)

    prune_flag = prune_guard_flag(top_score, next_ub, ks, M=M, eps3=eps3)

    sat = jnp.zeros((B,), dtype=jnp.int32)
    tfs = []
    for t in range(T):
        flat = payloads[t].reshape(B, -1)
        top_p = jnp.take_along_axis(flat, top_l, axis=1)
        if tc_mode:
            top_i = top_p.astype(jnp.int32)
            sat = sat | (tc_saturated(top_i, top_docs).astype(jnp.int32)
                         * FLAG_TF_SAT)
            tfs.append(jnp.where(top_docs >= 0, top_i & 0xFF, 0))
        else:
            tfs.append(jnp.where(top_docs >= 0, get_tf(t, top_l, blk), 0))
    flags = (boundary_truncated(score, top_score, M).astype(jnp.int32)
             | prune_flag | sat)
    return pack_with_flags(
        top_docs, jnp.concatenate([x[:, None, :] for x in tfs], axis=1),
        flags)


@lru_cache(maxsize=32)
def make_pruned_dense_kernel(T: int, NB: int, C: int, M: int, eps3: float):
    """Raw-column block-max pruned dense scan.

    fn(dense_sc (H, NB*128) f32, dense_tf (H, NB*128) i32,
       blockmax (H, NB) f32, slots (B, T) i32, use_score (B, T) f32,
       ks (B,) i32 per-query k) -> packed (B, T+2, M) i32."""

    def kernel(dense_sc, dense_tf, blockmax, blockmax2, argpos, slots,
               use_score, ks):
        H = dense_sc.shape[0]
        sc_rows = dense_sc.reshape(H * NB, 128)
        tf_rows = dense_tf.reshape(H * NB, 128)

        def get_row(t, blk):
            rows_idx = slots[:, t : t + 1] * np.int32(NB) + blk
            return jnp.take(sc_rows, rows_idx, axis=0)

        def get_tf(t, top_l, blk):
            rows_idx = slots[:, t : t + 1] * np.int32(NB) + blk
            tf = jnp.take(tf_rows, rows_idx, axis=0).reshape(
                slots.shape[0], -1)
            return jnp.take_along_axis(tf, top_l, axis=1)

        return _pruned_dense_body(
            get_row, get_tf, blockmax, slots, use_score, ks,
            T=T, NB=NB, C=C, M=M, eps3=eps3, tc_mode=False,
            blockmax2=blockmax2, argpos=argpos)

    return jax.jit(kernel)


@lru_cache(maxsize=32)
def make_pruned_dense_kernel_tc(T: int, NB: int, C: int, M: int,
                                eps3: float):
    """tc-mode block-max pruned dense scan: payload lanes are composed
    tc values (uint8 tf rows + the shared len-code row re-joined per
    selected block; exact as f32 and bit-identical to the former uint16
    dense_tc lanes); blockmax planes hold the host-side f64 mirror of the
    reconstructed score's block maxima x(1+2e-6), so ub dominates the
    in-kernel f32 reconstruction."""

    def kernel(dense_tf, len_code, avg32, blockmax, blockmax2, argpos,
               slots, idf32, ks):
        H = dense_tf.shape[0]
        tf_rows = dense_tf.reshape(H * NB, 128)
        len_rows = len_code.reshape(NB, 128)

        def get_row(t, blk):
            # the len-code block gather repeats per t with identical
            # operands — XLA CSE folds it to one gather per query
            rows_idx = slots[:, t : t + 1] * np.int32(NB) + blk
            tf = jnp.take(tf_rows, rows_idx, axis=0).astype(jnp.int32)
            code = jnp.take(len_rows, blk, axis=0).astype(jnp.int32) << 8
            return jnp.where(tf > 0, code | tf, 0).astype(jnp.float32)

        # blockmax planes are idf-scaled; padded slots (idf 0) contribute
        # no ub (keeps the bound tight, matching the raw use_score mask)
        weights = (idf32 > 0).astype(jnp.float32)
        return _pruned_dense_body(
            get_row, None, blockmax, slots, weights, ks,
            T=T, NB=NB, C=C, M=M, eps3=eps3, tc_mode=True, idf32=idf32,
            avg32=avg32, blockmax2=blockmax2, argpos=argpos)

    return jax.jit(kernel)


# ---------------------------------------------------------------------------
# Block-max pruned dense PHRASE scan — the reference-scale route for
# phrases over head terms. At 1M docs ~45% of text-mined adjacent pairs
# have min-df past the list-path ceiling (PHRASE_MAX_L), and the exact
# host path costs SECONDS per unique mega pair (positions-key intersect
# over ~10M keys). Every such pair is necessarily all-dense (min-df >
# PHRASE_MAX_L >= n_docs/32), so: select top-C ub blocks exactly as the
# pruned AND scan, recover each term's posting index for just the C*128
# candidate lanes by binary search into its CSR run (log2(df) probes per
# lane — affordable at this width, which is the whole point), verify
# adjusted positions (query_processing.h:266-362) anchored on the
# caller-chosen per-query anchor term (pick min max_tf: the PP lane
# budget follows the anchor's position-bag bound), and top_k over
# phrase-verified lanes only. The k-th kept PHRASE score is compared
# against next_ub (an AND-score bound, hence also a phrase-score bound):
# unexamined blocks cannot contain a phrase doc beating the kept top-k
# unless FLAG_PRUNE_MISS fires (same proof as the AND guard — phrase
# matches are a subset of AND matches). Phrase-frequent mega pairs (the
# pathological ones) pass the guard; phrase-rare ones fall back to the
# memoized host path.
# ---------------------------------------------------------------------------


def _pruned_phrase_body(get_row_f32, blockmax, postings_doc, positions,
                        pos_starts, starts, ends, slots, weights, anchor,
                        ks, *, T, NB, C, KV, PP, PW, M, n_bs_iters,
                        eps3, tc_mode, idf32=None, avg32=None,
                        blockmax2=None, argpos=None):
    """slots/starts/ends/weights/idf32 are in QUERY-TERM order (phrase
    adjacency is order-dependent; no candidate-first permutation).
    anchor: (B,) int32 — the term whose position bag seeds base lanes.

    Two-stage pruning: (1) block-max selects C blocks; (2) the C*128
    candidate lanes COMPACT to the KV highest AND scores before the
    element-gather-heavy stages (posting-index recovery + position
    verify); KV<<C*128 cuts that gather work ~C*128/KV. Exactness: the
    (KV+1)-th candidate score bounds every unverified lane, so the guard
    flags when max(next_ub, that score) could reach the kept k-th.
    top_k's index-ascending tie order (CPU, H100) makes the compacted
    lanes (score desc, doc asc) — the final top_k over them preserves
    the tie canon."""
    B = slots.shape[0]
    CL = C * 128
    blk, next_ub = _select_ub_blocks(blockmax, slots, weights,
                                     T=T, NB=NB, C=C,
                                     blockmax2=blockmax2, argpos=argpos)
    lane = jnp.arange(128, dtype=jnp.int32)
    cand_docs = (blk[:, :, None] * 128 + lane[None, None, :]).reshape(B, CL)

    match = jnp.ones((B, CL), dtype=bool)
    score = jnp.zeros((B, CL), dtype=jnp.float32)
    payloads = []
    for t in range(T):
        p = get_row_f32(t, blk).reshape(B, CL)
        payloads.append(p)
        match = match & (p > 0)
        if tc_mode:
            score = score + tc_score(p.astype(jnp.int32),
                                     idf32[:, t : t + 1], avg32)
        else:
            score = score + p * weights[:, t : t + 1]
    score = jnp.where(match, score, NEG_INF)

    # stage-2 compaction: KV best-scored matched lanes
    top_cs, top_cl = jax.lax.top_k(score, KV + 1)
    unseen = top_cs[:, KV]  # best unverified candidate score
    sel_score = top_cs[:, :KV]  # (B, KV) score desc, doc asc on ties
    sel_l = top_cl[:, :KV]
    sel_docs = jnp.take_along_axis(cand_docs, sel_l, axis=1)
    sel_valid = sel_score > NEG_INF

    # per-term posting index for the compacted lanes: matched lanes are
    # guaranteed present in every term's CSR run (the dense rows are
    # built from those very runs), so lower_bound IS the posting index;
    # invalid lanes yield in-range garbage masked out of `ok` below
    targets = jnp.broadcast_to(sel_docs[:, None, :], (B, T, KV))
    lo = _binary_search(postings_doc, targets,
                        starts[:, :, None], ends[:, :, None], n_bs_iters)
    ps = _gather1d(pos_starts, lo.reshape(B, -1)).reshape(B, T, KV)
    pe = _gather1d(pos_starts, lo.reshape(B, -1) + 1).reshape(B, T, KV)
    n_matches = _verify_pos_windows(positions, ps, pe, anchor,
                                    T=T, NL=KV, PP=PP, PW=PW)

    final_score = jnp.where(sel_valid & (n_matches > 0), sel_score,
                            NEG_INF)
    top_score, top_l = jax.lax.top_k(final_score, M)  # canon preserved
    top_docs = jnp.take_along_axis(sel_docs, top_l, axis=1)
    top_docs = jnp.where(top_score > NEG_INF, top_docs, -1)
    cand_l = jnp.take_along_axis(sel_l, top_l, axis=1)  # kept lanes in CL

    # guard: unexamined blocks bounded by next_ub; unverified candidate
    # lanes bounded by the (KV+1)-th score
    bound = jnp.maximum(next_ub, unseen)
    prune_flag = prune_guard_flag(top_score, bound, ks, M=M, eps3=eps3)
    sat = jnp.zeros((B,), dtype=jnp.int32)
    tfs = []  # tc mode only; raw callers gather tfs from their tf rows
    if tc_mode:
        for t in range(T):
            top_i = jnp.take_along_axis(payloads[t], cand_l,
                                        axis=1).astype(jnp.int32)
            sat = sat | (tc_saturated(top_i, top_docs).astype(jnp.int32)
                         * FLAG_TF_SAT)
            tfs.append(jnp.where(top_docs >= 0, top_i & 0xFF, 0))
    flags = (boundary_truncated(final_score, top_score, M).astype(jnp.int32)
             | prune_flag | sat)
    return top_docs, cand_l, blk, flags, tfs


@lru_cache(maxsize=32)
def make_pruned_phrase_kernel(T: int, NB: int, C: int, KV: int, PP: int,
                              PW: int, M: int, n_bs_iters: int,
                              eps3: float):
    """Raw-column pruned dense phrase scan.

    fn(dense_sc (H, NB*128) f32, dense_tf (H, NB*128) i32,
       blockmax (H, NB) f32, postings_doc, positions, pos_starts,
       starts (B,T) i32, ends (B,T) i32, slots (B,T) i32,
       use_score (B,T) f32, anchor (B,) i32, ks (B,) i32)
      -> packed (B, T+2, M) i32. All per-term arrays in QUERY order.
    PP bounds the anchor bag, PW every term's bag (window verify)."""

    def kernel(dense_sc, dense_tf, blockmax, blockmax2, argpos,
               postings_doc, positions, pos_starts, starts, ends, slots,
               use_score, anchor, ks):
        H = dense_sc.shape[0]
        sc_rows = dense_sc.reshape(H * NB, 128)
        tf_rows = dense_tf.reshape(H * NB, 128)

        def get_row(t, blk):
            rows_idx = slots[:, t : t + 1] * np.int32(NB) + blk
            return jnp.take(sc_rows, rows_idx, axis=0)

        top_docs, cand_l, blk, flags, _ = _pruned_phrase_body(
            get_row, blockmax, postings_doc, positions, pos_starts,
            starts, ends, slots, use_score, anchor, ks,
            T=T, NB=NB, C=C, KV=KV, PP=PP, PW=PW, M=M,
            n_bs_iters=n_bs_iters, eps3=eps3, tc_mode=False,
            blockmax2=blockmax2, argpos=argpos)
        tfs = []
        for t in range(T):
            rows_idx = slots[:, t : t + 1] * np.int32(NB) + blk
            tf_flat = jnp.take(tf_rows, rows_idx, axis=0).reshape(
                slots.shape[0], -1)
            top_tf = jnp.take_along_axis(tf_flat, cand_l, axis=1)
            tfs.append(jnp.where(top_docs >= 0, top_tf, 0))
        return pack_with_flags(
            top_docs,
            jnp.concatenate([x[:, None, :] for x in tfs], axis=1), flags)

    return jax.jit(kernel)


@lru_cache(maxsize=32)
def make_pruned_phrase_kernel_tc(T: int, NB: int, C: int, KV: int,
                                 PP: int, PW: int, M: int,
                                 n_bs_iters: int, eps3: float):
    """tc-mode pruned dense phrase scan (see make_pruned_phrase_kernel;
    idf32 (B,T) in QUERY order replaces use_score). Dense rows are the
    uint8 tf plane + shared len-code row, composed per selected block
    (bit-identical to the former uint16 tc lanes)."""

    def kernel(dense_tf, len_code, avg32, blockmax, blockmax2, argpos,
               postings_doc, positions, pos_starts, starts, ends, slots,
               idf32, anchor, ks):
        H = dense_tf.shape[0]
        tf_rows = dense_tf.reshape(H * NB, 128)
        len_rows = len_code.reshape(NB, 128)

        def get_row(t, blk):
            rows_idx = slots[:, t : t + 1] * np.int32(NB) + blk
            tf = jnp.take(tf_rows, rows_idx, axis=0).astype(jnp.int32)
            code = jnp.take(len_rows, blk, axis=0).astype(jnp.int32) << 8
            return jnp.where(tf > 0, code | tf, 0).astype(jnp.float32)

        weights = (idf32 > 0).astype(jnp.float32)
        top_docs, _, _, flags, tfs = _pruned_phrase_body(
            get_row, blockmax, postings_doc, positions, pos_starts,
            starts, ends, slots, weights, anchor, ks,
            T=T, NB=NB, C=C, KV=KV, PP=PP, PW=PW, M=M,
            n_bs_iters=n_bs_iters, eps3=eps3, tc_mode=True,
            idf32=idf32, avg32=avg32, blockmax2=blockmax2, argpos=argpos)
        return pack_with_flags(
            top_docs,
            jnp.concatenate([x[:, None, :] for x in tfs], axis=1), flags)

    return jax.jit(kernel)


def _full_phrase_body(rows_f32, rows_payload, postings_doc, positions,
                      pos_starts, starts, ends, anchor, ks, *,
                      T, N_pad, KV, PP, PW, M, n_bs_iters, eps3,
                      payload_tie_exact):
    """FULL-scan dense phrase: score every doc lane, verify the KV
    globally-best candidates, bound the rest by the (KV+1)-th score.

    The pruned phrase scan (C blocks of NB) is the wrong shape for mega
    pairs: their block-ub surface is near-flat, so next_ub stays at the
    global max and FLAG_PRUNE_MISS fires on ~13% of the 1M phrase_mega
    class even after a 4x (C,KV) retry — each miss a host exact pass.
    Scanning ALL lanes replaces the loose block bound with the tightest
    possible one: the (KV+1)-th ACTUAL candidate score, computed by the
    same f32 expression as the kept scores, so the f32-monotonicity
    doctrine (boundary_truncated's docstring) applies to the comparison
    and the only slop is the eps3 arithmetic band. Cost: T*N_pad lane
    ops per query — the same full dense scan dense_all_head_pair
    already pays, elementwise-parallel, no gathers.

    Tie refinement (payload_tie_exact=True, tc mode): on the quantized
    tc score surface the eps3 band at the kth kept score is dominated
    by EXACT ties — lanes whose integer payload (len_code<<8|tf per
    term) equals the kth lane's. Such a lane's f64 score is exactly the
    kth's (same integers through the same formula), so it can only
    displace the kth by the doc-asc canon: an UNSELECTED payload-equal
    band lane with doc id > kth's provably ranks after the kth kept —
    no parity risk, no flag; one with doc id < kth's flags. NOTE the
    selection membership is computed by an exact scatter of the
    selected lane ids, NOT from the (score, doc) order, so no argument
    rests on which equal-scored lane a backend's top_k selected. The
    count-based flags elsewhere in the engine (boundary_truncated,
    prune_guard_flag's >= comparison) were already order-robust. Raw
    mode has no exact integer payload (equal f32 score lanes can
    differ in f64), so every band lane flags
    (payload_tie_exact=False).

    Selection is a TWO-LEVEL exact top-k: per-128-block maxima ->
    top (KV+1) blocks -> row-gather -> top_k over (KV+1)*128 lanes.
    Every lane with score STRICTLY above the gathered (KV+1)-th value
    is provably selected (a block holding such a lane has max > that
    value; at most KV blocks can, and they all rank above the tie
    blocks), so `unseen` is the exact (KV+1)-th VALUE; equal-valued
    membership may differ from the canonical set, which the
    scatter-mask + payload rules above make harmless.

    rows_f32(t) -> (B, N_pad) f32 per-lane score contribution (0 where
    absent); rows_payload(t) -> (B, N_pad) i32 exact payload for the
    tie refinement, or None. Returns (top_docs, flags)."""
    B = starts.shape[0]
    score = jnp.zeros((B, N_pad), dtype=jnp.float32)
    match = jnp.ones((B, N_pad), dtype=bool)
    for t in range(T):
        p = rows_f32(t)
        match = match & (p > 0)
        score = score + p
    score = jnp.where(match, score, NEG_INF)

    NB = N_pad // 128
    if NB >= KV + 1:
        s3 = score.reshape(B, NB, 128)
        bm = jnp.max(s3, axis=2)
        _, blk = jax.lax.top_k(bm, KV + 1)
        # ascending block ids: gathered lane order == doc order
        nbs, _ = jax.lax.top_k(-blk.astype(jnp.float32), KV + 1)
        blk = (-nbs).astype(jnp.int32)
        rows3 = jnp.take_along_axis(s3, blk[:, :, None], axis=1)
        flat = rows3.reshape(B, (KV + 1) * 128)
        top_cs, fl = jax.lax.top_k(flat, KV + 1)
        top_cl = (jnp.take_along_axis(blk, fl // 128, axis=1) * 128
                  + fl % 128)
    else:  # tiny doc spaces: flat top_k is cheap and exact
        top_cs, top_cl = jax.lax.top_k(score, KV + 1)
    unseen = top_cs[:, KV]  # exact (KV+1)-th candidate VALUE
    sel_score = top_cs[:, :KV]
    sel_docs = top_cl[:, :KV]
    sel_valid = sel_score > NEG_INF

    # posting-index recovery for the selected lanes (guaranteed present
    # in every term's CSR run — the dense rows are built from them)
    targets = jnp.broadcast_to(sel_docs[:, None, :], (B, T, KV))
    lo = _binary_search(postings_doc, targets,
                        starts[:, :, None], ends[:, :, None], n_bs_iters)
    ps = _gather1d(pos_starts, lo.reshape(B, -1)).reshape(B, T, KV)
    pe = _gather1d(pos_starts, lo.reshape(B, -1) + 1).reshape(B, T, KV)
    n_matches = _verify_pos_windows(positions, ps, pe, anchor,
                                    T=T, NL=KV, PP=PP, PW=PW)

    final_score = jnp.where(sel_valid & (n_matches > 0), sel_score,
                            NEG_INF)
    top_score, top_l = jax.lax.top_k(final_score, M)  # canon preserved
    top_docs = jnp.take_along_axis(sel_docs, top_l, axis=1)
    top_docs = jnp.where(top_score > NEG_INF, top_docs, -1)

    k_idx = jnp.clip(ks.astype(jnp.int32) - 1, 0, M - 1)
    kth = jnp.take_along_axis(top_score, k_idx[:, None], axis=1)[:, 0]
    no_k = kth <= NEG_INF
    kth_doc = jnp.maximum(
        jnp.take_along_axis(top_docs, k_idx[:, None], axis=1)[:, 0], 0)

    # guard: any unselected lane inside the eps3 band of the kth kept
    # score flags, unless its payload proves an exact tie ranking
    # canonically after the kth (tc mode; see docstring). Selection
    # membership is an exact scatter of the selected ids — no reliance
    # on the hardware top_k's tie order.
    lane_id = jax.lax.broadcasted_iota(jnp.int32, (B, N_pad), 1)
    b_idx = jnp.arange(B, dtype=jnp.int32)[:, None]
    # only the first KV lanes are VERIFIED; the (KV+1)-th is as
    # unexamined as any other band lane and must not be masked out
    selected = jnp.zeros((B, N_pad), dtype=bool).at[
        b_idx, jnp.clip(sel_docs, 0, N_pad - 1)].set(True)
    safe_kth = jnp.where(no_k, jnp.inf, kth)
    band = ~selected & (score > NEG_INF) \
        & (score >= safe_kth[:, None] * np.float32(1.0 - eps3))
    if payload_tie_exact:
        bad = jnp.zeros((B, N_pad), dtype=bool)
        for t in range(T):
            pay = rows_payload(t)
            pay_kth = jnp.take_along_axis(pay, kth_doc[:, None], axis=1)
            bad = bad | (pay != pay_kth)
        # exact payload tie: flags only if it would canonically
        # DISPLACE the kth kept (equal f64 score, smaller doc id)
        bad = bad | (lane_id < kth_doc[:, None])
        band = band & bad
    miss = (no_k & (unseen > NEG_INF)) | jnp.any(band, axis=1)
    flags = (boundary_truncated(final_score, top_score, M).astype(jnp.int32)
             | miss.astype(jnp.int32) * FLAG_PRUNE_MISS)
    return top_docs, flags


@lru_cache(maxsize=32)
def make_full_phrase_kernel_tc(T: int, N_pad: int, KV: int, PP: int,
                               PW: int, M: int, n_bs_iters: int,
                               eps3: float):
    """tc-mode full-scan dense phrase (see _full_phrase_body). Dense
    rows are the uint8 TF plane + shared len-code row, composed per
    lane exactly as make_dense_search_kernel_tc. All per-term arrays in
    QUERY order (adjacency is order-dependent).

    fn(dense_tf (H, N_pad) u8, len_code (N_pad,) u8, avg32,
       postings_doc, positions, pos_starts, starts (B,T) i32,
       ends (B,T) i32, slots (B,T) i32, idf32 (B,T) f32, anchor (B,)
       i32, ks (B,) i32) -> packed (B, T+2, M) i32."""

    def kernel(dense_tf, len_code, avg32, postings_doc, positions,
               pos_starts, starts, ends, slots, idf32, anchor, ks):
        code_row = len_code.astype(jnp.int32)[None, :] << 8

        def payload(t):
            tf_t = jnp.take(dense_tf, slots[:, t], axis=0).astype(jnp.int32)
            return jnp.where(tf_t > 0, code_row | tf_t, 0)

        def row_f32(t):
            return tc_score(payload(t), idf32[:, t : t + 1], avg32)

        top_docs, flags = _full_phrase_body(
            row_f32, payload, postings_doc, positions, pos_starts,
            starts, ends, anchor, ks,
            T=T, N_pad=N_pad, KV=KV, PP=PP, PW=PW, M=M,
            n_bs_iters=n_bs_iters, eps3=eps3, payload_tie_exact=True)
        sat = jnp.zeros((starts.shape[0],), dtype=jnp.int32)
        tfs = []
        for t in range(T):
            top_t = jnp.take_along_axis(
                payload(t), jnp.maximum(top_docs, 0), axis=1)
            sat = sat | (tc_saturated(top_t, top_docs).astype(jnp.int32)
                         * FLAG_TF_SAT)
            tfs.append(jnp.where(top_docs >= 0, top_t & 0xFF, 0))
        return pack_with_flags(
            top_docs,
            jnp.concatenate([x[:, None, :] for x in tfs], axis=1),
            flags | sat)

    return jax.jit(kernel)


@lru_cache(maxsize=32)
def make_full_phrase_kernel(T: int, N_pad: int, KV: int, PP: int,
                            PW: int, M: int, n_bs_iters: int,
                            eps3: float):
    """Raw-column full-scan dense phrase (see _full_phrase_body; no
    exact integer payload in raw mode, so eps3-band ties flag).

    fn(dense_sc (H, N_pad) f32, dense_tf (H, N_pad) i32, postings_doc,
       positions, pos_starts, starts, ends, slots, use_score (B,T) f32,
       anchor (B,) i32, ks (B,) i32) -> packed (B, T+2, M) i32."""

    def kernel(dense_sc, dense_tf, postings_doc, positions, pos_starts,
               starts, ends, slots, use_score, anchor, ks):
        def row_f32(t):
            return jnp.take(dense_sc, slots[:, t], axis=0) \
                * use_score[:, t : t + 1]

        top_docs, flags = _full_phrase_body(
            row_f32, None, postings_doc, positions, pos_starts,
            starts, ends, anchor, ks,
            T=T, N_pad=N_pad, KV=KV, PP=PP, PW=PW, M=M,
            n_bs_iters=n_bs_iters, eps3=eps3, payload_tie_exact=False)
        tfs = []
        for t in range(T):
            p_tf = _dense_gather(dense_tf, slots[:, t : t + 1],
                                 jnp.maximum(top_docs, 0))
            tfs.append(jnp.where(top_docs >= 0, p_tf, 0))
        return pack_with_flags(
            top_docs,
            jnp.concatenate([x[:, None, :] for x in tfs], axis=1), flags)

    return jax.jit(kernel)


@lru_cache(maxsize=32)
def make_dense_search_kernel(T: int, N_pad: int, M: int):
    """Doc-space dense scan for all-head-term conjunctions.

    When every query term is a head term (df within ~an order of magnitude
    of n_docs), posting-list intersection degenerates: the candidate list
    is most of the doc space, and list-aligned methods (binary search /
    windowed compare / staircase merge) do Omega(df * probe_cost) work
    with gathers. The accelerator-friendly representation is the DENSE
    one: each head term keeps a (N_pad,) score vector (0 = absent) and the query is pure
    elementwise math over doc lanes — score = sum of row-gathered vectors,
    match = all rows nonzero, then the two-level exact top-M selection
    (two_level_top_m; the doc-lane index IS the doc id, and boundary-
    class spillover past M fires the count-based trunc flag computed
    over the full plane). Work is T*N lane-ops with NO per-candidate
    gathers, independent of df. (The reference's analog is the zigzag on
    its densest lists, query_processing.h:644-678 — linear passes over
    both lists.)

    fn(dense_sc (H, N_pad) f32, dense_tf (H, N_pad) i32,
       slots (B, T) i32 rows into H (padded slots repeat slot 0),
       use_score (B, T) f32) -> packed (B, T+1, M) i32 [docs; slot tfs].
    """

    def kernel(dense_sc, dense_tf, slots, use_score):
        B = slots.shape[0]
        score = jnp.zeros((B, N_pad), dtype=jnp.float32)
        match = jnp.ones((B, N_pad), dtype=bool)
        for t in range(T):
            sc_t = jnp.take(dense_sc, slots[:, t], axis=0)  # (B, N) rows
            match = match & (sc_t > 0)
            score = score + sc_t * use_score[:, t : t + 1]
        score = jnp.where(match, score, NEG_INF)
        top_score, top_docs = two_level_top_m(score, M)  # lane = doc id
        top_docs = jnp.where(top_score > NEG_INF, top_docs, -1)
        tfs = []
        for t in range(T):
            p_tf = _dense_gather(dense_tf, slots[:, t : t + 1],
                                 jnp.maximum(top_docs, 0))
            tfs.append(jnp.where(top_docs >= 0, p_tf, 0))
        trunc = boundary_truncated(score, top_score, M)
        return pack_with_flags(
            top_docs, jnp.concatenate([x[:, None, :] for x in tfs], axis=1),
            trunc.astype(jnp.int32))

    return jax.jit(kernel)


# ---------------------------------------------------------------------------
# Windowed block intersection — the fast path for multi-term queries whose
# posting lists are all long.
#
# The binary-search intersection (15 dependent random element probes per
# candidate) is replaced by block arithmetic over 128-wide rows: every
# term's posting run is 128-aligned (index/format.py BLOCK), posting
# memory is viewed as a (P/128, 128) matrix, and for each 128-candidate
# block we row-gather a WINDOW of the other list's blocks that can
# overlap it, then do a dense 128xW*128 equality compare. Window
# placement comes from block summaries (first element of each block) via a compare-count — no
# binary search, no element gathers anywhere.
#
# This is the batched analog of the reference's skip-list + in-block linear
# scan (flash_iterators.h:181-199, SkipForward): the block summary IS the
# skip list, the dense compare IS the in-block scan.
#
# Exactness: a candidate block's true overlap in the other list can exceed
# the fixed window width WIN when doc distributions are skewed; the kernel
# flags the affected QUERIES (per-row overflow bit) and the host re-runs
# just those through the exact host search. With similarly-sized lists
# overflow is rare.
# ---------------------------------------------------------------------------

def default_win(L: int, G: int) -> int:
    """Window width: ~2x the average blocks-per-candidate-block ratio."""
    ratio = max(1, (G * 128) // max(L, 1))
    return min(16, 2 * ratio + 2)


def _window_pick(eq, *payloads):
    """(B, I, 128, W) equality x each (B, I, W) payload -> (B, I, 128): the
    payload at each candidate's matching window lane, 0 where none. Each
    candidate matches at most one lane, so the masked sum has one nonzero
    term and is exact in the payload's own dtype (a matmul contraction
    here may run in TF32 on the GPU, which rounds f32 scores and uint16
    tc codes)."""
    return tuple(jnp.sum(jnp.where(eq, p[:, :, None, :],
                                   jnp.zeros((), p.dtype)), axis=-1)
                 for p in payloads)


def windowed_search_body(postings_doc, postings_score, postings_tf,
                         starts, ends, use_score, *, T, L, G, M, WIN,
                         tc=None, idf32=None, avg32=None):
    """Multi-term search via windowed block intersection.

    G = other-list block-count bucket (covers the longest non-candidate
    list in the group: G*128 >= max df). Returns search_body's outputs
    plus a PER-QUERY `overflow` bool (B,) — only the skewed queries pay
    the exact fallback, not the whole dispatch group.

    tc mode halves the windowed payload: the equality tensor picks ONE
    uint16 tc lane instead of (score, tf), and the score is reconstructed
    from the matched tc afterwards.
    """
    assert T >= 2
    B = starts.shape[0]
    I = L // 128
    tc_mode = tc is not None
    doc_blocks = postings_doc.reshape(-1, 128)

    if tc_mode:
        cdocs, ctc, cvalid, cs = _candidates(postings_doc, tc, starts, ends, L)
        ctc = ctc.astype(jnp.int32)
        cscore = tc_score(ctc, idf32[:, 0:1], avg32)
        tc_blocks = tc.reshape(-1, 128)
    else:
        cdocs, cscore, cvalid, cs = _candidates(
            postings_doc, postings_score, starts, ends, L)
        score_blocks = postings_score.reshape(-1, 128)
        tf_blocks = postings_tf.reshape(-1, 128)
    lane = jnp.arange(L, dtype=jnp.int32)
    cpidx = cs[:, None] + lane[None, :]
    cblocks = cdocs.reshape(B, I, 128)
    cbmin = cblocks[:, :, 0]  # (B, I) first = min (sorted)
    cbmax = jnp.max(jnp.where(cblocks < INT32_MAX, cblocks, -1), axis=2)

    total_score = []
    total_tf = []
    total_tc = []
    overflow = jnp.zeros((B,), dtype=bool)
    g = jnp.arange(G, dtype=jnp.int32)

    for t in range(1, T):
        st = starts[:, t]  # (B,)
        en = ends[:, t]
        sblock = st >> 7  # 128-aligned starts
        nblocks = (en - st + 127) >> 7  # (B,)
        gvalid = g[None, :] < nblocks[:, None]  # (B, G)
        rows_idx = sblock[:, None] + jnp.minimum(g[None, :], nblocks[:, None] - 1)
        rows_idx = jnp.maximum(rows_idx, 0)
        # block summaries: first element of each other-block
        obfirst = jnp.take(doc_blocks[:, 0], rows_idx, axis=0)  # (B, G)
        obfirst = jnp.where(gvalid, obfirst, INT32_MAX)

        # lower-bound block: last block whose first element <= cbmin;
        # j_lo = count(obfirst <= cbmin) - 1 clamped at 0.
        cmp_lo = (obfirst[:, None, :] <= cbmin[:, :, None]) & gvalid[:, None, :]
        j_lo = jnp.maximum(jnp.sum(cmp_lo, axis=2, dtype=jnp.int32) - 1, 0)  # (B, I)
        # last overlapping block: last block with first element <= cbmax
        cmp_hi = (obfirst[:, None, :] <= cbmax[:, :, None]) & gvalid[:, None, :]
        j_hi = jnp.maximum(jnp.sum(cmp_hi, axis=2, dtype=jnp.int32) - 1, 0)
        has_cand = cbmax >= 0
        overflow = overflow | jnp.any((j_hi - j_lo + 1 > WIN) & has_cand,
                                      axis=1)

        # partial scores are strictly positive (idf > 0, tf >= 1;
        # sentinel pads score 0), so score_t > 0 IS the membership flag.
        # Each candidate matches at most ONE window lane (doc ids unique
        # per list): _window_pick returns the matched payloads exactly.
        j = j_lo[:, :, None] + jnp.arange(WIN, dtype=jnp.int32)[None, None, :]
        wvalid = j < nblocks[:, None, None]  # (B, I, WIN)
        wrow = sblock[:, None, None] + jnp.minimum(
            j, jnp.maximum(nblocks[:, None, None] - 1, 0))
        wdocs = jnp.take(doc_blocks, wrow, axis=0)  # (B, I, WIN, 128)
        wdocs = jnp.where(wvalid[..., None], wdocs, INT32_MAX)
        eq = (cblocks[:, :, :, None, None] == wdocs[:, :, None, :, :])
        eq = eq.reshape(B, I, 128, WIN * 128)
        if tc_mode:
            wtc = jnp.take(tc_blocks, wrow, axis=0).reshape(B, I, WIN * 128)
            (wtc,) = _window_pick(eq, wtc.astype(jnp.int32))
            total_tc.append(wtc.reshape(B, L))
        else:
            wshape = (B, I, WIN * 128)
            wscore = jnp.take(score_blocks, wrow, axis=0).reshape(wshape)
            wtf = jnp.take(tf_blocks, wrow, axis=0).reshape(wshape)
            wscore, wtf = _window_pick(eq, wscore, wtf)
            total_score.append(wscore.reshape(B, L))
            total_tf.append(wtf.reshape(B, L))

    if tc_mode:
        tc_lanes = jnp.stack(total_tc, axis=1)  # (B, T-1, L) matched tc
        match = jnp.all(tc_lanes > 0, axis=1) & cvalid
        score = cscore + jnp.sum(
            tc_score(tc_lanes, idf32[:, 1:, None], avg32), axis=1)
    else:
        partial = jnp.stack(total_score, axis=1)  # (B, T-1, L)
        match = jnp.all(partial > 0, axis=1) & cvalid
        score = cscore * use_score[:, 0:1] + jnp.sum(
            partial * use_score[:, 1:, None], axis=1)
    score = jnp.where(match, score, NEG_INF)

    top_score, top_l = two_level_top_m(score, M)
    top_docs = jnp.take_along_axis(cdocs, top_l, axis=1)
    top_docs = jnp.where(top_score > NEG_INF, top_docs, -1)
    # candidate-slot tf via its own posting index; other slots from the
    # accumulated tf lanes
    top_cpidx = jnp.take_along_axis(cpidx, top_l, axis=1)
    sat = jnp.zeros((B,), dtype=jnp.int32)
    if tc_mode:
        top_ctc = jnp.take_along_axis(ctc, top_l, axis=1)
        cand_tf = jnp.where(top_docs >= 0, top_ctc & 0xFF, 0)
        top_rest_tc = jnp.take_along_axis(
            tc_lanes, top_l[:, None, :].repeat(T - 1, 1), axis=2)
        top_rest = jnp.where(top_docs[:, None, :] >= 0, top_rest_tc & 0xFF, 0)
        sat = (tc_saturated(top_ctc, top_docs)
               | tc_saturated(top_rest_tc, top_docs)).astype(jnp.int32)
    else:
        cand_tf = jnp.where(top_docs >= 0, _gather1d(postings_tf, top_cpidx), 0)
        tfs_rest = jnp.stack(total_tf, axis=1)  # (B, T-1, L)
        top_rest = jnp.take_along_axis(
            tfs_rest, top_l[:, None, :].repeat(T - 1, 1), axis=2)
    top_tfs = jnp.concatenate([cand_tf[:, None, :], top_rest], axis=1)
    top_pidx = jnp.zeros_like(top_tfs)  # not tracked on this path
    trunc = boundary_truncated(score, top_score, M)
    flags = (trunc.astype(jnp.int32) | (overflow.astype(jnp.int32) << 1)
             | (sat * FLAG_TF_SAT))
    return top_docs, top_score, top_tfs, top_pidx, flags


@lru_cache(maxsize=128)
def make_windowed_search_kernel(T: int, L: int, G: int, M: int,
                                mode: str = "raw"):
    win = default_win(L, G)

    if mode == "tc":
        def kernel(postings_doc, postings_tc, avg32, starts, ends, idf32):
            top_docs, _, top_tfs, _, flags = windowed_search_body(
                postings_doc, None, None, starts, ends, None,
                T=T, L=L, G=G, M=M, WIN=win,
                tc=postings_tc, idf32=idf32, avg32=avg32)
            return pack_with_flags(top_docs, top_tfs, flags)
    else:
        def kernel(postings_doc, postings_score, postings_tf,
                   starts, ends, use_score):
            top_docs, _, top_tfs, _, flags = windowed_search_body(
                postings_doc, postings_score, postings_tf, starts, ends,
                use_score, T=T, L=L, G=G, M=M, WIN=win)
            return pack_with_flags(top_docs, top_tfs, flags)

    return jax.jit(kernel)
