"""Document-partitioned sharded engine over a jax.sharding.Mesh.

The reference's entire distributed story is a gRPC client/server pair with
a single server owning the whole index (SURVEY.md §2, grpc_server_impl.h);
there is no index sharding. This module adds the device-mesh scaling axis
(BASELINE.json config 5): postings are partitioned by contiguous document
ranges across mesh devices, every device runs the same batched search step
on its local shard under shard_map, and per-shard top-k results are merged
with an all-gather + re-top-k — the collective rides the device
interconnect (NVLink on a multi-GPU host) instead of a network hop.

Correctness notes:
- df/idf/avg_len/doc length codes are global statistics, replicated.
- doc ranges are contiguous and ascending with shard id, so the merge's
  tie-break (lowest concatenated index on equal f32 scores) still resolves
  to the lowest doc id; the host f64 re-rank finalizes ordering exactly as
  in the single-device engine.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from wiser_tpu.engine import kernels as K
from wiser_tpu.engine.device import (
    B_BUCKETS,
    L_BUCKETS,
    T_BUCKETS,
    _bucket,
    DEFAULT_MARGIN,
)
from wiser_tpu.index.format import BLOCK, PackedIndex
from wiser_tpu.scoring import Bm25Similarity
from wiser_tpu.types import SearchQuery, SearchResult


@dataclass
class ShardedIndex:
    """Per-shard CSR posting columns stacked on a leading shard axis."""

    n_shards: int
    doc_bounds: np.ndarray  # int64[D+1] contiguous doc ranges
    postings_doc: np.ndarray  # int32[D, P_pad] global doc ids, pad SENTINEL
    postings_tf: np.ndarray  # int32[D, P_pad]
    postings_score: np.ndarray  # f32[D, P_pad] partial scores (global stats)
    term_starts: np.ndarray  # int32[D, T+1] 128-aligned per-shard CSR
    df_shard: np.ndarray  # int32[D, T] real per-shard posting counts
    pos_starts: np.ndarray  # int32[D, P_pad+1] per-shard position bags
    positions: np.ndarray  # int32[D, PP_pad]
    # global (replicated) metadata
    terms: List[str]
    df: np.ndarray
    idf64: np.ndarray
    n_docs: int
    avg_len: float
    doc_len_code: np.ndarray  # uint8[N]
    # per-shard bi-bloom rows (regathered per-posting columns, uint32
    # [D, P_pad, W]); None when the source index has no bloom columns
    bloom_ends: Optional[np.ndarray] = None
    bloom_begins: Optional[np.ndarray] = None
    max_tf: np.ndarray = None  # int32[T] global (phrase PP bucketing)
    # host-only reference to the source index: exact-fallback re-searches
    # and snippet offsets (never uploaded to devices)
    source: Optional[PackedIndex] = None

    @classmethod
    def from_packed(cls, packed: PackedIndex, n_shards: int) -> "ShardedIndex":
        from wiser_tpu.index.format import BLOCK, SENTINEL_DOC

        N, T = packed.n_docs, packed.n_terms
        # equal-width 128-aligned ranges: shard s owns docs
        # [s*Npd, (s+1)*Npd). The dense doc-space tier partitions on the
        # SAME grid, so a shard's postings reference exactly its dense
        # rows' doc range (local dense index = global doc - s*Npd).
        npd = (N + n_shards * BLOCK - 1) // (n_shards * BLOCK) * BLOCK
        bounds = np.minimum(np.arange(n_shards + 1, dtype=np.int64) * npd, N)
        scores = packed.partial_scores(
            Bm25Similarity(packed.avg_len).cache
        ).astype(np.float32)
        lens = np.diff(packed.term_starts)
        term_of = np.repeat(np.arange(T, dtype=np.int64), lens)
        real = packed.postings_doc != SENTINEL_DOC
        shard_of = np.full(packed.n_postings, -1, dtype=np.int64)
        if n_shards > 1:
            shard_of[real] = np.searchsorted(
                bounds[1:-1], packed.postings_doc[real], side="right")
        else:
            shard_of[real] = 0

        per = []
        for s in range(n_shards):
            sel = shard_of == s
            cnt = np.bincount(term_of[sel], minlength=T).astype(np.int64)
            padded = (cnt + BLOCK - 1) // BLOCK * BLOCK
            ts = np.zeros(T + 1, dtype=np.int64)
            np.cumsum(padded, out=ts[1:])
            per.append((sel, cnt, ts))

        lmax = _bucket(int(packed.df.max(initial=1)), L_BUCKETS)
        p_pad = max(int(ts[-1]) for _, _, ts in per) + lmax
        p_pad = (p_pad + BLOCK - 1) // BLOCK * BLOCK
        D = n_shards
        out_doc = np.full((D, p_pad), SENTINEL_DOC, dtype=np.int32)
        out_tf = np.zeros((D, p_pad), dtype=np.int32)
        out_sc = np.zeros((D, p_pad), dtype=np.float32)
        have_blooms = packed.bloom_ends is not None
        if have_blooms:
            W = packed.bloom_ends.shape[1]
            out_be = np.zeros((D, p_pad, W), dtype=np.uint32)
            out_bb = np.zeros((D, p_pad, W), dtype=np.uint32)
        df_shard = np.zeros((D, T), dtype=np.int32)
        pos_counts_global = np.diff(packed.pos_starts)
        shard_positions = []
        shard_pos_counts = []
        for s, (sel, cnt, ts) in enumerate(per):
            t_sel = term_of[sel]
            # rank of each selected posting within its term run
            csum = np.zeros(T + 1, dtype=np.int64)
            np.cumsum(cnt, out=csum[1:])
            rank = np.arange(t_sel.size) - csum[t_sel]
            dest = ts[t_sel] + rank
            out_doc[s, dest] = packed.postings_doc[sel]
            out_tf[s, dest] = packed.postings_tf[sel]
            out_sc[s, dest] = scores[sel]
            if have_blooms:
                out_be[s, dest] = packed.bloom_ends[sel]
                out_bb[s, dest] = packed.bloom_begins[sel]
            df_shard[s] = cnt
            # ragged gather of each selected posting's position bag
            sel_idx = np.nonzero(sel)[0]
            cnts = pos_counts_global[sel_idx]
            csum2 = np.zeros(len(cnts) + 1, dtype=np.int64)
            np.cumsum(cnts, out=csum2[1:])
            total = int(csum2[-1])
            src = (np.repeat(packed.pos_starts[sel_idx], cnts)
                   + np.arange(total) - np.repeat(csum2[:-1], cnts))
            shard_positions.append(packed.positions[src])
            counts_padded = np.zeros(p_pad, dtype=np.int64)
            counts_padded[dest] = cnts
            shard_pos_counts.append(counts_padded)
        pp_pad = max(1, max(len(x) for x in shard_positions))
        out_pos = np.zeros((D, pp_pad), dtype=np.int32)
        out_ps = np.zeros((D, p_pad + 1), dtype=np.int32)
        for s in range(D):
            out_pos[s, : len(shard_positions[s])] = shard_positions[s]
            out_ps[s, 1:] = np.cumsum(shard_pos_counts[s]).astype(np.int32)
        return cls(
            n_shards=D,
            doc_bounds=bounds,
            postings_doc=out_doc,
            postings_tf=out_tf,
            postings_score=out_sc,
            term_starts=np.stack([ts for _, _, ts in per]).astype(np.int32),
            df_shard=df_shard,
            pos_starts=out_ps,
            positions=out_pos,
            bloom_ends=out_be if have_blooms else None,
            bloom_begins=out_bb if have_blooms else None,
            max_tf=packed.max_tf.copy(),
            terms=packed.terms,
            df=packed.df.copy(),
            idf64=packed.idf64.copy(),
            n_docs=N,
            avg_len=packed.avg_len,
            doc_len_code=packed.doc_len_code.copy(),
            source=packed,
        )


@lru_cache(maxsize=64)
def make_sharded_kernel(T: int, L: int, M: int, n_bs_iters: int, mesh: Mesh,
                        M_out: int = None):
    """Sharded search step: local search_body per shard, all-gather + merge.

    fn(pd (D,Pp), psc (D,Pp), pt (D,Pp), ts (D,T+1), rows (B,T) slot-
       ordered, use_score (B,T)) -> (docs (B,M), score (B,M),
       tfs (B,T,M) slot-ordered) replicated.
    """

    def local(pd, psc, pt, ts, dfs, rows, use_score):
        pd, psc, pt, ts, dfs = pd[0], psc[0], pt[0], ts[0], dfs[0]
        starts = ts[rows]
        ends = starts + dfs[rows]
        td, tsc, ttf, _, ltrunc = K.search_body(
            pd, psc, pt, starts, ends, use_score,
            T=T, L=L, M=M, n_bs_iters=n_bs_iters,
        )
        g_d = jax.lax.all_gather(td, "d")  # (D, B, M)
        g_s = jax.lax.all_gather(tsc, "d")
        g_t = jax.lax.all_gather(ttf, "d")  # (D, B, T, M)
        g_f = jax.lax.all_gather(ltrunc, "d")  # (D, B)
        D = g_d.shape[0]
        B = td.shape[0]
        Mo = M_out or M
        gd = jnp.transpose(g_d, (1, 0, 2)).reshape(B, D * M)
        gs = jnp.transpose(g_s, (1, 0, 2)).reshape(B, D * M)
        gt = jnp.transpose(g_t, (1, 2, 0, 3)).reshape(B, T, D * M)
        s2, i2 = jax.lax.top_k(gs, Mo)
        d2 = jnp.take_along_axis(gd, i2, axis=1)
        t2 = jnp.take_along_axis(gt, i2[:, None, :].repeat(T, 1), axis=2)
        # guard: a shard's local buffer truncating its f32 boundary class,
        # or the merge stage truncating across the gathered D*M candidates
        trunc = (jnp.any(g_f, axis=0)
                 | K.boundary_truncated(gs, s2, Mo))
        return d2, s2, t2, trunc

    step = shard_map(
        local,
        mesh=mesh,
        in_specs=(P("d"), P("d"), P("d"), P("d"), P("d"), P(), P()),
        out_specs=(P(), P(), P(), P()),
        check_vma=False,
    )
    return jax.jit(step)


@lru_cache(maxsize=64)
def make_sharded_phrase_kernel(T: int, L: int, PP: int, M: int,
                               n_bs_iters: int, n_pos_iters: int, mesh: Mesh,
                               M_out: int = None):
    """Sharded phrase step: full local phrase pipeline per shard
    (kernels.phrase_body; positional verification is doc-local so each
    shard is independent), then all-gather + score merge."""

    def local(pd, psc, pt, ts, dfs, pos, pstarts, rows, use_score, slot_of):
        pd, psc, pt, ts, dfs = pd[0], psc[0], pt[0], ts[0], dfs[0]
        pos, pstarts = pos[0], pstarts[0]
        starts = ts[rows]
        ends = starts + dfs[rows]
        packed, tsc = K.phrase_body(
            pd, psc, pt, pos, pstarts, starts, ends, use_score, slot_of,
            T=T, L=L, PP=PP, M=M,
            n_bs_iters=n_bs_iters, n_pos_iters=n_pos_iters)
        body, lflag = packed[:, : T + 1, :], packed[:, T + 1, 0]
        g_p = jax.lax.all_gather(body, "d")  # (D, B, T+1, M)
        g_s = jax.lax.all_gather(tsc, "d")  # (D, B, M)
        g_f = jax.lax.all_gather(lflag, "d")  # (D, B)
        D = g_p.shape[0]
        B = body.shape[0]
        Mo = M_out or M
        gp = jnp.transpose(g_p, (1, 2, 0, 3)).reshape(B, T + 1, D * M)
        gs = jnp.transpose(g_s, (1, 0, 2)).reshape(B, D * M)
        s2, i2 = jax.lax.top_k(gs, Mo)
        merged = jnp.take_along_axis(gp, i2[:, None, :].repeat(T + 1, 1), axis=2)
        trunc = ((jnp.sum(g_f, axis=0) > 0)
                 | K.boundary_truncated(gs, s2, Mo))
        flag_row = jnp.broadcast_to(
            trunc.astype(jnp.int32)[:, None, None], (B, 1, Mo))
        return jnp.concatenate([merged, flag_row], axis=1)

    step = shard_map(
        local,
        mesh=mesh,
        in_specs=(P("d"), P("d"), P("d"), P("d"), P("d"), P("d"), P("d"),
                  P(), P(), P()),
        out_specs=P(),
        check_vma=False,
    )
    return jax.jit(step)


def _merge_gathered(top_docs, top_score, tfs, ltrunc, *, T, M,
                    M_out=None):
    """Shared merge tail: all-gather per-shard (docs, score, slot tfs,
    local trunc), re-top-k over the D*M gathered lanes. Gathered lane
    order is shard-major and shards own ascending doc ranges, so top_k's
    lowest-index tie keep preserves the (score desc, doc asc) canon.

    M_out: merged output width — may EXCEED the per-shard M (deep-k
    queries: a shard can hold at most its local L-bucket of matches, but
    k spans all shards; capping the merge at the local M silently
    truncated k=200 single-term results to 128 — round-4 fix).
    Returns (d2 (B,Mo), s2 (B,Mo), t2 (B,T,Mo), trunc (B,) — local OR
    merged boundary-class truncation)."""
    Mo = M_out or M
    g_d = jax.lax.all_gather(top_docs, "d")  # (D, B, M)
    g_s = jax.lax.all_gather(top_score, "d")
    g_t = jax.lax.all_gather(tfs, "d")  # (D, B, T, M)
    g_f = jax.lax.all_gather(ltrunc, "d")  # (D, B)
    D = g_d.shape[0]
    B = top_docs.shape[0]
    gd = jnp.transpose(g_d, (1, 0, 2)).reshape(B, D * M)
    gs = jnp.transpose(g_s, (1, 0, 2)).reshape(B, D * M)
    gt = jnp.transpose(g_t, (1, 2, 0, 3)).reshape(B, T, D * M)
    s2, i2 = jax.lax.top_k(gs, Mo)
    d2 = jnp.take_along_axis(gd, i2, axis=1)
    t2 = jnp.take_along_axis(gt, i2[:, None, :].repeat(T, 1), axis=2)
    trunc = jnp.any(g_f, axis=0) | K.boundary_truncated(gs, s2, Mo)
    return d2, s2, t2, trunc


@lru_cache(maxsize=32)
def make_sharded_dense_kernel(T: int, Npd: int, M: int, mesh: Mesh):
    """All-head conjunctions on the mesh: each shard scans its (H, Npd)
    dense doc-range slice (the single-device dense tier split on the doc
    axis — device.py _build_dense_rows), then all-gather + merge. Work
    per shard is T*Npd lane-ops = 1/D of the single-device dense scan;
    the collective moves only (D, B, T+2, M) ints over ICI.

    fn(dense_sc (D, H, Npd), dense_tf (D, H, Npd), slots (B,T) i32
       global dense rows, use_score (B,T)) -> packed (B, T+2, M) repl."""

    def local(dense_sc, dense_tf, slots, use_score):
        dsc, dtf = dense_sc[0], dense_tf[0]
        B = slots.shape[0]
        sid = jax.lax.axis_index("d").astype(jnp.int32)
        score = jnp.zeros((B, Npd), dtype=jnp.float32)
        match = jnp.ones((B, Npd), dtype=bool)
        for t in range(T):
            sc_t = jnp.take(dsc, slots[:, t], axis=0)  # (B, Npd)
            match = match & (sc_t > 0)
            score = score + sc_t * use_score[:, t : t + 1]
        score = jnp.where(match, score, K.NEG_INF)
        top_score, top_l = jax.lax.top_k(score, M)  # lane = LOCAL doc
        valid = top_score > K.NEG_INF
        top_docs = jnp.where(valid, sid * np.int32(Npd) + top_l, -1)
        tf_flat = dtf.reshape(-1)
        tfs = []
        for t in range(T):
            idx = (slots[:, t : t + 1].astype(jnp.int32) * np.int32(Npd)
                   + jnp.maximum(top_l, 0))
            tfs.append(jnp.where(valid, K._gather1d(tf_flat, idx), 0))
        tfs = jnp.concatenate([x[:, None, :] for x in tfs], axis=1)
        ltrunc = K.boundary_truncated(score, top_score, M)
        d2, s2, t2, trunc = _merge_gathered(top_docs, top_score, tfs,
                                            ltrunc, T=T, M=M)
        return K.pack_with_flags(d2, t2, trunc.astype(jnp.int32))

    step = shard_map(
        local, mesh=mesh,
        in_specs=(P("d"), P("d"), P(), P()),
        out_specs=P(), check_vma=False)
    return jax.jit(step)


@lru_cache(maxsize=32)
def make_sharded_pruned_dense_kernel(T: int, NB: int, C: int, M: int,
                                     eps3: float, mesh: Mesh):
    """Block-max pruned dense scan on the mesh (kernels module note): each
    shard ranks its OWN NB 128-doc blocks and examines its top C; the
    prune guard runs AFTER the merge against the max of the shards'
    next_ub bounds — exactly the single-device proof with "unexamined
    block" ranging over every shard (a per-shard guard against local
    k-th scores would over-flag shards with few local matches).

    fn(dense_sc (D,H,NB*128), dense_tf, blockmax (D,H,NB), slots (B,T),
       use_score (B,T), ks (B,)) -> packed (B, T+2, M) replicated."""

    def local(dense_sc, dense_tf, blockmax, slots, use_score, ks):
        dsc, dtf, bm = dense_sc[0], dense_tf[0], blockmax[0]
        B = slots.shape[0]
        H = dsc.shape[0]
        sid = jax.lax.axis_index("d").astype(jnp.int32)
        sc_rows = dsc.reshape(H * NB, 128)
        tf_rows = dtf.reshape(H * NB, 128)
        blk, next_ub = K._select_ub_blocks(bm, slots, use_score,
                                           T=T, NB=NB, C=C)
        lane = jnp.arange(128, dtype=jnp.int32)
        cand_local = (blk[:, :, None] * 128 + lane[None, None, :]
                      ).reshape(B, C * 128)
        match = jnp.ones((B, C, 128), dtype=bool)
        score = jnp.zeros((B, C, 128), dtype=jnp.float32)
        payload_tf = []
        for t in range(T):
            rows_idx = slots[:, t : t + 1] * np.int32(NB) + blk
            p = jnp.take(sc_rows, rows_idx, axis=0)  # (B, C, 128)
            payload_tf.append(jnp.take(tf_rows, rows_idx, axis=0))
            match = match & (p > 0)
            score = score + p * use_score[:, t, None, None]
        score = jnp.where(match, score, K.NEG_INF).reshape(B, -1)
        top_score, top_l = jax.lax.top_k(score, M)
        valid = top_score > K.NEG_INF
        loc = jnp.take_along_axis(cand_local, top_l, axis=1)
        top_docs = jnp.where(valid, sid * np.int32(NB * 128) + loc, -1)
        tfs = []
        for t in range(T):
            flat = payload_tf[t].reshape(B, -1)
            tfs.append(jnp.where(valid,
                                 jnp.take_along_axis(flat, top_l, axis=1),
                                 0))
        tfs = jnp.concatenate([x[:, None, :] for x in tfs], axis=1)
        ltrunc = K.boundary_truncated(score, top_score, M)
        d2, s2, t2, trunc = _merge_gathered(top_docs, top_score, tfs,
                                            ltrunc, T=T, M=M)
        g_ub = jax.lax.all_gather(next_ub, "d")  # (D, B)
        bound = jnp.max(g_ub, axis=0)
        flags = (trunc.astype(jnp.int32)
                 | K.prune_guard_flag(s2, bound, ks, M=M, eps3=eps3))
        return K.pack_with_flags(d2, t2, flags)

    step = shard_map(
        local, mesh=mesh,
        in_specs=(P("d"), P("d"), P("d"), P(), P(), P()),
        out_specs=P(), check_vma=False)
    return jax.jit(step)


@lru_cache(maxsize=32)
def make_sharded_semidense_kernel(T: int, L: int, M: int, Npd: int,
                                  n_bs: int, n_bs_iters: int, mesh: Mesh,
                                  M_out: int = None):
    """Mixed semi-dense kernel on the mesh (the single-device
    make_semidense_kernel split by doc range): slot 0 = candidate's LOCAL
    CSR run, slots 1..n_bs = non-dense others by local binary search,
    rest = dense others via one local doc-indexed gather (local index =
    global doc - s*Npd, in range because posting shards and dense slices
    partition on the same 128-aligned grid). Merge as usual.

    fn(pd, psc, pt, ts, dfs (all (D,...)), dense_sc (D,H,Npd), dense_tf,
       rows (B,T) slot-ordered term rows, use_score (B,T),
       slots (B,T) dense rows for slots n_bs+1..) -> packed (B,T+2,M)."""

    def local(pd, psc, pt, ts, dfs, dense_sc, dense_tf, rows, use_score,
              slots):
        pd, psc, pt, ts, dfs = pd[0], psc[0], pt[0], ts[0], dfs[0]
        dsc, dtf = dense_sc[0], dense_tf[0]
        B = rows.shape[0]
        sid = jax.lax.axis_index("d").astype(jnp.int32)
        starts = ts[rows]
        ends = starts + dfs[rows]
        cdocs, cscore, cvalid, cs = K._candidates(pd, psc, starts, ends, L)
        lane = jnp.arange(L, dtype=jnp.int32)
        cpidx = cs[:, None] + lane[None, :]
        match = cvalid
        score = cscore * use_score[:, 0:1]
        if n_bs:
            targets = jnp.broadcast_to(cdocs[:, None, :], (B, n_bs, L))
            lo = K._binary_search(pd, targets, starts[:, 1 : 1 + n_bs, None],
                                  ends[:, 1 : 1 + n_bs, None], n_bs_iters)
            hit = K._gather1d(pd, lo)
            found = (lo < ends[:, 1 : 1 + n_bs, None]) & (hit == targets)
            match = match & jnp.all(found, axis=1)
            partial = jnp.where(found, K._gather1d(psc, lo), 0.0)
            score = score + jnp.sum(
                partial * use_score[:, 1 : 1 + n_bs, None], axis=1)
        sc_flat = dsc.reshape(-1)
        tf_flat = dtf.reshape(-1)
        loc_doc = jnp.clip(cdocs - sid * np.int32(Npd), 0,
                           np.int32(Npd - 1))
        for t in range(1 + n_bs, T):
            idx = (slots[:, t : t + 1].astype(jnp.int32) * np.int32(Npd)
                   + loc_doc)
            p = K._gather1d(sc_flat, idx)  # (B, L)
            match = match & (p > 0)
            score = score + p * use_score[:, t : t + 1]
        score = jnp.where(match, score, K.NEG_INF)
        top_score, top_l = jax.lax.top_k(score, M)
        valid = top_score > K.NEG_INF
        top_docs = jnp.where(valid,
                             jnp.take_along_axis(cdocs, top_l, axis=1), -1)
        top_cpidx = jnp.take_along_axis(cpidx, top_l, axis=1)
        tfs = [jnp.where(valid, K._gather1d(pt, top_cpidx), 0)[:, None, :]]
        for t in range(1, 1 + n_bs):
            top_lo = jnp.take_along_axis(lo[:, t - 1, :], top_l, axis=1)
            tfs.append(jnp.where(valid, K._gather1d(pt, top_lo),
                                 0)[:, None, :])
        top_loc = jnp.take_along_axis(loc_doc, top_l, axis=1)
        for t in range(1 + n_bs, T):
            idx = (slots[:, t : t + 1].astype(jnp.int32) * np.int32(Npd)
                   + top_loc)
            tfs.append(jnp.where(valid, K._gather1d(tf_flat, idx),
                                 0)[:, None, :])
        tfs = jnp.concatenate(tfs, axis=1)
        ltrunc = K.boundary_truncated(score, top_score, M)
        d2, s2, t2, trunc = _merge_gathered(top_docs, top_score, tfs,
                                            ltrunc, T=T, M=M, M_out=M_out)
        return K.pack_with_flags(d2, t2, trunc.astype(jnp.int32))

    step = shard_map(
        local, mesh=mesh,
        in_specs=(P("d"), P("d"), P("d"), P("d"), P("d"), P("d"), P("d"),
                  P(), P(), P()),
        out_specs=P(), check_vma=False)
    return jax.jit(step)


@lru_cache(maxsize=32)
def make_sharded_compact_phrase_kernel(T: int, L: int, KV: int, PP: int,
                                       PW: int, M: int, n_bs_iters: int,
                                       eps3: float, mesh: Mesh,
                                       mode: str = "raw",
                                       avg32: float = 0.0,
                                       M_out: int = None):
    """Sharded fused compact phrase pipeline: per-shard cost-aware
    bi-bloom gate -> KV score compaction -> window verify -> local
    top-k (kernels.compact_phrase_body on the shard's columns), then
    all-gather + flag-OR merge. This closes the round-3 gap where the
    mesh phrase path skipped the bloom gate entirely
    (query_processing.h:796-807; VERDICT r3 item 8): for per-shard
    candidate runs past KV lanes, bloom-failing lanes are proven
    non-matches and the element-gather-heavy verify shrinks to the KV
    best survivors — the same economics as the single-chip compact
    kernel, per shard. FLAG_PRUNE_MISS from the per-shard (KV+1)-th
    bound merges by OR and forces the exact host path (conservative:
    each shard's guard compares against its own kept k-th)."""
    tc_mode = mode == "tc"

    def body(pd, psc, pt, ptc, ts, dfs, pos, pstarts, brows, bbitmap,
             brank, rows, use_score, idf32, slot_of, ks,
             p_slot, p_beg, p_mask, p_act):
        pd, ts, dfs = pd[0], ts[0], dfs[0]
        pos, pstarts = pos[0], pstarts[0]
        brows, bbitmap, brank = brows[0], bbitmap[0], brank[0]
        psc_l = psc[0] if psc is not None else None
        pt_l = pt[0] if pt is not None else None
        ptc_l = ptc[0] if ptc is not None else None
        starts = ts[rows]
        ends = starts + dfs[rows]
        packed, tsc = K.compact_phrase_body(
            pd, psc_l, pt_l, ptc_l,
            np.float32(avg32) if tc_mode else None,
            pos, pstarts, starts, ends, use_score, idf32, slot_of, ks,
            brows, bbitmap, brank, p_slot, p_beg, p_mask, p_act,
            T=T, L=L, KV=KV, PP=PP, PW=PW, M=M,
            n_bs_iters=n_bs_iters, eps3=eps3, tc_mode=tc_mode)
        lflags = packed[:, T + 1, 0]
        d2, s2, t2, flags = _merge_gathered_flags(
            packed[:, 0, :], tsc, packed[:, 1 : T + 1, :], lflags,
            T=T, M=M, M_out=M_out)
        flag_row = jnp.broadcast_to(flags[:, None, None],
                                    (flags.shape[0], 1, M_out or M))
        return jnp.concatenate([d2[:, None, :], t2, flag_row], axis=1)

    if tc_mode:
        def local(pd, ptc, ts, dfs, pos, pstarts, brows, bbitmap, brank,
                  rows, idf32, slot_of, ks, p_slot, p_beg, p_mask, p_act):
            return body(pd, None, None, ptc, ts, dfs, pos, pstarts,
                        brows, bbitmap, brank, rows, None, idf32,
                        slot_of, ks, p_slot, p_beg, p_mask, p_act)
    else:
        def local(pd, psc, pt, ts, dfs, pos, pstarts, brows, bbitmap,
                  brank, rows, use_score, slot_of, ks, p_slot, p_beg,
                  p_mask, p_act):
            return body(pd, psc, pt, None, ts, dfs, pos, pstarts,
                        brows, bbitmap, brank, rows, use_score, None,
                        slot_of, ks, p_slot, p_beg, p_mask, p_act)

    # raw mode shards THREE posting columns (pd, psc, pt) vs tc's two
    # (pd, ptc): 10 sharded operands, not 9 (ADVICE r4: fixed specs
    # crashed every raw-columns compact-phrase dispatch with blooms).
    n_sharded = 9 if tc_mode else 10
    step = shard_map(
        local, mesh=mesh,
        in_specs=(P("d"),) * n_sharded + (P(),) * 8,
        out_specs=P(), check_vma=False)
    return jax.jit(step)


def _merge_gathered_flags(top_docs, top_score, tfs, lflags, *, T, M,
                          M_out=None):
    """Like _merge_gathered, but the per-shard word is a FLAG bitfield
    (tc mode: FLAG_TRUNC | FLAG_TF_SAT), merged by bitwise OR so the
    caller can force the exact path on saturation ALWAYS while treating
    truncation as strict-parity-only (the single-chip _flags_to_force
    contract). M_out: merged output width (see _merge_gathered).
    Returns (d2, s2, t2, flags (B,) int32)."""
    Mo = M_out or M
    g_d = jax.lax.all_gather(top_docs, "d")  # (D, B, M)
    g_s = jax.lax.all_gather(top_score, "d")
    g_t = jax.lax.all_gather(tfs, "d")  # (D, B, T, M)
    g_f = jax.lax.all_gather(lflags, "d")  # (D, B) int32
    D = g_d.shape[0]
    B = top_docs.shape[0]
    gd = jnp.transpose(g_d, (1, 0, 2)).reshape(B, D * M)
    gs = jnp.transpose(g_s, (1, 0, 2)).reshape(B, D * M)
    gt = jnp.transpose(g_t, (1, 2, 0, 3)).reshape(B, T, D * M)
    s2, i2 = jax.lax.top_k(gs, Mo)
    d2 = jnp.take_along_axis(gd, i2, axis=1)
    t2 = jnp.take_along_axis(gt, i2[:, None, :].repeat(T, 1), axis=2)
    flags = g_f[0]
    for s in range(1, D):
        flags = flags | g_f[s]
    flags = flags | (K.boundary_truncated(gs, s2, Mo).astype(jnp.int32)
                     * K.FLAG_TRUNC)
    return d2, s2, t2, flags


@lru_cache(maxsize=64)
def make_sharded_kernel_tc(T: int, L: int, M: int, n_bs_iters: int,
                           mesh: Mesh, avg32: float, M_out: int = None):
    """tc-mode sharded search step: per-shard uint16 tc columns (6 B vs
    12 B/posting of per-shard HBM — the capacity mode config 5 exists
    for); scores reconstructed via kernels.tc_score, FLAG_TF_SAT merged
    across shards so saturated keeps force the exact host path.

    fn(pd (D,Pp), ptc (D,Pp) u16, ts, dfs, rows (B,T) slot order,
       idf32 (B,T) slot order, 0 on pads) ->
       (docs (B,M), score (B,M), tfs (B,T,M), flags (B,)) replicated."""

    def local(pd, ptc, ts, dfs, rows, idf32):
        pd, ptc, ts, dfs = pd[0], ptc[0], ts[0], dfs[0]
        starts = ts[rows]
        ends = starts + dfs[rows]
        td, tsc, ttf, _, lflags = K.search_body(
            pd, None, None, starts, ends, None,
            T=T, L=L, M=M, n_bs_iters=n_bs_iters,
            tc=ptc, idf32=idf32, avg32=np.float32(avg32))
        return _merge_gathered_flags(td, tsc, ttf, lflags, T=T, M=M,
                                     M_out=M_out)

    step = shard_map(
        local, mesh=mesh,
        in_specs=(P("d"), P("d"), P("d"), P("d"), P(), P()),
        out_specs=(P(), P(), P(), P()), check_vma=False)
    return jax.jit(step)


@lru_cache(maxsize=64)
def make_sharded_phrase_kernel_tc(T: int, L: int, PP: int, M: int,
                                  n_bs_iters: int, n_pos_iters: int,
                                  mesh: Mesh, avg32: float,
                                  M_out: int = None):
    """tc-mode sharded phrase step (kernels.phrase_body tc mode per
    shard, flags merged by OR). Output layout matches the raw variant:
    packed (B, T+2, M) with row T+1 = merged flag word."""

    def local(pd, ptc, ts, dfs, pos, pstarts, rows, idf32, slot_of):
        pd, ptc, ts, dfs = pd[0], ptc[0], ts[0], dfs[0]
        pos, pstarts = pos[0], pstarts[0]
        starts = ts[rows]
        ends = starts + dfs[rows]
        packed, tsc = K.phrase_body(
            pd, None, None, pos, pstarts, starts, ends, None, slot_of,
            T=T, L=L, PP=PP, M=M,
            n_bs_iters=n_bs_iters, n_pos_iters=n_pos_iters,
            tc=ptc, idf32=idf32, avg32=np.float32(avg32))
        body, lflags = packed[:, : T + 1, :], packed[:, T + 1, 0]
        d2, s2, t2, flags = _merge_gathered_flags(
            body[:, 0, :], tsc, body[:, 1 : T + 1, :], lflags, T=T, M=M,
            M_out=M_out)
        flag_row = jnp.broadcast_to(flags[:, None, None],
                                    (flags.shape[0], 1, M_out or M))
        return jnp.concatenate([d2[:, None, :], t2, flag_row], axis=1)

    step = shard_map(
        local, mesh=mesh,
        in_specs=(P("d"), P("d"), P("d"), P("d"), P("d"), P("d"),
                  P(), P(), P()),
        out_specs=P(), check_vma=False)
    return jax.jit(step)


@lru_cache(maxsize=32)
def make_sharded_dense_kernel_tc(T: int, Npd: int, M: int, mesh: Mesh,
                                 avg32: float):
    """tc-mode sharded dense scan: per-shard (H, Npd) uint8 TF plane +
    (Npd,) shared len-code slice (the round-4 compressed dense tier,
    doc-partitioned); lanes composed in-register exactly like the
    single-chip make_dense_search_kernel_tc.

    fn(dense_tf8 (D,H,Npd) u8, len_code (D,Npd) u8, slots (B,T),
       idf32 (B,T)) -> packed (B, T+2, M) replicated."""

    def local(dense_tf8, len_code, slots, idf32):
        dtf, lc = dense_tf8[0], len_code[0]
        B = slots.shape[0]
        sid = jax.lax.axis_index("d").astype(jnp.int32)
        code_row = lc.astype(jnp.int32)[None, :] << 8  # (1, Npd)
        score = jnp.zeros((B, Npd), dtype=jnp.float32)
        match = jnp.ones((B, Npd), dtype=bool)
        rows = []
        for t in range(T):
            tf_t = jnp.take(dtf, slots[:, t], axis=0).astype(jnp.int32)
            tc_t = jnp.where(tf_t > 0, code_row | tf_t, 0)
            rows.append(tc_t)
            match = match & (tc_t > 0)
            score = score + K.tc_score(tc_t, idf32[:, t : t + 1],
                                       np.float32(avg32))
        score = jnp.where(match, score, K.NEG_INF)
        top_score, top_l = jax.lax.top_k(score, M)  # lane = LOCAL doc
        valid = top_score > K.NEG_INF
        top_docs = jnp.where(valid, sid * np.int32(Npd) + top_l, -1)
        sat = jnp.zeros((B,), dtype=bool)
        tfs = []
        for t in range(T):
            top_t = jnp.take_along_axis(rows[t], jnp.maximum(top_l, 0),
                                        axis=1)
            sat = sat | K.tc_saturated(top_t, top_docs)
            tfs.append(jnp.where(valid, top_t & 0xFF, 0))
        tfs = jnp.concatenate([x[:, None, :] for x in tfs], axis=1)
        lflags = (K.boundary_truncated(score, top_score, M).astype(jnp.int32)
                  | sat.astype(jnp.int32) * K.FLAG_TF_SAT)
        d2, s2, t2, flags = _merge_gathered_flags(top_docs, top_score,
                                                  tfs, lflags, T=T, M=M)
        return K.pack_with_flags(d2, t2, flags)

    step = shard_map(
        local, mesh=mesh,
        in_specs=(P("d"), P("d"), P(), P()),
        out_specs=P(), check_vma=False)
    return jax.jit(step)


@lru_cache(maxsize=32)
def make_sharded_pruned_dense_kernel_tc(T: int, NB: int, C: int, M: int,
                                        eps3: float, mesh: Mesh,
                                        avg32: float):
    """tc-mode block-max pruned dense scan on the mesh: per-shard uint8
    TF plane + len-code slice composed per selected block; blockmax is
    the host-side f64-safe mirror (x(1+2e-6)) so the ub dominates the
    in-kernel f32 reconstruction. Guard runs after the merge against the
    max of the shards' next_ub (same proof as the raw mesh variant).

    fn(dense_tf8 (D,H,NB*128) u8, len_code (D,NB*128) u8,
       blockmax (D,H,NB) f32, slots (B,T), idf32 (B,T), ks (B,))
       -> packed (B, T+2, M) replicated."""

    def local(dense_tf8, len_code, blockmax, slots, idf32, ks):
        dtf, lc, bm = dense_tf8[0], len_code[0], blockmax[0]
        B = slots.shape[0]
        H = dtf.shape[0]
        sid = jax.lax.axis_index("d").astype(jnp.int32)
        tf_rows = dtf.reshape(H * NB, 128)
        len_rows = lc.reshape(NB, 128)
        weights = (idf32 > 0).astype(jnp.float32)
        blk, next_ub = K._select_ub_blocks(bm, slots, weights,
                                           T=T, NB=NB, C=C)
        lane = jnp.arange(128, dtype=jnp.int32)
        cand_local = (blk[:, :, None] * 128 + lane[None, None, :]
                      ).reshape(B, C * 128)
        match = jnp.ones((B, C, 128), dtype=bool)
        score = jnp.zeros((B, C, 128), dtype=jnp.float32)
        payload_tc = []
        for t in range(T):
            rows_idx = slots[:, t : t + 1] * np.int32(NB) + blk
            tf = jnp.take(tf_rows, rows_idx, axis=0).astype(jnp.int32)
            code = jnp.take(len_rows, blk, axis=0).astype(jnp.int32) << 8
            p = jnp.where(tf > 0, code | tf, 0)  # (B, C, 128) tc int
            payload_tc.append(p)
            match = match & (p > 0)
            score = score + K.tc_score(p, idf32[:, t, None, None],
                                       np.float32(avg32))
        score = jnp.where(match, score, K.NEG_INF).reshape(B, -1)
        top_score, top_l = jax.lax.top_k(score, M)
        valid = top_score > K.NEG_INF
        loc = jnp.take_along_axis(cand_local, top_l, axis=1)
        top_docs = jnp.where(valid, sid * np.int32(NB * 128) + loc, -1)
        sat = jnp.zeros((B,), dtype=bool)
        tfs = []
        for t in range(T):
            flat = payload_tc[t].reshape(B, -1)
            top_tc = jnp.take_along_axis(flat, top_l, axis=1)
            sat = sat | K.tc_saturated(top_tc, top_docs)
            tfs.append(jnp.where(valid, top_tc & 0xFF, 0))
        tfs = jnp.concatenate([x[:, None, :] for x in tfs], axis=1)
        lflags = (K.boundary_truncated(score, top_score, M)
                  .astype(jnp.int32)
                  | sat.astype(jnp.int32) * K.FLAG_TF_SAT)
        d2, s2, t2, flags = _merge_gathered_flags(top_docs, top_score,
                                                  tfs, lflags, T=T, M=M)
        g_ub = jax.lax.all_gather(next_ub, "d")  # (D, B)
        bound = jnp.max(g_ub, axis=0)
        flags = flags | K.prune_guard_flag(s2, bound, ks, M=M, eps3=eps3)
        return K.pack_with_flags(d2, t2, flags)

    step = shard_map(
        local, mesh=mesh,
        in_specs=(P("d"), P("d"), P("d"), P(), P(), P()),
        out_specs=P(), check_vma=False)
    return jax.jit(step)


@lru_cache(maxsize=32)
def make_sharded_semidense_kernel_tc(T: int, L: int, M: int, Npd: int,
                                     n_bs: int, n_bs_iters: int,
                                     mesh: Mesh, avg32: float,
                                     M_out: int = None):
    """tc-mode mixed semi-dense kernel on the mesh: candidate + bs others
    read the per-shard uint16 tc column; dense others gather the uint8 TF
    plane and recompose the tc lane from the candidate's own len code
    (same doc — the single-chip make_semidense_kernel_tc trick), costing
    zero extra gathers.

    fn(pd, ptc, ts, dfs (all (D,...)), dense_tf8 (D,H,Npd) u8,
       rows (B,T) slot-ordered, idf32 (B,T) slot order, slots (B,T))
       -> packed (B, T+2, M) replicated."""

    def local(pd, ptc, ts, dfs, dense_tf8, rows, idf32, slots):
        pd, ptc, ts, dfs = pd[0], ptc[0], ts[0], dfs[0]
        dtf = dense_tf8[0]
        B = rows.shape[0]
        sid = jax.lax.axis_index("d").astype(jnp.int32)
        starts = ts[rows]
        ends = starts + dfs[rows]
        cdocs, ctc, cvalid, cs = K._candidates(pd, ptc, starts, ends, L)
        ctc = ctc.astype(jnp.int32)
        lane = jnp.arange(L, dtype=jnp.int32)
        cpidx = cs[:, None] + lane[None, :]
        match = cvalid
        score = K.tc_score(ctc, idf32[:, 0:1], np.float32(avg32))
        sat_lane = (ctc & 0xFF) >= K.TF_SAT
        if n_bs:
            targets = jnp.broadcast_to(cdocs[:, None, :], (B, n_bs, L))
            lo = K._binary_search(pd, targets, starts[:, 1 : 1 + n_bs, None],
                                  ends[:, 1 : 1 + n_bs, None], n_bs_iters)
            hit = K._gather1d(pd, lo)
            found = (lo < ends[:, 1 : 1 + n_bs, None]) & (hit == targets)
            match = match & jnp.all(found, axis=1)
            hit_tc = K._gather1d(ptc, lo).astype(jnp.int32)
            score = score + jnp.sum(
                jnp.where(found,
                          K.tc_score(hit_tc, idf32[:, 1 : 1 + n_bs, None],
                                     np.float32(avg32)), 0.0), axis=1)
            sat_lane = sat_lane | jnp.any(
                found & ((hit_tc & 0xFF) >= K.TF_SAT), axis=1)
            bs_tc = [hit_tc[:, t - 1, :] for t in range(1, 1 + n_bs)]
        else:
            bs_tc = []
        tf_flat = dtf.reshape(-1)
        ccode = ctc & 0xFF00  # lane doc's len code, pre-shifted
        loc_doc = jnp.clip(cdocs - sid * np.int32(Npd), 0,
                           np.int32(Npd - 1))
        dense_tc = []
        for t in range(1 + n_bs, T):
            idx = (slots[:, t : t + 1].astype(jnp.int32) * np.int32(Npd)
                   + loc_doc)
            p_tf = K._gather1d(tf_flat, idx).astype(jnp.int32)  # (B, L)
            p_tc = jnp.where(p_tf > 0, ccode | p_tf, 0)
            dense_tc.append(p_tc)
            match = match & (p_tc > 0)
            score = score + K.tc_score(p_tc, idf32[:, t : t + 1],
                                       np.float32(avg32))
            sat_lane = sat_lane | (p_tf >= K.TF_SAT)
        score = jnp.where(match, score, K.NEG_INF)
        top_score, top_l = jax.lax.top_k(score, M)
        valid = top_score > K.NEG_INF
        top_docs = jnp.where(valid,
                             jnp.take_along_axis(cdocs, top_l, axis=1), -1)
        all_tc = [ctc] + bs_tc + dense_tc
        sat = jnp.any(jnp.take_along_axis(sat_lane, top_l, axis=1) & valid,
                      axis=1)
        tfs = []
        for t in range(T):
            top_tc = jnp.take_along_axis(all_tc[t], top_l, axis=1)
            tfs.append(jnp.where(valid, top_tc & 0xFF, 0)[:, None, :])
        tfs = jnp.concatenate(tfs, axis=1)
        lflags = (K.boundary_truncated(score, top_score, M)
                  .astype(jnp.int32)
                  | sat.astype(jnp.int32) * K.FLAG_TF_SAT)
        d2, s2, t2, flags = _merge_gathered_flags(top_docs, top_score,
                                                  tfs, lflags, T=T, M=M,
                                                  M_out=M_out)
        return K.pack_with_flags(d2, t2, flags)

    step = shard_map(
        local, mesh=mesh,
        in_specs=(P("d"), P("d"), P("d"), P("d"), P("d"), P(), P(), P()),
        out_specs=P(), check_vma=False)
    return jax.jit(step)


def host_exact_search_sharded(sh: ShardedIndex, cache64: np.ndarray,
                              rows, k: int, is_phrase: bool = False):
    """Exact host re-search over the sharded host columns (the fallback
    when no source PackedIndex is retained). Shards hold contiguous
    ascending doc ranges, so per-shard results concatenate in doc order
    and the final lexsort reproduces the oracle tie canon."""
    from wiser_tpu.scoring import K1

    docs_parts, tf_parts = [], []
    for s in range(sh.n_shards):
        dfs = [int(sh.df_shard[s, r]) for r in rows]
        if min(dfs) == 0:
            continue
        cand = int(np.argmin(dfs))
        cs = int(sh.term_starts[s, rows[cand]])
        docs = sh.postings_doc[s, cs : cs + dfs[cand]].astype(np.int64)
        mask = np.ones(len(docs), dtype=bool)
        tfs = np.zeros((len(rows), len(docs)), dtype=np.int64)
        pidx = np.zeros((len(rows), len(docs)), dtype=np.int64)
        for t, r in enumerate(rows):
            st, n = int(sh.term_starts[s, r]), dfs[t]
            arr = sh.postings_doc[s, st : st + n]
            idx = np.searchsorted(arr, docs)
            idc = np.minimum(idx, n - 1)
            found = (idx < n) & (arr[idc] == docs)
            mask &= found
            tfs[t] = sh.postings_tf[s, st + idc]
            pidx[t] = st + idc
        if is_phrase and len(rows) >= 2:
            from wiser_tpu.engine.device import _host_phrase_mask

            mask &= _host_phrase_mask(sh.positions[s], sh.pos_starts[s],
                                      docs, pidx, mask, len(rows))
        docs_parts.append(docs[mask])
        tf_parts.append(tfs[:, mask])
    if not docs_parts:
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.float64)
    docs_m = np.concatenate(docs_parts)
    tfs_m = np.concatenate(tf_parts, axis=1).astype(np.float64)
    if docs_m.size == 0:
        return docs_m, np.zeros(0, dtype=np.float64)
    cache_val = cache64[sh.doc_len_code[docs_m] & 0xFF]
    score = np.zeros(docs_m.size, dtype=np.float64)
    for t, r in enumerate(rows):
        idf = np.float64(sh.idf64[r])
        f = tfs_m[t]
        score = score + idf * ((f * (K1 + 1)) / (f + cache_val))
    order = np.lexsort((docs_m, -score))[:k]
    return docs_m[order], score[order]


class ShardedEngine:
    """Search over a ShardedIndex on a device mesh: single-term, AND, and
    phrase queries (phrase runs the full local pipeline per shard —
    positional verification is doc-local — then merges; the bi-bloom gate
    is skipped on the sharded path, which never changes results).

    Bit-parity hardening mirrors TpuEngine: the f32 tie-class truncation
    guard flags suspect queries for an exact host re-search; queries whose
    per-shard candidate run exceeds the largest L bucket route to host;
    snippets resolve offsets through the retained source index."""

    def __init__(
        self,
        sharded: ShardedIndex,
        mesh: Optional[Mesh] = None,
        margin: int = DEFAULT_MARGIN,
        doc_bodies: Optional[List[str]] = None,
        strict_parity: bool = False,
        dense_budget_bytes: int = 7 << 29,
        single_term_depth: int = 64,
        columns: str = "raw",
    ):
        if mesh is None:
            devs = np.array(jax.devices()[: sharded.n_shards])
            mesh = Mesh(devs, ("d",))
        if mesh.devices.size != sharded.n_shards:
            raise ValueError(
                f"mesh has {mesh.devices.size} devices, index has "
                f"{sharded.n_shards} shards"
            )
        if columns not in ("raw", "tc"):
            raise ValueError(f"unknown columns mode {columns!r}")
        self.columns = columns
        self.mesh = mesh
        self.sharded = sharded
        self.margin = margin
        self.similarity = Bm25Similarity(sharded.avg_len)
        self.cache64 = self.similarity.cache
        self.term_to_row = {t: i for i, t in enumerate(sharded.terms)}
        self._avg32 = float(np.float32(sharded.avg_len))
        # widened guard epsilon for in-kernel score reconstruction
        # (device.py rel_eps note)
        self.rel_eps = 1e-5 if columns == "tc" else 1e-6

        shard_spec = NamedSharding(mesh, P("d"))
        self.d_postings_doc = jax.device_put(sharded.postings_doc, shard_spec)
        if columns == "tc":
            # per-shard compressed column: (doc_len_code << 8 | min(tf,
            # 255)), 0 on SENTINEL pads — 6 B/posting of per-shard HBM
            # instead of 12 (the single-chip tc layout, doc-partitioned;
            # packed_value.h:87-274 is the reference's analog)
            from wiser_tpu.index.format import SENTINEL_DOC

            real = sharded.postings_doc != SENTINEL_DOC
            docs_safe = np.where(real, sharded.postings_doc, 0)
            tc_col = np.where(
                real,
                (sharded.doc_len_code[docs_safe].astype(np.uint16) << 8)
                | np.minimum(sharded.postings_tf, K.TF_SAT).astype(np.uint16),
                np.uint16(0))
            self.d_postings_tc = jax.device_put(tc_col, shard_spec)
            self.d_postings_score = None
            self.d_postings_tf = None
        else:
            self.d_postings_score = jax.device_put(sharded.postings_score,
                                                   shard_spec)
            self.d_postings_tf = jax.device_put(sharded.postings_tf,
                                                shard_spec)
        self.d_term_starts = jax.device_put(sharded.term_starts, shard_spec)
        self.d_df_shard = jax.device_put(sharded.df_shard, shard_spec)
        self.d_positions = jax.device_put(sharded.positions, shard_spec)
        self.d_pos_starts = jax.device_put(sharded.pos_starts, shard_spec)
        # per-shard sparse folded bi-bloom columns (the single-chip
        # _build_bloom_sparse layout, one fold per shard) — enables the
        # cost-aware bloom gate on the sharded compact phrase path
        self.d_bloom_rows = None
        if sharded.bloom_ends is not None:
            from wiser_tpu.engine.device import TpuEngine as _T

            D = sharded.n_shards
            P_pad = sharded.postings_doc.shape[1]
            gate_term = sharded.df <= _T.BLOOM_DF_CEILING
            rows_all, bitmap_all, rank_all = [], [], []
            for s in range(D):
                ts_s = sharded.term_starts[s]
                lens = np.diff(ts_s)
                gate = np.zeros(P_pad, dtype=bool)
                gate[: int(ts_s[-1])] = np.repeat(gate_term, lens)
                rows_parts, bitmap_parts, rank_parts = [], [], []
                base = 0
                for side in (sharded.bloom_ends[s], sharded.bloom_begins[s]):
                    fold = side[:, 0].copy()
                    for w in range(1, side.shape[1]):
                        np.bitwise_or(fold, side[:, w], out=fold)
                    stored = (fold != 0) & gate
                    rows_parts.append(fold[stored])
                    bitmap_parts.append(
                        np.packbits(stored, bitorder="little").view("<u4"))
                    cnt = stored.reshape(-1, 32).sum(axis=1)
                    rank = np.zeros(len(cnt), dtype=np.int64)
                    np.cumsum(cnt[:-1], out=rank[1:])
                    rank_parts.append((rank + base).astype(np.int32))
                    base += int(stored.sum())
                rows_all.append(np.concatenate(rows_parts) if base
                                else np.zeros(1, dtype=np.uint32))
                bitmap_all.append(np.concatenate(bitmap_parts))
                rank_all.append(np.concatenate(rank_parts))
            nnz_max = max(1, max(len(r) for r in rows_all))
            rows_stk = np.zeros((D, nnz_max), dtype=np.uint32)
            for s, r in enumerate(rows_all):
                rows_stk[s, : len(r)] = r
            self.d_bloom_rows = jax.device_put(rows_stk, shard_spec)
            self.d_bloom_bitmap = jax.device_put(
                np.stack(bitmap_all), shard_spec)
            self.d_bloom_rank = jax.device_put(
                np.stack(rank_all), shard_spec)
        self._max_df = int(sharded.df.max(initial=1))
        self._max_tf = int(sharded.max_tf.max(initial=1)) \
            if sharded.max_tf is not None else 1
        self.doc_bodies = doc_bodies
        self.strict_parity = strict_parity
        # per-shard max df per term: the tight L bucket + saturation check
        self._df_shard_max = sharded.df_shard.max(axis=0).astype(np.int64)

        # single-chip feature parity on the mesh (round-3): dense doc-
        # space tier (split on the shard doc grid), block-max pruning,
        # mixed semi-dense route, host impact table, request coalescing.
        # All need the global column view — retained in sharded.source;
        # without it (exotic hand-built ShardedIndex) the engine falls
        # back to the plain bs route, results identical.
        D = sharded.n_shards
        from wiser_tpu.index.format import BLOCK

        self._npd = ((sharded.n_docs + D * BLOCK - 1) // (D * BLOCK)
                     * BLOCK)
        self._dense_H = 0
        self._dense_slot = np.full(len(sharded.df), -1, dtype=np.int32)
        self._tt = None
        src = sharded.source
        if src is not None:
            scores64 = src.partial_scores(self.cache64)
            if dense_budget_bytes:
                self._build_dense_rows(src, scores64, dense_budget_bytes)
            if single_term_depth:
                from wiser_tpu.engine.device import build_single_term_table

                self._tt = build_single_term_table(src, scores64,
                                                   single_term_depth)
        self._st_depth = single_term_depth

    # same tier constants as the single-device engine (device.py)
    DENSE_MIN_DF_FRACTION = 96
    DENSE_MIN_DF_FLOOR = 1024
    PRUNED_DENSE_MIN_NB = 2048
    PRUNED_DENSE_C = 512

    def _build_dense_rows(self, src: PackedIndex, scores64: np.ndarray,
                          budget_bytes: int) -> None:
        """Dense (H, D*Npd) head-term rows split on the shard doc grid ->
        (D, H, Npd) device arrays sharded on axis 0 (the single-device
        tier of device.py _build_dense_rows, partitioned by doc range)."""
        sh = self.sharded
        n, D = sh.n_docs, sh.n_shards
        dense_min = max(self.DENSE_MIN_DF_FLOOR,
                        n // self.DENSE_MIN_DF_FRACTION)
        rows = np.nonzero(sh.df >= dense_min)[0]
        if len(rows) == 0:
            return
        N_pad = self._npd * D
        row_bytes = 1 if self.columns == "tc" else 8
        cap = max(1, int(budget_bytes // (N_pad * row_bytes)))
        if len(rows) > cap:
            rows = rows[np.argsort(sh.df[rows])[::-1][:cap]]
        H = len(rows)
        lens = np.diff(src.term_starts)
        shard_spec = NamedSharding(self.mesh, P("d"))
        if self.columns == "tc":
            # compressed tier (device.py round-4 layout): uint8 TF plane
            # + shared per-doc len-code row, composed in-kernel; blockmax
            # is the f64-safe mirror of the reconstructed score
            from wiser_tpu.engine.device import _tc_score64_ub

            dense_tf8 = np.zeros((H, N_pad), dtype=np.uint8)
            len_code = np.zeros(N_pad, dtype=np.uint8)
            len_code[: sh.n_docs] = sh.doc_len_code[: sh.n_docs]
            for slot, r in enumerate(rows.tolist()):
                s = int(src.term_starts[r])
                m = min(int(src.df[r]), int(lens[r]))
                docs = src.postings_doc[s : s + m]
                dense_tf8[slot, docs] = np.minimum(
                    src.postings_tf[s : s + m], K.TF_SAT).astype(np.uint8)
                self._dense_slot[r] = slot
            self._dense_H = H
            NBg = N_pad // BLOCK
            bm = np.zeros((H, NBg), dtype=np.float32)
            idf32_rows = sh.idf64[rows].astype(np.float32)
            code16 = len_code.astype(np.uint16) << 8
            for h0 in range(0, H, 8):
                h1 = min(h0 + 8, H)
                tc_chunk = np.where(dense_tf8[h0:h1] > 0,
                                    code16[None, :] | dense_tf8[h0:h1],
                                    np.uint16(0))
                ub = _tc_score64_ub(
                    tc_chunk, idf32_rows[h0:h1, None].astype(np.float64),
                    self._avg32)
                bm[h0:h1] = ub.reshape(h1 - h0, NBg, BLOCK).max(axis=2)
            self.d_dense_tf8 = jax.device_put(
                np.ascontiguousarray(
                    dense_tf8.reshape(H, D, self._npd).transpose(1, 0, 2)),
                shard_spec)
            self.d_len_code = jax.device_put(
                np.ascontiguousarray(len_code.reshape(D, self._npd)),
                shard_spec)
            self.d_dense_blockmax = jax.device_put(
                np.ascontiguousarray(
                    bm.reshape(H, D, self._npd // BLOCK).transpose(1, 0, 2)),
                shard_spec)
            return
        scores32 = scores64.astype(np.float32)
        dense_sc = np.zeros((H, N_pad), dtype=np.float32)
        dense_tf = np.zeros((H, N_pad), dtype=np.int32)
        for slot, r in enumerate(rows.tolist()):
            s = int(src.term_starts[r])
            m = min(int(src.df[r]), int(lens[r]))
            docs = src.postings_doc[s : s + m]
            dense_sc[slot, docs] = scores32[s : s + m]
            dense_tf[slot, docs] = src.postings_tf[s : s + m]
            self._dense_slot[r] = slot
        self._dense_H = H
        NBg = N_pad // BLOCK
        blockmax = dense_sc.reshape(H, NBg, BLOCK).max(axis=2)
        self.d_dense_sc = jax.device_put(
            np.ascontiguousarray(
                dense_sc.reshape(H, D, self._npd).transpose(1, 0, 2)),
            shard_spec)
        self.d_dense_tf = jax.device_put(
            np.ascontiguousarray(
                dense_tf.reshape(H, D, self._npd).transpose(1, 0, 2)),
            shard_spec)
        self.d_dense_blockmax = jax.device_put(
            np.ascontiguousarray(
                blockmax.reshape(H, D, self._npd // BLOCK)
                .transpose(1, 0, 2)),
            shard_spec)

    def _serve_single_term(self, qi: int, row: int, q: SearchQuery,
                           results) -> bool:
        """Host impact-table answer (device.py analog); False = deeper
        than the table, go through the device path."""
        tt_starts, tt_docs, tt_scores = self._tt
        s, e = int(tt_starts[row]), int(tt_starts[row + 1])
        cnt = e - s
        if q.n_results > cnt and int(self.sharded.df[row]) > cnt:
            return False
        take = min(q.n_results, cnt)
        self._fill_result(results[qi], tt_docs[s : s + take],
                          tt_scores[s : s + take], [row], q)
        return True

    def lookup(self, term: str) -> int:
        return self.term_to_row.get(term, -1)

    def search(self, query: SearchQuery) -> SearchResult:
        return self.search_batch([query])[0]

    # -- exact host fallback -------------------------------------------

    def _host_exact(self, rows, k: int, is_phrase: bool):
        if self.sharded.source is not None:
            from wiser_tpu.engine.device import host_exact_search

            return host_exact_search(self.sharded.source, self.cache64,
                                     rows, k, is_phrase=is_phrase)
        return host_exact_search_sharded(self.sharded, self.cache64,
                                         rows, k, is_phrase=is_phrase)

    def _fill_result(self, res: SearchResult, docs, scores, rows,
                     q: SearchQuery) -> None:
        res.set_arrays(docs, scores)
        if (q.return_snippets and self.doc_bodies is not None
                and self.sharded.source is not None):
            from wiser_tpu.engine.device import snippet_for

            for e in res.entries:
                e.snippet = snippet_for(self.sharded.source, self.doc_bodies,
                                        rows, q, e.doc_id)

    def _route_saturated(self, items, is_phrase: bool):
        """Queries whose per-shard candidate run exceeds the largest L
        bucket would silently scan only the first L postings: exact host
        path instead (mirrors TpuEngine._route_saturated)."""
        keep, over = [], []
        for item in items:
            _, rows, _ = item
            cand = rows[int(np.argmin([self.sharded.df[r] for r in rows]))]
            (over if int(self._df_shard_max[cand]) > L_BUCKETS[-1]
             else keep).append(item)
        if not over:
            return items, []

        def run_host(res_list, over=over, is_phrase=is_phrase):
            for qi, rows, q in over:
                d, s = self._host_exact(rows, q.n_results, is_phrase)
                self._fill_result(res_list[qi], d, s, rows, q)

        return keep, [run_host]

    # compact phrase pipeline engages when the per-shard candidate run
    # exceeds this many lanes (the single-chip PRUNED_PHRASE_KV analog)
    PHRASE_COMPACT_KV = 1024
    BLOOM_ENABLE_FACTOR = 1

    def _assemble_bloom_probes(self, group, T: int, B: int, slot_of):
        """Folded probe assembly for the sharded bloom gate (the
        single-chip TpuEngine._assemble_bloom_probes, with the same
        cost-aware side selection, query_processing.h:796-807). group
        items are (qi, rows, q); slot_of maps query-term order to kernel
        slots."""
        from wiser_tpu.engine.device import TpuEngine as _T

        sh = self.sharded
        cfg = sh.source.bloom_cfg if sh.source is not None else None
        C = max(1, T - 1)
        probe_slot = np.zeros((B, C), dtype=np.int32)
        probe_begins = np.zeros((B, C), dtype=bool)
        probe_mask = np.zeros((B, C), dtype=np.uint32)
        probe_active = np.zeros((B, C), dtype=bool)
        factor = self.BLOOM_ENABLE_FACTOR
        ceil = _T.BLOOM_DF_CEILING
        if cfg is not None:
            for i, (qi, rows, q) in enumerate(group):
                terms = q.terms
                dfs = [int(sh.df[r]) for r in rows]
                slot = slot_of[i]
                if len(rows) == 2:
                    s1, s2 = dfs
                    if factor * s1 <= s2 and s1 <= ceil:
                        probe_slot[i, 0] = slot[0]
                        probe_begins[i, 0] = False
                        probe_mask[i, 0] = cfg.probe_mask_folded(terms[1])
                        probe_active[i, 0] = True
                    elif factor * s2 < s1 and s2 <= ceil:
                        probe_slot[i, 0] = slot[1]
                        probe_begins[i, 0] = True
                        probe_mask[i, 0] = cfg.probe_mask_folded(terms[0])
                        probe_active[i, 0] = True
                else:
                    for c in range(len(rows) - 1):
                        if dfs[c] > ceil:
                            continue
                        probe_slot[i, c] = slot[c]
                        probe_begins[i, c] = False
                        probe_mask[i, c] = cfg.probe_mask_folded(terms[c + 1])
                        probe_active[i, c] = True
        return (probe_slot, probe_begins, probe_mask, probe_active)

    def _run_phrase(self, phrase, results) -> list:
        if not phrase:
            return []
        from wiser_tpu.engine.device import PP_BUCKETS

        phrase, pending = self._route_saturated(phrase, is_phrase=True)
        repl = NamedSharding(self.mesh, P())
        groups: Dict[Tuple[int, int, int, int], list] = {}
        for qi, rows, q in phrase:
            T = len(rows)  # exact T (no slot padding for phrase)
            # slot 0 scans the global-min-df term; L covers its longest
            # per-shard run (not the global df — ~n_shards x tighter)
            cand = rows[int(np.argmin([self.sharded.df[r] for r in rows]))]
            L = _bucket(int(self._df_shard_max[cand]), L_BUCKETS)
            PP = _bucket(int(self.sharded.max_tf[rows[0]]), PP_BUCKETS)
            PW = _bucket(max(int(self.sharded.max_tf[r]) for r in rows),
                         PP_BUCKETS)
            groups.setdefault((T, L, PP, PW), []).append((qi, rows, q))

        for (T, L, PP, PW), group in groups.items():
            B = _bucket(len(group), B_BUCKETS)
            rows_arr = np.zeros((B, T), dtype=np.int32)
            use_score = np.zeros((B, T), dtype=np.float32)
            idf32_s = np.zeros((B, T), dtype=np.float32)
            idf64_q = np.zeros((B, T), dtype=np.float64)
            slot_of = np.zeros((B, T), dtype=np.int32)
            ks = np.zeros(B, dtype=np.int32)
            for i, (qi, rows, q) in enumerate(group):
                dfs = [int(self.sharded.df[r]) for r in rows]
                cand = int(np.argmin(dfs))
                order = [cand] + [t for t in range(len(rows)) if t != cand]
                ks[i] = q.n_results
                for slot, t in enumerate(order):
                    rows_arr[i, slot] = rows[t]
                    use_score[i, slot] = 1.0
                    idf32_s[i, slot] = np.float32(
                        self.sharded.idf64[rows[t]])
                    slot_of[i, t] = slot
                for t, r in enumerate(rows):
                    idf64_q[i, t] = self.sharded.idf64[r]
            M = min(L, int(ks.max(initial=1)) + self.margin)
            # merged output must cover k even when each shard's local
            # buffer is smaller (deep-k truncation fix, round 4)
            Mo = min(int(ks.max(initial=1)) + self.margin,
                     M * self.sharded.n_shards)
            compact = (self.d_bloom_rows is not None
                       and L > self.PHRASE_COMPACT_KV)
            if compact:
                # cost-aware bi-bloom gate + KV compaction per shard
                # (the single-chip compact pipeline, sharded — round 4)
                KV = self.PHRASE_COMPACT_KV
                Mc = min(KV, int(ks.max(initial=1)) + self.margin)
                Moc = min(int(ks.max(initial=1)) + self.margin,
                          Mc * self.sharded.n_shards)
                probes = self._assemble_bloom_probes(group, T,
                                                     rows_arr.shape[0],
                                                     slot_of)
                eps3 = 3.0 * self.rel_eps
                kern = make_sharded_compact_phrase_kernel(
                    T, L, KV, PP, PW, Mc, K.n_iters_for(self._max_df),
                    eps3, self.mesh,
                    mode=self.columns, avg32=self._avg32, M_out=Moc)
                pr = tuple(jax.device_put(p, repl) for p in probes)
                if self.columns == "tc":
                    out = kern(self.d_postings_doc, self.d_postings_tc,
                               self.d_term_starts, self.d_df_shard,
                               self.d_positions, self.d_pos_starts,
                               self.d_bloom_rows, self.d_bloom_bitmap,
                               self.d_bloom_rank,
                               jax.device_put(rows_arr, repl),
                               jax.device_put(idf32_s, repl),
                               jax.device_put(slot_of, repl),
                               jax.device_put(ks, repl), *pr)
                else:
                    out = kern(self.d_postings_doc, self.d_postings_score,
                               self.d_postings_tf, self.d_term_starts,
                               self.d_df_shard,
                               self.d_positions, self.d_pos_starts,
                               self.d_bloom_rows, self.d_bloom_bitmap,
                               self.d_bloom_rank,
                               jax.device_put(rows_arr, repl),
                               jax.device_put(use_score, repl),
                               jax.device_put(slot_of, repl),
                               jax.device_put(ks, repl), *pr)
            elif self.columns == "tc":
                kern = make_sharded_phrase_kernel_tc(
                    T, L, PP, M, K.n_iters_for(self._max_df),
                    K.n_iters_for(self._max_tf), self.mesh, self._avg32,
                    M_out=Mo)
                out = kern(
                    self.d_postings_doc, self.d_postings_tc,
                    self.d_term_starts, self.d_df_shard,
                    self.d_positions, self.d_pos_starts,
                    jax.device_put(rows_arr, repl),
                    jax.device_put(idf32_s, repl),
                    jax.device_put(slot_of, repl),
                )
            else:
                kern = make_sharded_phrase_kernel(
                    T, L, PP, M, K.n_iters_for(self._max_df),
                    K.n_iters_for(self._max_tf), self.mesh, M_out=Mo)
                out = kern(
                    self.d_postings_doc, self.d_postings_score,
                    self.d_postings_tf, self.d_term_starts, self.d_df_shard,
                    self.d_positions, self.d_pos_starts,
                    jax.device_put(rows_arr, repl),
                    jax.device_put(use_score, repl),
                    jax.device_put(slot_of, repl),
                )

            def finalize(res_list, out=out, group=group, T=T,
                         slot_of=slot_of, idf64_q=idf64_q, ks=ks):
                merged = np.asarray(out)
                flags = merged[:, T + 1, 0]
                self._finalize_group(
                    res_list, merged[:, 0, :], merged[:, 1 : T + 1, :],
                    group, slot_of, idf64_q, ks, is_phrase=True,
                    force_host=(flags & K.FLAG_TRUNC) != 0,
                    # compact path: an unverified-lane bound miss
                    # (FLAG_PRUNE_MISS) must force the exact path
                    force_always=(flags & (K.FLAG_TF_SAT
                                           | K.FLAG_PRUNE_MISS
                                           | K.FLAG_OVERFLOW)) != 0)

            pending.append(finalize)
        return pending

    def _finalize_group(self, results, docs, tfs_slot, group, slot_of,
                        idf64_q, ks, is_phrase: bool,
                        force_host=None, force_always=None) -> None:
        """Exact f64 re-rank + tie-class truncation guard + snippets —
        the sharded mirror of TpuEngine._finalize_arrays. force_host
        (boundary-class truncation) forces only under strict_parity;
        force_always (prune-guard misses etc.) always forces."""
        from wiser_tpu.engine.topk import (rescore_sorted_arrays,
                                           truncation_suspects)

        tf_q = np.take_along_axis(
            tfs_slot,
            np.broadcast_to(slot_of[:, :, None].astype(np.int64),
                            tfs_slot.shape), axis=1)
        docs_f, score_f, n_valid = rescore_sorted_arrays(
            docs, tf_q, idf64_q, self.sharded.doc_len_code, self.cache64)
        suspects = truncation_suspects(score_f, n_valid, ks,
                                       rel_eps=self.rel_eps)
        if force_host is not None and self.strict_parity:
            suspects = suspects | force_host[: len(suspects)]
        if force_always is not None:
            suspects = suspects | force_always[: len(suspects)]
        for i, (qi, rows, q) in enumerate(group):
            if suspects[i]:
                d, s = self._host_exact(rows, int(ks[i]), is_phrase)
                self._fill_result(results[qi], d, s, rows, q)
            else:
                cnt = min(int(ks[i]), int(n_valid[i]))
                self._fill_result(results[qi], docs_f[i, :cnt],
                                  score_f[i, :cnt], rows, q)

    def search_batch(self, queries: List[SearchQuery]) -> List[SearchResult]:
        results, pending = self.submit_batch(queries)
        for f in pending:
            f(results)
        return results

    def submit_batch(self, queries: List[SearchQuery]):
        """Dispatch every group before fetching any result (one roundtrip
        per group instead of a sync fetch after each dispatch) — the same
        pipelined contract as TpuEngine.submit_batch."""
        results = [SearchResult() for _ in queries]
        planned = []
        phrase = []
        # request coalescing (device.py analog): identical queries in a
        # batch execute once and fan out
        dedup: Dict[tuple, int] = {}
        dups: List[tuple] = []
        for qi, q in enumerate(queries):
            if q.n_results <= 0 or not q.terms:
                continue
            rows = [self.lookup(t) for t in q.terms]
            if any(r < 0 for r in rows):
                continue
            key = (tuple(rows), q.n_results, q.is_phrase,
                   q.return_snippets, q.n_snippet_passages)
            prim = dedup.get(key)
            if prim is not None:
                dups.append((qi, prim))
                continue
            dedup[key] = qi
            if (len(rows) == 1 and self._tt is not None
                    and self._serve_single_term(qi, rows[0], q, results)):
                continue
            if q.is_phrase and len(rows) >= 2:
                phrase.append((qi, rows, q))
            else:
                planned.append((qi, rows, q))

        pending = self._run_phrase(phrase, results)
        planned, host_pending = self._route_saturated(planned, is_phrase=False)
        pending += host_pending

        # df-tier routing (device.py analog): all-head -> dense scan;
        # tail candidate x any head other -> semi-dense; rest -> bs
        bs_items = []
        dense_items = []
        semi_items = []
        for item in planned:
            _, rows, _ = item
            if self._dense_H and len(rows) > 1:
                ds = [int(self._dense_slot[r]) for r in rows]
                if all(s >= 0 for s in ds):
                    dense_items.append(item)
                    continue
                cand = int(np.argmin([self.sharded.df[r] for r in rows]))
                if any(s >= 0 for t, s in enumerate(ds) if t != cand):
                    semi_items.append(item)
                    continue
            bs_items.append(item)
        pending += self._submit_dense(dense_items, results)
        pending += self._submit_semidense(semi_items, results)
        planned = bs_items

        groups: Dict[Tuple[int, int], list] = {}
        for item in planned:
            _, rows, _ = item
            T = _bucket(len(rows), T_BUCKETS)
            cand = rows[int(np.argmin([self.sharded.df[r] for r in rows]))]
            Lb = _bucket(int(self._df_shard_max[cand]), L_BUCKETS)
            groups.setdefault((T, Lb), []).append(item)

        repl = NamedSharding(self.mesh, P())
        for (T, L), group in groups.items():
            B = _bucket(len(group), B_BUCKETS)
            rows_arr = np.zeros((B, T), dtype=np.int32)
            use_score = np.zeros((B, T), dtype=np.float32)
            idf32_s = np.zeros((B, T), dtype=np.float32)
            idf64_q = np.zeros((B, T), dtype=np.float64)
            slot_of = np.zeros((B, T), dtype=np.int64)
            ks = np.zeros(B, dtype=np.int32)
            for i, (_, rows, q) in enumerate(group):
                dfs = [int(self.sharded.df[r]) for r in rows]
                cand = int(np.argmin(dfs))
                order = [cand] + [t for t in range(len(rows)) if t != cand]
                ks[i] = q.n_results
                for slot in range(T):
                    t = order[slot] if slot < len(order) else order[0]
                    rows_arr[i, slot] = rows[t]
                    if slot < len(order):
                        use_score[i, slot] = 1.0
                        idf32_s[i, slot] = np.float32(
                            self.sharded.idf64[rows[t]])
                for slot, t in enumerate(order):
                    slot_of[i, t] = slot
                for t, r in enumerate(rows):
                    idf64_q[i, t] = self.sharded.idf64[r]
            max_k = max(q.n_results for _, _, q in group)
            M = min(L, max_k + self.margin)
            Mo = min(max_k + self.margin, M * self.sharded.n_shards)
            if self.columns == "tc":
                kern = make_sharded_kernel_tc(
                    T, L, M, K.n_iters_for(self._max_df), self.mesh,
                    self._avg32, M_out=Mo)
                docs, score, tfs, flags = kern(
                    self.d_postings_doc, self.d_postings_tc,
                    self.d_term_starts, self.d_df_shard,
                    jax.device_put(rows_arr, repl),
                    jax.device_put(idf32_s, repl),
                )

                def finalize(res_list, docs=docs, tfs=tfs, flags=flags,
                             group=group, slot_of=slot_of, idf64_q=idf64_q,
                             ks=ks, T=T):
                    fl = np.asarray(flags)
                    self._finalize_group(
                        res_list, np.asarray(docs), np.asarray(tfs),
                        group, slot_of, idf64_q, ks, is_phrase=False,
                        force_host=(fl & K.FLAG_TRUNC) != 0,
                        force_always=(fl & K.FLAG_TF_SAT) != 0)
            else:
                kern = make_sharded_kernel(T, L, M,
                                           K.n_iters_for(self._max_df),
                                           self.mesh, M_out=Mo)
                docs, score, tfs, trunc = kern(
                    self.d_postings_doc, self.d_postings_score,
                    self.d_postings_tf,
                    self.d_term_starts, self.d_df_shard,
                    jax.device_put(rows_arr, repl),
                    jax.device_put(use_score, repl),
                )

                def finalize(res_list, docs=docs, tfs=tfs, trunc=trunc,
                             group=group, slot_of=slot_of, idf64_q=idf64_q,
                             ks=ks, T=T):
                    self._finalize_group(res_list, np.asarray(docs),
                                         np.asarray(tfs), group, slot_of,
                                         idf64_q, ks, is_phrase=False,
                                         force_host=np.asarray(trunc))

            pending.append(finalize)

        if dups:
            def copy_dups(res_list, dups=dups):
                for dqi, pqi in dups:
                    src, dst = res_list[pqi], res_list[dqi]
                    if src._docs is not None:
                        dst.set_arrays(src._docs, src._scores)
                        dst._entries = list(src._entries)
                    else:
                        dst._entries = list(src._entries)

            copy_dups.barrier = True  # reads primaries' results: run last
            pending.append(copy_dups)
        return results, pending

    # -- dense / semi-dense mesh routes --------------------------------

    def _submit_dense(self, items, results) -> list:
        """All-head conjunctions via the sharded dense scan (pruned when
        each shard has enough 128-blocks to make block-max selection
        worthwhile, mirroring device.py thresholds on the LOCAL slice)."""
        if not items:
            return []
        pending = []
        repl = NamedSharding(self.mesh, P())
        NB = self._npd // BLOCK
        C = self.PRUNED_DENSE_C
        pruned = NB >= max(self.PRUNED_DENSE_MIN_NB, C + 1)
        eps3 = 3.0 * self.rel_eps
        groups: Dict[int, list] = {}
        for item in items:
            groups.setdefault(_bucket(len(item[1]), T_BUCKETS),
                              []).append(item)
        for T, group in groups.items():
            B = _bucket(len(group), B_BUCKETS)
            slots = np.zeros((B, T), dtype=np.int32)
            use = np.zeros((B, T), dtype=np.float32)
            idf32_g = np.zeros((B, T), dtype=np.float32)
            idf64_q = np.zeros((B, T), dtype=np.float64)
            slot_of = np.tile(np.arange(T, dtype=np.int64), (B, 1))
            ks = np.zeros(B, dtype=np.int32)
            for i, (_, rows, q) in enumerate(group):
                ks[i] = q.n_results
                for t in range(T):
                    r = rows[t] if t < len(rows) else rows[0]
                    slots[i, t] = self._dense_slot[r]
                    if t < len(rows):
                        use[i, t] = 1.0
                        idf32_g[i, t] = np.float32(self.sharded.idf64[r])
                        idf64_q[i, t] = self.sharded.idf64[r]
            M = min(int(ks.max(initial=1)) + self.margin, self._npd)
            if self.columns == "tc":
                if pruned:
                    kern = make_sharded_pruned_dense_kernel_tc(
                        T, NB, C, M, eps3, self.mesh, self._avg32)
                    out = kern(self.d_dense_tf8, self.d_len_code,
                               self.d_dense_blockmax,
                               jax.device_put(slots, repl),
                               jax.device_put(idf32_g, repl),
                               jax.device_put(ks, repl))
                else:
                    kern = make_sharded_dense_kernel_tc(
                        T, self._npd, M, self.mesh, self._avg32)
                    out = kern(self.d_dense_tf8, self.d_len_code,
                               jax.device_put(slots, repl),
                               jax.device_put(idf32_g, repl))
            elif pruned:
                kern = make_sharded_pruned_dense_kernel(
                    T, NB, C, M, eps3, self.mesh)
                out = kern(self.d_dense_sc, self.d_dense_tf,
                           self.d_dense_blockmax,
                           jax.device_put(slots, repl),
                           jax.device_put(use, repl),
                           jax.device_put(ks, repl))
            else:
                kern = make_sharded_dense_kernel(T, self._npd, M, self.mesh)
                out = kern(self.d_dense_sc, self.d_dense_tf,
                           jax.device_put(slots, repl),
                           jax.device_put(use, repl))

            def finalize(res_list, out=out, group=group, T=T,
                         slot_of=slot_of, idf64_q=idf64_q, ks=ks):
                packed = np.asarray(out)  # full B rows (group <= B)
                flags = packed[:, T + 1, 0]
                self._finalize_group(
                    res_list, packed[:, 0, :], packed[:, 1 : T + 1, :],
                    group, slot_of, idf64_q, ks, is_phrase=False,
                    force_host=(flags & K.FLAG_TRUNC) != 0,
                    force_always=(flags & (K.FLAG_OVERFLOW | K.FLAG_TF_SAT
                                           | K.FLAG_PRUNE_MISS)) != 0)

            pending.append(finalize)
        return pending

    def _submit_semidense(self, items, results) -> list:
        """Tail-candidate x (dense + small-bs) others via the sharded
        mixed semi-dense kernel (device.py _submit_semidense, doc-
        partitioned). Slot layout: 0 = candidate, 1..n_bs = non-dense
        others, rest = dense others; pads repeat the first dense slot."""
        if not items:
            return []
        pending = []
        repl = NamedSharding(self.mesh, P())
        groups: Dict[tuple, list] = {}
        bs_df_max: Dict[tuple, int] = {}
        for item in items:
            _, rows, _ = item
            cand = int(np.argmin([self.sharded.df[r] for r in rows]))
            bs_rows = [r for t, r in enumerate(rows)
                       if t != cand and self._dense_slot[r] < 0]
            T = _bucket(len(rows), T_BUCKETS)
            L = _bucket(int(self._df_shard_max[rows[cand]]), L_BUCKETS)
            key = (T, L, len(bs_rows))
            groups.setdefault(key, []).append(item)
            if bs_rows:
                mx = max(int(self._df_shard_max[r]) for r in bs_rows)
                bs_df_max[key] = max(bs_df_max.get(key, 0), mx)
        for (T, L, NBs), group in groups.items():
            n_it = K.n_iters_for(_bucket(bs_df_max.get((T, L, NBs), 1),
                                         L_BUCKETS)) if NBs else 0
            B = _bucket(len(group), B_BUCKETS)
            rows_arr = np.zeros((B, T), dtype=np.int32)
            use = np.zeros((B, T), dtype=np.float32)
            idf32_s = np.zeros((B, T), dtype=np.float32)
            slots = np.zeros((B, T), dtype=np.int32)
            idf64_q = np.zeros((B, T), dtype=np.float64)
            slot_of = np.zeros((B, T), dtype=np.int64)
            ks = np.zeros(B, dtype=np.int32)
            for i, (_, rows, q) in enumerate(group):
                cand = int(np.argmin([self.sharded.df[r] for r in rows]))
                others = [t for t in range(len(rows)) if t != cand]
                bs_t = [t for t in others if self._dense_slot[rows[t]] < 0]
                dn_t = [t for t in others if self._dense_slot[rows[t]] >= 0]
                order = [cand] + bs_t + dn_t
                ks[i] = q.n_results
                first_dense = 1 + len(bs_t)
                for slot, t in enumerate(order):
                    r = rows[t]
                    rows_arr[i, slot] = r
                    if slot >= first_dense:
                        slots[i, slot] = self._dense_slot[r]
                    use[i, slot] = 1.0
                    idf32_s[i, slot] = np.float32(self.sharded.idf64[r])
                    slot_of[i, t] = slot
                for slot in range(len(order), T):  # padded slots
                    rows_arr[i, slot] = rows_arr[i, first_dense]
                    slots[i, slot] = slots[i, first_dense]
                for t, r in enumerate(rows):
                    idf64_q[i, t] = self.sharded.idf64[r]
            M = min(L, int(ks.max(initial=1)) + self.margin)
            Mo = min(int(ks.max(initial=1)) + self.margin,
                     M * self.sharded.n_shards)
            if self.columns == "tc":
                kern = make_sharded_semidense_kernel_tc(
                    T, L, M, self._npd, NBs, n_it, self.mesh, self._avg32,
                    M_out=Mo)
                out = kern(self.d_postings_doc, self.d_postings_tc,
                           self.d_term_starts, self.d_df_shard,
                           self.d_dense_tf8,
                           jax.device_put(rows_arr, repl),
                           jax.device_put(idf32_s, repl),
                           jax.device_put(slots, repl))
            else:
                kern = make_sharded_semidense_kernel(
                    T, L, M, self._npd, NBs, n_it, self.mesh, M_out=Mo)
                out = kern(self.d_postings_doc, self.d_postings_score,
                           self.d_postings_tf, self.d_term_starts,
                           self.d_df_shard, self.d_dense_sc, self.d_dense_tf,
                           jax.device_put(rows_arr, repl),
                           jax.device_put(use, repl),
                           jax.device_put(slots, repl))

            def finalize(res_list, out=out, group=group, T=T,
                         slot_of=slot_of, idf64_q=idf64_q, ks=ks):
                packed = np.asarray(out)  # full B rows (group <= B)
                flags = packed[:, T + 1, 0]
                self._finalize_group(
                    res_list, packed[:, 0, :], packed[:, 1 : T + 1, :],
                    group, slot_of, idf64_q, ks, is_phrase=False,
                    force_host=(flags & K.FLAG_TRUNC) != 0,
                    force_always=(flags & (K.FLAG_OVERFLOW | K.FLAG_TF_SAT
                                           | K.FLAG_PRUNE_MISS)) != 0)

            pending.append(finalize)
        return pending
