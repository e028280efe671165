"""Exact top-k finalization: host f64 re-rank of device candidates.

The device ranks with float32 for speed and returns the top-M candidate
docs (M = k + margin) with their per-term tfs. This module recomputes the
exact float64 BM25 score with the reference's operation order
(CalcDocScoreLossy, scoring.h:124-145) and produces the final
(score desc, doc_id asc) top-k — bit-identical to the oracle whenever the
f32 candidate set covers the true top-k, which the margin guarantees in
practice and the parity tests enforce.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from wiser_tpu.scoring import K1


def rescore_topk(
    top_docs: np.ndarray,  # (M,) int32, -1 = invalid
    top_tfs: np.ndarray,  # (T, M) int32 (slot-major, query-term order)
    n_real_terms: int,
    idf64: np.ndarray,  # (n_real_terms,) float64
    doc_len_code: np.ndarray,  # (N,) uint8
    cache64: np.ndarray,  # (256,) float64 tfnorm cache
    k: int,
) -> List[Tuple[float, int]]:
    """Returns [(score, doc_id)] of length <= k, final order."""
    valid = top_docs >= 0
    docs = top_docs[valid].astype(np.int64)
    if docs.size == 0:
        return []
    tfs = top_tfs[:n_real_terms, valid].astype(np.float64)  # (T, m)
    cache_val = cache64[doc_len_code[docs] & 0xFF]  # (m,)
    score = np.zeros(docs.size, dtype=np.float64)
    for t in range(n_real_terms):
        f = tfs[t]
        score = score + np.float64(idf64[t]) * ((f * (K1 + 1)) / (f + cache_val))
    order = np.lexsort((docs, -score))[:k]
    return [(float(score[i]), int(docs[i])) for i in order]


def rescore_sorted_arrays(
    top_docs: np.ndarray,  # (B, M) int32, -1 = invalid
    top_tfs_q: np.ndarray,  # (B, T, M) int32, QUERY-term order
    idf64_q: np.ndarray,  # (B, T) float64, 0.0 on padded slots
    doc_len_code: np.ndarray,
    cache64: np.ndarray,
) -> tuple:
    """Exact f64 re-rank, fully array-valued: returns
    (docs (B,M) int64 sorted by (score desc, doc asc),
     scores (B,M) f64, n_valid (B,) int64). See rescore_topk_batch for
    the bit-exactness argument (padded slots contribute exactly +0.0)."""
    B, T, M = top_tfs_q.shape
    valid = (top_docs >= 0) & (top_docs < doc_len_code.shape[0])
    docs = np.where(valid, top_docs, 0).astype(np.int64)
    cache_val = cache64[doc_len_code[docs] & 0xFF]
    score = np.zeros((B, M), dtype=np.float64)
    for t in range(T):
        f = top_tfs_q[:, t, :].astype(np.float64)
        score = score + idf64_q[:, t : t + 1] * ((f * (K1 + 1)) / (f + cache_val))
    # flat-index gathers: np.take_along_axis materializes np.indices()
    # per call, which dominated finalize wall on 32k batches (profiled
    # 0.49s/batch of pure index building on the single host core)
    off = (np.arange(B, dtype=np.int64) * M)[:, None]
    docs_sorted_idx = np.argsort(docs, axis=1, kind="stable")
    flat = docs_sorted_idx + off
    score_d = np.where(valid.ravel()[flat], score.ravel()[flat], -np.inf)
    final_idx = np.argsort(-score_d, axis=1, kind="stable")
    order = flat.ravel()[final_idx + off].reshape(B, M)
    docs_f = docs.ravel()[order]
    score_f = score.ravel()[order]
    n_valid = valid.sum(axis=1)
    return docs_f, score_f, n_valid


def truncation_suspects(score_f: np.ndarray, n_valid: np.ndarray,
                        ks: np.ndarray, rel_eps: float = 1e-6) -> np.ndarray:
    """Detect queries whose f32-ARITHMETIC error may have reordered a
    candidate across the buffer boundary.

    Division of labor with the device-side flag (kernels.py
    boundary_truncated): the device flags every query whose f32 boundary
    CLASS was truncated (covers exact f64 ties and f32-rounding
    collisions exactly — it counts lanes with score == the kept minimum).
    What remains is queries where f32 SUMMATION error inverted the order
    of two f64-distinct, f32-distinct scores across the boundary; that
    requires an f64 gap within the arithmetic error bound
    (~(T+1) * 2^-23 relative < rel_eps), which is what this flags.
    Exact f64 ties at the boundary need no host pass here — if their
    class was cut, the device flag fired. Together the two checks cover
    every possible parity break; callers re-run flagged queries exactly
    on host."""
    B, M = score_f.shape
    full = n_valid >= M
    if not full.any():
        return full
    k_idx = np.minimum(np.maximum(ks, 1) - 1, M - 1)
    kth = np.take_along_axis(score_f, k_idx[:, None].astype(np.int64), 1)[:, 0]
    last = score_f[:, M - 1]
    near = np.abs(kth - last) <= rel_eps * np.maximum(np.abs(kth), 1e-30)
    return full & near & (kth != last)


def rescore_topk_batch(
    top_docs: np.ndarray,  # (B, M) int32, -1 = invalid
    top_tfs: np.ndarray,  # (B, T, M) int32 (slot-major, query-term order)
    idf64_slots: np.ndarray,  # (B, T) float64, 0.0 on padded slots
    doc_len_code: np.ndarray,  # (N,) uint8
    cache64: np.ndarray,  # (256,) float64
    ks: np.ndarray,  # (B,) per-query k
) -> List[List[Tuple[float, int]]]:
    """Vectorized exact f64 re-rank of a whole group at once.

    Accumulation runs over all T slots in slot order; padded slots have
    idf 0.0, whose contribution is exactly +0.0 in f64 and therefore does
    not perturb the bit pattern of the real-term sum — so this matches
    the per-query reference order (CalcDocScoreLossy) exactly.
    """
    B, T, M = top_tfs.shape
    # guard: doc ids outside [0, n_docs) are invalid lanes by construction
    valid = (top_docs >= 0) & (top_docs < doc_len_code.shape[0])  # (B, M)
    docs = np.where(valid, top_docs, 0).astype(np.int64)
    cache_val = cache64[doc_len_code[docs] & 0xFF]  # (B, M)
    score = np.zeros((B, M), dtype=np.float64)
    for t in range(T):
        f = top_tfs[:, t, :].astype(np.float64)
        score = score + idf64_slots[:, t : t + 1] * ((f * (K1 + 1)) / (f + cache_val))
    # batched lexsort by (-score, doc): stable doc-ascending sort, then
    # stable score-descending sort
    docs_sorted_idx = np.argsort(docs, axis=1, kind="stable")
    score_d = np.take_along_axis(score, docs_sorted_idx, axis=1)
    valid_d = np.take_along_axis(valid, docs_sorted_idx, axis=1)
    score_d = np.where(valid_d, score_d, -np.inf)
    final_idx = np.argsort(-score_d, axis=1, kind="stable")
    order = np.take_along_axis(docs_sorted_idx, final_idx, axis=1)
    docs_f = np.take_along_axis(docs, order, axis=1)
    score_f = np.take_along_axis(score, order, axis=1)
    valid_f = np.take_along_axis(valid, order, axis=1)
    out = []
    for b in range(B):
        kb = int(ks[b])
        row = []
        for m in range(min(kb, M)):
            if not valid_f[b, m]:
                break
            row.append((float(score_f[b, m]), int(docs_f[b, m])))
        out.append(row)
    return out
