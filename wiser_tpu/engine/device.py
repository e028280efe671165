"""TpuEngine — the HBM-resident search engine (the VacuumEngine analog).

Loads a PackedIndex into device memory and executes batches of queries as
single XLA programs (see engine/kernels.py for the execution model). The
host side does what hosts are good at: term dictionary lookup, shape
bucketing, batch assembly, exact f64 re-ranking, snippets.

Query dispatch mirrors ProcessQueryDelta (query_processing.h:956-979):
  1 term             -> single-term scan kernel (T=1 path)
  N terms, no phrase -> k-way intersection kernel
  N>=2 terms, phrase -> match kernel (+ bi-bloom gate) -> position verify
                        -> top-k select
Bucketing replaces the reference's per-query adaptivity: queries are
grouped by (slot count, candidate-list length bucket), large groups are
chunked to a fixed batch width, and every group is dispatched
asynchronously before any result is fetched — one device roundtrip's
latency is paid once per batch, not once per group.

Slot layout (see kernels.py): slot 0 holds each query's least-frequent
term (the candidate list); remaining terms keep their relative order in
slots 1..; padded slots repeat slot 0 with use_score=0. The host records
the query-term -> slot permutation to restore the reference's exact f64
summation order in the re-rank.
"""

from __future__ import annotations

import os
import time as _time
from dataclasses import dataclass, field
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple

import jax.numpy as jnp
import numpy as np

from wiser_tpu.engine import kernels as K
from wiser_tpu.engine.topk import rescore_sorted_arrays, truncation_suspects
from wiser_tpu.index.format import PackedIndex, SENTINEL_DOC
from wiser_tpu.scoring import Bm25Similarity
from wiser_tpu.types import SearchQuery, SearchResult, SearchResultEntry

# Every (T, L) combo is a separate compiled program AND a separate
# dispatch + fetch per batch — fewer groups is fewer dispatches, at the
# price of padded lanes; the coarse alternative is coarse_buckets below.
L_BUCKETS = [128, 512, 2048, 8192, 32768, 131072, 524288, 2097152]
# small buckets matter: a 1-query group padded to B=128 at L=131072
# would run 127 dead rows of element gathers
B_BUCKETS = [8, 32, 128, 1024, 4096]
B_CHUNK = 4096
T_BUCKETS = [1, 2, 3, 4, 8]
PP_BUCKETS = [8, 32, 128, 512, 2048, 8192]
DEFAULT_MARGIN = 54  # M = k + margin; fixed M=64 for k=10 keeps shapes few


def _bucket(value: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if value <= b:
            return b
    return buckets[-1]


@lru_cache(maxsize=8)
def _tc_norm64_table(avg: float) -> np.ndarray:
    """f64 tfnorm of every uint16 tc value, as kernels.tc_score defines it
    (a table: the dense tier evaluates it for H x n_docs lanes)."""
    tc = np.arange(1 << 16, dtype=np.int64)
    tf_i = tc & 0xFF
    tf = tf_i.astype(np.float64)
    code = (tc >> 8) & 0xFF
    bits = code & 7
    shift = np.minimum((code >> 3) - 1, 27)
    length = np.where(shift < 0, bits, (bits | 8) << np.maximum(shift, 0))
    cache = np.float64(K.K1_F32) * (
        np.float64(K.ONE_MINUS_B_F32)
        + np.float64(K.B_F32) * length.astype(np.float64) / np.float64(avg))
    with np.errstate(invalid="ignore", divide="ignore"):
        norm = (tf * np.float64(K.K1_PLUS_1)) / (tf + cache)
    norm = np.where(tf_i == 0, 0.0, norm)
    return np.where(tf_i >= K.TF_SAT, np.float64(K.K1_PLUS_1), norm)


def _tc_score64_ub(tc_u16: np.ndarray, idf64: np.ndarray,
                   avg: float) -> np.ndarray:
    """f64 upper bound on the device's f32 tc_score reconstruction
    (kernels.tc_score), x(1+2e-6) to dominate its ~9 f32 rounding steps.
    idf64 must be the f64 value of the f32 idf the kernel uses."""
    norm = _tc_norm64_table(float(avg))[tc_u16]
    return (idf64 * norm * (1 + 2e-6)).astype(np.float32)


# Escape hatch for the bi-bloom pre-gate below (ADVICE r4): the gate is
# exact ONLY if the builder's bloom columns have no false negatives; a
# bloom-build bug would corrupt device path and host fallback alike, so
# the independent check (tests/test_engine_parity bloom-drop test, or
# WISER_HOST_BLOOM_GATE=0 at runtime) must be able to bypass it.
HOST_BLOOM_GATE = os.environ.get("WISER_HOST_BLOOM_GATE", "1") != "0"


def host_exact_search(packed: PackedIndex, cache64: np.ndarray,
                      rows: Sequence[int], k: int, is_phrase: bool = False):
    """Exact host-side conjunctive/phrase search over the packed columns —
    the fallback when the device's f32 candidate margin may have
    truncated a tie class (engine/topk.py truncation_suspects), and the
    reference semantics oracle for one-off queries.

    Returns (docs int64[<=k], scores f64[<=k]) in final order."""
    from wiser_tpu.scoring import K1

    dfs = [int(packed.df[r]) for r in rows]
    cand = int(np.argmin(dfs))
    cs = int(packed.term_starts[rows[cand]])
    docs = packed.postings_doc[cs : cs + dfs[cand]].astype(np.int64)
    mask = np.ones(len(docs), dtype=bool)
    tfs = np.zeros((len(rows), len(docs)), dtype=np.int64)
    pidx = np.zeros((len(rows), len(docs)), dtype=np.int64)
    for t, r in enumerate(rows):
        st, n = int(packed.term_starts[r]), dfs[t]
        arr = packed.postings_doc[st : st + n]
        idx = np.searchsorted(arr, docs)
        idc = np.minimum(idx, n - 1)
        found = (idx < n) & (arr[idc] == docs)
        mask &= found
        tfs[t] = packed.postings_tf[st + idc]
        pidx[t] = st + idc
    docs_m = docs[mask]
    if docs_m.size == 0:
        return docs_m, np.zeros(0, dtype=np.float64)
    tfs_m = tfs[:, mask].astype(np.float64)
    cache_val = cache64[packed.doc_len_code[docs_m] & 0xFF]
    score = np.zeros(docs_m.size, dtype=np.float64)
    for t, r in enumerate(rows):
        idf = np.float64(packed.idf64[r])
        f = tfs_m[t]
        score = score + idf * ((f * (K1 + 1)) / (f + cache_val))
    order = np.lexsort((docs_m, -score))
    if is_phrase and len(rows) >= 2:
        # Score-ordered LAZY phrase verification: scoring ignores
        # adjacency (BM25 over term tfs, phrase only filters — reference
        # scoring semantics), so walk AND-matched candidates in the final
        # (score desc, doc asc) canon and verify adjacency chunk by chunk
        # until k survive. A later candidate can never displace an
        # earlier verified one, so the first k survivors ARE the answer —
        # exact, and on phrase-frequent mega pairs ("of the"-style, the
        # expensive ones) it touches ~one chunk of position bags instead
        # of key-intersecting the full ~10M-key surface (seconds/query).
        pidx_m = pidx[:, mask]
        # bi-bloom pre-gate (the reference's IsPossibleToPresent on the
        # host path, query_processing.h:796-807): for each adjacent pair
        # (t, t+1), term t's per-posting "followers" filter must contain
        # t+1 — a definite-no is exact, so gating only shrinks the
        # verify set. Phrase-RARE mega pairs (the costliest host calls)
        # collapse to near-nothing; saturated filters on ultra-frequent
        # terms just pass more lanes through, never drop a match.
        if HOST_BLOOM_GATE and packed.bloom_ends is not None and docs_m.size:
            cfg = packed.bloom_cfg
            keep_m = np.ones(docs_m.size, dtype=bool)
            terms = packed.terms
            for t in range(len(rows) - 1):
                widx, wmask = cfg.probe_word_masks(terms[rows[t + 1]])
                filt = packed.bloom_ends[pidx_m[t]]  # (n_cand, W)
                ok = np.ones(docs_m.size, dtype=bool)
                for h in range(len(widx)):
                    ok &= (filt[:, widx[h]] & wmask[h]) == wmask[h]
                keep_m &= ok
                if not keep_m.any():
                    break
            sel = np.nonzero(keep_m)[0]
            docs_m = docs_m[sel]
            score = score[sel]
            pidx_m = pidx_m[:, sel]
            if docs_m.size == 0:
                return (docs_m.astype(np.int64),
                        np.zeros(0, dtype=np.float64))
            order = np.lexsort((docs_m, -score))
        kept: list = []
        i, chunk = 0, 2048
        while i < order.size and len(kept) < k:
            take = order[i : i + chunk]
            sub = np.ones(take.size, dtype=bool)
            okm = _host_phrase_mask(packed.positions, packed.pos_starts,
                                    docs_m[take], pidx_m[:, take], sub,
                                    len(rows))
            kept.extend(take[okm])
            i += chunk
            chunk *= 4  # phrase-rare pairs: approach full-set cost fast
        order = np.asarray(kept[:k], dtype=np.int64)
        return docs_m[order], score[order]
    order = order[:k]
    return docs_m[order], score[order]


def _host_phrase_mask(positions: np.ndarray, pos_starts: np.ndarray,
                      docs: np.ndarray, pidx: np.ndarray, mask: np.ndarray,
                      n_terms: int) -> np.ndarray:
    """Vectorized adjusted-position phrase verification over the matched
    candidates: term t's positions are keyed as doc*SHIFT + (pos - t);
    a phrase match is a key present in every term's key set, computed by
    iterative sorted intersection (np.intersect1d) — no per-doc Python.
    (The per-doc set-ops version was minutes per query on "of the"-style
    mega pairs.)"""
    sel = np.nonzero(mask)[0]
    if sel.size == 0:
        return mask
    shift = np.int64(positions.max(initial=0)) + np.int64(n_terms) + 1

    def keys(t: int) -> np.ndarray:
        p = pidx[t, sel]
        s = pos_starts[p].astype(np.int64)
        e = pos_starts[p + 1].astype(np.int64)
        cnt = e - s
        total = int(cnt.sum())
        out_starts = np.zeros(len(sel) + 1, dtype=np.int64)
        np.cumsum(cnt, out=out_starts[1:])
        idx = (np.repeat(s, cnt)
               + np.arange(total) - np.repeat(out_starts[:-1], cnt))
        pos = positions[idx].astype(np.int64)
        doc_of = np.repeat(docs[sel], cnt)
        return doc_of * shift + (pos - t)

    base = keys(0)
    for t in range(1, n_terms):
        base = np.intersect1d(base, keys(t), assume_unique=False)
        if base.size == 0:
            break
    ok_docs = np.unique(base // shift)
    out = np.zeros_like(mask)
    out[sel] = np.isin(docs[sel], ok_docs)
    return out


def build_single_term_table(packed: PackedIndex, scores64: np.ndarray,
                            depth: int):
    """Impact-ordered per-term top tables (see TpuEngine note). Shared by
    the single-device and sharded engines — the table depends only on the
    global index, not the device layout.

    Returns (tt_starts int64[T+1], tt_docs int64[...], tt_scores f64)."""
    lens = np.diff(packed.term_starts)
    term_of = np.repeat(np.arange(packed.n_terms, dtype=np.int64), lens)
    # sentinel pads score exactly 0.0 < any real score -> sorted last
    order = np.lexsort((packed.postings_doc, -scores64, term_of))
    # cap by actual run length too: a staged hot view keeps global df
    # for cold rows but gives them zero-length runs
    cnt = np.minimum(np.minimum(packed.df, lens), depth).astype(np.int64)
    tt_starts = np.zeros(packed.n_terms + 1, dtype=np.int64)
    np.cumsum(cnt, out=tt_starts[1:])
    total = int(tt_starts[-1])
    seg = packed.term_starts.astype(np.int64)
    idx = order[np.repeat(seg[:-1], cnt)
                + np.arange(total) - np.repeat(tt_starts[:-1], cnt)]
    return tt_starts, packed.postings_doc[idx].astype(np.int64), scores64[idx]


@dataclass
class _PlannedQuery:
    qi: int  # index into the input batch
    rows: List[int]  # term dictionary rows, query order
    query: SearchQuery
    slot_rows: List[int] = field(default_factory=list)  # candidate-first
    slot_of_term: List[int] = field(default_factory=list)  # query t -> slot

    def plan_slots(self, df: np.ndarray) -> None:
        cand = int(np.argmin([df[r] for r in self.rows]))
        order = [cand] + [t for t in range(len(self.rows)) if t != cand]
        self.slot_rows = [self.rows[t] for t in order]
        self.slot_of_term = [0] * len(self.rows)
        for slot, t in enumerate(order):
            self.slot_of_term[t] = slot


class TpuEngine:
    def __init__(
        self,
        packed: PackedIndex,
        doc_bodies: Optional[Sequence[str]] = None,
        bloom_enable_factor: Optional[int] = 1,
        margin: int = DEFAULT_MARGIN,
        single_term_depth: int = 64,
        dense_budget_bytes: int = 7 << 29,  # 3.5 GB
        strict_parity: bool = False,
        columns: str = "raw",
        coarse_buckets: bool = False,
        io_workers: int = 8,
        io_mode: str = "both",
        dense_from: Optional[PackedIndex] = None,
        host_packed: Optional[PackedIndex] = None,
    ):
        # dense_from: build the dense head-term tier from THIS index's
        # posting runs instead of `packed`'s. The staged engine passes
        # the full host-RAM index here so head terms can be served
        # dense-only — a head term's (N_pad,) uint8 row costs ~1/10 of
        # its CSR run at 1M docs and answers every non-phrase query
        # shape the term appears in, which is what makes the budget
        # curve degrade gracefully instead of cliffing (without it, a
        # quarter budget held 95% of posting bytes yet the dense tier got
        # zero leftover bytes and every head query fell to the host path).
        # host_packed: the index the EXACT HOST fallback searches. For a
        # staged hot view this must be the full index — the view gives
        # csr-cold terms zero-length runs, and a dense-routed query that
        # guard-flags to host would otherwise silently search an empty
        # run (the reference's host path always reads the full on-flash
        # index, vacuum_engine.h:144-166).
        self._dense_from = dense_from
        self._host_packed = host_packed if host_packed is not None else packed
        self.strict_parity = strict_parity
        # columns="tc": compressed device columns — one uint16
        # (doc_len_code << 8 | min(tf, 255)) lane replaces the (score f32,
        # tf i32) pair; 12 -> 6 bytes/posting of HBM at identical results
        # (kernels.tc_score reconstructs the selection score in-kernel;
        # saturated-tf and near-tie queries take the exact host path).
        # This is the serving-side analog of the reference's packed
        # posting storage (packed_value.h:87-274, flash_containers.h:557).
        if columns not in ("raw", "tc"):
            raise ValueError(f"unknown columns mode {columns!r}")
        self.columns = columns
        # io_workers: overlap per-group dispatch and fetch waits. A batch
        # spans many shape groups; dispatching each group's XLA execution
        # and fetching its packed output each block the calling thread.
        # Two small thread pools overlap them: dispatch closures run on
        # _io_pool, finalizers (fetch + host re-rank) run on _fetch_pool.
        # Groups are independent XLA programs over immutable columns, and every query belongs to exactly one
        # group, so cross-thread writes never alias. 0 disables (serial).
        self.io_workers = io_workers
        if io_mode not in ("both", "dispatch", "fetch", "off"):
            raise ValueError(f"unknown io_mode {io_mode!r}")
        self._io_pool = None
        self._fetch_pool = None
        if io_workers and io_workers > 1 and io_mode != "off":
            from concurrent.futures import ThreadPoolExecutor

            # separate pools: a finalizer blocks on its group's dispatch
            # future; sharing one pool could starve queued dispatches
            # behind blocked finalizers under pipelined serving
            if io_mode in ("both", "dispatch"):
                self._io_pool = ThreadPoolExecutor(
                    io_workers, thread_name_prefix="wiser-dispatch")
            if io_mode in ("both", "fetch"):
                self._fetch_pool = ThreadPoolExecutor(
                    io_workers, thread_name_prefix="wiser-fetch")
        import threading

        # guards the per-batch deferred-rescue queue (_drain_rescues):
        # finalizers append from the fetch pool's threads
        self._rescue_lock = threading.Lock()
        # cheap execution counters (flag rates, host-fallback cost) — the
        # profiling substrate for route attribution and the parity audit
        self._stats_lock = threading.Lock()
        self.stats: Dict[str, float] = {}
        # coarse_buckets: merge small L buckets and odd T buckets so a
        # batch spans FEWER shape groups, hence fewer dispatches and
        # fetches per batch. Padding lanes/slots are sentinel-masked, so
        # results are identical; cost is wasted lanes on small lists
        # (cheap) and one extra bs slot for T=3.
        if coarse_buckets:
            self._lb = [2048, 8192, 32768, 131072, 524288, 2097152]
            self._tb = [1, 2, 4, 8]
        else:
            self._lb = list(L_BUCKETS)
            self._tb = list(T_BUCKETS)
        if packed.n_postings >= 2**31 or len(packed.positions) >= 2**31:
            raise ValueError("index too large for int32 device addressing")
        self.packed = packed
        self.doc_bodies = doc_bodies
        self.bloom_enable_factor = bloom_enable_factor
        self.margin = margin
        # widened guard epsilon for the in-kernel score reconstruction:
        # per-term ~9 f32 rounding steps (vs 1 for the baked column) plus
        # the T-term f32 sum -> worst-case relative error < (9+1)*T*2^-24
        # ~ 4.8e-6 at T=8; 1e-5 covers it with margin. Cost is only a
        # slightly higher exact-host fallback rate on near-ties.
        self.rel_eps = 1e-5 if columns == "tc" else 1e-6

        self.similarity = Bm25Similarity(packed.avg_len)
        self.cache64 = self.similarity.cache  # (256,) f64

        # Precomputed per-posting partial scores: idf * lossy tfnorm in
        # f64, cast to f32 — the device's entire selection-phase scoring.
        scores64 = packed.partial_scores(self.cache64)
        # pad columns so any dynamic_slice starting inside the real data
        # stays in range: a candidate list may start near the very end,
        # so the tail needs a full L-bucket of slack.
        # slack must cover the largest candidate dynamic_slice anywhere in
        # the real data (plus headroom for block-aligned kernel overreach)
        pad = _bucket(int(packed.df.max(initial=1)), self._lb) + 4096
        self._h_doc = np.pad(packed.postings_doc, (0, pad),
                             constant_values=K.INT32_MAX).astype(np.int32)
        if columns == "tc":
            real = packed.postings_doc != SENTINEL_DOC
            code = packed.doc_len_code[
                np.where(real, packed.postings_doc, 0).astype(np.int64)]
            tf8 = np.minimum(packed.postings_tf, K.TF_SAT).astype(np.uint16)
            tc = (code.astype(np.uint16) << 8) | tf8
            self._h_tc = np.pad(np.where(real, tc, 0).astype(np.uint16),
                                (0, pad))
            self._h_score = None
            self._h_tf = None
        else:
            self._h_tc = None
            self._h_score = np.pad(scores64.astype(np.float32), (0, pad))
            self._h_tf = np.pad(packed.postings_tf, (0, pad)).astype(np.int32)
        self._avg32 = np.float32(packed.avg_len)
        self._build_bloom_sparse()
        self._upload()

        self._max_df = int(packed.df.max(initial=1))
        self._starts32 = packed.term_starts.astype(np.int32)
        self._df32 = packed.df.astype(np.int32)
        # per-term CSR availability: a staged hot view keeps the real df
        # on csr-cold rows but gives them zero-length runs. Routes that
        # read a term's posting run (bs/windowed/semidense-candidate/
        # phrase) must not touch such a row — the planner falls back to
        # the dense route or the exact host path (host_packed).
        self._csr_ok = np.diff(packed.term_starts) >= packed.df

        self._st_depth = single_term_depth
        if single_term_depth:
            self._build_single_term_table(scores64, single_term_depth)

        # memo over exact-host executions: the index is immutable, so a
        # repeated (rows, k, phrase) triple returns the identical arrays.
        # Real logs repeat hot queries heavily (the AOL trace's head), and
        # mega-pair host fallbacks cost milliseconds each — this is the
        # reference's "OS page cache keeps hot postings" effect at the
        # result level.
        self._host_cache: Dict[tuple, tuple] = {}
        self.HOST_CACHE_CAP = 200_000

        self._dense_H = 0
        self._dense_slot = np.full(packed.n_terms, -1, dtype=np.int32)
        if dense_budget_bytes:
            self._build_dense_rows(dense_budget_bytes)

    # -- dense head-term rows --------------------------------------------

    # terms with df >= n_docs/DENSE_ELIGIBLE_FRACTION are ELIGIBLE for
    # dense rows (budget-capped, largest df first). The wider tier
    # converts most mixed-kernel bs-others (mid-df terms) into one-gather
    # dense slots instead of n_iters x L element gathers per bs slot.
    # The budget cap is the real limiter: raw rows cost 8 B/doc (at 1M
    # docs the 3.76 GB default budget saturates at ~470 rows), tc rows 2.
    DENSE_ELIGIBLE_FRACTION = 384
    # ALL-dense conjunctions route to the doc-space (pruned) dense scan
    # only when plentiful: candidate df above SEMI_FROM_DENSE_MAX_CAND_L
    # or expected intersection >= 4k. Sparse all-head combos (random
    # head triples: expected matches << k) made the prune guard flag
    # ~95% of queries to host — the top-C ub blocks rarely contain the
    # few (or zero) true matches; the semidense kernel answers the same
    # queries exactly with L x (T-1) gathers and no flag tail.
    DENSE_MIN_DF_FRACTION = 96  # retained: min-df for the ALL-dense route
    SEMI_FROM_DENSE_MAX_CAND_L = 16384
    DENSE_MIN_DF_FLOOR = 1024  # class attr so tests/dryruns can shrink it
    # block-max pruning (kernels.make_pruned_dense_kernel): engage when
    # the doc space exceeds PRUNED_DENSE_MIN_NB 128-doc blocks — below
    # that the plain dense scan is already cheap and pruning only adds a
    # flag-fallback tail. C blocks
    # (C*128 lanes) are examined per query; FLAG_PRUNE_MISS routes any
    # query whose guard cannot prove exactness to the memoized host path.
    PRUNED_DENSE_MIN_NB = 2048
    PRUNED_DENSE_C = 512
    # Device-side second-chance passes for FLAG_PRUNE_MISS rows.
    # DENSE_RESCUE re-scans flagged rows with the full T x n_docs dense
    # kernel instead of sending them to the serialized host merge.
    # PHRASE_RESCUE retries mega phrases at RETRY_C/RETRY_KV; 63% of
    # retried rows still re-flag (mega pairs' ub surface is flat even at
    # 4x C), the other 37% are rescued. Both are ON; their cost on the
    # GPU against the host path is not measured yet.
    DENSE_RESCUE = True
    PHRASE_RESCUE = True

    def _build_dense_rows(self, budget_bytes: int) -> None:
        """Dense (N_pad,) score/tf vectors for head terms, so all-head
        conjunctions run the doc-space dense kernel (kernels.py
        make_dense_search_kernel) instead of list intersection. At
        reference scale ~25% of an AOL-shaped workload is all-head
        multi-term — the windowed/merge paths do Omega(df*512) work and
        OOM at L-buckets past 131072; the dense scan is T*N lane-ops."""
        # dense_from (staged): build rows from the FULL index so head
        # terms are servable dense-only while their CSR stays cold.
        # Without it (standalone engine), a hot view's eligible-but-cold
        # term would get an all-zero dense row (never served — cold
        # queries go to the staging path), so exclude zero-length runs.
        packed = self._dense_from if self._dense_from is not None \
            else self.packed
        n = packed.n_docs
        self._dense_slot = np.full(packed.n_terms, -1, dtype=np.int32)
        dense_min = max(self.DENSE_MIN_DF_FLOOR,
                        n // self.DENSE_ELIGIBLE_FRACTION)
        run_lens = np.diff(packed.term_starts)
        rows = np.nonzero((packed.df >= dense_min) & (run_lens > 0))[0]
        if len(rows) == 0:
            return
        self._n_pad_docs = (n + 127) // 128 * 128
        # bytes per head-term row: (f32 score + i32 tf) = 8 raw; tc mode
        # stores only a uint8 TF lane = 1 byte (8x the head capacity per
        # byte) — the doc len code is a DOC property, stored once in a
        # shared (N_pad,) row and recomposed in-kernel (round-4 dense-tier
        # compression: 2 B -> 1 B/doc/row halved the 1M dense tier with a
        # bit-identical composed lane; VERDICT r3 item 3)
        row_bytes = 1 if self.columns == "tc" else 8
        # full per-row cost incl. the blockmax/blockmax2 (f32) + argpos
        # (u8) planes; a budget that cannot afford one row builds no tier
        # (staged leftover budgets are charged honestly — no free first
        # row)
        per_row = self._n_pad_docs * row_bytes + (self._n_pad_docs // 128) * 9
        cap = int(budget_bytes // per_row)
        if cap == 0:
            return
        # element-flat dense gathers (slot * N_pad + doc) auto-widen to
        # int64 past 2^31 plane elements (kernels._dense_flat_idx) — the
        # old hard cap there limited the 10M dense tier to ~213 rows and
        # forced every head pair to the host path.
        # The remaining int32 bound is the pruned kernels' BLOCK-row
        # index (slot * NB + blk into the (H*NB, 128) blockmax rows):
        # H * NB must stay < 2^31 (~27k rows at 10M docs — far above any
        # realistic budget).
        cap = min(cap, (2**31 - 1) // max(self._n_pad_docs // 128, 1) - 1)
        if len(rows) > cap:
            rows = rows[np.argsort(packed.df[rows])[::-1][:cap]]
        H = len(rows)
        lens = np.diff(packed.term_starts)
        if self.columns == "tc":
            dense_tf8 = np.zeros((H, self._n_pad_docs), dtype=np.uint8)
            # shared per-doc len-code row (pad docs keep code 0: their tf
            # lanes are 0 everywhere, so composed lanes stay exactly 0)
            len_code = np.zeros(self._n_pad_docs, dtype=np.uint8)
            len_code[:n] = packed.doc_len_code[:n]
        else:
            dense_sc = np.zeros((H, self._n_pad_docs), dtype=np.float32)
            dense_tf = np.zeros((H, self._n_pad_docs), dtype=np.int32)
        cache64 = self.cache64
        for slot, r in enumerate(rows.tolist()):
            s = int(packed.term_starts[r])
            m = min(int(packed.df[r]), int(lens[r]))  # staged hot views
            docs = packed.postings_doc[s : s + m]
            # values come from `packed` (= dense_from when staged), not
            # the view's padded host columns: for a csr-cold term the
            # view has no postings at all. tf8/score math is identical
            # to the _h_tc/_h_score bake (same formula, same dtypes).
            tf_m = packed.postings_tf[s : s + m]
            if self.columns == "tc":
                dense_tf8[slot, docs] = np.minimum(
                    tf_m, K.TF_SAT).astype(np.uint8)
            else:
                tf64 = tf_m.astype(np.float64)
                code = packed.doc_len_code[docs.astype(np.int64)] & 0xFF
                sc64 = packed.idf64[r] * ((tf64 * 2.2)
                                          / (tf64 + cache64[code]))
                dense_sc[slot, docs] = sc64.astype(np.float32)
                dense_tf[slot, docs] = tf_m.astype(np.int32)
            self._dense_slot[r] = slot
        self._dense_H = H
        # per-128-doc-block score upper bounds for the pruned dense scan
        # (kernels._pruned_dense_body). Raw mode: exact f32 block max of
        # the very values the kernel sums — the bound is exact. tc mode:
        # the kernel RECONSTRUCTS scores in f32 (tc_score), so the bound
        # is the f64 host reconstruction x (1+2e-6), covering the ~9-step
        # f32 rounding of the in-kernel decode (see rel_eps note above).
        NBLK = self._n_pad_docs // 128
        # alongside the block max: the 2nd-largest score (WITH
        # multiplicity — max ties keep bm2 == bm, the tie-safety the
        # refined bound proof needs) and the argmax doc's position within
        # the block (uint8). kernels._select_ub_blocks combines them into
        # a second-order ub that cut the measured head-pair flag rate at
        # C=512 from 67.5% to 13.3% on the 1M index (the sum-of-maxima ub
        # assumes all terms peak at the same doc; they almost never do).
        if self.columns == "tc":
            bm = np.zeros((H, NBLK), dtype=np.float32)
            bm2 = np.zeros((H, NBLK), dtype=np.float32)
            ap = np.zeros((H, NBLK), dtype=np.uint8)
            idf32_rows = self.packed.idf64[rows].astype(np.float32)
            code16 = len_code.astype(np.uint16) << 8  # (N_pad,)
            for h0 in range(0, H, 8):
                h1 = min(h0 + 8, H)
                # composed lanes == the former uint16 dense_tc rows
                tc_chunk = np.where(dense_tf8[h0:h1] > 0,
                                    code16[None, :] | dense_tf8[h0:h1],
                                    np.uint16(0))
                ub = _tc_score64_ub(tc_chunk,
                                    idf32_rows[h0:h1, None].astype(np.float64),
                                    float(self._avg32))
                ub3 = ub.reshape(h1 - h0, NBLK, 128)
                top2 = np.partition(ub3, 126, axis=2)[:, :, 126:]
                bm[h0:h1] = top2[:, :, 1]
                bm2[h0:h1] = top2[:, :, 0]
                ap[h0:h1] = np.argmax(ub3, axis=2).astype(np.uint8)
            self._h_dense_blockmax = bm
            self._h_dense_blockmax2 = bm2
            self._h_dense_argpos = ap
            self._h_dense_tf_rows = dense_tf8  # kept for re-provision
            self._h_len_code = len_code
            self.d_dense_tf8 = jnp.asarray(dense_tf8)
            self.d_len_code = jnp.asarray(len_code)
        else:
            sc3 = dense_sc.reshape(H, NBLK, 128)
            top2 = np.partition(sc3, 126, axis=2)[:, :, 126:]
            self._h_dense_blockmax = top2[:, :, 1].copy()
            self._h_dense_blockmax2 = top2[:, :, 0].copy()
            self._h_dense_argpos = np.argmax(sc3, axis=2).astype(np.uint8)
            self._h_dense_sc = dense_sc  # kept for device-loss re-provision
            self._h_dense_tf = dense_tf
            self.d_dense_sc = jnp.asarray(dense_sc)
            self.d_dense_tf = jnp.asarray(dense_tf)
        self.d_dense_blockmax = jnp.asarray(self._h_dense_blockmax)
        self.d_dense_blockmax2 = jnp.asarray(self._h_dense_blockmax2)
        self.d_dense_argpos = jnp.asarray(self._h_dense_argpos)

    # Bloom rows are stored on device only for terms with df <= this
    # ceiling (= PHRASE_MAX_L: higher-df candidates never take the
    # list-path phrase kernels, and the pruned dense phrase route has no
    # bloom gate). Probes whose gathered slot's term exceeds it are
    # host-disabled (probe_active=False -> pass, pruning-only change).
    # Combined with non-empty-row presence (the reference's BloomBoxWriter
    # bitmap, flash_containers.h:532-561) and the 1-word fold, device
    # bloom bytes drop ~24x vs the dense 2x(P,3) layout (1M docs:
    # 1.88 GB -> ~0.1 GB) at a slightly higher false-positive rate —
    # false positives only admit lanes into the position verify, never
    # change results.
    BLOOM_DF_CEILING = 32768

    def _build_bloom_sparse(self) -> None:
        """Host-side sparse folded bloom columns (see kernels._bloom_gate
        for the device layout). Rebuilt once; uploaded by _upload."""
        pk = self.packed
        if pk.bloom_ends is None:
            self._h_bloom_rows = np.zeros(1, dtype=np.uint32)
            self._h_bloom_bitmap = np.zeros(2, dtype=np.uint32)
            self._h_bloom_rank = np.zeros(2, dtype=np.int32)
            return
        lens = np.diff(pk.term_starts)
        term_mask = np.repeat(pk.df <= self.BLOOM_DF_CEILING, lens)
        rows_parts, bitmap_parts, rank_parts = [], [], []
        base = 0
        for rows in (pk.bloom_ends, pk.bloom_begins):
            fold = rows[:, 0].copy()
            for w in range(1, rows.shape[1]):
                np.bitwise_or(fold, rows[:, w], out=fold)
            stored = (fold != 0) & term_mask
            rows_parts.append(fold[stored])
            bitmap_parts.append(
                np.packbits(stored, bitorder="little").view("<u4"))
            cnt = stored.reshape(-1, 32).sum(axis=1)
            rank = np.zeros(len(cnt), dtype=np.int64)
            np.cumsum(cnt[:-1], out=rank[1:])
            rank_parts.append((rank + base).astype(np.int32))
            base += int(stored.sum())
        self._h_bloom_rows = (np.concatenate(rows_parts) if base
                              else np.zeros(1, dtype=np.uint32))
        self._h_bloom_bitmap = np.concatenate(bitmap_parts)
        self._h_bloom_rank = np.concatenate(rank_parts)

    def _build_single_term_table(self, scores64: np.ndarray, depth: int):
        """Impact-ordered per-term top table: a single-term query's top-k
        depends only on the index (score = idf * lossy tfnorm — exactly
        the f64 partial score), so the answer is precomputable. Serving a
        single-term query becomes a host array slice — no device work.
        This generalizes the reference's 256-entry BM25 cache idea
        (scoring.h:85-90) to the full per-term answer; the reference
        cannot afford it because it re-reads postings from flash, we can
        because the table is (n_terms x depth x 2) ints in host RAM.

        Table rows are sorted by the exact oracle canon (f64 score desc,
        doc asc), so any k <= depth (or k >= df) is served bit-exactly."""
        self._tt_starts, self._tt_docs, self._tt_scores = \
            build_single_term_table(self.packed, scores64, depth)

    def _serve_single_term(self, qi: int, row: int, q: SearchQuery,
                           results: List[SearchResult]) -> bool:
        """Answer a single-term query from the impact table; returns False
        if the query needs more depth than the table holds."""
        k = q.n_results
        s, e = int(self._tt_starts[row]), int(self._tt_starts[row + 1])
        cnt = e - s
        if k > cnt and int(self.packed.df[row]) > cnt:
            return False  # deeper than the table: device/host path
        take = min(k, cnt)
        res = results[qi]
        res.set_arrays(self._tt_docs[s : s + take],
                       self._tt_scores[s : s + take])
        if q.return_snippets and self.doc_bodies is not None:
            pq = _PlannedQuery(qi, [row], q)
            for entry in res.entries:
                entry.snippet = self._snippet(pq, entry.doc_id)
        return True

    def _upload(self) -> None:
        """Upload the device-resident columns (once, at init)."""
        packed = self.packed
        self.d_postings_doc = jnp.asarray(self._h_doc)
        if self.columns == "tc":
            self.d_postings_tc = jnp.asarray(self._h_tc)
            self.d_avg32 = jnp.asarray(self._avg32)
            self.d_postings_score = None
            self.d_postings_tf = None
        else:
            self.d_postings_score = jnp.asarray(self._h_score)
            self.d_postings_tf = jnp.asarray(self._h_tf)
        self.d_pos_starts = jnp.asarray(packed.pos_starts, dtype=jnp.int32)
        # trailing pad: the window verify dynamic-slices PW-wide bags
        # anywhere in the column, so the tail needs >= PW slack entries
        # (pad VALUES are masked by per-lane validity; the slack only
        # prevents dynamic_slice clamping, which would silently load
        # misaligned real data). uint16 when positions fit (2x less HBM;
        # kernels cast at load via _pos_gather) — the reference stores
        # positions as varint deltas for the same byte reason.
        max_pos = int(packed.positions.max(initial=0))
        if max_pos + self.MAX_T < 2**16 - 1:
            positions = np.concatenate([
                np.asarray(packed.positions).astype(np.uint16),
                np.full(self.POS_PAD, 2**16 - 1, dtype=np.uint16)])
        else:
            positions = np.concatenate([
                np.asarray(packed.positions, dtype=np.int32),
                np.full(self.POS_PAD, -1, dtype=np.int32)])
        self.d_positions = jnp.asarray(positions)
        self.d_bloom_rows = jnp.asarray(self._h_bloom_rows)
        self.d_bloom_bitmap = jnp.asarray(self._h_bloom_bitmap)
        self.d_bloom_rank = jnp.asarray(self._h_bloom_rank)

    def _bump(self, **deltas) -> None:
        with self._stats_lock:
            for k, v in deltas.items():
                self.stats[k] = self.stats.get(k, 0) + v

    def stats_take(self) -> Dict[str, float]:
        """Return and reset the counters (per-measurement attribution)."""
        with self._stats_lock:
            out, self.stats = self.stats, {}
        return out

    def clear_result_memos(self) -> None:
        """Drop result-level caches (the memoized host merges). Benchmark
        harnesses call this between a warmup pass and a timed pass over
        the same query list: shape/compile warmth is steady-state serving
        reality, but a primed RESULT cache would turn the timed pass into
        a cache readout."""
        with self._stats_lock:
            self._host_cache.clear()

    def _host_exact(self, rows, k: int, is_phrase: bool = False):
        """Memoized exact host search (see _host_cache note)."""
        key = (tuple(rows), int(k), bool(is_phrase))
        hit = self._host_cache.get(key)
        if hit is None:
            import time as _time

            if len(self._host_cache) >= self.HOST_CACHE_CAP:
                self._host_cache.clear()
            t0 = _time.time()
            hit = host_exact_search(self._host_packed, self.cache64, rows,
                                    k, is_phrase=is_phrase)
            self._bump(host_exact_calls=1,
                       host_exact_s=_time.time() - t0)
            self._host_cache[key] = hit
        else:
            self._bump(host_exact_hits=1)
        return hit

    def device_bytes(self) -> dict:
        """Accounting of device-resident index bytes per column family —
        the capacity story of the compressed mode (the reference's
        packed-posting rationale, flash_engine_dumper.h:557-620)."""
        out = {}
        posting = self.d_postings_doc.nbytes
        if self.columns == "tc":
            posting += self.d_postings_tc.nbytes
        else:
            posting += self.d_postings_score.nbytes + self.d_postings_tf.nbytes
        out["postings"] = int(posting)
        out["positions"] = int(self.d_positions.nbytes + self.d_pos_starts.nbytes)
        if getattr(self, "_dense_H", 0):
            dense = (self.d_dense_tf8.nbytes + self.d_len_code.nbytes
                     if self.columns == "tc"
                     else self.d_dense_sc.nbytes + self.d_dense_tf.nbytes)
            dense += (self.d_dense_blockmax.nbytes
                      + self.d_dense_blockmax2.nbytes
                      + self.d_dense_argpos.nbytes)
        else:
            dense = 0
        out["dense_tier"] = int(dense)
        out["blooms"] = int(self.d_bloom_rows.nbytes
                            + self.d_bloom_bitmap.nbytes
                            + self.d_bloom_rank.nbytes)
        out["total"] = sum(out.values())
        return out

    def _dispatch_async(self, fn):
        """Run a dispatch closure on the IO pool (dispatches of separate
        groups overlap) or inline when pooling is off.
        Returns either the device array or a Future of it — resolve with
        _resolve."""
        if self._io_pool is not None:
            return self._io_pool.submit(fn)
        return fn()

    @staticmethod
    def _resolve(out):
        """Future-or-array -> array (re-raises dispatch-side errors)."""
        return out.result() if hasattr(out, "result") else out

    def _fetch(self, out) -> np.ndarray:
        """Resolve + device->host fetch, timed into fetch_wait_s — this
        wait covers BOTH device compute still in flight and the transfer,
        so (finalize_s - fetch_wait_s) is the route's host-side cost."""
        t0 = _time.perf_counter()
        arr = np.asarray(self._resolve(out))
        self._bump(fetch_wait_s=_time.perf_counter() - t0)
        return arr

    # ------------------------------------------------------------------

    def search(self, query: SearchQuery) -> SearchResult:
        return self.search_batch([query])[0]

    def search_batch(self, queries: List[SearchQuery]) -> List[SearchResult]:
        results, pending = self.submit_batch(queries)
        self.run_pending(results, pending)
        return results

    def run_pending(self, results, pending) -> None:
        """Drain finalizers; independent ones run on the fetch pool so
        their device->host waits and host re-ranks overlap. Finalizers
        marked .barrier (the coalescing
        fan-out, which reads other queries' results) run after."""
        barrier = [f for f in pending if getattr(f, "barrier", False)]
        plain = [f for f in pending if not getattr(f, "barrier", False)]
        if self._fetch_pool is not None and len(plain) > 1:
            futs = [self._fetch_pool.submit(f, results) for f in plain]
            for fu in futs:
                fu.result()
        else:
            for f in plain:
                f(results)
        for f in barrier:
            f(results)

    MAX_T = 8  # hard cap on query terms in the vectorized flat path

    def submit_batch(self, queries: List[SearchQuery]):
        """Asynchronously dispatch a batch; device work proceeds while the
        caller prepares (or submits) more batches. Returns
        (results, finalizers) — call each finalizer(results) to fetch and
        fill in the entries. Lets a serving loop keep several batches in
        flight (the analog of the reference's async completion-queue
        server, grpc_server_impl.h:209-458)."""
        results = [SearchResult() for _ in queries]

        # one python pass for term-dictionary lookups; everything after is
        # vectorized numpy (host planning was ~30% of batch time before)
        lookup = self.packed.term_to_row.get
        flat_qi: List[int] = []
        flat_rows: List[List[int]] = []
        phrase: List[_PlannedQuery] = []
        long_tail: List[_PlannedQuery] = []
        # request coalescing: identical (rows, k, phrase, snippets)
        # queries in one batch execute ONCE and fan out — real logs
        # repeat hot queries heavily (the AOL head), and the reference
        # gets the same effect from its OS page cache on hot postings
        dedup: Dict[tuple, int] = {}
        dups: List[tuple] = []
        for qi, q in enumerate(queries):
            terms = q.terms
            if q.n_results <= 0 or not terms:
                continue
            rows = [lookup(t, -1) for t in terms]
            if min(rows) < 0:
                continue  # missing term -> empty result
            key = (tuple(rows), q.n_results, q.is_phrase,
                   q.return_snippets, q.n_snippet_passages)
            prim = dedup.get(key)
            if prim is not None:
                dups.append((qi, prim))
                continue
            dedup[key] = qi
            if (len(rows) == 1 and self._st_depth
                    and self._serve_single_term(qi, rows[0], q, results)):
                continue  # answered from the impact table, zero device work
            if q.is_phrase and len(rows) >= 2:
                pq = _PlannedQuery(qi, rows, q)
                pq.plan_slots(self.packed.df)
                phrase.append(pq)
            elif len(rows) > self.MAX_T:
                pq = _PlannedQuery(qi, rows, q)
                pq.plan_slots(self.packed.df)
                long_tail.append(pq)
            else:
                flat_qi.append(qi)
                flat_rows.append(rows)

        # per-batch deferred-rescue queue: prune-guard-flagged rows from
        # EVERY group collect here and re-dispatch as one batched full
        # scan in a barrier finalizer (a 128-padded per-group re-scan was
        # ~11x padding waste at the 1M mix's ~4-9% flag rates)
        rq: List[dict] = []
        pending = self._submit_flat_vec(flat_qi, flat_rows, queries,
                                        results, rq=rq)
        pending += self._submit_flat(long_tail)
        pending += self._submit_phrase(phrase, rq=rq)

        def drain_rescues(res_list, rq=rq):
            self._drain_rescues(rq)

        drain_rescues.barrier = True  # after every plain finalizer
        pending.append(drain_rescues)
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

    def _submit_flat_vec(self, flat_qi, flat_rows, queries, results,
                         rq=None):
        """Vectorized planning + assembly for <=MAX_T-term flat queries."""
        N = len(flat_qi)
        if N == 0:
            return []
        MT = self.MAX_T
        qi_arr = np.asarray(flat_qi, dtype=np.int64)
        n_terms = np.fromiter((len(r) for r in flat_rows), dtype=np.int32, count=N)
        rows_pad = np.zeros((N, MT), dtype=np.int32)
        for i, r in enumerate(flat_rows):
            rows_pad[i, : len(r)] = r
        ks = np.fromiter((queries[qi].n_results for qi in flat_qi),
                         dtype=np.int32, count=N)

        slot_idx = np.arange(MT, dtype=np.int32)[None, :]
        valid = slot_idx < n_terms[:, None]  # (N, MT)
        dfs = self._df32[rows_pad]
        dfs_m = np.where(valid, dfs, np.int32(2**31 - 1))
        cand = np.argmin(dfs_m, axis=1).astype(np.int32)
        cand_df = np.take_along_axis(dfs_m, cand[:, None], 1)[:, 0]
        # per-term CSR availability (csr-cold rows of a staged hot view):
        # routes that read posting runs are fenced off these terms below
        csr_bad = ~self._csr_ok[rows_pad] & valid  # (N, MT)
        any_missing = csr_bad.any(axis=1)

        lb = np.asarray(self._lb, dtype=np.int64)
        L_idx = np.minimum(np.searchsorted(lb, cand_df), len(lb) - 1)
        l2 = np.max(np.where(valid, dfs, 0), axis=1)
        L2_idx = np.minimum(np.searchsorted(lb, l2), len(lb) - 1)
        Lval = lb[L_idx]
        L2val = lb[L2_idx]
        windowed = ((n_terms > 1) & (Lval >= self.WINDOWED_MIN_L)
                    & (Lval <= self.WINDOWED_MAX_L)
                    & (L2val // Lval <= self.WINDOWED_MAX_RATIO))
        tb = np.asarray(self._tb, dtype=np.int64)
        T_idx = np.minimum(np.searchsorted(tb, n_terms), len(tb) - 1)

        pending = []
        # all-head-term conjunctions -> doc-space dense kernel (work
        # independent of df; the only memory-safe route for mega L buckets)
        if self._dense_H:
            slot_dense = self._dense_slot[rows_pad] >= 0
            all_dense = np.all(slot_dense | ~valid, axis=1) & (n_terms > 1)
            # sparse all-head combos go SEMIDENSE: the prune guard can
            # only prove exactness when the top-C blocks hold >= k
            # matches, so expected-intersection-poor queries (random head
            # triples: ~95% flag rate measured at 1M) would all fall back
            # to host. Expected matches under independence =
            # N * prod(df_i/N); semidense answers exactly at L x (T-1)
            # gathers when the candidate list is small enough.
            with np.errstate(divide="ignore"):
                log_df = np.where(valid, np.log(np.maximum(dfs, 1)), 0.0)
            logN = np.log(max(self.packed.n_docs, 1))
            exp_matches = np.exp(
                log_df.sum(axis=1) - (n_terms - 1) * logN)
            # csr-missing all-dense queries take the dense route even
            # when sparse (the semidense alternative needs the candidate
            # term's CSR); a guard flag there falls back to the exact
            # host search over host_packed — correct either way
            all_dense &= ((cand_df.astype(np.int64)
                           > self.SEMI_FROM_DENSE_MAX_CAND_L)
                          | (exp_matches >= 4.0 * ks)
                          | any_missing)
            if all_dense.any():
                dm = np.nonzero(all_dense)[0]
                pending += self._submit_dense(
                    dm, qi_arr, flat_rows, rows_pad, n_terms, ks, queries,
                    results, rq=rq)
                keep = ~all_dense
                if not keep.any():
                    return pending
                (qi_arr, n_terms, rows_pad, ks, valid, dfs, cand, cand_df,
                 Lval, L2val, windowed, T_idx, L_idx, L2_idx,
                 csr_bad, any_missing) = (
                    qi_arr[keep], n_terms[keep], rows_pad[keep], ks[keep],
                    valid[keep], dfs[keep], cand[keep], cand_df[keep],
                    Lval[keep], L2val[keep], windowed[keep], T_idx[keep],
                    L_idx[keep], L2_idx[keep], csr_bad[keep],
                    any_missing[keep])
                flat_rows = [flat_rows[i] for i in np.nonzero(keep)[0]]
                N = len(flat_rows)

        # mega-pair routing: WINDOWED-ELIGIBLE mega pairs run the windowed
        # device kernel; only ineligible ones (length ratio > 4, where WIN
        # would blow up) go to the exact host merge. Queries whose
        # candidate list exceeds the largest L bucket (bucket saturation
        # would silently scan only the first L postings) are ALWAYS routed
        # to the exact host path — including single-term ones.
        saturated = cand_df.astype(np.int64) > int(lb[-1])
        # tail-candidate x (dense + small-bs) others -> mixed semi-dense
        # kernel: dense others cost one doc-indexed gather per lane, the
        # remaining small (< dense_min) others a short-span binary search
        # — ANY dense other qualifies. This replaces the full-column bs
        # kernel (~20 serial dependent gathers per lane across multi-MB
        # runs) and the host merge for every multi-term query touching a
        # head term.
        semi = np.zeros(len(qi_arr), dtype=bool)
        if self._dense_H:
            slot_dense = self._dense_slot[rows_pad] >= 0
            idxs = np.arange(rows_pad.shape[1], dtype=np.int32)[None, :]
            any_dense_other = np.any(
                slot_dense & valid & (idxs != cand[:, None]), axis=1)
            # semidense OUTRANKS the windowed kernel when a dense other
            # exists: one doc-indexed gather per lane vs the windowed
            # block compare's (WIN*128)-wide equality tensor per lane;
            # with the widened dense-eligibility tier this absorbs most
            # former windowed traffic in tc mode.
            semi = (n_terms > 1) & any_dense_other & ~saturated
            # the candidate term's CSR seeds the lanes and non-dense
            # others are resolved by bs over their runs — both need CSR
            cand_ok = np.take_along_axis(
                self._csr_ok[rows_pad], cand[:, None].astype(np.int64),
                1)[:, 0]
            semi &= cand_ok & np.all(slot_dense | ~csr_bad, axis=1)
            if semi.any():
                sm = np.nonzero(semi)[0]
                pending += self._submit_semidense(
                    sm, qi_arr, flat_rows, n_terms, cand, ks, Lval, queries,
                    results, rows_pad=rows_pad)
        host_merge = ((n_terms > 1) & (Lval >= self.HOST_MERGE_MIN_L)
                      & ~windowed & ~semi) | saturated \
            | (any_missing & ~semi)  # windowed/bs/single need every CSR
        if host_merge.any():
            hm = np.nonzero(host_merge)[0]

            # bind originals: qi_arr/flat_rows/ks are re-filtered below
            def run_host_merge(res_list, hm=hm, qi_arr=qi_arr,
                               flat_rows=flat_rows, ks=ks):
                for i in hm:
                    qi = int(qi_arr[i])
                    d, s = self._host_exact(flat_rows[i], int(ks[i]))
                    res = res_list[qi]
                    res.set_arrays(d, s)
                    q = queries[qi]
                    if q.return_snippets and self.doc_bodies is not None:
                        pq = _PlannedQuery(qi, flat_rows[i], q)
                        for e in res.entries:
                            e.snippet = self._snippet(pq, e.doc_id)

            pending.append(run_host_merge)
        routed = host_merge | semi
        if routed.any():
            keep = ~routed
            if not keep.any():
                return pending
            # drop routed queries from the device plan
            (qi_arr, n_terms, rows_pad, ks, valid, dfs, cand, Lval, L2val,
             windowed, T_idx) = (
                qi_arr[keep], n_terms[keep], rows_pad[keep], ks[keep],
                valid[keep], dfs[keep], cand[keep], Lval[keep], L2val[keep],
                windowed[keep], T_idx[keep])
            L_idx = L_idx[keep]
            L2_idx = L2_idx[keep]
            flat_rows = [flat_rows[i] for i in np.nonzero(keep)[0]]
            N = len(flat_rows)

        key = (T_idx.astype(np.int64) * 1000 + L_idx * 10
               + np.where(windowed, L2_idx + 1, 0))
        uniq_keys, inverse = np.unique(key, return_inverse=True)

        # slot order: candidate first, remaining real terms in query order,
        # padding last (stable argsort of a rank key)
        rank = np.where(slot_idx == cand[:, None], np.int32(-1),
                        np.where(valid, slot_idx, np.int32(MT + 1)))
        order = np.argsort(rank, axis=1, kind="stable")  # (N, MT)
        slot_rows_all = np.take_along_axis(rows_pad, order, 1)
        # fill padding slots with the candidate's row
        slot_rows_all = np.where(slot_idx < n_terms[:, None], slot_rows_all,
                                 slot_rows_all[:, :1])
        slot_of_all = np.argsort(order, axis=1, kind="stable")  # query t -> slot
        idf64_all = self.packed.idf64[rows_pad] * valid  # query-term order
        # slot-order f32 idfs for the tc kernels (0 on padded slots)
        idf32_slot_all = (self.packed.idf64[slot_rows_all]
                          * (slot_idx < n_terms[:, None])).astype(np.float32)

        for gi, gkey in enumerate(uniq_keys):
            members_all = np.nonzero(inverse == gi)[0]
            T_i = int(key[members_all[0]])  # decode from any member
            T = int(tb[T_i // 1000])
            L = int(lb[(T_i % 1000) // 10])
            w_code = T_i % 10
            L2 = int(lb[w_code - 1]) if w_code else 0
            # windowed kernels materialize (B, L/128, WIN, 128) window
            # tensors per non-candidate slot (the row-gathered docs/score/
            # tf payloads); cap the batch width so the largest live tensor
            # stays ~0.5GB (WIN=10 shapes at B=4096 would take 8GB)
            chunk = B_CHUNK
            if L2:
                win = K.default_win(L, L2 // 128)
                lanes = (T - 1) * L * win
                fit = (1 << 27) // max(lanes, 1)
                chunk = 128
                for b in B_BUCKETS:  # largest bucket within the memory cap
                    if b <= fit:
                        chunk = b
            for ci in range(0, len(members_all), chunk):
                m = members_all[ci : ci + chunk]
                B = _bucket(len(m), B_BUCKETS)
                slot_rows = np.zeros((B, T), dtype=np.int32)
                slot_rows[: len(m)] = slot_rows_all[m, :T]
                starts = self._starts32[slot_rows]
                ends = starts + self._df32[slot_rows]
                starts[len(m):] = 0
                ends[len(m):] = 0
                use_score = np.zeros((B, T), dtype=np.float32)
                use_score[: len(m)] = (
                    np.arange(T)[None, :] < n_terms[m, None]).astype(np.float32)
                idf64_q = np.zeros((B, T), dtype=np.float64)
                idf64_q[: len(m)] = idf64_all[m, :T]
                idf32_g = np.zeros((B, T), dtype=np.float32)
                idf32_g[: len(m)] = idf32_slot_all[m, :T]
                slot_of = np.zeros((B, T), dtype=np.int64)
                slot_of[: len(m)] = slot_of_all[m, :T]
                ks_g = np.zeros(B, dtype=np.int32)
                ks_g[: len(m)] = ks[m]
                pending.append(self._dispatch_flat(
                    T, L, L2, starts, ends, use_score, idf64_q, slot_of,
                    ks_g, qi_arr[m], flat_rows, m, queries, results,
                    idf32=idf32_g))
        return pending

    # (B, N_pad) f32 tensors: 128 x 1M docs = 512MB per live tensor
    DENSE_CHUNK = 128
    # the PRUNED kernel's biggest live tensors are the (B, T, C*128)
    # candidate payloads — lane-budgeted chunks go much wider, cutting
    # the dispatch count ~8x (at 1M docs, 60% of the two-term workload
    # routes here)
    PRUNED_DENSE_B_BUCKETS = [8, 128, 512, 1024]

    def _submit_dense(self, dm, qi_arr, flat_rows, rows_pad, n_terms, ks,
                      queries, results, rq=None):
        """All-head conjunctions via the doc-space dense kernel."""
        pending = []
        NBLK = self._n_pad_docs // 128
        pruned = NBLK >= max(self.PRUNED_DENSE_MIN_NB,
                             self.PRUNED_DENSE_C + 1)
        groups: Dict[int, list] = {}
        for i in dm:
            groups.setdefault(int(_bucket(int(n_terms[i]), self._tb)),
                              []).append(int(i))
        for T, members in groups.items():
            if pruned:
                buckets = self.PRUNED_DENSE_B_BUCKETS
                fit = (1 << 27) // max(T * self.PRUNED_DENSE_C * 128, 1)
                chunk = buckets[0]
                for b in buckets:
                    if b <= fit:
                        chunk = b
            else:
                buckets = [8, self.DENSE_CHUNK]
                chunk = self.DENSE_CHUNK
            for ci in range(0, len(members), chunk):
                m = members[ci : ci + chunk]
                B = _bucket(len(m), buckets)
                slots = np.zeros((B, T), dtype=np.int32)
                use = np.zeros((B, T), dtype=np.float32)
                idf64_q = np.zeros((B, T), dtype=np.float64)
                idf32_g = np.zeros((B, T), dtype=np.float32)
                slot_of = np.tile(np.arange(T, dtype=np.int64), (B, 1))
                ks_g = np.zeros(B, dtype=np.int32)
                for bi, i in enumerate(m):
                    rows = flat_rows[i]
                    ks_g[bi] = ks[i]
                    for t in range(T):
                        r = rows[t] if t < len(rows) else rows[0]
                        slots[bi, t] = self._dense_slot[r]
                        if t < len(rows):
                            use[bi, t] = 1.0
                            idf64_q[bi, t] = self.packed.idf64[r]
                            idf32_g[bi, t] = np.float32(self.packed.idf64[r])
                M = min(int(ks_g.max(initial=1)) + self.margin,
                        self._n_pad_docs)
                NB = NBLK
                C = self.PRUNED_DENSE_C

                def dispatch(T=T, M=M, slots=slots, idf32_g=idf32_g,
                             use=use, ks_g=ks_g):
                    if pruned:
                        # block-max pruned scan: ~NB/C less lane work;
                        # any query the guard can't prove exact is
                        # flagged to the memoized host path
                        # (_flags_to_force bit 3). Guard slop 3*rel_eps
                        # (see kernels module note).
                        eps3 = 3.0 * self.rel_eps
                        kd = jnp.asarray(ks_g)
                        if self.columns == "tc":
                            kern = K.make_pruned_dense_kernel_tc(
                                T, NB, C, M, eps3)
                            return kern(self.d_dense_tf8, self.d_len_code,
                                        self.d_avg32,
                                        self.d_dense_blockmax,
                                        self.d_dense_blockmax2,
                                        self.d_dense_argpos,
                                        jnp.asarray(slots),
                                        jnp.asarray(idf32_g), kd)
                        kern = K.make_pruned_dense_kernel(T, NB, C, M, eps3)
                        return kern(self.d_dense_sc, self.d_dense_tf,
                                    self.d_dense_blockmax,
                                    self.d_dense_blockmax2,
                                    self.d_dense_argpos,
                                    jnp.asarray(slots), jnp.asarray(use),
                                    kd)
                    if self.columns == "tc":
                        kern = K.make_dense_search_kernel_tc(
                            T, self._n_pad_docs, M)
                        return kern(self.d_dense_tf8, self.d_len_code,
                                    self.d_avg32, jnp.asarray(slots),
                                    jnp.asarray(idf32_g))
                    kern = K.make_dense_search_kernel(T, self._n_pad_docs, M)
                    return kern(self.d_dense_sc, self.d_dense_tf,
                                jnp.asarray(slots), jnp.asarray(use))

                holder = [self._dispatch_async(dispatch)]

                def finalize(res_list, holder=holder,
                             T=T, M=M, m=m, slot_of=slot_of, slots=slots,
                             idf32_g=idf32_g, use=use,
                             idf64_q=idf64_q, ks_g=ks_g, qi_arr=qi_arr,
                             flat_rows=flat_rows, queries=queries,
                             pruned=pruned, rq=rq):
                    n = len(m)
                    packed_out = self._fetch(holder[0])[:n]
                    force = self._flags_to_force(packed_out[:, T + 1, 0])
                    if (pruned and self.DENSE_RESCUE and rq is not None
                            and force.any()
                            and ((packed_out[:n, T + 1, 0]
                                  & K.FLAG_PRUNE_MISS) != 0).any()):
                        # defer flagged rows to the batch-level drain: ONE
                        # full-scan re-dispatch per (T, M) across every
                        # group of this batch instead of a 128-padded
                        # re-scan per group (see _drain_rescues)
                        miss = (packed_out[:n, T + 1, 0]
                                & K.FLAG_PRUNE_MISS) != 0
                        sub = np.nonzero(miss)[0]
                        keep = np.nonzero(~miss)[0]
                        qis = np.asarray([qi_arr[i] for i in m],
                                         dtype=np.int64)
                        members = np.asarray(m)
                        with self._rescue_lock:
                            rq.append(dict(
                                kind="dense", T=T, M=M, slots=slots[sub],
                                idf32_g=idf32_g[sub], use=use[sub],
                                slot_of=slot_of[sub],
                                idf64_q=idf64_q[sub], ks=ks_g[sub],
                                qis=qis[sub], members=members[sub],
                                flat_rows=flat_rows, queries=queries,
                                res_list=res_list))
                        if keep.size:
                            self._finalize_arrays(
                                packed_out[keep][:, 0, :],
                                packed_out[keep][:, 1 : T + 1, :],
                                slot_of[keep], idf64_q[keep], ks_g[keep],
                                qis[keep], flat_rows, members[keep],
                                queries, res_list, force_host=force[keep])
                        return
                    if pruned and self.DENSE_RESCUE and force.any():
                        # prune-guard misses retry on the exact full
                        # dense scan (device) before any host fallback
                        # (no deferral queue: rescue them per group).
                        miss = (packed_out[:n, T + 1, 0]
                                & K.FLAG_PRUNE_MISS) != 0
                        if miss.any():
                            sub = np.nonzero(miss)[0]
                            rescued = self._dense_full_rescue(
                                T, M, slots[sub], idf32_g[sub], use[sub])
                            packed_out = packed_out.copy()  # device view is RO
                            packed_out[sub] = rescued
                            force[sub] = self._flags_to_force(
                                rescued[:, T + 1, 0], rescue=True)
                    qis = np.asarray([qi_arr[i] for i in m], dtype=np.int64)
                    self._finalize_arrays(
                        packed_out[:, 0, :], packed_out[:, 1 : T + 1, :],
                        slot_of[:n], idf64_q[:n], ks_g[:n], qis, flat_rows,
                        np.asarray(m), queries, res_list,
                        force_host=force)

                pending.append(finalize)
        return pending

    def _dense_full_rescue(self, T, M, slots, idf32_g, use):
        """Exact full-scan dense kernel over a flagged subset — the
        device-side second chance for FLAG_PRUNE_MISS rows. Returns
        packed (n, T+2, M) rows in the same layout as the pruned kernel;
        the caller re-derives force_host from the rescue's own flags
        (no prune bit can recur: every doc block is examined)."""
        n = len(slots)
        t0 = _time.perf_counter()
        out = np.empty((n, T + 2, M), dtype=np.int32)
        # lane-budget the full-scan chunk: a (B, N_pad) f32 workspace at
        # B=128 is 512MB at 1M docs but 5.1GB at 10M — on a staged
        # bigger-than-HBM engine that rides on top of a ~10GiB resident
        # budget, a wide rescue is itself an HBM-OOM hazard. 2^28 lanes
        # keeps the 1M shapes identical (chunk 128) and drops to 8-wide
        # chunks at 10M (~320MB live).
        fit = (1 << 28) // max(self._n_pad_docs, 1)
        buckets = [b for b in [8, self.DENSE_CHUNK] if b <= max(fit, 8)]
        chunk = buckets[-1]
        chunks = []
        for ci in range(0, n, chunk):
            sl = slice(ci, min(ci + chunk, n))
            B = _bucket(sl.stop - sl.start, buckets)
            s_p = np.zeros((B, T), dtype=np.int32)
            s_p[: sl.stop - sl.start] = slots[sl]
            i_p = np.zeros((B, T), dtype=np.float32)
            i_p[: sl.stop - sl.start] = idf32_g[sl]
            u_p = np.zeros((B, T), dtype=np.float32)
            u_p[: sl.stop - sl.start] = use[sl]

            def dispatch(s_p=s_p, i_p=i_p, u_p=u_p):
                if self.columns == "tc":
                    kern = K.make_dense_search_kernel_tc(
                        T, self._n_pad_docs, M)
                    return kern(self.d_dense_tf8, self.d_len_code,
                                self.d_avg32,
                                jnp.asarray(s_p), jnp.asarray(i_p))
                kern = K.make_dense_search_kernel(T, self._n_pad_docs, M)
                return kern(self.d_dense_sc, self.d_dense_tf,
                            jnp.asarray(s_p), jnp.asarray(u_p))

            chunks.append((sl, self._dispatch_async(dispatch)))
        for sl, holder in chunks:
            out[sl] = self._fetch(holder)[: sl.stop - sl.start]
        self._bump(prune_rescued=n, rescue_s=_time.perf_counter() - t0)
        return out

    def _drain_rescues(self, rq: List[dict]) -> None:
        """Batch-level second-chance pass (barrier finalizer): flagged
        rows deferred by every group of a batch re-dispatch TOGETHER —
        dense prune misses as one full-scan call per (T, M), pruned-
        phrase misses as one retry call per (T, PP, PW, M) — then the
        affected rows finalize. Replaces per-group rescues whose 128-wide
        chunk was ~90% padding at the 1M mix's 4-9% flag rates."""
        with self._rescue_lock:
            ctxs, rq[:] = list(rq), []
        if not ctxs:
            return
        groups: Dict[tuple, List[dict]] = {}
        for c in ctxs:
            key = ((c["kind"], c["T"], c["M"]) if c["kind"] == "dense"
                   else (c["kind"], c["T"], c["PP"], c["PW"], c["M"]))
            groups.setdefault(key, []).append(c)
        for key, cs in groups.items():
            T, M = cs[0]["T"], cs[0]["M"]
            if key[0] == "dense":
                rescued = self._dense_full_rescue(
                    T, M,
                    np.concatenate([c["slots"] for c in cs]),
                    np.concatenate([c["idf32_g"] for c in cs]),
                    np.concatenate([c["use"] for c in cs]))
                off = 0
                for c in cs:
                    k = len(c["qis"])
                    sub = rescued[off : off + k]
                    off += k
                    force = self._flags_to_force(sub[:, T + 1, 0],
                                                 rescue=True)
                    self._finalize_arrays(
                        sub[:, 0, :], sub[:, 1 : T + 1, :], c["slot_of"],
                        c["idf64_q"], c["ks"], c["qis"], c["flat_rows"],
                        c["members"], c["queries"], c["res_list"],
                        force_host=force)
            else:
                PP, PW = cs[0]["PP"], cs[0]["PW"]
                rescued = self._pruned_phrase_rescue(
                    T, PP, PW, M,
                    np.concatenate([c["starts"] for c in cs]),
                    np.concatenate([c["ends"] for c in cs]),
                    np.concatenate([c["slots"] for c in cs]),
                    np.concatenate([c["use"] for c in cs]),
                    np.concatenate([c["idf32_q"] for c in cs]),
                    np.concatenate([c["anchor"] for c in cs]),
                    np.concatenate([c["ks"] for c in cs]))
                off = 0
                for c in cs:
                    k = len(c["group"])
                    sub = rescued[off : off + k]
                    off += k
                    force = self._flags_to_force(sub[:, T + 1, 0],
                                                 rescue=True)
                    self._finalize_group(
                        c["group"], sub[:, 0, :], sub[:, 1 : T + 1, :],
                        c["slot_id"], c["idf64_q"], c["ks"], c["res_list"],
                        force_host=force)

    def _submit_semidense(self, sm, qi_arr, flat_rows, n_terms, cand, ks,
                          Lval, queries, results, rows_pad=None):
        """Tail-candidate x (dense + small-bs) others via the mixed
        semi-dense kernel. Slot layout: 0 = candidate, 1..n_bs =
        non-dense others (short-span binary search), rest = dense
        others; padded slots repeat the first dense slot with idf 0.

        Group split and slot layout are vectorized (stable argsort of a
        per-(member, t) class rank, the _submit_flat_vec trick) — the
        per-member Python double loop was ~30% of 32k-batch planning
        time on the single host core."""
        pending = []
        if rows_pad is None:  # long-tail caller convenience
            MTmax = max(len(flat_rows[i]) for i in sm)
            rows_pad = np.zeros((len(flat_rows), MTmax), dtype=np.int64)
            for i in sm:
                rows_pad[i, : len(flat_rows[i])] = flat_rows[i]
        MT = rows_pad.shape[1]
        sm = np.asarray(sm, dtype=np.int64)
        rp = rows_pad[sm]                       # (S, MT) term rows
        nt = np.asarray(n_terms)[sm]
        cs = np.asarray(cand)[sm]
        col = np.arange(MT, dtype=np.int64)[None, :]
        v = col < nt[:, None]
        ds = self._dense_slot[rp]               # dense slot or -1
        is_cand = col == cs[:, None]
        is_bs = v & ~is_cand & (ds < 0)
        nbs = is_bs.sum(axis=1).astype(np.int64)
        # slot order: candidate, bs others (query order), dense others
        # (query order), padding — stable argsort of the class rank
        rank = np.where(is_cand, np.int32(-1),
                        np.where(is_bs, np.int32(0),
                                 np.where(v, np.int32(1), np.int32(2))))
        order = np.argsort(rank, axis=1, kind="stable")    # (S, MT)
        slot_of_s = np.argsort(order, axis=1, kind="stable")
        sr = np.take_along_axis(rp, order, 1)              # slot-order rows
        ds_s = np.take_along_axis(ds, order, 1)
        idf64_q_s = self.packed.idf64[rp] * v              # query order
        tb = np.asarray(self._tb, dtype=np.int64)
        T_of = tb[np.searchsorted(tb, nt)]
        dfb = np.where(is_bs, self.packed.df[rp], 0).max(axis=1)

        gkey = (T_of * (MT + 1) + nbs) * np.int64(1 << 40) \
            + np.asarray(Lval)[sm].astype(np.int64)
        uniq_keys, inverse = np.unique(gkey, return_inverse=True)
        for gi in range(len(uniq_keys)):
            sel = np.nonzero(inverse == gi)[0]
            T = int(T_of[sel[0]])
            L = int(np.asarray(Lval)[sm[sel[0]]])
            NBs = int(nbs[sel[0]])
            members = [int(sm[s]) for s in sel]
            g_bs_df_max = int(dfb[sel].max(initial=0))
            # quantize the bs depth to L buckets so shapes stay few
            n_it = K.n_iters_for(_bucket(max(g_bs_df_max, 1),
                                         self._lb)) if NBs else 0
            # (B, L) gather tensors per non-candidate slot: cap the chunk
            chunk = B_BUCKETS[0]
            fit = (1 << 27) // max((T - 1) * L, 1)
            for b in B_BUCKETS:
                if b <= fit:
                    chunk = b
            first_dense = 1 + NBs
            ks_all = np.asarray(ks)
            slotcol = np.arange(T, dtype=np.int64)[None, :]
            for ci in range(0, len(sel), chunk):
                gsel = sel[ci : ci + chunk]
                m = members[ci : ci + chunk]
                n = len(gsel)
                B = _bucket(n, B_BUCKETS)
                live = slotcol < nt[gsel][:, None]        # (n, T) slot live
                srt = sr[gsel, :T]
                csbs = slotcol < first_dense              # cand + bs slots
                starts = np.zeros((B, T), dtype=np.int32)
                ends = np.zeros((B, T), dtype=np.int32)
                st = np.where(csbs, self._starts32[srt], 0)
                starts[:n] = st
                ends[:n] = st + np.where(csbs, self._df32[srt], 0)
                slots = np.zeros((B, T), dtype=np.int32)
                sl = np.where(live & ~csbs, ds_s[gsel, :T], 0)
                # padded slots repeat the first dense slot (idf/use 0)
                sl = np.where(live | csbs, sl, sl[:, first_dense : first_dense + 1])
                slots[:n] = sl
                use = np.zeros((B, T), dtype=np.float32)
                use[:n] = live.astype(np.float32)
                idf64_q = np.zeros((B, T), dtype=np.float64)
                idf64_q[:n] = idf64_q_s[gsel, :T]
                idf32_s = np.zeros((B, T), dtype=np.float32)
                idf32_s[:n] = (self.packed.idf64[srt] * live).astype(
                    np.float32)
                slot_of = np.zeros((B, T), dtype=np.int64)
                slot_of[:n] = np.where(v[gsel], slot_of_s[gsel], 0)[:, :T]
                ks_g = np.zeros(B, dtype=np.int32)
                ks_g[:n] = ks_all[np.asarray(m)]
                M = min(L, int(ks_g.max(initial=1)) + self.margin)

                def dispatch(T=T, L=L, M=M, NBs=NBs, n_it=n_it,
                             starts=starts, ends=ends, use=use,
                             idf32_s=idf32_s, slots=slots):
                    if self.columns == "tc":
                        kern = K.make_semidense_kernel_tc(
                            T, L, M, self._n_pad_docs, NBs, n_it)
                        return kern(self.d_postings_doc, self.d_postings_tc,
                                    self.d_avg32, self.d_dense_tf8,
                                    jnp.asarray(starts), jnp.asarray(ends),
                                    jnp.asarray(idf32_s),
                                    jnp.asarray(slots))
                    kern = K.make_semidense_kernel(T, L, M,
                                                   self._n_pad_docs,
                                                   NBs, n_it)
                    return kern(self.d_postings_doc, self.d_postings_score,
                                self.d_postings_tf, self.d_dense_sc,
                                self.d_dense_tf, jnp.asarray(starts),
                                jnp.asarray(ends), jnp.asarray(use),
                                jnp.asarray(slots))

                holder = [self._dispatch_async(dispatch)]

                def finalize(res_list, holder=holder,
                             T=T, m=m, slot_of=slot_of,
                             idf64_q=idf64_q, ks_g=ks_g, qi_arr=qi_arr,
                             flat_rows=flat_rows, queries=queries):
                    n = len(m)
                    packed_out = self._fetch(holder[0])[:n]
                    qis = np.asarray([qi_arr[i] for i in m], dtype=np.int64)
                    self._finalize_arrays(
                        packed_out[:, 0, :], packed_out[:, 1 : T + 1, :],
                        slot_of[:n], idf64_q[:n], ks_g[:n], qis, flat_rows,
                        np.asarray(m), queries, res_list,
                        force_host=self._flags_to_force(
                            packed_out[:, T + 1, 0]))

                pending.append(finalize)
        return pending

    def _dispatch_flat(self, T, L, L2, starts, ends, use_score, idf64_q,
                       slot_of, ks, qis, flat_rows, members, queries, results,
                       idf32=None):
        M = min(L, int(ks.max(initial=1)) + self.margin)
        tc = self.columns == "tc"

        def make_args():
            if tc:
                return (
                    self.d_postings_doc, self.d_postings_tc, self.d_avg32,
                    jnp.asarray(starts), jnp.asarray(ends),
                    jnp.asarray(idf32),
                )
            return (
                self.d_postings_doc, self.d_postings_score,
                self.d_postings_tf,
                jnp.asarray(starts), jnp.asarray(ends), jnp.asarray(use_score),
            )

        mode = "tc" if tc else "raw"
        if L2:
            kern = K.make_windowed_search_kernel(T, L, L2 // 128, M, mode=mode)
        else:
            kern = K.make_search_kernel(T, L, M, K.n_iters_for(self._max_df),
                                        mode=mode)
        holder = [self._dispatch_async(lambda: kern(*make_args()))]

        # _shape default: submit-site attribution for profiling probes
        def finalize(res_list, _shape=(T, L, L2, len(members))):
            packed = self._fetch(holder[0])
            # per-query flags (boundary-class truncation / window
            # overflow): only flagged queries take the exact host fallback
            force_host = self._flags_to_force(packed[:, T + 1, 0])
            self._finalize_arrays(
                packed[:, 0, :], packed[:, 1 : T + 1, :], slot_of, idf64_q,
                ks, qis, flat_rows, members, queries, res_list,
                force_host=force_host)

        return finalize

    def _flags_to_force(self, flags: np.ndarray,
                        rescue: bool = False) -> np.ndarray:
        """Kernel flag word -> host-fallback mask. Bit 1 (window overflow:
        lanes genuinely missing), bit 2 (a kept lane's tf byte
        saturated — its tc-mode score was the optimistic bound and its
        returned tf is wrong) and bit 3 (pruned-dense: an unexamined
        block's upper bound could beat/tie the kept set) always force
        the exact path. Bit 0
        (f32 boundary-CLASS truncated) forces only under strict_parity:
        a truncated class breaks parity only in the astronomically rare
        event that an excluded class member f32-collides with a distinct
        f64 score (see topk.truncation_suspects); ~80% of all-head
        queries have >buffer tie classes, so defaulting this on would put
        most of the mega workload on the host path."""
        force = (flags & (K.FLAG_OVERFLOW | K.FLAG_TF_SAT
                          | K.FLAG_PRUNE_MISS)) != 0
        if self.strict_parity:
            force = force | ((flags & K.FLAG_TRUNC) != 0)
        if rescue:  # second-chance pass: count only what still forces
            self._bump(forced_host_after_rescue=int(force.sum()))
            return force
        self._bump(
            q_flag_seen=len(flags),
            flag_trunc=int(((flags & K.FLAG_TRUNC) != 0).sum()),
            flag_overflow=int(((flags & K.FLAG_OVERFLOW) != 0).sum()),
            flag_tf_sat=int(((flags & K.FLAG_TF_SAT) != 0).sum()),
            flag_prune_miss=int(((flags & K.FLAG_PRUNE_MISS) != 0).sum()),
            forced_host=int(force.sum()))
        return force

    def _finalize_arrays(self, top_docs, top_tfs_slot, slot_of, idf64_q, ks,
                         qis, flat_rows, members, queries, results,
                         force_host=None):
        n = len(qis)
        t0 = _time.perf_counter()
        B, T, M = top_tfs_slot.shape
        # flat-index gather (take_along_axis builds np.indices per call —
        # measured finalize hot spot on 32k batches)
        flat = ((np.arange(B, dtype=np.int64)[:, None] * T
                 + slot_of.astype(np.int64))[:, :, None] * M
                + np.arange(M, dtype=np.int64)[None, None, :])
        tf_q = top_tfs_slot.reshape(-1)[flat]
        docs_f, score_f, n_valid = rescore_sorted_arrays(
            top_docs, tf_q, idf64_q, self.packed.doc_len_code, self.cache64)
        suspects = truncation_suspects(score_f, n_valid, ks,
                                       rel_eps=self.rel_eps)
        if force_host is not None:
            suspects = suspects | force_host[: len(suspects)]
        self._bump(host_fallback_q=int(suspects.sum()),
                   rescore_s=_time.perf_counter() - t0)
        cnts = np.minimum(ks[:n], n_valid[:n])
        snip = self.doc_bodies is not None
        for i in range(n):
            qi = int(qis[i])
            res = results[qi]
            if suspects[i]:
                # possible f32 tie-class truncation at the margin: exact
                # host re-search (rare)
                d, s = self._host_exact(
                    flat_rows[int(members[i])], int(ks[i]))
                res.set_arrays(d, s)
            else:
                cnt = cnts[i]
                res.set_arrays(docs_f[i, :cnt], score_f[i, :cnt])
            if snip:
                q = queries[qi]
                if q.return_snippets:
                    pq = _PlannedQuery(qi, flat_rows[int(members[i])], q)
                    entries = res.entries  # materialize
                    for e in entries:
                        e.snippet = self._snippet(pq, e.doc_id)

    # -- grouping / assembly -------------------------------------------

    def _chunked_groups(self, planned: List[_PlannedQuery], keyfn,
                        lanes_of=None, lane_budget: int = None,
                        buckets: Sequence[int] = B_BUCKETS):
        """Group by shape key, then chunk. With lane_budget, the chunk
        width shrinks so B * lanes_of(key) stays under it — the per-group
        tensors must fit device memory."""
        groups: Dict[tuple, List[_PlannedQuery]] = {}
        for pq in planned:
            groups.setdefault(keyfn(pq), []).append(pq)
        for key, group in groups.items():
            chunk = B_CHUNK
            if lane_budget is not None:
                fit = max(1, lane_budget // max(int(lanes_of(key)), 1))
                chunk = buckets[0]
                for b in buckets:
                    if b <= fit:
                        chunk = b
            for i in range(0, len(group), chunk):
                yield key, group[i : i + chunk]

    def _assemble(self, group: List[_PlannedQuery], T: int,
                  buckets: Sequence[int] = B_BUCKETS):
        """Slot-ordered (starts, ends, use_score, idf32) + query-order f64
        metadata for the re-rank."""
        B = _bucket(len(group), buckets)
        starts = np.zeros((B, T), dtype=np.int32)
        ends = np.zeros((B, T), dtype=np.int32)
        use_score = np.zeros((B, T), dtype=np.float32)
        idf32_s = np.zeros((B, T), dtype=np.float32)  # slot order
        idf64_q = np.zeros((B, T), dtype=np.float64)  # query-term order
        slot_of = np.zeros((B, T), dtype=np.int64)
        ks = np.zeros(B, dtype=np.int32)
        for i, pq in enumerate(group):
            ks[i] = pq.query.n_results
            srows = pq.slot_rows
            for t in range(T):
                r = srows[t] if t < len(srows) else srows[0]
                starts[i, t] = self._starts32[r]
                ends[i, t] = self._starts32[r] + self._df32[r]
                if t < len(srows):
                    use_score[i, t] = 1.0
                    idf32_s[i, t] = np.float32(self.packed.idf64[r])
            for t, qr in enumerate(pq.rows):
                idf64_q[i, t] = self.packed.idf64[qr]
                slot_of[i, t] = pq.slot_of_term[t]
        return starts, ends, use_score, idf32_s, idf64_q, slot_of, ks

    def _finalize_group(self, group, top_docs, top_tfs_slot, slot_of,
                        idf64_q, ks, results, force_host=None):
        # slot order -> query-term order for the exact f64 sum
        t0 = _time.perf_counter()
        M = top_tfs_slot.shape[2]
        tf_q = np.take_along_axis(
            top_tfs_slot, np.broadcast_to(slot_of[:, :, None],
                                          (slot_of.shape[0], slot_of.shape[1], M)),
            axis=1,
        )
        docs_f, score_f, n_valid = rescore_sorted_arrays(
            top_docs, tf_q, idf64_q, self.packed.doc_len_code, self.cache64)
        suspects = truncation_suspects(score_f, n_valid, ks,
                                       rel_eps=self.rel_eps)
        if force_host is not None:
            suspects = suspects | force_host[: len(suspects)]
        self._bump(host_fallback_q=int(suspects.sum()),
                   rescore_s=_time.perf_counter() - t0)
        for i, pq in enumerate(group):
            res = results[pq.qi]
            if suspects[i]:
                d, s = self._host_exact(
                    pq.rows, int(ks[i]), is_phrase=pq.query.is_phrase)
                res.set_arrays(d, s)
            else:
                cnt = min(int(ks[i]), int(n_valid[i]))
                res.set_arrays(docs_f[i, :cnt], score_f[i, :cnt])
            if pq.query.return_snippets and self.doc_bodies is not None:
                for e in res.entries:
                    e.snippet = self._snippet(pq, e.doc_id)

    # -- non-phrase (single + AND) -------------------------------------

    # windowed intersection is used when every list in the group is long
    # and similarly sized; binary search otherwise (and as the overflow
    # fallback)
    WINDOWED_MIN_L = 1024
    WINDOWED_MAX_RATIO = 4
    # above this L the window payload tensors ((B, L/128, WIN, 128) x3)
    # exceed device memory even at B=128; all-head queries that big take
    # the dense path, the rest go to the host merge
    WINDOWED_MAX_L = 131072
    # multi-term queries whose candidate list exceeds this go to the exact
    # host merge: the dense windowed compare does ~WIN*128 lane-ops per
    # candidate (vs the merge's ~2), which stops paying off for very long
    # similar lists on this gather-poor backend. (A Pallas staircase-merge
    # device path was tried through round 3 and lost every A/B — removed.)
    HOST_MERGE_MIN_L = 131072

    def _flat_key(self, pq: _PlannedQuery):
        T = _bucket(len(pq.rows), self._tb)
        L = _bucket(int(self.packed.df[pq.slot_rows[0]]), self._lb)
        if T == 1:
            return (T, L, 0, 0)
        l2 = _bucket(max(int(self.packed.df[r]) for r in pq.slot_rows), self._lb)
        windowed = (self.WINDOWED_MIN_L <= L <= self.WINDOWED_MAX_L
                    and l2 // L <= self.WINDOWED_MAX_RATIO)
        # note: keying on per-group search depth was tried and splits
        # groups too finely (more dispatches than the iterations save)
        return (T, L, l2 if windowed else 0, 0)

    def _route_saturated(self, planned: List[_PlannedQuery], is_phrase: bool,
                         max_l: int = None):
        """Split off queries whose candidate list exceeds max_l (default:
        the largest L bucket — the kernels would silently scan only the
        first L candidates). They run exactly on host instead."""
        if max_l is None:
            max_l = self._lb[-1]
        keep: List[_PlannedQuery] = []
        over: List[_PlannedQuery] = []
        for pq in planned:
            if (int(self.packed.df[pq.slot_rows[0]]) > max_l
                    or not all(self._csr_ok[r] for r in pq.rows)):
                # csr-cold rows (staged dense-only terms) have no posting
                # runs for the list kernels to read — exact host path
                over.append(pq)
            else:
                keep.append(pq)
        if not over:
            return planned, []

        def run_host(res_list, over=over, is_phrase=is_phrase):
            for pq in over:
                d, s = self._host_exact(
                    pq.rows, pq.query.n_results, is_phrase=is_phrase)
                res = res_list[pq.qi]
                res.set_arrays(d, s)
                if pq.query.return_snippets and self.doc_bodies is not None:
                    for e in res.entries:
                        e.snippet = self._snippet(pq, e.doc_id)

        return keep, [run_host]

    def _submit_flat(self, planned: List[_PlannedQuery]):
        planned, pending = self._route_saturated(planned, is_phrase=False)
        mode = "tc" if self.columns == "tc" else "raw"
        for (T, L, L2, iters), group in self._chunked_groups(planned, self._flat_key):
            (starts, ends, use_score, idf32_s, idf64_q, slot_of,
             ks) = self._assemble(group, T)
            M = min(L, int(ks.max(initial=1)) + self.margin)
            if mode == "tc":
                args = (
                    self.d_postings_doc, self.d_postings_tc, self.d_avg32,
                    jnp.asarray(starts), jnp.asarray(ends),
                    jnp.asarray(idf32_s),
                )
            else:
                args = (
                    self.d_postings_doc, self.d_postings_score,
                    self.d_postings_tf,
                    jnp.asarray(starts), jnp.asarray(ends),
                    jnp.asarray(use_score),
                )
            if L2:  # windowed block-intersection path
                kern = K.make_windowed_search_kernel(T, L, L2 // 128, M,
                                                     mode=mode)
            else:
                kern = K.make_search_kernel(
                    T, L, M, iters or K.n_iters_for(self._max_df), mode=mode)
            out = self._dispatch_async(lambda kern=kern, args=args:
                                       kern(*args))

            def finalize(results, group=group, out=out,
                         slot_of=slot_of, idf64_q=idf64_q, ks=ks,
                         args=args, T=T, L=L, M=M):
                packed = self._fetch(out)  # ONE roundtrip
                force_host = self._flags_to_force(packed[:, T + 1, 0])
                top_docs = packed[:, 0, :]
                top_tfs = packed[:, 1 : T + 1, :]
                self._finalize_group(group, top_docs, top_tfs, slot_of,
                                     idf64_q, ks, results,
                                     force_host=force_host)

            pending.append(finalize)
        return pending

    # -- phrase --------------------------------------------------------

    # phrase verify tensors are (B, PP, L)-shaped per term; past this L
    # the exact host phrase search is the memory-safe route (all-head
    # phrase pairs — "of the" — are rare in real logs, common in mined
    # ones; device bloom-gated compaction is the future lever here)
    PHRASE_MAX_L = 32768
    PHRASE_B_BUCKETS = [8, 32, 128, 1024, 4096]
    # pruned dense phrase route (kernels.make_pruned_phrase_kernel):
    # C blocks examined, compacted to the KV best AND scores before the
    # posting-index recovery + window position verify. PW (every term's
    # bag bound) past MAX_PW would blow the dense (PP x PW)-per-lane
    # compare — such queries go host instead.
    PRUNED_PHRASE_C = 256
    PRUNED_PHRASE_KV = 1024
    # FULL-scan mega phrases (kernels.make_full_phrase_kernel*): score
    # EVERY doc lane instead of C selected blocks, so the guard bound is
    # the (KV+1)-th actual candidate score instead of a near-flat block
    # ub — the source of phrase_mega's 8.5% terminal host rate under the
    # pruned route at 1M. Costs T*N_pad lane-ops/query
    # (what dense_all_head_pair already pays); tc mode additionally
    # un-flags exact integer-payload ties at the kth kept score.
    FULL_PHRASE_SCAN = True
    # guard-flagged pruned phrases retry once at this scale before any
    # host fallback: 4x blocks shrinks next_ub down the sorted-ub curve,
    # 4x KV shrinks the unverified-lane bound (the (KV+1)-th AND score)
    PRUNED_PHRASE_RETRY_C = 1024
    PRUNED_PHRASE_RETRY_KV = 4096
    # the mega-phrase (pruned/full-scan) route's live tensors are (B,
    # N_pad) score/payload planes — at 1M docs the generic 2^27 lane
    # budget capped dispatches at B=32, making phrase_mega 54 dispatch
    # groups per 4k batch. 2^29 lanes ~= 2 GB of f32
    # planes: B=128 at 1M (4x fewer dispatches), still B=8 at 10M. The
    # compact/list phrase paths keep the 2^27 budget (their (B, KV, PP,
    # PW) verify tensors OOMed at B=1024, L=32768 — see _submit_phrase).
    PRUNED_PHRASE_LANE_BUDGET = 1 << 29
    PRUNED_PHRASE_MAX_PP = 128
    PHRASE_MAX_PW = 128
    POS_PAD = 1024  # trailing -1 pad on the positions column

    def _submit_phrase(self, planned: List[_PlannedQuery], rq=None):
        pending = []
        # all-dense mega phrases ("of the") -> pruned dense phrase scan:
        # past PHRASE_MAX_L the list path can't run and the exact host
        # path costs seconds per unique mega pair at reference scale
        if self._dense_H:
            NB = self._n_pad_docs // 128
            C = self.PRUNED_PHRASE_C
            if NB >= max(self.PRUNED_DENSE_MIN_NB, C + 1):
                pruned, rest = [], []
                for pq in planned:
                    mega = (int(self.packed.df[pq.slot_rows[0]])
                            > self.PHRASE_MAX_L)
                    ok = (mega and len(pq.rows) >= 2
                          and all(self._dense_slot[r] >= 0 for r in pq.rows)
                          # posting-index recovery + position verify read
                          # the CSR runs — csr-cold terms go host instead
                          and all(self._csr_ok[r] for r in pq.rows)
                          and min(int(self.packed.max_tf[r])
                                  for r in pq.rows)
                          <= self.PRUNED_PHRASE_MAX_PP
                          and max(int(self.packed.max_tf[r])
                                  for r in pq.rows)
                          <= self.PHRASE_MAX_PW)
                    (pruned if ok else rest).append(pq)
                if pruned:
                    pending += self._submit_pruned_phrase(pruned, rq=rq)
                    planned = rest
        planned, sat_pending = self._route_saturated(
            planned, is_phrase=True,
            max_l=min(self.PHRASE_MAX_L, self._lb[-1]))
        pending += sat_pending
        # (L, PP) keys whose verify tensor exceeds the lane budget even
        # at the smallest B bucket (8) would exhaust device memory
        # (L=32768 x PP=2048 = 537M lanes at B=8),
        # and compact-path groups need every term's bag within the
        # window bound. The exact host path is the memory-safe route.
        KVp = self.PRUNED_PHRASE_KV
        over_pp = [
            pq for pq in planned
            if (_bucket(int(self.packed.df[pq.slot_rows[0]]), self._lb)
                * _bucket(int(self.packed.max_tf[pq.rows[0]]), PP_BUCKETS)
                > (1 << 27) // self.PHRASE_B_BUCKETS[0])
            or (_bucket(int(self.packed.df[pq.slot_rows[0]]), self._lb)
                > KVp
                and max(int(self.packed.max_tf[r]) for r in pq.rows)
                > self.PHRASE_MAX_PW)]
        if over_pp:
            keep_ids = {id(pq) for pq in over_pp}
            planned = [pq for pq in planned if id(pq) not in keep_ids]

            def run_host_pp(res_list, over=tuple(over_pp)):
                for pq in over:
                    d, s = self._host_exact(
                        pq.rows, pq.query.n_results, is_phrase=True)
                    res = res_list[pq.qi]
                    res.set_arrays(d, s)
                    if pq.query.return_snippets and self.doc_bodies is not None:
                        for e in res.entries:
                            e.snippet = self._snippet(pq, e.doc_id)

            pending.append(run_host_pp)
        keyfn = lambda pq: (
            len(pq.rows),  # exact T; phrase adjacency needs true slots
            _bucket(int(self.packed.df[pq.slot_rows[0]]), self._lb),
            _bucket(int(self.packed.max_tf[pq.rows[0]]), PP_BUCKETS),
            _bucket(max(int(self.packed.max_tf[r]) for r in pq.rows),
                    PP_BUCKETS),  # PW: every term's bag (window verify)
            # semidense match stage: every non-candidate term dense ->
            # dense-plane membership + KV compaction replaces the L-wide
            # bs match AND the L-wide bloom gate
            # (kernels.make_semidense_phrase_kernel); only worthwhile
            # where the compact path would run L-wide stages
            _bucket(int(self.packed.df[pq.slot_rows[0]]), self._lb) > KVp
            and all(self._dense_slot[r] >= 0 for r in pq.slot_rows[1:]),
        )
        # phrase verify tensors are (B, PP, L) x T-ish (or (B, KV, PP,
        # PW) compares plus (B, T, L) match tensors on the compacted
        # path): small B buckets keep the largest live tensor bounded.
        # compact-path match stage keeps ~(T + bloom W + bs temps)
        # L-wide int32 planes live — budget ~10 L-lanes per query
        # (B=1024 at L=32768 compiled to a 19.4G HBM program and OOMed)
        for (T, L, PP, PW, sd), group in self._chunked_groups(
                planned, keyfn,
                lanes_of=lambda k: (max(10 * k[1], k[0] * KVp * k[3],
                                        KVp * k[2] * k[3] // 4)
                                    if k[1] > KVp
                                    else k[1] * max(k[2], 1)),
                lane_budget=1 << 27, buckets=self.PHRASE_B_BUCKETS):
            (starts, ends, use_score, idf32_s, idf64_q, slot_of,
             ks) = self._assemble(group, T, buckets=self.PHRASE_B_BUCKETS)
            B = starts.shape[0]
            slots_arr = None
            if sd:
                slots_arr = np.zeros((B, T), dtype=np.int32)
                for bi, pq in enumerate(group):
                    for t, r in enumerate(pq.slot_rows[1:], start=1):
                        slots_arr[bi, t] = self._dense_slot[r]
            probes_np = (None if sd
                         else self._assemble_bloom_probes(group, T, B))

            def chain(T=T, L=L, PP=PP, PW=PW, sd=sd, starts=starts,
                      ends=ends, use_score=use_score, idf32_s=idf32_s,
                      slot_of=slot_of, ks=ks, probes_np=probes_np,
                      slots_arr=slots_arr):
                tc = self.columns == "tc"
                if sd:
                    # semidense match + KV compaction before every
                    # element-gather stage; no bloom columns touched
                    KV = self.PRUNED_PHRASE_KV
                    M = min(KV, int(ks.max(initial=1)) + self.margin)
                    eps3 = 3.0 * self.rel_eps
                    kern = K.make_semidense_phrase_kernel(
                        T, L, KV, PP, PW, M, self._n_pad_docs,
                        K.n_iters_for(self._max_df), eps3,
                        mode="tc" if tc else "raw")
                    so = jnp.asarray(slot_of.astype(np.int32))
                    kd = jnp.asarray(ks)
                    sl = jnp.asarray(slots_arr)
                    if tc:
                        return kern(self.d_postings_doc,
                                    self.d_postings_tc, self.d_avg32,
                                    self.d_dense_tf8, self.d_positions,
                                    self.d_pos_starts,
                                    jnp.asarray(starts), jnp.asarray(ends),
                                    jnp.asarray(idf32_s), sl, so, kd)
                    return kern(self.d_postings_doc,
                                self.d_postings_score,
                                self.d_postings_tf, self.d_dense_sc,
                                self.d_positions, self.d_pos_starts,
                                jnp.asarray(starts), jnp.asarray(ends),
                                jnp.asarray(use_score), sl, so, kd)
                if L > self.PRUNED_PHRASE_KV:
                    # fused compact pipeline: one dispatch, and only the
                    # KV best-scored surviving lanes are position-
                    # verified (kernels.make_compact_phrase_kernel)
                    KV = self.PRUNED_PHRASE_KV
                    M = min(KV, int(ks.max(initial=1)) + self.margin)
                    eps3 = 3.0 * self.rel_eps
                    kern = K.make_compact_phrase_kernel(
                        T, L, KV, PP, PW, M, K.n_iters_for(self._max_df),
                        eps3, mode="tc" if tc else "raw")
                    probes = tuple(jnp.asarray(p) for p in probes_np)
                    so = jnp.asarray(slot_of.astype(np.int32))
                    kd = jnp.asarray(ks)
                    if tc:
                        return kern(self.d_postings_doc, self.d_postings_tc,
                                    self.d_avg32, self.d_positions,
                                    self.d_pos_starts, jnp.asarray(starts),
                                    jnp.asarray(ends), jnp.asarray(idf32_s),
                                    so, kd, self.d_bloom_rows,
                                    self.d_bloom_bitmap, self.d_bloom_rank,
                                    *probes)
                    return kern(self.d_postings_doc, self.d_postings_score,
                                self.d_postings_tf, self.d_positions,
                                self.d_pos_starts, jnp.asarray(starts),
                                jnp.asarray(ends), jnp.asarray(use_score),
                                so, kd, self.d_bloom_rows,
                                self.d_bloom_bitmap, self.d_bloom_rank,
                                *probes)
                if tc:
                    match_kern = K.make_match_kernel_tc(
                        T, L, K.n_iters_for(self._max_df))
                    match, bloom_pass, cdocs, pidx, score, sat_lane = \
                        match_kern(
                            self.d_postings_doc, self.d_postings_tc,
                            self.d_avg32, jnp.asarray(starts),
                            jnp.asarray(ends), jnp.asarray(idf32_s),
                            self.d_bloom_rows, self.d_bloom_bitmap,
                            self.d_bloom_rank,
                            *(jnp.asarray(p) for p in probes_np),
                        )
                else:
                    match_kern = K.make_match_kernel(
                        T, L, K.n_iters_for(self._max_df))
                    match, bloom_pass, cdocs, pidx, score = match_kern(
                        self.d_postings_doc, self.d_postings_score,
                        jnp.asarray(starts), jnp.asarray(ends),
                        jnp.asarray(use_score),
                        self.d_bloom_rows, self.d_bloom_bitmap,
                        self.d_bloom_rank,
                        *(jnp.asarray(p) for p in probes_np),
                    )
                active = match & bloom_pass
                n_pos_iters = K.n_iters_for(
                    int(self.packed.max_tf.max(initial=1)))
                verify = K.make_phrase_verify_kernel(T, L, PP, n_pos_iters)
                # verify wants pidx in query-term order
                pidx_q = jnp.take_along_axis(
                    pidx, jnp.asarray(slot_of.astype(np.int32))[:, :, None]
                    .repeat(L, 2), axis=1)
                n_matches = verify(
                    self.d_positions, self.d_pos_starts, pidx_q, active)
                final = active & (n_matches > 0)
                M = min(L, int(ks.max(initial=1)) + self.margin)
                if tc:
                    select = K.make_select_topk_kernel_tc(T, L, M)
                    return select(self.d_postings_tc, cdocs, pidx, score,
                                  final, sat_lane)
                select = K.make_select_topk_kernel(T, L, M)
                return select(self.d_postings_tf, cdocs, pidx, score, final)

            holder = [self._dispatch_async(chain)]

            def finalize(results, group=group, holder=holder,
                         slot_of=slot_of, idf64_q=idf64_q, ks=ks, T=T):
                packed = self._fetch(holder[0])
                self._finalize_group(group, packed[:, 0, :],
                                     packed[:, 1 : T + 1, :], slot_of,
                                     idf64_q, ks, results,
                                     force_host=self._flags_to_force(packed[:, T + 1, 0]))

            pending.append(finalize)
        return pending

    def _submit_pruned_phrase(self, planned: List[_PlannedQuery], rq=None):
        """All-dense mega phrases via the pruned dense phrase kernel
        (kernels._pruned_phrase_body). Arrays are in QUERY-term order
        (adjacency is order-dependent); the per-query anchor is the term
        with the smallest max_tf, bounding the PP base-lane bucket."""
        pending = []
        NB = self._n_pad_docs // 128
        C = self.PRUNED_PHRASE_C
        KV = min(self.PRUNED_PHRASE_KV, C * 128 - 1,
                 self._n_pad_docs - 1)
        full = self.FULL_PHRASE_SCAN
        n_bs = K.n_iters_for(self._max_df)
        eps3 = 3.0 * self.rel_eps
        keyfn = lambda pq: (
            len(pq.rows),  # exact T
            _bucket(min(int(self.packed.max_tf[r]) for r in pq.rows),
                    PP_BUCKETS),  # anchor bag bound (base lanes)
            _bucket(max(int(self.packed.max_tf[r]) for r in pq.rows),
                    PP_BUCKETS),  # every term's bag bound (PW windows)
        )
        scan_lanes = self._n_pad_docs if full else C * 128
        for (T, PP, PW), group in self._chunked_groups(
                planned, keyfn,
                lanes_of=lambda k: max(k[0] * scan_lanes,
                                       k[0] * KV * k[2],
                                       KV * k[1] * k[2] // 4),
                lane_budget=self.PRUNED_PHRASE_LANE_BUDGET,
                buckets=self.PHRASE_B_BUCKETS):
            B = _bucket(len(group), self.PHRASE_B_BUCKETS)
            starts = np.zeros((B, T), dtype=np.int32)
            ends = np.zeros((B, T), dtype=np.int32)
            slots = np.zeros((B, T), dtype=np.int32)
            use = np.zeros((B, T), dtype=np.float32)
            idf32_q = np.zeros((B, T), dtype=np.float32)
            idf64_q = np.zeros((B, T), dtype=np.float64)
            anchor = np.zeros(B, dtype=np.int32)
            ks = np.zeros(B, dtype=np.int32)
            for i, pq in enumerate(group):
                ks[i] = pq.query.n_results
                anchor[i] = int(np.argmin(
                    [int(self.packed.max_tf[r]) for r in pq.rows]))
                for t, r in enumerate(pq.rows):
                    starts[i, t] = self._starts32[r]
                    ends[i, t] = self._starts32[r] + self._df32[r]
                    slots[i, t] = self._dense_slot[r]
                    use[i, t] = 1.0
                    idf32_q[i, t] = np.float32(self.packed.idf64[r])
                    idf64_q[i, t] = self.packed.idf64[r]
            M = min(KV, int(ks.max(initial=1)) + self.margin)

            def dispatch(T=T, PP=PP, PW=PW, M=M, starts=starts, ends=ends,
                         slots=slots, idf32_q=idf32_q, use=use,
                         anchor=anchor, ks=ks):
                return self._pruned_phrase_dispatch(
                    T, PP, PW, M, C, KV, starts, ends, slots, use,
                    idf32_q, anchor, ks)

            holder = [self._dispatch_async(dispatch)]
            # tfs are already in query-term order: identity slot_of
            slot_id = np.tile(np.arange(T, dtype=np.int64), (B, 1))

            def finalize(results, group=group, holder=holder,
                         T=T, PP=PP, PW=PW, M=M,
                         slot_id=slot_id, idf64_q=idf64_q, ks=ks,
                         starts=starts, ends=ends, slots=slots, use=use,
                         idf32_q=idf32_q, anchor=anchor, rq=rq):
                packed_out = self._fetch(holder[0])
                force = self._flags_to_force(packed_out[:, T + 1, 0])
                miss = (packed_out[:, T + 1, 0] & K.FLAG_PRUNE_MISS) != 0
                miss[len(group):] = False  # padding rows: never retry
                if miss.any() and self.PHRASE_RESCUE and rq is not None:
                    # defer flagged rows to the batch-level rescue drain
                    # (one retry dispatch per (T, PP, PW, M) across every
                    # group of this batch — see _drain_rescues)
                    sub = np.nonzero(miss)[0]
                    keep = np.nonzero(~miss[: len(group)])[0]
                    with self._rescue_lock:
                        rq.append(dict(
                            kind="phrase", T=T, PP=PP, PW=PW, M=M,
                            starts=starts[sub], ends=ends[sub],
                            slots=slots[sub], use=use[sub],
                            idf32_q=idf32_q[sub], anchor=anchor[sub],
                            ks=ks[sub], idf64_q=idf64_q[sub],
                            slot_id=slot_id[sub],
                            group=[group[i] for i in sub],
                            res_list=results))
                    if keep.size:
                        self._finalize_group(
                            [group[i] for i in keep],
                            packed_out[keep][:, 0, :],
                            packed_out[keep][:, 1 : T + 1, :],
                            slot_id[keep], idf64_q[keep], ks[keep],
                            results, force_host=force[keep])
                    return
                if miss.any() and self.PHRASE_RESCUE:
                    sub = np.nonzero(miss)[0]
                    rescued = self._pruned_phrase_rescue(
                        T, PP, PW, M, starts[sub], ends[sub], slots[sub],
                        use[sub], idf32_q[sub], anchor[sub], ks[sub])
                    packed_out = packed_out.copy()  # device view is RO
                    packed_out[sub] = rescued
                    force[sub] = self._flags_to_force(
                        rescued[:, T + 1, 0], rescue=True)
                self._finalize_group(
                    group, packed_out[:, 0, :], packed_out[:, 1 : T + 1, :],
                    slot_id, idf64_q, ks, results, force_host=force)

            pending.append(finalize)
        return pending

    def _pruned_phrase_dispatch(self, T, PP, PW, M, C, KV, starts, ends,
                                slots, use, idf32_q, anchor, ks):
        """Build + call the mega-phrase kernel at a (C, KV) scale —
        FULL_PHRASE_SCAN replaces the C-block selection with a full
        doc-space scan (C then only keys the lane-budget math)."""
        NB = self._n_pad_docs // 128
        n_bs = K.n_iters_for(self._max_df)
        eps3 = 3.0 * self.rel_eps
        if self.FULL_PHRASE_SCAN:
            KV = min(KV, self._n_pad_docs - 1)  # top_k(KV+1) bound
            if self.columns == "tc":
                kern = K.make_full_phrase_kernel_tc(
                    T, self._n_pad_docs, KV, PP, PW, M, n_bs, eps3)
                return kern(self.d_dense_tf8, self.d_len_code,
                            self.d_avg32, self.d_postings_doc,
                            self.d_positions, self.d_pos_starts,
                            jnp.asarray(starts), jnp.asarray(ends),
                            jnp.asarray(slots), jnp.asarray(idf32_q),
                            jnp.asarray(anchor), jnp.asarray(ks))
            kern = K.make_full_phrase_kernel(
                T, self._n_pad_docs, KV, PP, PW, M, n_bs, eps3)
            return kern(self.d_dense_sc, self.d_dense_tf,
                        self.d_postings_doc, self.d_positions,
                        self.d_pos_starts, jnp.asarray(starts),
                        jnp.asarray(ends), jnp.asarray(slots),
                        jnp.asarray(use), jnp.asarray(anchor),
                        jnp.asarray(ks))
        if self.columns == "tc":
            kern = K.make_pruned_phrase_kernel_tc(
                T, NB, C, KV, PP, PW, M, n_bs, eps3)
            return kern(self.d_dense_tf8, self.d_len_code, self.d_avg32,
                        self.d_dense_blockmax, self.d_dense_blockmax2,
                        self.d_dense_argpos, self.d_postings_doc,
                        self.d_positions, self.d_pos_starts,
                        jnp.asarray(starts), jnp.asarray(ends),
                        jnp.asarray(slots), jnp.asarray(idf32_q),
                        jnp.asarray(anchor), jnp.asarray(ks))
        kern = K.make_pruned_phrase_kernel(
            T, NB, C, KV, PP, PW, M, n_bs, eps3)
        return kern(self.d_dense_sc, self.d_dense_tf,
                    self.d_dense_blockmax, self.d_dense_blockmax2,
                    self.d_dense_argpos, self.d_postings_doc,
                    self.d_positions, self.d_pos_starts,
                    jnp.asarray(starts), jnp.asarray(ends),
                    jnp.asarray(slots), jnp.asarray(use),
                    jnp.asarray(anchor), jnp.asarray(ks))

    def _pruned_phrase_rescue(self, T, PP, PW, M, starts, ends, slots,
                              use, idf32_q, anchor, ks):
        """Retry guard-flagged pruned phrases once at RETRY_C/RETRY_KV
        (same kernel family, same packed layout) before the host path;
        mega pairs' blockmax-sum ub surface is near-flat, so the
        production (C, KV) guard misses ~13% at 1M while a 4x-scaled
        certificate passes for most of them at ~1/10 the host cost."""
        NB = self._n_pad_docs // 128
        C2 = min(self.PRUNED_PHRASE_RETRY_C, NB - 1)
        if self.FULL_PHRASE_SCAN:
            # full scan re-examines nothing new block-wise; only a
            # deeper KV tightens the unverified-candidate bound
            KV2 = min(self.PRUNED_PHRASE_RETRY_KV, self._n_pad_docs - 1)
            scan = self._n_pad_docs
        else:
            KV2 = min(self.PRUNED_PHRASE_RETRY_KV, C2 * 128 - 1)
            scan = C2 * 128
        n = len(ks)
        t0 = _time.perf_counter()
        out = np.empty((n, T + 2, M), dtype=np.int32)
        # the retry's verify tensors are (B, KV2, PP, PW)-ish: keep the
        # largest live tensor inside the lane budget via small B chunks
        lanes = max(T * scan, T * KV2 * PW, KV2 * PP * PW // 4)
        fit = max(1, self.PRUNED_PHRASE_LANE_BUDGET // max(lanes, 1))
        chunk = self.PHRASE_B_BUCKETS[0]
        for b in self.PHRASE_B_BUCKETS:
            if b <= fit:
                chunk = b
        chunks = []
        for ci in range(0, n, chunk):
            sl = slice(ci, min(ci + chunk, n))
            B = _bucket(sl.stop - sl.start, self.PHRASE_B_BUCKETS)
            pad = lambda a: np.concatenate(
                [a[sl], np.zeros((B - (sl.stop - sl.start),) + a.shape[1:],
                                 dtype=a.dtype)]) \
                if B > sl.stop - sl.start else a[sl]

            def dispatch(s=pad(starts), e=pad(ends), sg=pad(slots),
                         u=pad(use), ig=pad(idf32_q), a=pad(anchor),
                         kg=pad(ks)):
                return self._pruned_phrase_dispatch(
                    T, PP, PW, M, C2, KV2, s, e, sg, u, ig, a, kg)

            chunks.append((sl, self._dispatch_async(dispatch)))
        for sl, holder in chunks:
            out[sl] = self._fetch(holder)[: sl.stop - sl.start]
        self._bump(prune_rescued=n, rescue_s=_time.perf_counter() - t0)
        return out

    def _assemble_bloom_probes(self, group, T: int, B: int):
        """Folded probe assembly for the sparse bloom gate. A probe is
        active only if the GATHERED slot's term has device rows (df <=
        BLOOM_DF_CEILING) — inactive probes pass, a pruning-only change."""
        cfg = self.packed.bloom_cfg
        C = max(1, T - 1)
        probe_slot = np.zeros((B, C), dtype=np.int32)
        probe_begins = np.zeros((B, C), dtype=bool)
        probe_mask = np.zeros((B, C), dtype=np.uint32)
        probe_active = np.zeros((B, C), dtype=bool)

        factor = self.bloom_enable_factor
        have_blooms = self.packed.bloom_ends is not None
        ceil = self.BLOOM_DF_CEILING
        if have_blooms and factor is not None:
            for i, pq in enumerate(group):
                terms, rows = pq.query.terms, pq.rows
                slot = pq.slot_of_term
                dfs = [int(self.packed.df[r]) for r in rows]
                if len(rows) == 2:
                    # cost-aware side selection (query_processing.h:796-807)
                    s1, s2 = dfs
                    if factor * s1 <= s2 and s1 <= ceil:
                        probe_slot[i, 0], probe_begins[i, 0] = slot[0], False
                        probe_mask[i, 0] = cfg.probe_mask_folded(terms[1])
                        probe_active[i, 0] = True
                    elif factor * s2 < s1 and s2 <= ceil:
                        probe_slot[i, 0], probe_begins[i, 0] = slot[1], True
                        probe_mask[i, 0] = cfg.probe_mask_folded(terms[0])
                        probe_active[i, 0] = True
                else:
                    # chained HasNextTerm fallback (query_processing.h:784-794)
                    for c in range(len(rows) - 1):
                        if dfs[c] > ceil:
                            continue
                        probe_slot[i, c], probe_begins[i, c] = slot[c], False
                        probe_mask[i, c] = cfg.probe_mask_folded(terms[c + 1])
                        probe_active[i, c] = True

        return (probe_slot, probe_begins, probe_mask, probe_active)

    # -- snippets ------------------------------------------------------

    def _snippet(self, pq: _PlannedQuery, doc: int) -> str:
        if self.doc_bodies is None:
            return ""
        # host_packed: a hot view's offset bags exist only for csr-hot
        # terms; the full index serves snippets for dense-only routes
        return snippet_for(self._host_packed, self.doc_bodies, pq.rows,
                           pq.query, doc)


def _posting_index(packed: PackedIndex, row: int, doc: int) -> int:
    ts, te = int(packed.term_starts[row]), int(packed.term_starts[row + 1])
    j = int(np.searchsorted(packed.postings_doc[ts:te], doc))
    return ts + j


def snippet_for(pk: PackedIndex, doc_bodies, rows: Sequence[int],
                query: SearchQuery, doc: int) -> str:
    """Host-side snippet for one result doc — shared by the single-device,
    staged, and sharded engines (vacuum_engine.h:243-255 analog)."""
    from wiser_tpu.highlighter import SimpleHighlighter

    offset_table = []
    pidxs = [_posting_index(pk, r, doc) for r in rows]
    if query.is_phrase and len(rows) >= 2:
        # keep only offsets at phrase-match positions
        # (ResultDocEntry::FilterOffsetByPosition, query_processing.h:469-492)
        pos_lists = [
            pk.positions[pk.pos_starts[p] : pk.pos_starts[p + 1]] for p in pidxs
        ]
        base = set(int(x) for x in pos_lists[0])
        for t in range(1, len(pos_lists)):
            base &= set(int(x) - t for x in pos_lists[t])
        for t, p in enumerate(pidxs):
            pos_to_j = {int(x): j for j, x in enumerate(pos_lists[t])}
            s = int(pk.off_starts[p])
            pairs = []
            for m in sorted(base):
                j = pos_to_j.get(m + t)
                if j is not None and s + j < int(pk.off_starts[p + 1]):
                    pairs.append((int(pk.off_begin[s + j]), int(pk.off_end[s + j])))
            offset_table.append(pairs)
    else:
        for p in pidxs:
            s, e = int(pk.off_starts[p]), int(pk.off_starts[p + 1])
            offset_table.append(
                list(zip(pk.off_begin[s:e].tolist(), pk.off_end[s:e].tolist()))
            )
    return SimpleHighlighter().highlight(
        offset_table, query.n_snippet_passages, doc_bodies[doc]
    )
