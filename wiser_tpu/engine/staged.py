"""StagedEngine — host↔HBM posting staging for indexes larger than HBM.

The reference's core idea is "read as needed": keep the term index and doc
lengths in RAM and read posting bytes from flash on demand with adaptive
prefetch (vacuum_engine.h:144-166,221-236; madvise in flash_iterators.h).
The translation to a device with less memory than the index:

- a HOT TIER of posting columns lives in HBM, chosen greedily by df until
  a device-memory budget is filled (head terms are both most of the bytes
  and most of the accesses under Zipf query loads);
- queries whose terms are all hot run on the resident TpuEngine unchanged;
- COLD queries have their full posting runs staged per batch: the host
  copies the needed (deduplicated) term runs into a scratch column,
  ships it with an async device_put, and dispatches the same search
  kernels against the scratch arrays. The async submit API overlaps the
  next batch's staging transfer with current compute — the prefetch
  analog.

Phrase queries run on whichever tier owns their terms: all-hot phrases
use the resident engine's full pipeline (bloom gate included); phrases
touching cold terms get their POSITION BAGS staged alongside the posting
runs and run the bloomless phrase pipeline against the scratch columns.
"""

from __future__ import annotations

import os
import sys

from dataclasses import replace
from functools import lru_cache
from typing import Dict, List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from wiser_tpu.engine import kernels as K
from wiser_tpu.engine.device import (
    B_BUCKETS,
    L_BUCKETS,
    T_BUCKETS,
    TpuEngine,
    _bucket,
)
from wiser_tpu.index.format import BLOCK, PackedIndex, SENTINEL_DOC
from wiser_tpu.scoring import Bm25Similarity
from wiser_tpu.types import SearchQuery, SearchResult

# CHUNK_LIMIT bounds a cold chunk's staged postings; the top scratch
# bucket is 2x that because the packed-transport cap must also cover
# A_total + Grawb*BLOCK, whose raw-segment bucket rounding can add up
# to ~2^23 on top of the chunk itself (_submit_cold chunks the cold set
# so _bucket's clip-to-largest can never truncate the scratch).
CHUNK_LIMIT = 1 << 23
SCRATCH_BUCKETS = [1 << 15, 1 << 17, 1 << 19, 1 << 21, 1 << 23, 1 << 24]

# Cold-path shape buckets are deliberately COARSER than the hot path's
# (device.py): a cold kernel's compile key is (T, L, M, B, cap), and at
# corpus scale the fine hot-path bucket product makes nearly every cold
# batch hit fresh compiles. <=8x kernel-compute padding buys a ~5x
# smaller compile universe. Phrase cold groups keep exact T (adjacency
# needs true slots) but share the coarse L/B sets.
COLD_L_BUCKETS = [8192, 65536, 524288, L_BUCKETS[-1]]
COLD_B_BUCKETS = [128, 1024, B_BUCKETS[-1]]
COLD_T_BUCKETS = [1, 2, 4, 8]
# Multi-term cold groups above this candidate df go to the exact host
# path: cold mega pairs are rare and their staged runs are the single
# biggest transfer items (a 2^21-posting run is 24 MB of raw columns),
# so skipping the staging outright bounds the per-batch transfer. The
# bs kernel itself runs and is exact at (T=2, L=2^21) — chip_smoke.py
# checks that shape on the GPU — and the hot path routes giant-df
# candidates to its dense tier.
COLD_L_MAX_MULTI = 524288
# per-dispatch lane budget of the cold kernels, as on the hot path: a
# (B, T, L) search or (B, PP, L) phrase-verify plane of 2^27 int32 lanes
# is 512 MB. Groups over it even at the smallest B bucket (a cold phrase
# group at B=1024 asked the GPU for 169 GiB) take the exact host path.
COLD_LANE_BUDGET = 1 << 27
BYTES_PER_POSTING = 12  # doc + tf + score columns (raw layout)
BYTES_PER_POSTING_TC = 6  # doc + uint16 tc (compressed layout)

# packed cold transport: staged doc blocks whose delta width fits
# PACK_WIDTH ship as bit-packed words and decode ON DEVICE
# (ops/unpack.py — the LittleIntPacker analog finally on the serving
# path); wider blocks (delta >= 2^16 <=> doc gaps > 65535, i.e. terms
# with df <~ n_docs/512) ship raw in a trailing segment. Fewer staged
# bytes is less host->device transfer per cold batch.
PACK_WIDTH = 16
_G16_BUCKETS = [1 << 8, 1 << 10, 1 << 12, 1 << 14, 1 << 16]
_GRAW_BUCKETS = [1 << 6, 1 << 9, 1 << 12, 1 << 16]


@lru_cache(maxsize=64)
def _make_doc_combine(G16: int, Graw: int, cap: int, width: int):
    """Jitted device-side scratch-doc-column reassembly: unpack the
    width-`width` delta blocks into [0, G16*128), then overlay the raw
    segment at its true offset (padding junk lands in slack past the
    last run — every consumer masks by CSR ends/cvalid)."""
    from wiser_tpu.ops.unpack import delta_decode_docs, unpack_blocks_xla

    def f(words, first, raw_flat, off_raw):
        dec = delta_decode_docs(unpack_blocks_xla(words, width),
                                first)
        out = jnp.zeros((cap,), dtype=jnp.int32)
        out = jax.lax.dynamic_update_slice(out, dec.reshape(-1), (0,))
        if Graw:
            out = jax.lax.dynamic_update_slice(out, raw_flat, (off_raw,))
        return out

    return jax.jit(f)


def _cold_chunk(lanes: int) -> int:
    """Widest COLD_B_BUCKETS chunk whose B * lanes fits COLD_LANE_BUDGET;
    0 when even the smallest does not."""
    fit = [b for b in COLD_B_BUCKETS if b * lanes <= COLD_LANE_BUDGET]
    return fit[-1] if fit else 0


def per_term_device_cost(packed: PackedIndex,
                         columns: str = "raw",
                         split: bool = False) -> np.ndarray:
    """int64[n_terms] HBM bytes a term costs when resident, mirroring
    TpuEngine's device layout (device.py _upload / device_bytes): CSR
    posting columns (+ the int32 pos_starts lane), position bags (uint16
    when they fit), and the term's share of the sparse folded bloom
    columns (4 B per stored nonzero row + bitmap/rank overhead). This is
    the budget-accounting substrate for the staged hot tier — the
    round-3 grid charged only posting bytes, so the dense tier and
    position/bloom columns landed OUTSIDE the budget and the cgroup-cap
    analog (reference tools/run_exp.py:628-696) capped nothing real.

    With split=True returns (core, phrase): `core` is what a term costs
    to serve boolean/ranked queries (posting lanes + the int32
    pos_starts lane — structural, uploaded per posting), `phrase` is
    what it additionally costs to serve phrase queries (position bags +
    both bi-bloom columns). The split exists because positions+blooms
    are ~55% of per-term bytes at 1M docs but serve only the phrase
    share of the workload — whole-term admission let them crowd out
    postings (at a 0.25 budget: 56% of posting bytes resident yet
    0.4% of queries fully hot)."""
    lens = np.diff(packed.term_starts).astype(np.int64)
    bpp = BYTES_PER_POSTING_TC if columns == "tc" else BYTES_PER_POSTING
    core = lens * (bpp + 4)  # +4: int32 pos_starts per posting
    s = packed.term_starts
    pos_cnt = (packed.pos_starts[s[1:]]
               - packed.pos_starts[s[:-1]]).astype(np.int64)
    pos_b = 2 if (len(packed.positions) == 0
                  or int(packed.positions.max(initial=0)) < 2**16 - 1) else 4
    phrase = pos_cnt * pos_b
    if packed.bloom_ends is not None:
        from wiser_tpu.engine.device import TpuEngine

        gate = packed.df <= TpuEngine.BLOOM_DF_CEILING
        for rows in (packed.bloom_ends, packed.bloom_begins):
            fold = rows[:, 0].copy()
            for w in range(1, rows.shape[1]):
                np.bitwise_or(fold, rows[:, w], out=fold)
            stored = (fold != 0) & np.repeat(gate, lens)
            csum = np.zeros(len(stored) + 1, dtype=np.int64)
            np.cumsum(stored, out=csum[1:])
            phrase += (csum[s[1:]] - csum[s[:-1]]) * 4
        # presence bitmap (1 bit) + rank lane (1 b/32 postings * 4 B),
        # BOTH sides = ~0.5 B/posting — uploaded for every posting
        # regardless of phrase residency (zeroed rows are merely "not
        # stored"), so it is a CORE charge; only the folded row words
        # above are phrase bytes. The old whole-lens phrase charge made
        # residency overshoot the budget ~7% at 1M.
        core += (lens + 1) // 2
    if split:
        return core, phrase
    return core + phrase


def dense_tier_bytes(packed: PackedIndex, columns: str = "raw",
                     budget_bytes: int = None) -> int:
    """HBM bytes TpuEngine's dense head-term tier would take under
    `budget_bytes` (device.py _build_dense_rows math, without building):
    row plane + f32 blockmax plane."""
    from wiser_tpu.engine.device import TpuEngine

    if budget_bytes is None:
        budget_bytes = 7 << 29
    if not budget_bytes:
        return 0
    n = packed.n_docs
    n_pad = (n + 127) // 128 * 128
    dense_min = max(TpuEngine.DENSE_MIN_DF_FLOOR,
                    n // TpuEngine.DENSE_ELIGIBLE_FRACTION)
    row_bytes = 1 if columns == "tc" else 8
    # row + blockmax/blockmax2 (f32) + argpos (u8) planes
    per_row = n_pad * row_bytes + (n_pad // 128) * 9
    cap = int(budget_bytes // per_row)
    cap = min(cap, (2**31 - 1) // n_pad - 1)
    H = min(int((packed.df >= dense_min).sum()), cap)
    if H <= 0:
        return 0
    # + the shared per-doc len-code row (tc mode stores it once)
    return H * per_row + (n_pad if columns == "tc" else 0)


def full_device_bytes(packed: PackedIndex, columns: str = "raw") -> int:
    """Total HBM footprint of an unconstrained TpuEngine over `packed` —
    the frac=1.0 base for the HBM-budget grid (the reference grid's
    'index size' denominator)."""
    return (int(per_term_device_cost(packed, columns).sum())
            + dense_tier_bytes(packed, columns))


def _hot_view(packed: PackedIndex, hbm_budget_bytes: int,
              bytes_per_posting: int = BYTES_PER_POSTING,
              term_weights: np.ndarray = None,
              cost: np.ndarray = None,
              cost_phrase: np.ndarray = None,
              hot: np.ndarray = None,
              phrase_hot: np.ndarray = None,
              ) -> Tuple[PackedIndex, np.ndarray, np.ndarray]:
    """Build a PackedIndex whose posting columns contain only the hottest
    terms (greedy within budget); cold terms keep their real df (global
    stats must stay global) but point at an empty run.

    Admission order: with `term_weights` (per-term expected access
    frequency, e.g. counts from a query log), greedy by weight — the
    benefit of residency is access_freq x staged bytes and the cost is the
    same bytes, so benefit/byte = access_freq alone. Without weights,
    df-greedy (the Zipf-rank prior: frequent terms are queried most).

    With `cost` (int64[n_terms] device bytes per term, see
    per_term_device_cost), terms are charged their FULL residency cost;
    otherwise the legacy posting-bytes-only charge applies.

    With `cost_phrase` (the split from per_term_device_cost(split=True)),
    admission is COMPONENT-granular, two passes in the same order:
    pass 1 admits term cores (postings — serve every query shape),
    pass 2 spends the leftover on phrase components (position bags +
    bloom rows — serve only phrase queries). A core-hot/phrase-cold
    term gets an empty position bag and zeroed bloom rows in the view;
    StagedEngine routes phrase queries touching it to the cold path.
    Marginal bytes always buy coverage for 100% of the workload before
    buying coverage for its phrase share — this is what makes the
    memory curve degrade gracefully instead of cliffing when position
    bags crowd out postings.

    With `hot` (and optionally `phrase_hot`) given, admission is the
    CALLER's: the masks are used as-is and only the view is built
    (StagedEngine's proportional-share planner computes them alongside
    the dense-tier budget).

    Returns (view, hot, phrase_hot); without cost_phrase,
    phrase_hot == hot (whole-term admission)."""
    lens = np.diff(packed.term_starts)
    if hot is not None:
        if phrase_hot is None:
            phrase_hot = hot
        return _build_hot_view(packed, lens, hot, phrase_hot)
    if term_weights is not None:
        # weight desc, df desc as tiebreak (np.lexsort: last key primary)
        order = np.lexsort((-packed.df, -np.asarray(term_weights)))
    else:
        order = np.argsort(packed.df)[::-1]
    if cost is not None:
        charge = cost.astype(np.int64)
        budget = int(hbm_budget_bytes)
    else:
        charge = lens.astype(np.int64)
        budget = hbm_budget_bytes // bytes_per_posting
    hot = np.zeros(packed.n_terms, dtype=bool)
    used = 0
    for r in order:
        run = int(charge[r])
        if used + run > budget:
            continue
        used += run
        hot[r] = True
    if cost_phrase is not None:
        phrase_hot = np.zeros(packed.n_terms, dtype=bool)
        charge_p = cost_phrase.astype(np.int64)
        for r in order:
            if not hot[r]:
                continue
            run = int(charge_p[r])
            if used + run > budget:
                continue
            used += run
            phrase_hot[r] = True
    else:
        phrase_hot = hot
    return _build_hot_view(packed, lens, hot, phrase_hot)


def _build_hot_view(packed: PackedIndex, lens: np.ndarray,
                    hot: np.ndarray, phrase_hot: np.ndarray):
    """Compact the posting/position/offset/bloom columns to the admitted
    terms (see _hot_view). Cold rows keep real df on zero-length runs."""
    new_starts = np.zeros(packed.n_terms + 1, dtype=np.int64)
    np.cumsum(np.where(hot, lens, 0), out=new_starts[1:])
    P_hot = int(new_starts[-1])
    # global-posting-index gather map for the compacted view: every
    # per-posting column (docs, tfs, position bags, offset bags, bloom
    # rows) must be remapped through it — the bags are CSRs addressed by
    # posting index, so keeping the originals would silently read another
    # term's positions/offsets/filters on the hot tier.
    gather = np.empty(P_hot, dtype=np.int64)
    # per-hot-posting phrase residency (positions/blooms kept?): phrase-
    # cold terms get empty position bags + zeroed bloom rows in the view
    keep_pos = np.empty(P_hot, dtype=bool)
    for r in np.nonzero(hot)[0]:
        s_old, n = int(packed.term_starts[r]), int(lens[r])
        s_new = int(new_starts[r])
        gather[s_new : s_new + n] = np.arange(s_old, s_old + n)
        keep_pos[s_new : s_new + n] = bool(phrase_hot[r])
    doc = packed.postings_doc[gather].astype(np.int32, copy=False)
    tf = packed.postings_tf[gather].astype(np.int32, copy=False)

    def _regather_csr(starts: np.ndarray, *payloads, keep=None):
        seg_lens = np.diff(starts)[gather]
        if keep is not None:
            seg_lens[~keep] = 0  # fresh fancy-index copy: in-place safe
        new_csr = np.zeros(P_hot + 1, dtype=np.int64)
        np.cumsum(seg_lens, out=new_csr[1:])
        total = int(new_csr[-1])
        outs = tuple(np.empty(total, dtype=p.dtype) for p in payloads)
        # slabbed ragged element gather: the absolute-source-index temp
        # is int64 PER ELEMENT — one flat build over the 10M corpus's
        # 2.4B-element position bags is ~19GB (x2 for the np.repeat
        # operands), a host-OOM spike when a tc budget admits
        # most of the index. 32M-segment slabs bound the live temp.
        CH = 1 << 25
        for s0 in range(0, P_hot, CH):
            s1 = min(s0 + CH, P_hot)
            t0, t1 = int(new_csr[s0]), int(new_csr[s1])
            if t1 == t0:
                continue
            lens_sl = seg_lens[s0:s1]
            idx = (np.repeat(starts[gather[s0:s1]], lens_sl)
                   + np.arange(t1 - t0, dtype=np.int64)
                   - np.repeat(new_csr[s0:s1] - t0, lens_sl))
            for p, o in zip(payloads, outs):
                o[t0:t1] = p[idx]
            del idx
        return (new_csr,) + outs

    pos_starts, positions = _regather_csr(packed.pos_starts,
                                          packed.positions, keep=keep_pos)
    # offset bags stay whole-term: host RAM (never uploaded — device.py
    # has no off_* arrays), used by the highlighter on hot results
    off_starts, off_begin, off_end = _regather_csr(
        packed.off_starts, packed.off_begin, packed.off_end)
    bloom_ends = (packed.bloom_ends[gather]
                  if packed.bloom_ends is not None else None)
    bloom_begins = (packed.bloom_begins[gather]
                    if packed.bloom_begins is not None else None)
    if bloom_ends is not None and not keep_pos.all():
        # zero rows are "not stored" to the sparse folded column builder
        # (device bloom bytes) — routing keeps hot phrase queries off
        # phrase-cold terms, so the gate never reads these rows.
        # In-place on the fresh gathered copies: np.where here doubled a
        # 2x7.5GB allocation at 10M scale.
        cold = ~keep_pos
        bloom_ends[cold] = 0
        bloom_begins[cold] = 0
    # cold rows get zero-length runs (monotone CSR preserved); they are
    # never dispatched to the hot engine by construction
    view = replace(
        packed,
        term_starts=new_starts,
        postings_doc=doc,
        postings_tf=tf,
        pos_starts=pos_starts,
        positions=positions,
        off_starts=off_starts,
        off_begin=off_begin,
        off_end=off_end,
        bloom_ends=bloom_ends,
        bloom_begins=bloom_begins,
        term_to_row=packed.term_to_row,
        idf64=packed.idf64,
        max_tf=packed.max_tf,
    )
    return view, hot, phrase_hot


class StagedEngine:
    def __init__(self, packed: PackedIndex, hbm_budget_bytes: int,
                 doc_bodies=None, margin: int = 54,
                 strict_parity: bool = False, columns: str = "raw",
                 term_weights: np.ndarray = None,
                 cold_transfer: str = "packed"):
        # columns="tc": the HOT tier serves from compressed uint16
        # columns (device.py) — the budget then buys ~2x the resident
        # terms — and the cold FLAT scratch ships compressed too
        # (uint16 tc; phrase batches still stage raw score/tf, their
        # kernels read them). cold_transfer="packed" additionally ships
        # staged doc ids as 16-bit delta blocks decoded on device
        # (ops/unpack.py): the cold tier is bandwidth-bound, not
        # capacity-bound, so the win is transfer wall time: raw
        # 12 B/posting -> ~4 (tc) / ~8 (raw columns).
        if cold_transfer not in ("raw", "packed"):
            raise ValueError(f"unknown cold_transfer {cold_transfer!r}")
        self.cold_transfer = cold_transfer
        self.columns = columns
        self.packed = packed
        self.strict_parity = strict_parity
        # hbm_budget_bytes is the TOTAL device budget (the cgroup-cap
        # analog): resident terms are charged their full footprint
        # (postings + positions + blooms, per_term_device_cost) and the
        # dense head-term tier is charged per admitted row — the round-3
        # grid charged postings alone, so a "50% budget" ran a full
        # 3.2 GB dense tier beside a 0.2% hot tier: cold staging instead
        # of a memory curve.
        #
        # PROPORTIONAL-SHARE composition: the budget splits across the
        # three column families (dense rows / CSR cores / phrase
        # components) by their FULL-residency byte shares, spilling
        # unspendable remainders dense -> core -> phrase, so every
        # family degrades by roughly the same factor as the budget
        # shrinks. The dense tier gets its own share because head terms
        # are servable dense-ONLY for every non-phrase query shape
        # (TpuEngine dense_from): a head term's (N_pad,) uint8 row is
        # ~1/10 of its CSR bytes at 1M docs. The alternative —
        # CSR-first admission with the dense tier on leftovers — holds
        # 95% of posting bytes at a 0.25 budget yet loses throughput,
        # because every head query (most of the Zipf query mass) loses
        # its dense route and pays the host path.
        cost_core, cost_phr = per_term_device_cost(packed, columns,
                                                   split=True)
        n_pad = (packed.n_docs + 127) // 128 * 128
        row_bytes = 1 if columns == "tc" else 8
        per_row = n_pad * row_bytes + (n_pad // 128) * 9
        dense_min = max(TpuEngine.DENSE_MIN_DF_FLOOR,
                        packed.n_docs // TpuEngine.DENSE_ELIGIBLE_FRACTION)
        eligible = packed.df >= dense_min
        # row-index cap mirrors _build_dense_rows (slot * NB block-row
        # ids stay int32; element-flat gathers auto-widen to int64 in
        # kernels._dense_flat_idx, so n_pad no longer caps H)
        h_cap = max(0, (2**31 - 1) // max(n_pad // 128, 1) - 1)
        full_dense = min(int(eligible.sum()), h_cap) * per_row \
            + (n_pad if columns == "tc" else 0)  # + shared len-code row
        full_core = int(cost_core.sum())
        full_phr = int(cost_phr.sum())
        total_full = max(1, full_dense + full_core + full_phr)
        B = int(hbm_budget_bytes)
        # full residency (0.1% tolerance absorbs base-accounting drift
        # between full_device_bytes and this planner): no share rounding
        if B >= total_full - total_full // 1000:
            dense_budget, core_budget, phrase_budget = (
                full_dense, full_core, full_phr)
        else:
            s_dense = B * full_dense // total_full
            s_core = B * full_core // total_full
            s_phr = B - s_dense - s_core
            dense_budget = min(full_dense, s_dense)
            carry = s_dense - dense_budget
            core_budget = min(full_core, s_core + carry)
            carry = s_core + carry - core_budget
            phrase_budget = s_phr + carry

        # CSR admission: weight desc (df when unweighted), NON-eligible
        # terms first — an eligible term is served by its dense row for
        # every non-phrase shape, so its CSR only buys phrase/windowed
        # routes and must not crowd out terms with no dense alternative.
        w = (np.asarray(term_weights, dtype=np.float64)
             if term_weights is not None
             else packed.df.astype(np.float64))
        order = np.lexsort((-packed.df, -w, eligible))
        charge = cost_core.astype(np.int64)
        hot = np.zeros(packed.n_terms, dtype=bool)
        used = 0
        for r in order:
            run = int(charge[r])
            if used + run > core_budget:
                continue
            used += run
            hot[r] = True
        phrase_hot = np.zeros(packed.n_terms, dtype=bool)
        charge_p = cost_phr.astype(np.int64)
        used_p = 0
        for r in order:
            if not hot[r]:
                continue  # positions/blooms index through the CSR run
            run = int(charge_p[r])
            if used_p + run > phrase_budget:
                continue
            used_p += run
            phrase_hot[r] = True
        self.hot_mask = hot
        self.phrase_hot_mask = phrase_hot
        hot_view, _, _ = _hot_view(packed, 0, hot=hot,
                                   phrase_hot=phrase_hot)
        self.hot = TpuEngine(hot_view, doc_bodies=doc_bodies, margin=margin,
                             strict_parity=strict_parity, columns=columns,
                             dense_budget_bytes=dense_budget,
                             dense_from=packed, host_packed=packed,
                             single_term_depth=0)
        # dense-only-servable terms (row admitted by TpuEngine within
        # dense_budget, df desc — same order as the share planner)
        self.dense_mask = self.hot._dense_slot >= 0
        self.hot_bytes_used = int(
            used + used_p + self.hot.device_bytes()["dense_tier"])
        self.margin = margin
        self.doc_bodies = doc_bodies
        self.similarity = Bm25Similarity(packed.avg_len)
        self.cache64 = self.similarity.cache
        scores64 = packed.partial_scores(self.cache64)
        self._scores32 = scores64.astype(np.float32)
        # full-index single-term impact table (host RAM, zero HBM): a
        # single-term query's answer depends only on the index, so it is
        # served at table-slice speed at ANY budget — the faithful analog
        # is the reference's scoring cache + OS page cache on the hottest
        # postings (scoring.h:85-90). Queries deeper than the table fall
        # through to the hot/cold paths.
        from wiser_tpu.engine.device import build_single_term_table

        self._st_depth = 64
        (self._tt_starts, self._tt_docs,
         self._tt_scores) = build_single_term_table(packed, scores64,
                                                    self._st_depth)
        del scores64
        self._starts32 = packed.term_starts.astype(np.int32)
        self._df32 = packed.df.astype(np.int32)
        self._lens = np.diff(packed.term_starts).astype(np.int64)
        self._max_df = int(packed.df.max(initial=1))
        self._cold_host_cache: Dict[tuple, tuple] = {}
        if cold_transfer == "packed":
            from wiser_tpu.ops.unpack import doc_block_widths

            # one full-column pass at init: per-term "all blocks pack at
            # PACK_WIDTH" flag (runs are 128-aligned, so a term's blocks
            # are a contiguous block-range; reduceat = segment max)
            bw = doc_block_widths(packed.postings_doc)
            tb0 = (packed.term_starts[:-1] // BLOCK).astype(np.int64)
            self._pack16 = (np.maximum.reduceat(bw, tb0) <= PACK_WIDTH
                            if len(bw) else np.zeros(0, dtype=bool))
        if columns == "tc":
            self._code_u16 = packed.doc_len_code.astype(np.uint16)

    @property
    def hot_fraction(self) -> float:
        return float(self.hot_mask.mean()) if len(self.hot_mask) else 0.0

    def device_bytes(self) -> dict:
        """Resident (hot-tier) device bytes — the budget's spend."""
        return self.hot.device_bytes()

    @property
    def phrase_hot_fraction(self) -> float:
        """Share of terms whose phrase components (positions + blooms)
        are resident — phrase queries touching any other term go cold."""
        return (float(self.phrase_hot_mask.mean())
                if len(self.phrase_hot_mask) else 0.0)

    def search(self, query: SearchQuery) -> SearchResult:
        return self.search_batch([query])[0]

    def search_batch(self, queries: List[SearchQuery]) -> List[SearchResult]:
        results, pending = self.submit_batch(queries)
        self.run_pending(results, pending)
        return results

    def run_pending(self, results, pending) -> None:
        """Drain via the hot engine's fetch pool (overlapped group fetches;
        device.py run_pending) — cold finalizers are independent too."""
        self.hot.run_pending(results, pending)

    def _serve_single(self, qi: int, row: int, q: SearchQuery,
                      results: List[SearchResult]) -> bool:
        """Answer a single-term query from the full-index impact table
        (host RAM slice, any budget); False when deeper than the table."""
        k = q.n_results
        s, e = int(self._tt_starts[row]), int(self._tt_starts[row + 1])
        cnt = e - s
        if k > cnt and int(self.packed.df[row]) > cnt:
            return False
        take = min(k, cnt)
        res = results[qi]
        res.set_arrays(self._tt_docs[s : s + take],
                       self._tt_scores[s : s + take])
        if q.return_snippets and self.doc_bodies is not None:
            from wiser_tpu.engine.device import snippet_for

            for entry in res.entries:
                entry.snippet = snippet_for(self.packed, self.doc_bodies,
                                            [row], q, entry.doc_id)
        return True

    def submit_batch(self, queries: List[SearchQuery]):
        results = [SearchResult() for _ in queries]
        lookup = self.packed.term_to_row.get
        hot_q: List[SearchQuery] = []
        hot_qi: List[int] = []
        cold: List[Tuple[int, List[int], SearchQuery]] = []
        hot_mask, phrase_mask = self.hot_mask, self.phrase_hot_mask
        dense_mask = self.dense_mask
        for qi, q in enumerate(queries):
            if q.n_results <= 0 or not q.terms:
                continue
            rows = [lookup(t, -1) for t in q.terms]
            if min(rows) < 0:
                continue
            if len(rows) == 1 and self._serve_single(
                    qi, rows[0], q, results):
                continue
            if q.is_phrase and len(rows) >= 2:
                # phrase kernels read CSR runs + position bags + blooms
                ok = all(hot_mask[r] and phrase_mask[r] for r in rows)
            else:
                # a dense row serves every non-phrase shape (the hot
                # engine's planner fences csr-cold rows off list routes)
                ok = all(hot_mask[r] or dense_mask[r] for r in rows)
            if ok:
                hot_q.append(q)
                hot_qi.append(qi)
            else:
                cold.append((qi, rows, q))

        hot_results, hot_pending = self.hot.submit_batch(hot_q)
        for j, qi in enumerate(hot_qi):
            results[qi] = hot_results[j]  # shared objects, filled below

        # inner finalizers index by the INNER batch numbering: bind them to
        # hot_results, not the outer list (barrier marks must survive the
        # wrap — run_pending orders on them)
        pending = []
        for f in hot_pending:
            w = (lambda res_list, f=f: f(hot_results))
            if getattr(f, "barrier", False):
                w.barrier = True
            pending.append(w)
        pending += self._submit_cold(cold, queries, results)
        return results, pending

    # -- cold path -----------------------------------------------------

    # Cold compute backend. "host" (default): every cold query takes the
    # memoized exact host search — cost scales with the CANDIDATE (min)
    # df via vectorized searchsorted, and the biggest pairs were already
    # host-routed. "device" stages cold runs to a scratch column, decodes
    # packed doc blocks on the device and runs the same search kernels
    # there (element-gather-bound at the 65k-524k L buckets). Which one
    # is faster on the GPU is not measured yet.
    # The reference's own low-memory mode is CPU search over page-cached
    # flash reads (engine_bench.cc + run_exp.py cgroup grid), so host
    # compute over the RAM-resident PackedIndex is the faithful analog.
    COLD_COMPUTE = "host"
    COLD_HOST_CACHE_CAP = 200_000

    def _host_exact_memo(self, rows, k: int, is_phrase: bool = False):
        from wiser_tpu.engine.device import host_exact_search

        key = (tuple(rows), int(k), bool(is_phrase))
        cache = self._cold_host_cache
        hit = cache.get(key)
        if hit is None:
            if len(cache) >= self.COLD_HOST_CACHE_CAP:
                cache.clear()
            hit = host_exact_search(self.packed, self.cache64, rows, k,
                                    is_phrase=is_phrase)
            cache[key] = hit
        return hit

    def clear_result_memos(self) -> None:
        self._cold_host_cache.clear()
        self.hot.clear_result_memos()

    def _submit_cold(self, cold, queries, results):
        """Chunk the cold set so each chunk's staged postings fit the
        largest scratch bucket, then stage chunk by chunk. Without this,
        low-residency batches at corpus scale exceed SCRATCH_BUCKETS[-1]
        and _bucket's clip-to-largest would silently truncate the
        scratch (observed at 1M docs / 5% budget / batch 8192)."""
        if not cold:
            return []
        pending = []
        if self.COLD_COMPUTE == "host":
            return [self._host_finalizer(cold)]

        def _is_sat(item):
            rows = item[1]
            mn = min(int(self._df32[r]) for r in rows)
            # single-term saturation guard too: _bucket would CLIP a
            # candidate df above the top L bucket and silently scan a
            # truncated window (reachable at >=5M docs)
            return mn > (COLD_L_MAX_MULTI if len(rows) > 1
                         else L_BUCKETS[-1])

        sat = [it for it in cold if _is_sat(it)]
        if sat:
            cold = [it for it in cold if not _is_sat(it)]

            def run_host_sat(res_list, sat=sat):
                from wiser_tpu.engine.device import host_exact_search

                for qi, rows, q in sat:
                    d, s = host_exact_search(
                        self.packed, self.cache64, rows, q.n_results,
                        is_phrase=q.is_phrase and len(rows) >= 2)
                    res_list[qi].set_arrays(d, s)

            pending.append(run_host_sat)
        # slack for the cap's lmax margin: the largest run actually
        # staged, not the global top bucket (keeps small CHUNK_LIMIT
        # values meaningful in tests and tiny corpora)
        slack = _bucket(
            max((int(self._df32[r]) for it in cold for r in it[1]),
                default=1), COLD_L_BUCKETS)
        limit = CHUNK_LIMIT - slack
        chunk, seen, tot = [], set(), 0
        for item in cold:
            new = sorted({r for r in item[1]} - seen)
            add = int(self._lens[new].sum()) if new else 0
            if chunk and tot + add > limit:
                pending += self._submit_cold_chunk(chunk, queries, results)
                chunk, seen, tot = [], set(), 0
                new = sorted(set(item[1]))
                add = int(self._lens[new].sum())
            if add > limit and not chunk:
                raise ValueError(
                    f"single cold query stages {add} postings > scratch "
                    f"capacity {limit}; raise SCRATCH_BUCKETS")
            chunk.append(item)
            seen.update(new)
            tot += add
        if chunk:
            pending += self._submit_cold_chunk(chunk, queries, results)
        return pending

    def _host_finalizer(self, items):
        """Finalizer answering (qi, rows, q) items by exact host search."""
        def run_host(res_list, items=items):
            from wiser_tpu.engine.device import snippet_for

            for qi, rows, q in items:
                d, s = self._host_exact_memo(
                    rows, q.n_results, q.is_phrase and len(rows) >= 2)
                res = res_list[qi]
                res.set_arrays(d, s)
                if q.return_snippets and self.doc_bodies is not None:
                    for e in res.entries:
                        e.snippet = snippet_for(
                            self.packed, self.doc_bodies, rows, q, e.doc_id)

        return run_host

    def _submit_cold_chunk(self, cold, queries, results):
        phrase = [(qi, rows, q) for qi, rows, q in cold
                  if q.is_phrase and len(rows) >= 2]
        flat = [(qi, rows, q) for qi, rows, q in cold
                if not (q.is_phrase and len(rows) >= 2)]
        # stage every involved term's padded run once
        staged_terms = sorted({r for _, rows, _ in cold for r in rows})
        packed_mode = self.cold_transfer == "packed"
        if packed_mode:
            # pack16-eligible runs first: the packed segment must be a
            # contiguous prefix so decoded blocks land in place
            staged_terms.sort(key=lambda r: (not self._pack16[r], r))
        tc_flat = self.columns == "tc" and bool(flat)
        # phrase kernels read raw score/tf scratch; flat tc batches skip
        # shipping those columns entirely
        need_raw_cols = bool(phrase) or not tc_flat
        run_lens = self._lens[staged_terms]
        offs = np.zeros(len(staged_terms) + 1, dtype=np.int64)
        np.cumsum(run_lens, out=offs[1:])
        total = int(offs[-1])
        lmax = _bucket(int(self._df32[staged_terms].max(initial=1)),
                       COLD_L_BUCKETS)
        cap = _bucket(total + lmax, SCRATCH_BUCKETS)
        nA = int(np.searchsorted(
            np.fromiter((not self._pack16[r] for r in staged_terms),
                        dtype=bool, count=len(staged_terms)), True)) \
            if packed_mode else 0
        A_total = int(offs[nA])
        if packed_mode:
            G16b = _bucket(max(A_total // BLOCK, 1), _G16_BUCKETS)
            graw = (total - A_total + BLOCK - 1) // BLOCK
            Grawb = _bucket(graw, _GRAW_BUCKETS) if graw else 0
            cap = _bucket(max(total + lmax, G16b * BLOCK,
                              A_total + Grawb * BLOCK), SCRATCH_BUCKETS)
        s_doc = np.full(cap, SENTINEL_DOC, dtype=np.int32)
        s_tf = np.zeros(cap, dtype=np.int32) if need_raw_cols else None
        s_sc = np.zeros(cap, dtype=np.float32) if need_raw_cols else None
        s_tc = np.zeros(cap, dtype=np.uint16) if tc_flat else None
        scratch_start: Dict[int, int] = {}
        pk = self.packed
        for i, r in enumerate(staged_terms):
            a, n = int(offs[i]), int(run_lens[i])
            src = int(self._starts32[r])
            docs = pk.postings_doc[src : src + n]
            tfs = pk.postings_tf[src : src + n]
            s_doc[a : a + n] = docs
            if need_raw_cols:
                s_tf[a : a + n] = tfs
                s_sc[a : a + n] = self._scores32[src : src + n]
            if tc_flat:
                m = int(self._df32[r])  # real (un-padded) postings only
                code = self._code_u16[docs[:m]]
                s_tc[a : a + m] = (code << np.uint16(8)) | np.minimum(
                    tfs[:m], 255).astype(np.uint16)
            scratch_start[r] = a
        if packed_mode:
            from wiser_tpu.native import lib as native
            from wiser_tpu.ops.unpack import doc_block_deltas

            w = PACK_WIDTH
            deltas, first = doc_block_deltas(s_doc[:A_total])
            G16 = len(first)
            words = np.zeros((G16b, 4 * w), dtype=np.uint32)
            if G16:
                words[:G16] = native.pack_blocks(
                    deltas.reshape(-1), np.full(G16, w, dtype=np.uint8),
                ).reshape(G16, 4 * w)
            f16 = np.zeros(G16b, dtype=np.int32)
            f16[:G16] = first
            rawf = np.zeros(max(Grawb, 1) * BLOCK, dtype=np.int32)
            rawf[: total - A_total] = s_doc[A_total:total]
            comb = _make_doc_combine(G16b, Grawb, cap, w)
            d_doc = comb(jnp.asarray(words), jnp.asarray(f16),
                         jnp.asarray(rawf), np.int32(A_total))
        else:
            d_doc = jnp.asarray(s_doc)  # async host->device transfer
        d_tf = jnp.asarray(s_tf) if need_raw_cols else None
        d_sc = jnp.asarray(s_sc) if need_raw_cols else None
        d_tc = jnp.asarray(s_tc) if tc_flat else None

        pending = []
        if phrase:
            # stage position bags too ("read as needed" covers phrase
            # data: scratch bags are CSR-indexed by scratch posting index)
            pos_counts = np.zeros(cap, dtype=np.int64)
            pos_chunks = []
            pk = self.packed
            for i, r in enumerate(staged_terms):
                a, n = int(offs[i]), int(run_lens[i])
                src = int(self._starts32[r])
                ps = pk.pos_starts[src : src + n + 1]
                pos_counts[a : a + n] = np.diff(ps)
                pos_chunks.append(pk.positions[int(ps[0]) : int(ps[-1])])
            s_pstarts = np.zeros(cap + 1, dtype=np.int64)
            np.cumsum(pos_counts, out=s_pstarts[1:])
            s_positions = (np.concatenate(pos_chunks)
                           if pos_chunks else np.zeros(0, dtype=np.int32))
            if s_positions.size == 0:
                s_positions = np.zeros(1, dtype=np.int32)
            d_pos = jnp.asarray(s_positions.astype(np.int32))
            d_ps = jnp.asarray(s_pstarts.astype(np.int32))
            pending += self._submit_cold_phrase(
                phrase, scratch_start, d_doc, d_sc, d_tf, d_pos, d_ps,
                queries, results)

        # group/assemble (python loop — the cold tail is small)
        groups: Dict[tuple, list] = {}
        for qi, rows, q in flat:
            dfs = [int(self._df32[r]) for r in rows]
            cslot = int(np.argmin(dfs))
            T = _bucket(len(rows), COLD_T_BUCKETS)
            L = _bucket(dfs[cslot], COLD_L_BUCKETS)
            groups.setdefault((T, L), []).append((qi, rows, q, cslot))
        for (T, L), group in groups.items():
            width = _cold_chunk(T * L)
            if not width:
                pending.append(self._host_finalizer(
                    [(qi, rows, q) for qi, rows, q, _ in group]))
                continue
            for ci in range(0, len(group), width):
                chunk = group[ci : ci + width]
                B = _bucket(len(chunk), COLD_B_BUCKETS)
                starts = np.zeros((B, T), dtype=np.int32)
                ends = np.zeros((B, T), dtype=np.int32)
                use_score = np.zeros((B, T), dtype=np.float32)
                idf32_s = np.zeros((B, T), dtype=np.float32)
                idf64_q = np.zeros((B, T), dtype=np.float64)
                slot_of = np.zeros((B, T), dtype=np.int64)
                ks = np.zeros(B, dtype=np.int32)
                qis = np.zeros(B, dtype=np.int64)
                rows_of = []
                for i, (qi, rows, q, cslot) in enumerate(chunk):
                    ks[i] = q.n_results
                    qis[i] = qi
                    rows_of.append(rows)
                    order = [cslot] + [t for t in range(len(rows)) if t != cslot]
                    for slot in range(T):
                        t = order[slot] if slot < len(order) else order[0]
                        r = rows[t]
                        starts[i, slot] = scratch_start[r]
                        ends[i, slot] = scratch_start[r] + self._df32[r]
                        if slot < len(order):
                            use_score[i, slot] = 1.0
                            idf32_s[i, slot] = np.float32(
                                self.packed.idf64[r])
                    for slot, t in enumerate(order):
                        slot_of[i, t] = slot
                    for t, r in enumerate(rows):
                        idf64_q[i, t] = self.packed.idf64[r]
                M = min(L, int(ks.max(initial=1)) + self.margin)
                if os.environ.get("WISER_DEBUG_COLD"):
                    print(f"cold flat group T={T} L={L} M={M} B={B} "
                          f"cap={cap} ni={K.n_iters_for(self._max_df)} "
                          f"tc={tc_flat}", file=sys.stderr, flush=True)
                if tc_flat:
                    kern = K.make_search_kernel(
                        T, L, M, K.n_iters_for(self._max_df), mode="tc")
                    out = kern(d_doc, d_tc, self.hot.d_avg32,
                               jnp.asarray(starts), jnp.asarray(ends),
                               jnp.asarray(idf32_s))
                else:
                    kern = K.make_search_kernel(
                        T, L, M, K.n_iters_for(self._max_df))
                    out = kern(d_doc, d_sc, d_tf, jnp.asarray(starts),
                               jnp.asarray(ends), jnp.asarray(use_score))

                def finalize(res_list, out=out, T=T, n=len(chunk), qis=qis,
                             slot_of=slot_of, idf64_q=idf64_q, ks=ks,
                             rows_of=rows_of, queries=queries,
                             tc_flat=tc_flat):
                    from wiser_tpu.engine.device import host_exact_search
                    from wiser_tpu.engine.topk import (
                        rescore_sorted_arrays, truncation_suspects)

                    packed_out = np.asarray(out)
                    top_docs = packed_out[:, 0, :]
                    tfs_slot = packed_out[:, 1 : T + 1, :]
                    tf_q = np.take_along_axis(
                        tfs_slot,
                        np.broadcast_to(slot_of[:, :, None], tfs_slot.shape),
                        axis=1)
                    docs_f, score_f, n_valid = rescore_sorted_arrays(
                        top_docs, tf_q, idf64_q, self.packed.doc_len_code,
                        self.cache64)
                    suspects = truncation_suspects(
                        score_f, n_valid, ks,
                        rel_eps=1e-5 if tc_flat else 1e-6)
                    if tc_flat:
                        # saturated tf bytes score the optimistic bound;
                        # those queries must take the exact host path
                        suspects = suspects | (
                            (packed_out[:, T + 1, 0] & K.FLAG_TF_SAT) != 0)
                    if self.strict_parity:
                        suspects = suspects | (packed_out[:, T + 1, 0] != 0)
                    for i in range(n):
                        qi = int(qis[i])
                        res = res_list[qi]
                        if suspects[i]:
                            d, s = host_exact_search(
                                self.packed, self.cache64, rows_of[i],
                                int(ks[i]))
                            res.set_arrays(d, s)
                        else:
                            cnt = min(int(ks[i]), int(n_valid[i]))
                            res.set_arrays(docs_f[i, :cnt], score_f[i, :cnt])
                        q = queries[qi]
                        if q.return_snippets and self.doc_bodies is not None:
                            from wiser_tpu.engine.device import snippet_for

                            # snippets resolve posting bags via the FULL
                            # host index (cold rows aren't in the hot view)
                            for e in res.entries:
                                e.snippet = snippet_for(
                                    self.packed, self.doc_bodies, rows_of[i],
                                    q, e.doc_id)

                pending.append(finalize)
        return pending

    def _submit_cold_phrase(self, phrase, scratch_start, d_doc, d_sc, d_tf,
                            d_pos, d_ps, queries, results):
        """Cold-tier phrase execution against the staged scratch columns
        (bloomless phrase_body — the gate is a pruning optimization)."""
        from wiser_tpu.engine.device import PP_BUCKETS, host_exact_search
        from wiser_tpu.engine.topk import (rescore_sorted_arrays,
                                           truncation_suspects)

        groups: Dict[tuple, list] = {}
        for qi, rows, q in phrase:
            dfs = [int(self._df32[r]) for r in rows]
            cslot = int(np.argmin(dfs))
            T = len(rows)  # exact T: phrase adjacency needs true slots
            L = _bucket(dfs[cslot], COLD_L_BUCKETS)
            PP = _bucket(int(self.packed.max_tf[rows[0]]), PP_BUCKETS)
            groups.setdefault((T, L, PP), []).append((qi, rows, q, cslot))

        pending = []
        n_pos_iters = K.n_iters_for(int(self.packed.max_tf.max(initial=1)))
        for (T, L, PP), group in groups.items():
            width = _cold_chunk(max(T, PP) * L)
            if not width:
                pending.append(self._host_finalizer(
                    [(qi, rows, q) for qi, rows, q, _ in group]))
                continue
            for ci in range(0, len(group), width):
                chunk = group[ci : ci + width]
                B = _bucket(len(chunk), COLD_B_BUCKETS)
                starts = np.zeros((B, T), dtype=np.int32)
                ends = np.zeros((B, T), dtype=np.int32)
                use_score = np.zeros((B, T), dtype=np.float32)
                idf64_q = np.zeros((B, T), dtype=np.float64)
                slot_of = np.zeros((B, T), dtype=np.int32)
                ks = np.zeros(B, dtype=np.int32)
                qis = np.zeros(B, dtype=np.int64)
                rows_of = []
                for i, (qi, rows, q, cslot) in enumerate(chunk):
                    ks[i] = q.n_results
                    qis[i] = qi
                    rows_of.append(rows)
                    order = [cslot] + [t for t in range(T) if t != cslot]
                    for slot, t in enumerate(order):
                        r = rows[t]
                        starts[i, slot] = scratch_start[r]
                        ends[i, slot] = scratch_start[r] + self._df32[r]
                        use_score[i, slot] = 1.0
                        slot_of[i, t] = slot
                    for t, r in enumerate(rows):
                        idf64_q[i, t] = self.packed.idf64[r]
                M = min(L, int(ks.max(initial=1)) + self.margin)
                kern = K.make_phrase_kernel(
                    T, L, PP, M, K.n_iters_for(self._max_df), n_pos_iters)
                out = kern(d_doc, d_sc, d_tf, d_pos, d_ps,
                           jnp.asarray(starts), jnp.asarray(ends),
                           jnp.asarray(use_score), jnp.asarray(slot_of))

                def finalize(res_list, out=out, T=T, n=len(chunk), qis=qis,
                             slot_of=slot_of, idf64_q=idf64_q, ks=ks,
                             rows_of=rows_of, queries=queries):
                    packed_out = np.asarray(out)
                    tf_q = np.take_along_axis(
                        packed_out[:, 1 : T + 1, :],
                        np.broadcast_to(
                            slot_of[:, :, None].astype(np.int64),
                            packed_out[:, 1 : T + 1, :].shape), axis=1)
                    docs_f, score_f, n_valid = rescore_sorted_arrays(
                        packed_out[:, 0, :], tf_q, idf64_q,
                        self.packed.doc_len_code, self.cache64)
                    suspects = truncation_suspects(score_f, n_valid, ks)
                    if self.strict_parity:
                        suspects = suspects | (packed_out[:, T + 1, 0] != 0)
                    for i in range(n):
                        qi = int(qis[i])
                        res = res_list[qi]
                        if suspects[i]:
                            d, s = host_exact_search(
                                self.packed, self.cache64, rows_of[i],
                                int(ks[i]), is_phrase=True)
                            res.set_arrays(d, s)
                        else:
                            cnt = min(int(ks[i]), int(n_valid[i]))
                            res.set_arrays(docs_f[i, :cnt], score_f[i, :cnt])
                        q = queries[qi]
                        if q.return_snippets and self.doc_bodies is not None:
                            from wiser_tpu.engine.device import snippet_for

                            for e in res.entries:
                                e.snippet = snippet_for(
                                    self.packed, self.doc_bodies, rows_of[i],
                                    q, e.doc_id)

                pending.append(finalize)
        return pending
