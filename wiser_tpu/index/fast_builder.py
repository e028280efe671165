"""Vectorized linedoc -> PackedIndex builder for reference-scale corpora.

The oracle-based builder (index/builder.py) loops per posting in Python —
fine for test corpora, hopeless at the reference's 20M-doc Wikipedia
(flash_engine_dumper.h:735 streams the full dump through a native
dumper). This module is the scalable analog: the linedoc stream is parsed
in chunks with column-level string ops (one `str.split`/`fromstring` per
chunk, not per value), term ids are assigned through a single dict pass,
and the packed CSR columns are assembled with numpy prefix sums and
ragged gathers — no per-posting Python anywhere.

Semantics are IDENTICAL to builder.build_index (tests enforce equality of
every column, including avg_len's running-mean fold order and the lossy
doc-length codes): this is a faster dumper for the same format, exactly
like convert_qq_to_vacuum vs the in-memory engine.

Expected input is the canonical linedoc shape produced by
data/corpus.py / data/scale_corpus.py (and the reference's pipeline):
tokens = unique terms, single-space separated; positions groups
"p1;p2;." per term; offsets groups "a,b;c,d;." per term. Non-canonical
rows raise ValueError — callers fall back to the oracle path.
"""

from __future__ import annotations

import os
import shutil
import time
from itertools import repeat
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from wiser_tpu.index.bloom import BloomConfig
from wiser_tpu.index.format import BLOCK, PackedIndex, SENTINEL_DOC
from wiser_tpu.codecs import uint_to_char4_np
from wiser_tpu.scoring import RunningAvgLength


def _fromstring(s: str, seps: str) -> np.ndarray:
    import warnings

    for ch in seps:
        s = s.replace(ch, " ")
    if not s.strip():
        return np.empty(0, dtype=np.int64)
    with warnings.catch_warnings():
        # np.fromstring's text mode is deprecated but is the only C-speed
        # bulk number parser in numpy; guarded by the count checks below
        warnings.simplefilter("ignore", DeprecationWarning)
        return np.fromstring(s, dtype=np.int64, sep=" ")


class _Spill:
    """Append-mode disk spill for chunk-parsed columns.

    At 10M docs the in-RAM accumulation alone is ~100 GB (measured: the
    parse phase of a 10M build plateaued at 103 GB RSS) and the pack
    phase needs tens of GB of working set on top — past this host's
    125 GB. Spilling each chunk's columns to flat binary files keeps the
    parse-phase resident set at ~the vocab dict, and the pack phase
    reloads each column exactly once with np.fromfile (no duplicate):
    the same stream-through-disk shape as the reference's two-stage
    dumper (flash_engine_dumper.h:735)."""

    def __init__(self, spill_dir: str):
        os.makedirs(spill_dir, exist_ok=True)
        self.dir = spill_dir
        self._files: Dict[str, object] = {}

    def append(self, name: str, arr: np.ndarray) -> None:
        f = self._files.get(name)
        if f is None:
            f = self._files[name] = open(
                os.path.join(self.dir, name + ".bin"), "wb")
        f.write(memoryview(np.ascontiguousarray(arr)))

    def load(self, name: str, dtype) -> np.ndarray:
        f = self._files.pop(name, None)
        if f is not None:
            f.close()
        path = os.path.join(self.dir, name + ".bin")
        if not os.path.exists(path):
            return np.empty(0, dtype=dtype)
        return np.fromfile(path, dtype=dtype)

    def drop(self, name: str) -> None:
        """Delete a spill file as soon as its column has been consumed —
        frees disk ahead of the index save (the 10M build runs with
        ~80 GB free disk total)."""
        path = os.path.join(self.dir, name + ".bin")
        if os.path.exists(path):
            os.remove(path)

    def cleanup(self) -> None:
        for f in self._files.values():
            f.close()
        self._files.clear()
        shutil.rmtree(self.dir, ignore_errors=True)


class _ChunkAccum:
    """Per-corpus accumulation of chunk-parsed columns.

    With a _Spill attached, the big per-entry columns go to disk and the
    lists stay empty; only vocab/doc_lengths stay resident."""

    def __init__(self, spill: Optional[_Spill] = None):
        self.vocab: Dict[str, int] = {}
        self.term_ids: List[np.ndarray] = []
        self.doc_ids: List[np.ndarray] = []
        self.tf: List[np.ndarray] = []
        self.positions: List[np.ndarray] = []
        self.off_b: List[np.ndarray] = []
        self.off_e: List[np.ndarray] = []
        self.doc_lengths: List[np.ndarray] = []
        # (a_hash u32, b_hash u32, entry_of i64) per chunk: neighbor keys
        # are murmur-hashed AT PARSE TIME — holding the key strings for
        # the whole corpus measured ~20 GB of the builder's 31 GB peak at
        # 1M docs (100M+ small Python strings), and the bloom writer only
        # ever needs the two hashes
        self.bloom_ends_keys: List[tuple] = []
        self.bloom_begins_keys: List[tuple] = []
        self.n_docs = 0
        self.n_entries = 0
        self.spill = spill


def _map_term_ids(vocab: Dict[str, int], flat_tokens: List[str]) -> np.ndarray:
    """Dict-map tokens to ids, inserting new terms; C-driven via map().

    int32 ids: the accumulated (term_id, doc_id, tf) triples are the
    builder's second-largest resident after bloom keys — 24 B/entry in
    int64 was ~13 GB of a 10M-doc build's peak on their own."""
    ids = np.fromiter(map(vocab.get, flat_tokens, repeat(-1)),
                      dtype=np.int32, count=len(flat_tokens))
    missing = np.nonzero(ids < 0)[0]
    if len(missing):
        for i in missing.tolist():
            t = flat_tokens[i]
            gid = vocab.setdefault(t, len(vocab))
            ids[i] = gid
    return ids


def _parse_group_col(cols: List[str], n_entries: int, seps: str,
                     what: str) -> Tuple[np.ndarray, np.ndarray]:
    """Parse a '.'-separated per-term group column over a whole chunk.

    Returns (counts int64[n_entries], flat numbers int64[total])."""
    joined = "".join(cols)
    buf = np.frombuffer(joined.encode("utf-8"), dtype=np.uint8)
    dots = np.flatnonzero(buf == ord("."))
    if len(buf) and buf[-1] != ord("."):  # unterminated last group
        dots = np.append(dots, len(buf))
    if len(dots) != n_entries:
        raise ValueError(
            f"non-canonical {what} column: {len(dots)} groups for "
            f"{n_entries} token entries (empty groups / missing dots?)")
    semis = np.flatnonzero(buf == ord(";"))
    counts = np.diff(np.searchsorted(semis, dots), prepend=0)
    nums = _fromstring(joined, ";,.")
    return counts.astype(np.int64), nums


def _hash_bloom_col(cols: List[str], n_entries: int, what: str):
    """Parse a '!'-separated phrase-neighbor column and double-hash its
    keys (libbloom's a + i*b probe sequence needs exactly these two murmur
    values per key) in one pass over the column's bytes. Keys are the
    single-space-split pieces of every non-empty group. Returns (a u32,
    b u32, entry_of int64) per key."""
    from wiser_tpu.native.lib import murmur2_batch_seeded

    blob = "".join(cols).encode("utf-8")
    if blob and not blob.endswith(b"!"):  # unterminated last group
        blob += b"!"
    buf = np.frombuffer(blob, dtype=np.uint8)
    bangs = np.flatnonzero(buf == ord("!"))
    if len(bangs) != n_entries:
        raise ValueError(
            f"non-canonical {what} column: {len(bangs)} groups for "
            f"{n_entries} token entries")
    # pieces end at every separator; a piece belongs to the group whose
    # '!' closes it, and empty groups ("!!") contribute no key
    sep = np.flatnonzero((buf == ord(" ")) | (buf == ord("!")))
    starts = np.concatenate([[0], sep[:-1] + 1]).astype(np.int64)
    group = np.searchsorted(bangs, sep)
    glen = np.diff(bangs, prepend=-1) - 1
    keep = glen[group] > 0
    starts, ends = starts[keep], sep[keep].astype(np.int64)
    entry_of = group[keep]
    a = murmur2_batch_seeded(blob, starts, ends, None)  # seed=MURMUR
    b = murmur2_batch_seeded(blob, starts, ends, a)
    return a, b, entry_of.astype(np.int64)


def parse_linedoc_chunks(
    path: str, fmt: str, chunk_docs: int = 20_000,
    n_rows: Optional[int] = None, with_blooms: bool = False,
) -> Iterator[tuple]:
    """Yield per-chunk column lists (tok_cols, pos_cols, off_cols,
    body_cols, ends_cols, begins_cols)."""
    if fmt not in ("WITH_POSITIONS", "WITH_PHRASE_END", "WITH_BI_BLOOM"):
        raise ValueError(
            f"fast builder supports positional formats, not {fmt}")
    want_blooms = with_blooms and fmt == "WITH_BI_BLOOM"
    cols: List[List[str]] = [[], [], [], [], [], []]
    count = 0
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        f.readline()  # header
        for line in f:
            if n_rows is not None and count >= n_rows:
                break
            line = line.rstrip("\n")
            if not line:
                continue
            items = line.split("\t")
            cols[0].append(items[2])  # tokens
            cols[1].append(items[4])  # positions
            cols[2].append(items[3])  # offsets
            cols[3].append(items[1])  # body
            if want_blooms:
                cols[4].append(items[5])  # ends
                cols[5].append(items[6])  # begins
            count += 1
            if len(cols[0]) >= chunk_docs:
                yield tuple(cols)
                cols = [[], [], [], [], [], []]
    if cols[0]:
        yield tuple(cols)


def _accumulate_chunk(acc: _ChunkAccum, chunk: tuple,
                      with_blooms: bool) -> None:
    tok_cols, pos_cols, off_cols, body_cols, ends_cols, begins_cols = chunk
    n_docs = len(tok_cols)
    flat_tokens: List[str] = []
    n_tok = np.empty(n_docs, dtype=np.int64)
    for i, tc in enumerate(tok_cols):
        ts = tc.split(" ")
        if ts and ts[-1] == "":
            ts.pop()
        flat_tokens.extend(ts)
        n_tok[i] = len(ts)
    if "" in flat_tokens:
        raise ValueError("non-canonical tokens column (empty tokens)")
    E = len(flat_tokens)

    term_ids = _map_term_ids(acc.vocab, flat_tokens)
    doc_ids = np.repeat(
        np.arange(acc.n_docs, acc.n_docs + n_docs, dtype=np.int32), n_tok)

    pos_counts, pos_nums = _parse_group_col(pos_cols, E, ";.", "positions")
    if int(pos_counts.sum()) != len(pos_nums):
        raise ValueError("non-canonical positions column (count mismatch)")
    off_counts, off_nums = _parse_group_col(off_cols, E, ";,.", "offsets")
    if 2 * int(off_counts.sum()) != len(off_nums):
        raise ValueError("non-canonical offsets column (pair mismatch)")
    if not np.array_equal(off_counts, pos_counts):
        raise ValueError("offsets/positions group size mismatch")

    # body length: count of non-empty space-separated terms. Canonical
    # bodies are single-spaced; fall back per-doc where not.
    blen = np.empty(n_docs, dtype=np.int64)
    for i, b in enumerate(body_cols):
        if not b:
            blen[i] = 0
        elif "  " not in b and b[0] != " " and b[-1] != " ":
            blen[i] = b.count(" ") + 1
        else:
            blen[i] = len([t for t in b.split(" ") if t])

    spill = acc.spill
    if spill is not None:
        spill.append("term_ids", term_ids)
        spill.append("doc_ids", doc_ids)
        spill.append("tf", pos_counts.astype(np.int32))
        spill.append("positions", pos_nums.astype(np.int32))
        spill.append("off_b", off_nums[0::2].astype(np.int32))
        spill.append("off_e", off_nums[1::2].astype(np.int32))
    else:
        acc.term_ids.append(term_ids)
        acc.doc_ids.append(doc_ids)
        acc.tf.append(pos_counts.astype(np.int32))
        acc.positions.append(pos_nums.astype(np.int32))
        acc.off_b.append(off_nums[0::2].astype(np.int32))
        acc.off_e.append(off_nums[1::2].astype(np.int32))
    acc.doc_lengths.append(blen)
    if with_blooms:
        entry_base = acc.n_entries
        for colz, name, store in (
                (ends_cols, "ends", acc.bloom_ends_keys),
                (begins_cols, "begins", acc.bloom_begins_keys)):
            a, b, entry_of = _hash_bloom_col(colz, E, "bloom")
            # int32 entry ids: < 2^31 entries by the device-addressing
            # guard; the (a, b, entry_of) chunks are the builder's
            # largest resident (measured ~20 GB of the 31 GB 1M peak
            # pre-hashing; 8->4 B per id cuts the 10M build ~4 GB)
            eids = (entry_of + entry_base).astype(np.int32)
            if spill is not None:
                spill.append(name + "_a", a)
                spill.append(name + "_b", b)
                spill.append(name + "_e", eids)
            else:
                store.append((a, b, eids))
    acc.n_docs += n_docs
    acc.n_entries += E


def _bloom_rows(key_chunks, n_entries: int, order_inv: np.ndarray,
                pidx: np.ndarray, P: int, cfg: BloomConfig) -> np.ndarray:
    """Build columnar bloom rows (P, n_words) from pre-hashed
    (a, b, entry_of) chunks. entry ids are pre-sort; order_inv maps them
    to sorted entry order, pidx maps sorted entries to padded posting
    indices. key_chunks may be a list of tuples or a zero-arg callable
    returning an iterator (the disk-spill path streams slices so the
    H-wide u64 temp stays bounded)."""
    if callable(key_chunks):
        key_chunks = key_chunks()
    rows = np.zeros((P, cfg.n_words), dtype=np.uint32)
    H = cfg.n_hashes
    bits = np.uint64(cfg.bits)
    i_h = np.arange(H, dtype=np.uint64)[None, :]
    from wiser_tpu.native import lib as native

    for a, b, entry_of in key_chunks:
        if not len(a):
            continue
        prow = pidx[order_inv[entry_of]]
        if native.bloom_set_rows(a, b, prow, H, cfg.bits, rows):
            continue
        x = ((a.astype(np.uint64)[:, None] + i_h * b.astype(np.uint64)[:, None])
             & np.uint64(0xFFFFFFFF)) % bits
        word = (x // 32).astype(np.int64)
        mask = (np.uint32(1) << (x % 32).astype(np.uint32)).astype(np.uint32)
        flat = prow[:, None] * cfg.n_words + word
        np.bitwise_or.at(rows.reshape(-1), flat.ravel(), mask.ravel())
    return rows


def pack_from_arrays(
    term_ids: np.ndarray,  # (E,) discovery-order ids
    doc_ids: np.ndarray,  # (E,)
    tf: np.ndarray,  # (E,)
    positions: np.ndarray,  # flat, per-entry groups of tf values
    off_b: np.ndarray,
    off_e: np.ndarray,
    doc_lengths: np.ndarray,  # (N,)
    vocab: Dict[str, int],
    bloom_cfg: Optional[BloomConfig] = None,
    bloom_key_chunks: Optional[tuple] = None,  # (ends_chunks, begins_chunks)
) -> PackedIndex:
    """Assemble the packed CSR columns from flat occurrence arrays.

    Memory discipline: every stored column keeps its format dtype, but
    all E/P/total-sized TEMPORARIES are int32 and freed (del) the moment
    they are consumed — at 10M docs (E~0.6B entries, 0.8B positions) the
    naive int64 version of this function needs >60 GB of working set on
    top of the inputs; this one stays under ~25 GB. Inputs are consumed:
    callers must drop their references (build_packed_fast does)."""
    terms = sorted(vocab)
    T = len(terms)
    remap = np.empty(T, dtype=np.int32)
    remap[np.fromiter((vocab[t] for t in terms), dtype=np.int64, count=T)] = \
        np.arange(T, dtype=np.int32)
    tid = remap[term_ids]
    del term_ids

    E = len(tid)
    if E >= 2**31 or len(positions) >= 2**31:
        raise ValueError("corpus exceeds int32 entry addressing "
                         f"(E={E}, positions={len(positions)})")
    order = np.lexsort((doc_ids, tid)).astype(np.int32)
    df = np.bincount(tid[order], minlength=T)
    del tid
    padded = (df + BLOCK - 1) // BLOCK * BLOCK
    term_starts = np.zeros(T + 1, dtype=np.int64)
    np.cumsum(padded, out=term_starts[1:])
    P = int(term_starts[-1])
    if P >= 2**31:
        raise ValueError(f"padded postings exceed int32 addressing (P={P})")

    seg = np.zeros(T + 1, dtype=np.int64)
    np.cumsum(df, out=seg[1:])
    # pidx = repeat(term_starts, df) + (arange(E) - repeat(seg, df)):
    # sorted entry -> padded posting index, built in int32 pieces
    pidx = np.repeat(term_starts[:-1].astype(np.int32), df)
    pidx += np.arange(E, dtype=np.int32)
    pidx -= np.repeat(seg[:-1].astype(np.int32), df)
    del seg

    doc_s = doc_ids[order]
    del doc_ids
    postings_doc = np.full(P, SENTINEL_DOC, dtype=np.int32)
    postings_doc[pidx] = doc_s
    del doc_s
    tf_s = tf[order]
    postings_tf = np.zeros(P, dtype=np.int32)
    postings_tf[pidx] = tf_s

    # second-level CSRs: ragged reorder of the per-entry bags.
    # gather = repeat(src_starts[order] - new_starts, tf_s) + arange(total)
    src_starts = np.zeros(E + 1, dtype=np.int64)
    np.cumsum(tf, out=src_starts[1:])
    del tf
    new_starts = np.zeros(E + 1, dtype=np.int64)
    np.cumsum(tf_s, out=new_starts[1:])
    total = int(new_starts[-1])
    base = src_starts[:-1].astype(np.int32)[order]
    base -= new_starts[:-1].astype(np.int32)
    del src_starts, new_starts
    gather = np.repeat(base, tf_s)
    del base
    gather += np.arange(total, dtype=np.int32)

    pos_counts_padded = np.zeros(P, dtype=np.int64)
    pos_counts_padded[pidx] = tf_s
    del tf_s
    pos_starts = np.zeros(P + 1, dtype=np.int64)
    np.cumsum(pos_counts_padded, out=pos_starts[1:])
    del pos_counts_padded

    positions_f = positions[gather]
    del positions
    off_b_f = off_b[gather]
    del off_b
    off_e_f = off_e[gather]
    del off_e, gather

    # exact oracle semantics: running mean in insertion order
    avg = RunningAvgLength()
    for v in doc_lengths.tolist():
        avg.add(int(v))

    bloom_ends = bloom_begins = None
    if bloom_key_chunks is not None:
        order_inv = np.empty(E, dtype=np.int32)
        order_inv[order] = np.arange(E, dtype=np.int32)
        del order
        # order_inv maps pre-sort entry -> sorted rank; compose with pidx
        sorted_to_pidx = pidx
        bloom_ends = _bloom_rows(bloom_key_chunks[0], E,
                                 order_inv, sorted_to_pidx, P, bloom_cfg)
        bloom_begins = _bloom_rows(bloom_key_chunks[1], E,
                                   order_inv, sorted_to_pidx, P, bloom_cfg)

    return PackedIndex(
        terms=terms,
        term_starts=term_starts,
        df=df.astype(np.int64),
        postings_doc=postings_doc,
        postings_tf=postings_tf,
        n_docs=len(doc_lengths),
        avg_len=float(avg.avg),
        doc_len_code=uint_to_char4_np(doc_lengths),
        pos_starts=pos_starts,
        positions=positions_f,
        off_starts=pos_starts.copy(),  # offsets parallel positions (1 pair per pos)
        off_begin=off_b_f,
        off_end=off_e_f,
        bloom_cfg=bloom_cfg or BloomConfig(),
        bloom_ends=bloom_ends,
        bloom_begins=bloom_begins,
    )


def _consume_concat(chunks: List[np.ndarray]) -> np.ndarray:
    """Concatenate chunk arrays, freeing each chunk as it is copied —
    np.concatenate holds source + destination simultaneously, which at
    10M docs doubles ~35 GB of accumulated columns."""
    if not chunks:
        return np.empty(0, dtype=np.int32)
    total = sum(len(c) for c in chunks)
    out = np.empty(total, dtype=chunks[0].dtype)
    o = 0
    while chunks:
        c = chunks.pop(0)
        out[o : o + len(c)] = c
        o += len(c)
    return out


def _spill_side_loader(spill: _Spill, prefix: str, slice_keys: int = 4_000_000):
    """Zero-arg callable for _bloom_rows: loads one bloom side's hashed
    keys from spill, drops the files, and yields bounded slices."""

    def gen():
        a = spill.load(prefix + "_a", np.uint32)
        b = spill.load(prefix + "_b", np.uint32)
        e = spill.load(prefix + "_e", np.int32)
        for suf in ("_a", "_b", "_e"):
            spill.drop(prefix + suf)
        for i in range(0, len(a), slice_keys):
            yield a[i : i + slice_keys], b[i : i + slice_keys], \
                e[i : i + slice_keys]

    return gen


def build_packed_fast(
    path: str, fmt: str = "WITH_POSITIONS",
    n_rows: Optional[int] = None,
    chunk_docs: int = 20_000,
    with_blooms: bool = False,
    bloom_cfg: Optional[BloomConfig] = None,
    verbose: bool = False,
    spill_dir: Optional[str] = None,
) -> PackedIndex:
    """Stream a linedoc file into a PackedIndex, vectorized end to end.

    With spill_dir, parsed columns stream to disk and reload once at
    pack time — required above ~5M docs on a 128 GB host (a 10M in-RAM
    build measured 103 GB resident before packing even began).

    reference analog: tools/indexer.py:139-151 (create_qq_mem_dump +
    convert_qq_to_vacuum) in one pass."""
    spill = _Spill(spill_dir) if spill_dir else None
    try:
        acc = _ChunkAccum(spill)
        t0 = time.time()
        for chunk in parse_linedoc_chunks(path, fmt, chunk_docs, n_rows,
                                          with_blooms):
            _accumulate_chunk(acc, chunk, with_blooms)
            if verbose:
                print(f"  parsed {acc.n_docs} docs ({time.time()-t0:.1f}s)",
                      flush=True)
        if acc.n_docs == 0:
            raise ValueError(f"no docs parsed from {path}")
        if spill is not None:
            cols = []
            for name in ("term_ids", "doc_ids", "tf", "positions",
                         "off_b", "off_e"):
                cols.append(spill.load(name, np.int32))
                spill.drop(name)
            bloom_chunks = ((_spill_side_loader(spill, "ends"),
                             _spill_side_loader(spill, "begins"))
                            if with_blooms else None)
        else:
            cols = [_consume_concat(acc.term_ids),
                    _consume_concat(acc.doc_ids),
                    _consume_concat(acc.tf),
                    _consume_concat(acc.positions),
                    _consume_concat(acc.off_b),
                    _consume_concat(acc.off_e)]
            bloom_chunks = ((acc.bloom_ends_keys, acc.bloom_begins_keys)
                            if with_blooms else None)
        doc_lengths = _consume_concat(acc.doc_lengths)
        vocab = acc.vocab
        del acc
        packed = pack_from_arrays(
            cols.pop(0), cols.pop(0), cols.pop(0),
            cols.pop(0), cols.pop(0), cols.pop(0),
            doc_lengths, vocab,
            bloom_cfg=bloom_cfg or BloomConfig(),
            bloom_key_chunks=bloom_chunks,
        )
        if verbose:
            print(f"  packed {packed.n_postings} postings / "
                  f"{packed.n_terms} terms in {time.time()-t0:.1f}s",
                  flush=True)
        return packed
    finally:
        if spill is not None:
            spill.cleanup()
