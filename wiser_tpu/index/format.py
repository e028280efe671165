"""PackedIndex — the on-device columnar index format (the Vacuum analog).

The reference's Vacuum file (flash_containers.h, flash_engine_dumper.h)
stores per-term "cozy box" columns — doc-ID packs, TF packs, position
packs, offset packs, bloom boxes — plus a skip list per term and a term
dictionary. This is the same decomposition re-laid-out for HBM instead of
flash:

- postings are one global CSR: `term_starts[t] .. term_starts[t+1]` slices
  `postings_doc`/`postings_tf` (ascending doc ids within a term). The CSR
  offsets ARE the skip list: block k of term t starts at
  `term_starts[t] + 128*k`, and random access is an O(log df) vectorized
  binary search instead of skip-pointer chasing.
- positions/offsets are a second-level CSR addressed by global posting
  index — the exact analog of the reference's "posting bag" indirection
  (PostingBagBlobIndexes, flash_containers.h:71).
- bi-bloom filters are fixed-width uint32 rows per posting
  (`bloom_ends[p]`, `bloom_begins[p]`) so a batched probe is a row gather
  plus bitwise AND (vs. BloomBoxIterator, flash_containers.h:565).
- the term dictionary is a sorted term array (binary search /dict on host)
  standing in for the hat-trie .tip (term_index.h:101-163).
- doc bodies live in a host-side compressed doc store (doc_store.py); only
  scoring metadata (`doc_len_code`) is device-resident.

Persisted as a directory: `meta.json`, `columns.npz`, `terms.txt`,
`docs.store` — the my.vacuum/my.tip/my.fdx/my.fdt/my.doc_length analog
(vacuum_engine.h:144-166).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from wiser_tpu.index.bloom import BloomConfig

FORMAT_VERSION = 2

# Every term's posting run is padded to a multiple of BLOCK postings
# (sentinel doc INT32_MAX, tf 0) so each term starts on a block boundary —
# the direct analog of the reference's 128-value packs
# (flash_containers.h:10, packed_value.h), and what lets the device
# address posting blocks as rows of a (P/128, 128) matrix: one 128-wide
# row gather instead of 128 element gathers.
BLOCK = 128
SENTINEL_DOC = np.int32(2**31 - 1)


@dataclass
class PackedIndex:
    # term dictionary (sorted unicode order)
    terms: List[str]
    term_starts: np.ndarray  # int64[T+1] -> padded CSR offsets (128-aligned)
    df: np.ndarray  # int64[T] real posting counts (<= padded run length)
    postings_doc: np.ndarray  # int32[P_pad], ascending within term, pad SENTINEL
    postings_tf: np.ndarray  # int32[P_pad], pad 0

    # doc metadata
    n_docs: int
    avg_len: float  # float64 running mean (insertion order)
    doc_len_code: np.ndarray  # uint8[N]

    # positions (second-level CSR by global posting index)
    pos_starts: np.ndarray  # int64[P+1]
    positions: np.ndarray  # int32[sum tf]

    # offsets for highlighting (host-side use only)
    off_starts: np.ndarray  # int64[P+1]
    off_begin: np.ndarray  # int32
    off_end: np.ndarray  # int32

    # bi-bloom columnar filters; shape (P, W) uint32, all-zero = absent
    bloom_cfg: BloomConfig = field(default_factory=BloomConfig)
    bloom_ends: Optional[np.ndarray] = None
    bloom_begins: Optional[np.ndarray] = None

    # derived (built in __post_init__)
    term_to_row: Dict[str, int] = field(default_factory=dict, repr=False)
    idf64: np.ndarray = None  # float64[T]
    max_tf: np.ndarray = None  # int32[T] (for phrase position bucketing)

    def __post_init__(self):
        if not self.term_to_row:
            self.term_to_row = {t: i for i, t in enumerate(self.terms)}
        if self.idf64 is None:
            from wiser_tpu.scoring import calc_es_idf

            self.idf64 = np.asarray(calc_es_idf(self.n_docs, self.df), dtype=np.float64)
        if self.max_tf is None:
            if len(self.postings_tf) and len(self.terms):
                # segmented max via reduceat (runs are never empty: padded
                # to >=1 block) — ufunc.at was 100x slower at 20M postings
                self.max_tf = np.maximum.reduceat(
                    self.postings_tf, self.term_starts[:-1].astype(np.int64)
                ).astype(np.int32)
            else:
                self.max_tf = np.zeros(len(self.terms), dtype=np.int32)

    # -- introspection ----------------------------------------------------

    @property
    def n_terms(self) -> int:
        return len(self.terms)

    @property
    def n_postings(self) -> int:
        """Padded posting count (block-aligned)."""
        return int(self.term_starts[-1])

    def lookup(self, term: str) -> int:
        """term -> row, or -1 (the TermTrieIndex::Find analog)."""
        return self.term_to_row.get(term, -1)

    def postinglist_size(self, term: str) -> int:
        r = self.lookup(term)
        return int(self.df[r]) if r >= 0 else 0

    def partial_scores(self, cache64: np.ndarray) -> np.ndarray:
        """Per-posting f64 partial BM25 score idf_term * lossy_tfnorm —
        the device selection-phase score column (the 256-entry cache idea
        of scoring.h:85-90 extended to a full per-posting bake). Padded
        (sentinel) postings score 0."""
        lens = np.diff(self.term_starts)
        term_of = np.repeat(np.arange(self.n_terms, dtype=np.int64), lens)
        valid = self.postings_doc != SENTINEL_DOC
        code = self.doc_len_code[
            np.where(valid, self.postings_doc, 0).astype(np.int64)] & 0xFF
        cache_val = cache64[code]
        tf = self.postings_tf.astype(np.float64)
        score = self.idf64[term_of] * ((tf * 2.2) / (tf + cache_val))
        return np.where(valid, score, 0.0)

    # -- persistence ------------------------------------------------------

    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        meta = {
            "format_version": FORMAT_VERSION,
            "n_docs": self.n_docs,
            "avg_len": self.avg_len,
            "n_terms": self.n_terms,
            "bloom": {
                "expected_entries": self.bloom_cfg.expected_entries,
                "error_ratio": self.bloom_cfg.error_ratio,
            },
            "has_blooms": self.bloom_ends is not None,
        }
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f, indent=1)
        with open(os.path.join(path, "terms.txt"), "w", encoding="utf-8") as f:
            f.write("\n".join(self.terms))
        cols = {
            "term_starts": self.term_starts,
            "df": self.df,
            "postings_doc": self.postings_doc,
            "postings_tf": self.postings_tf,
            "doc_len_code": self.doc_len_code,
            "pos_starts": self.pos_starts,
            "positions": self.positions,
            "off_starts": self.off_starts,
            "off_begin": self.off_begin,
            "off_end": self.off_end,
        }
        if self.bloom_ends is not None:
            cols["bloom_ends"] = self.bloom_ends
            cols["bloom_begins"] = self.bloom_begins
        np.savez(os.path.join(path, "columns.npz"), **cols)

    @classmethod
    def load(cls, path: str, skip_offsets: bool = False) -> "PackedIndex":
        """Load a saved index. skip_offsets=True leaves the char-offset
        bags empty (zero-length CSR): they feed only the highlighter and
        cost ~15 GB of host RAM at 10M docs — benchmarks and serving
        paths that never highlight should skip them."""
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        if meta["format_version"] != FORMAT_VERSION:
            raise ValueError(f"unsupported index format {meta['format_version']}")
        with open(os.path.join(path, "terms.txt"), encoding="utf-8") as f:
            raw = f.read()
        terms = raw.split("\n") if raw else []
        z = np.load(os.path.join(path, "columns.npz"))
        if skip_offsets:
            n_post = int(z["term_starts"][-1])
            off_starts = np.zeros(n_post + 1, dtype=np.int64)
            off_begin = np.zeros(0, dtype=np.int32)
            off_end = np.zeros(0, dtype=np.int32)
        else:
            off_starts = z["off_starts"]
            off_begin = z["off_begin"]
            off_end = z["off_end"]
        return cls(
            terms=terms,
            term_starts=z["term_starts"],
            df=z["df"],
            postings_doc=z["postings_doc"],
            postings_tf=z["postings_tf"],
            n_docs=meta["n_docs"],
            avg_len=meta["avg_len"],
            doc_len_code=z["doc_len_code"],
            pos_starts=z["pos_starts"],
            positions=z["positions"],
            off_starts=off_starts,
            off_begin=off_begin,
            off_end=off_end,
            bloom_cfg=BloomConfig(
                meta["bloom"]["expected_entries"], meta["bloom"]["error_ratio"]
            ),
            bloom_ends=z["bloom_ends"] if meta["has_blooms"] else None,
            bloom_begins=z["bloom_begins"] if meta["has_blooms"] else None,
        )
