"""In-memory oracle engine — the QQ-Mem analog, exact f64 semantics.

Plays the role the in-memory QQ-Mem engine plays for Vacuum in the reference
(qq_mem_engine.h:46-447): a simple, obviously-correct engine used as ground
truth in equivalence tests against the packed device engine (SURVEY.md §4's
load-bearing test idea). All scoring is float64 with the reference's
operation order; top-k is canonicalized as (score desc, doc_id asc), which
reproduces the reference min-heap's kept set (query_processing.h:897-945:
strict-> insertion over ascending doc ids keeps the lowest doc ids among
ties).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from wiser_tpu.scoring import Bm25Similarity, RunningAvgLength, calc_es_idf, K1
from wiser_tpu.codecs import uint_to_char4
from wiser_tpu.types import DocInfo, SearchQuery, SearchResult, SearchResultEntry


@dataclass
class Posting:
    """reference: StandardPosting (posting.h:130-151)."""

    doc_id: int
    term_freq: int
    offsets: List[Tuple[int, int]] = field(default_factory=list)
    positions: List[int] = field(default_factory=list)


class OracleEngine:
    """Exact in-memory engine over parsed DocInfos.

    reference: QqMemEngineDelta (qq_mem_engine.h:268-447) +
    InvertedIndexQqMemDelta (qq_mem_engine.h:46-265).
    """

    def __init__(self):
        self.index: Dict[str, List[Posting]] = {}
        self.doc_bodies: List[str] = []
        self.doc_len_codes: List[int] = []  # lossy 1-byte codes
        self._avg = RunningAvgLength()
        self.similarity = Bm25Similarity(1.0)
        # per (term, doc): set of following / preceding terms, for the
        # bi-bloom phrase pre-check (bloom_filter.h:277-322). The oracle
        # keeps exact sets; bloom false positives never change results.
        self.phrase_ends: Dict[Tuple[str, int], set] = {}
        self.phrase_begins: Dict[Tuple[str, int], set] = {}

    # -- indexing ----------------------------------------------------------

    def add_document(self, doc: DocInfo) -> int:
        """reference: QqMemEngineDelta::AddDocument (qq_mem_engine.h:298-305)."""
        doc_id = len(self.doc_bodies)
        self.doc_bodies.append(doc.body)

        tokens = doc.get_tokens()
        offsets = doc.get_offset_pairs_vec()
        positions = doc.get_positions()
        ends = doc.get_phrase_ends()
        begins = doc.get_phrase_begins()

        for i, term in enumerate(tokens):
            offs = offsets[i] if i < len(offsets) else []
            poss = positions[i] if i < len(positions) else []
            # term freq = positions count when available, else offsets count,
            # else 1 (TOKEN_ONLY indexes token counts via count_tokens —
            # tokens column holds unique terms in fixtures, tf from groups).
            tf = len(poss) or len(offs) or 1
            self.index.setdefault(term, []).append(
                Posting(doc_id, tf, offs, poss)
            )
            if i < len(ends) and ends[i]:
                self.phrase_ends[(term, doc_id)] = set(ends[i].split(" "))
            if i < len(begins) and begins[i]:
                self.phrase_begins[(term, doc_id)] = set(begins[i].split(" "))

        self._avg.add(doc.body_length())
        self.doc_len_codes.append(uint_to_char4(doc.body_length()))
        self.similarity.reset(float(self._avg.avg))
        return doc_id

    def load_linedocs(self, docs) -> int:
        n = 0
        for d in docs:
            self.add_document(d)
            n += 1
        return n

    # -- introspection -----------------------------------------------------

    @property
    def n_docs(self) -> int:
        return len(self.doc_bodies)

    @property
    def avg_length(self) -> float:
        return float(self._avg.avg)

    def term_count(self) -> int:
        return len(self.index)

    def postinglist_size(self, term: str) -> int:
        return len(self.index.get(term, []))

    def get_document(self, doc_id: int) -> str:
        return self.doc_bodies[doc_id]

    # -- search ------------------------------------------------------------

    def _postings(self, term: str) -> List[Posting]:
        return self.index.get(term, [])

    @staticmethod
    def _intersect(lists: List[List[Posting]]) -> List[List[Posting]]:
        """Return per-doc posting tuples for docs present in every list,
        ascending doc id (the zigzag result, query_processing.h:644-678)."""
        if not lists or any(len(l) == 0 for l in lists):
            return []
        maps = [{p.doc_id: p for p in l} for l in lists[1:]]
        out = []
        for p0 in lists[0]:
            row = [p0]
            ok = True
            for m in maps:
                q = m.get(p0.doc_id)
                if q is None:
                    ok = False
                    break
                row.append(q)
            if ok:
                out.append(row)
        return out

    @staticmethod
    def phrase_match_count(postings_row: List[Posting]) -> int:
        """Number of phrase occurrences: positions p_i with common p_i - i
        (reference adjusted-position algorithm, query_processing.h:266-362)."""
        adjusted = [set(np.asarray(p.positions, dtype=np.int64) - i)
                    for i, p in enumerate(postings_row)]
        common = set.intersection(*adjusted) if adjusted else set()
        return len(common)

    def phrase_match_table(self, postings_row: List[Posting]) -> List[List[int]]:
        """Original positions of each term at every phrase match, per match
        (the PositionInfoTable2 analog), used for highlighting."""
        adjusted = [set(np.asarray(p.positions, dtype=np.int64) - i)
                    for i, p in enumerate(postings_row)]
        common = sorted(set.intersection(*adjusted)) if adjusted else []
        return [[int(base + i) for i, _ in enumerate(postings_row)] for base in common]

    def search(self, query: SearchQuery) -> SearchResult:
        """reference: Search → ProcessQueryDelta (qq_mem_engine.h:335-368,
        query_processing.h:956-979)."""
        result = SearchResult()
        if query.n_results == 0:
            return result
        terms = query.terms
        lists = [self._postings(t) for t in terms]
        if any(len(l) == 0 for l in lists):
            return result

        idfs = [float(calc_es_idf(self.n_docs, len(l))) for l in lists]

        rows = self._intersect(lists)
        if query.is_phrase and len(terms) > 1:
            rows = [r for r in rows if self.phrase_match_count(r) > 0]
        if not rows:
            return result

        # exact f64 scores, term-order accumulation
        scored = []
        for row in rows:
            code = self.doc_len_codes[row[0].doc_id]
            cache_val = self.similarity.cache[code & 0xFF]
            s = np.float64(0.0)
            for idf, p in zip(idfs, row):
                tfn = (np.float64(p.term_freq) * (K1 + 1)) / (np.float64(p.term_freq) + cache_val)
                s = s + np.float64(idf) * tfn
            scored.append((float(s), row[0].doc_id, row))

        scored.sort(key=lambda x: (-x[0], x[1]))
        top = scored[: query.n_results]

        for s, doc_id, row in top:
            snippet = ""
            if query.return_snippets:
                from wiser_tpu.highlighter import SimpleHighlighter
                offset_table = [p.offsets for p in row]
                if query.is_phrase:
                    table = self.phrase_match_table(row)
                    offset_table = _filter_offsets_by_positions(row, table)
                snippet = SimpleHighlighter().highlight(
                    offset_table, query.n_snippet_passages, self.doc_bodies[doc_id]
                )
            result.entries.append(SearchResultEntry(doc_id, s, snippet))
        return result


def _filter_offsets_by_positions(row: List[Posting], table: List[List[int]]) -> List[List[Tuple[int, int]]]:
    """Keep only the offset pairs at phrase-match positions
    (reference: ResultDocEntry::FilterOffsetByPosition,
    query_processing.h:469-492). Positions index into each posting's
    position list; offsets are parallel to positions."""
    out: List[List[Tuple[int, int]]] = []
    for i, p in enumerate(row):
        pos_to_idx = {pos: j for j, pos in enumerate(p.positions)}
        pairs = []
        for match in table:
            j = pos_to_idx.get(match[i])
            if j is not None and j < len(p.offsets):
                pairs.append(p.offsets[j])
        out.append(pairs)
    return out
