"""fast_builder must produce a PackedIndex identical (every column) to
the oracle-based builder — the same format, a 100x faster dumper, exactly
like convert_qq_to_vacuum vs the in-memory engine (SURVEY.md §2 builders).
"""

import numpy as np
import pytest

from wiser_tpu.data.synth import synth_docinfos
from wiser_tpu.index.builder import build_index
from wiser_tpu.index.fast_builder import build_packed_fast
from wiser_tpu.linedoc import write_linedoc
from wiser_tpu.types import SearchQuery


def _docinfos_to_linedoc(docs, path, with_bloom):
    rows = []
    for d in docs:
        row = ["t", d.body, d.tokens, d.token_offsets, d.token_positions]
        if with_bloom:
            row += [d.phrase_ends, d.phrase_begins]
        rows.append(row)
    write_linedoc(path, rows, with_bloom=with_bloom)


def assert_packed_equal(a, b, with_blooms=False):
    assert a.terms == b.terms
    assert a.n_docs == b.n_docs
    assert a.avg_len == b.avg_len  # bit-exact running mean
    np.testing.assert_array_equal(a.term_starts, b.term_starts)
    np.testing.assert_array_equal(a.df, b.df)
    np.testing.assert_array_equal(a.postings_doc, b.postings_doc)
    np.testing.assert_array_equal(a.postings_tf, b.postings_tf)
    np.testing.assert_array_equal(a.doc_len_code, b.doc_len_code)
    np.testing.assert_array_equal(a.pos_starts, b.pos_starts)
    np.testing.assert_array_equal(a.positions, b.positions)
    np.testing.assert_array_equal(a.off_starts, b.off_starts)
    np.testing.assert_array_equal(a.off_begin, b.off_begin)
    np.testing.assert_array_equal(a.off_end, b.off_end)
    if with_blooms:
        np.testing.assert_array_equal(a.bloom_ends, b.bloom_ends)
        np.testing.assert_array_equal(a.bloom_begins, b.bloom_begins)


class TestFastBuilderParity:
    def test_synth_corpus_equal(self, tmp_path):
        docs = synth_docinfos(n_docs=250, vocab_size=80, mean_len=30,
                              seed=13, with_blooms=False)
        slow, _ = build_index(docs)
        path = str(tmp_path / "corpus.linedoc")
        _docinfos_to_linedoc(docs, path, with_bloom=False)
        fast = build_packed_fast(path, "WITH_POSITIONS", chunk_docs=64)
        assert_packed_equal(slow, fast)

    def test_synth_corpus_with_blooms_equal(self, tmp_path):
        docs = synth_docinfos(n_docs=120, vocab_size=40, mean_len=20,
                              seed=29, with_blooms=True)
        slow, _ = build_index(docs, with_blooms=True)
        path = str(tmp_path / "corpus_bloom.linedoc")
        _docinfos_to_linedoc(docs, path, with_bloom=True)
        fast = build_packed_fast(path, "WITH_BI_BLOOM", chunk_docs=50,
                                 with_blooms=True)
        assert_packed_equal(slow, fast, with_blooms=True)

    def test_real_fixture_equal(self):
        """The reference's own wiki-abstract fixture."""
        from wiser_tpu.linedoc import parse_linedoc

        path = ("/root/reference/src/qq_mem/src/testdata/"
                "line_doc_with_positions")
        docs = list(parse_linedoc(path, "WITH_POSITIONS"))
        slow, _ = build_index(docs)
        fast = build_packed_fast(path, "WITH_POSITIONS", chunk_docs=2)
        assert_packed_equal(slow, fast)

    def test_search_parity_through_engine(self, tmp_path):
        """End-to-end: a fast-built index serves bit-identical results."""
        from wiser_tpu.engine.device import TpuEngine

        docs = synth_docinfos(n_docs=200, vocab_size=60, mean_len=25,
                              seed=31, with_blooms=False)
        slow, oracle = build_index(docs)
        path = str(tmp_path / "c.linedoc")
        _docinfos_to_linedoc(docs, path, with_bloom=False)
        fast = build_packed_fast(path, "WITH_POSITIONS")
        eng = TpuEngine(fast)
        for q in [SearchQuery(["t0"], n_results=10),
                  SearchQuery(["t1", "t2"], n_results=10),
                  SearchQuery(["t0", "t1"], n_results=10, is_phrase=True)]:
            o = oracle.search(q)
            r = eng.search(q)
            assert [(e.doc_id, e.doc_score) for e in o.entries] == \
                   [(e.doc_id, e.doc_score) for e in r.entries], q

    def test_spill_mode_equal(self, tmp_path):
        """Disk-spill accumulation (the >5M-doc path) must be column-for-
        column identical to the in-RAM path, blooms included."""
        docs = synth_docinfos(n_docs=150, vocab_size=50, mean_len=22,
                              seed=47, with_blooms=True)
        path = str(tmp_path / "corpus_spill.linedoc")
        _docinfos_to_linedoc(docs, path, with_bloom=True)
        ram = build_packed_fast(path, "WITH_BI_BLOOM", chunk_docs=40,
                                with_blooms=True)
        spill_dir = str(tmp_path / "spill")
        spilled = build_packed_fast(path, "WITH_BI_BLOOM", chunk_docs=40,
                                    with_blooms=True, spill_dir=spill_dir)
        assert_packed_equal(ram, spilled, with_blooms=True)
        import os
        assert not os.path.exists(spill_dir)  # cleaned up

    def test_non_canonical_raises(self, tmp_path):
        path = str(tmp_path / "bad.linedoc")
        # two tokens but only one positions group: misaligned columns
        write_linedoc(path, [["t", "a b", "a b", "0,0;.2,2;.", "0;."]])
        with pytest.raises(ValueError):
            build_packed_fast(path, "WITH_POSITIONS")


class TestColumnParsers:
    """The byte-level column parsers keep the str.split semantics of the
    linedoc format, including non-canonical spacing."""

    @pytest.mark.parametrize("cols", [
        ["a b!!c!", "dd!"],         # empty group, several keys
        [" a!b  c!", "x!"],          # leading / double spaces -> "" keys
        ["a!", "b c"],               # unterminated last group
        ["é ü!!"],                   # non-ASCII keys
    ])
    def test_hash_bloom_col_matches_split(self, cols):
        from wiser_tpu.index.fast_builder import _hash_bloom_col
        from wiser_tpu.native.lib import murmur2_batch_seeded

        groups = "".join(cols).split("!")
        if groups and groups[-1] == "":
            groups.pop()
        keys, entry_of = [], []
        for i, g in enumerate(groups):
            if g:
                keys += g.split(" ")
                entry_of += [i] * len(g.split(" "))
        blob = "\x00".join(keys).encode("utf-8")
        lens = np.array([len(k.encode("utf-8")) for k in keys], np.int64)
        starts = np.concatenate([[0], np.cumsum(lens[:-1] + 1)])
        starts = starts.astype(np.int64)
        want_a = murmur2_batch_seeded(blob, starts, starts + lens, None)
        want_b = murmur2_batch_seeded(blob, starts, starts + lens, want_a)
        a, b, e = _hash_bloom_col(cols, len(groups), "bloom")
        np.testing.assert_array_equal(a, want_a)
        np.testing.assert_array_equal(b, want_b)
        np.testing.assert_array_equal(e, entry_of)
        with pytest.raises(ValueError, match="non-canonical"):
            _hash_bloom_col(cols, len(groups) + 1, "bloom")

    def test_group_col_counts(self):
        from wiser_tpu.index.fast_builder import _parse_group_col

        counts, nums = _parse_group_col(["1;2;.", "3;.", "4;5;6;"], 3,
                                        ";.", "positions")
        np.testing.assert_array_equal(counts, [2, 1, 3])
        np.testing.assert_array_equal(nums, [1, 2, 3, 4, 5, 6])
        with pytest.raises(ValueError, match="non-canonical"):
            _parse_group_col(["1;.2;."], 3, ";.", "positions")

    def test_bloom_rows_native_matches_numpy(self, monkeypatch):
        from wiser_tpu.index import fast_builder as fb
        from wiser_tpu.index.bloom import BloomConfig
        from wiser_tpu.native import lib as native

        rng = np.random.default_rng(3)
        n, E, P = 5000, 1000, 700
        a = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
        b = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
        chunk = (a, b, rng.integers(0, E, n))
        order_inv = rng.permutation(E).astype(np.int32)
        pidx = rng.integers(0, P, E).astype(np.int32)
        cfg = BloomConfig()
        got = fb._bloom_rows([chunk], E, order_inv, pidx, P, cfg)
        monkeypatch.setattr(native, "bloom_set_rows", lambda *args: False)
        want = fb._bloom_rows([chunk], E, order_inv, pidx, P, cfg)
        assert want.any()
        np.testing.assert_array_equal(got, want)
