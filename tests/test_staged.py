"""StagedEngine (host<->HBM posting staging) — the "read as needed"
analog. Tiny budgets force real staging on every path."""

import numpy as np
import pytest

from wiser_tpu.data.synth import synth_docinfos, synth_query_terms
from wiser_tpu.engine.staged import StagedEngine
from wiser_tpu.index.builder import build_index
from wiser_tpu.types import SearchQuery


@pytest.fixture(scope="module")
def corpus():
    docs = synth_docinfos(n_docs=400, vocab_size=100, mean_len=30, seed=21)
    packed, oracle = build_index(docs)
    return packed, oracle


@pytest.fixture(scope="module", params=["host", "device"], autouse=True)
def cold_mode(request):
    """Run the whole staged suite under BOTH cold compute backends: the
    default memoized host path and the stage-to-scratch device kernels
    (kept for backends without RAM-resident postings)."""
    old = StagedEngine.COLD_COMPUTE
    StagedEngine.COLD_COMPUTE = request.param
    yield request.param
    StagedEngine.COLD_COMPUTE = old


def assert_same(oracle_res, res, msg=""):
    o = [(e.doc_id, e.doc_score) for e in oracle_res.entries]
    t = [(e.doc_id, e.doc_score) for e in res.entries]
    assert o == t, f"{msg}\noracle={o}\nstaged={t}"


class TestHotColdSplit:
    def test_budget_controls_hot_fraction(self, corpus):
        from wiser_tpu.engine.staged import full_device_bytes

        packed, _ = corpus
        total_bytes = full_device_bytes(packed)
        small = StagedEngine(packed, hbm_budget_bytes=total_bytes // 10)
        big = StagedEngine(packed, hbm_budget_bytes=total_bytes)
        assert small.hot_fraction < 1.0
        assert big.hot_fraction == 1.0
        # the budget is charged for everything resident: terms + the
        # dense tier must fit inside it
        used = big.hot_bytes_used
        assert used <= total_bytes
        small_used = small.hot_bytes_used
        assert small_used <= total_bytes // 10

    def test_zero_budget_all_cold(self, corpus):
        packed, oracle = corpus
        eng = StagedEngine(packed, hbm_budget_bytes=0)
        assert eng.hot_fraction == 0.0
        q = SearchQuery(["t0"], n_results=10)
        assert_same(oracle.search(q), eng.search(q))


class TestStagedParity:
    @pytest.fixture(scope="class")
    def engine(self, corpus):
        packed, _ = corpus
        # ~30% hot: mixed hot/cold batches
        return StagedEngine(packed, hbm_budget_bytes=packed.n_postings * 12 // 3)

    def test_single_term_hot_and_cold(self, corpus, engine):
        _, oracle = corpus
        for t in ["t0", "t1", "t40", "t77", "t99"]:
            if engine.packed.lookup(t) < 0:
                continue
            q = SearchQuery([t], n_results=10)
            assert_same(oracle.search(q), engine.search(q), f"term={t}")

    def test_mixed_batch(self, corpus, engine):
        _, oracle = corpus
        queries = [SearchQuery(terms, n_results=10)
                   for terms in synth_query_terms(40, 100, n_terms=2, seed=3)]
        queries += [SearchQuery([f"t{i}"], n_results=10) for i in (0, 50, 90)]
        batch = engine.search_batch(queries)
        for q, r in zip(queries, batch):
            assert_same(oracle.search(q), r, f"{q.terms}")

    def test_cold_and_query_with_hot_term(self, corpus, engine):
        # one hot + one cold term -> whole query staged
        _, oracle = corpus
        hot_rows = np.nonzero(engine.hot_mask)[0]
        cold_rows = np.nonzero(~engine.hot_mask)[0]
        if len(hot_rows) == 0 or len(cold_rows) == 0:
            pytest.skip("split degenerate")
        terms = [engine.packed.terms[hot_rows[0]],
                 engine.packed.terms[cold_rows[0]]]
        q = SearchQuery(terms, n_results=10)
        assert_same(oracle.search(q), engine.search(q))

    def test_snippets_on_cold(self, corpus):
        packed, oracle = corpus
        eng = StagedEngine(packed, hbm_budget_bytes=0,
                           doc_bodies=oracle.doc_bodies)
        q = SearchQuery(["t0"], n_results=3, return_snippets=True)
        o = oracle.search(q)
        s = eng.search(q)
        assert [e.snippet for e in o.entries] == [e.snippet for e in s.entries]

    def test_phrase_on_cold_matches_oracle(self, corpus):
        """Cold-tier phrases run against staged position bags (r2: the
        NotImplementedError edge is gone)."""
        packed, oracle = corpus
        eng = StagedEngine(packed, hbm_budget_bytes=0)
        assert eng.hot_fraction == 0.0
        hits = 0
        for a, b in [("t0", "t1"), ("t1", "t0"), ("t2", "t0"), ("t0", "t3")]:
            q = SearchQuery([a, b], n_results=10, is_phrase=True)
            o = oracle.search(q)
            hits += o.size()
            assert_same(o, eng.search(q), f"cold phrase {a} {b}")
        assert hits > 0, "need at least one matching phrase in corpus"

    def test_phrase_mixed_hot_cold_batch(self, corpus):
        packed, oracle = corpus
        eng = StagedEngine(packed,
                           hbm_budget_bytes=packed.n_postings * 12 // 3)
        queries = [SearchQuery([f"t{i}", f"t{j}"], n_results=10,
                               is_phrase=True)
                   for i in range(6) for j in range(6) if i != j]
        queries += [SearchQuery([f"t{i}"], n_results=10) for i in range(4)]
        batch = eng.search_batch(queries)
        for q, r in zip(queries, batch):
            assert_same(oracle.search(q), r, f"{q.terms} phrase={q.is_phrase}")


class TestHotTierBags:
    """The hot view compacts posting columns, so every per-posting bag
    (positions, offsets, blooms) must be remapped — a cold low-df term
    earlier in the dictionary shifts every hot posting index after it.
    Regression for the silent wrong-bag bug (ADVICE r1, high)."""

    @pytest.fixture(scope="class")
    def engine(self):
        docs = synth_docinfos(n_docs=300, vocab_size=90, mean_len=35,
                              seed=33, with_blooms=True)
        packed, oracle = build_index(docs, with_blooms=True)
        eng = StagedEngine(packed, hbm_budget_bytes=packed.n_postings * 12 // 2,
                           doc_bodies=oracle.doc_bodies)
        return packed, oracle, eng

    def _hot_pair(self, packed, oracle, eng):
        """An all-hot term pair with a non-empty oracle phrase result."""
        hot = np.nonzero(eng.hot_mask)[0]
        # prefer rows whose posting indices actually shifted under
        # compaction — those are the ones a bag-remap bug corrupts
        shifted = [int(r) for r in hot
                   if int(packed.term_starts[r]) != int(eng.hot.packed.term_starts[r])]
        ordered = shifted + [int(r) for r in hot if int(r) not in set(shifted)]
        hot_terms = [packed.terms[r] for r in ordered]
        for a in hot_terms[:20]:
            for b in hot_terms[:20]:
                if a == b:
                    continue
                q = SearchQuery([a, b], n_results=1, is_phrase=True)
                if oracle.search(q).size() > 0:
                    return [a, b]
        pytest.skip("no all-hot adjacent pair in corpus")

    def test_phrase_on_hot_matches_oracle(self, engine):
        packed, oracle, eng = engine
        assert 0.0 < eng.hot_fraction < 1.0, "need a real hot/cold split"
        terms = self._hot_pair(packed, oracle, eng)
        q = SearchQuery(terms, n_results=10, is_phrase=True)
        o = oracle.search(q)
        assert o.size() > 0
        assert_same(o, eng.search(q), f"hot phrase {terms}")

    def test_snippets_on_hot_match_oracle(self, engine):
        packed, oracle, eng = engine
        hot = np.nonzero(eng.hot_mask)[0]
        # pick a hot term that is NOT the first dictionary row so the
        # compaction actually shifted its posting indices
        shifted = [r for r in hot
                   if int(packed.term_starts[r]) != int(eng.hot.packed.term_starts[r])]
        if not shifted:
            pytest.skip("no shifted hot rows")
        term = packed.terms[shifted[0]]
        q = SearchQuery([term], n_results=3, return_snippets=True)
        o = oracle.search(q)
        s = eng.search(q)
        assert [e.snippet for e in o.entries] == [e.snippet for e in s.entries]


class TestColdChunking:
    """_submit_cold must split cold sets whose staged postings exceed
    the scratch capacity (observed live: 1M docs / 5% budget / batch
    8192 overflowed SCRATCH_BUCKETS[-1] and _bucket's clip-to-largest
    truncated the scratch into a broadcast error)."""

    def test_oversized_cold_batch_chunks_and_matches(self, corpus,
                                                     monkeypatch):
        packed, oracle = corpus
        from wiser_tpu.engine import staged as S

        # shrink the chunk limit so this 400-doc corpus forces multiple
        # chunks; keep SCRATCH_BUCKETS intact (caps stay valid)
        monkeypatch.setattr(S, "CHUNK_LIMIT", L_BUCKETS_TOP + 4096)
        eng = StagedEngine(packed, hbm_budget_bytes=0)
        assert eng.hot_fraction == 0.0
        rng = np.random.default_rng(5)
        terms = [t for t in packed.terms if packed.lookup(t) >= 0]
        queries = []
        for _ in range(64):
            k = int(rng.integers(1, 4))
            queries.append(SearchQuery(
                list(rng.choice(terms, size=k, replace=False)),
                n_results=10))
        got = eng.search_batch(queries)
        for q, r in zip(queries, got):
            assert_same(oracle.search(q), r, f"terms={q.terms}")

    def test_single_query_over_capacity_raises(self, corpus, monkeypatch,
                                               cold_mode):
        if cold_mode != "device":
            pytest.skip("scratch chunker is a device-cold-path guard")
        packed, _ = corpus
        from wiser_tpu.engine import staged as S

        monkeypatch.setattr(S, "CHUNK_LIMIT", L_BUCKETS_TOP)
        eng = StagedEngine(packed, hbm_budget_bytes=0)
        # force limit below any single run: chunker must raise, not clip.
        # (two terms: a single-term query is answered by the staged
        # full-index impact table and never reaches the cold chunker)
        monkeypatch.setattr(S, "CHUNK_LIMIT", -1)
        with pytest.raises(ValueError, match="scratch capacity"):
            eng.search(SearchQuery([packed.terms[0], packed.terms[1]],
                                   n_results=5))

    @pytest.mark.parametrize("budget", [0, 1 << 22])
    def test_lane_budget_routes_to_host_exactly(self, corpus, monkeypatch,
                                                budget):
        """Cold groups over the per-dispatch lane budget (0: every group;
        2^22: the phrase ones) run on the exact host path, flat and
        phrase alike; the rest stay on the cold device kernels."""
        from wiser_tpu.engine import kernels as K
        from wiser_tpu.engine import staged as S

        packed, oracle = corpus
        monkeypatch.setattr(S, "COLD_LANE_BUDGET", budget)
        eng = StagedEngine(packed, hbm_budget_bytes=0)
        eng.COLD_COMPUTE = "device"
        terms = [t for t in packed.terms if packed.lookup(t) >= 0]
        rng = np.random.default_rng(9)
        queries = [SearchQuery(list(rng.choice(terms, size=k, replace=False)),
                               n_results=10, is_phrase=phrase)
                   for k in (2, 3) for phrase in (False, True)
                   for _ in range(8)]
        K.make_search_kernel.cache_clear()
        K.make_phrase_kernel.cache_clear()
        got = eng.search_batch(queries)
        for q, r in zip(queries, got):
            assert_same(oracle.search(q), r, f"terms={q.terms}")
        ran = (K.make_search_kernel.cache_info().currsize
               + K.make_phrase_kernel.cache_info().currsize)
        assert (ran == 0) == (budget == 0)


from wiser_tpu.engine.device import L_BUCKETS as _LB  # noqa: E402

L_BUCKETS_TOP = _LB[-1]


class TestDenseOnlyTier:
    """Dense-only head terms: under a constrained budget the planner
    admits head-term DENSE ROWS (built from the full index,
    TpuEngine dense_from) while their CSR stays cold. Every non-phrase
    query over such terms must still serve from the hot tier, bit-exact:
    the hot planner fences csr-cold rows off the list routes (semidense
    candidate / windowed / bs) and the exact-host fallback searches the
    FULL index (host_packed), never the hot view's empty runs."""

    @pytest.fixture(scope="class", params=["raw", "tc"])
    def staged(self, request, corpus):
        from wiser_tpu.engine.device import TpuEngine
        from wiser_tpu.engine.staged import full_device_bytes

        packed, oracle = corpus
        old = TpuEngine.DENSE_MIN_DF_FLOOR
        TpuEngine.DENSE_MIN_DF_FLOOR = 32  # 400-doc corpus: heads qualify
        try:
            total = full_device_bytes(packed, request.param)
            eng = StagedEngine(packed, hbm_budget_bytes=total // 3,
                               doc_bodies=[d.body for d in oracle.docs]
                               if hasattr(oracle, "docs") else None,
                               columns=request.param)
        finally:
            TpuEngine.DENSE_MIN_DF_FLOOR = old
        eng._test_budget = total // 3
        return packed, oracle, eng

    def test_dense_only_terms_exist(self, staged):
        packed, _, eng = staged
        dense_only = eng.dense_mask & ~eng.hot_mask
        assert dense_only.any(), (
            "fixture must produce dense-only terms "
            f"(hot {eng.hot_mask.mean():.2f}, dense {eng.dense_mask.mean():.2f})")

    def test_all_query_shapes_parity(self, staged):
        packed, oracle, eng = staged
        rng = np.random.default_rng(11)
        dense_only = np.nonzero(eng.dense_mask & ~eng.hot_mask)[0]
        csr_hot = np.nonzero(eng.hot_mask)[0]
        queries = []
        # targeted: dense-only pairs, dense-only x csr-hot mixes,
        # triples, singles on dense-only terms, and phrase over
        # dense-only terms (must go cold, still exact)
        for _ in range(40):
            pools = [dense_only, csr_hot]
            k = int(rng.integers(1, 4))
            rows = [int(rng.choice(pools[int(rng.integers(0, 2))]))
                    for _ in range(k)]
            rows = list(dict.fromkeys(rows))
            terms = [packed.terms[r] for r in rows]
            queries.append(SearchQuery(terms, n_results=10))
        for _ in range(10):
            if len(dense_only) >= 2:
                rows = rng.choice(dense_only, size=2, replace=False)
                queries.append(SearchQuery(
                    [packed.terms[int(r)] for r in rows], n_results=10,
                    is_phrase=True))
        got = eng.search_batch(queries)
        for q, r in zip(queries, got):
            assert_same(oracle.search(q), r,
                        f"terms={q.terms} phrase={q.is_phrase}")

    def test_budget_respected(self, staged):
        packed, _, eng = staged
        budget = eng._test_budget
        resident = eng.hot.device_bytes()["total"]
        # structural slack: the posting columns carry a fixed
        # (max-L-bucket + 4096)-posting dynamic-slice pad tail
        # (device.py) that is budget-independent — ~72 KB here, which
        # dwarfs a toy-corpus budget but is ~0.002% of a 1M-doc one
        from wiser_tpu.engine.device import L_BUCKETS

        pad = (L_BUCKETS[0] + 4096) * (12 if eng.columns == "raw" else 10)
        assert resident <= budget + budget // 10 + pad, (
            f"resident {resident} exceeds budget {budget} (+pad {pad})")
