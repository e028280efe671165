"""Windowed block-intersection kernel: parity + overflow fallback.

The fast multi-term path (kernels.windowed_search_body) only engages for
long, similarly-sized lists; these corpora are shaped to force it, and to
force the skew-overflow fallback to the binary-search kernel.
"""

import numpy as np
import pytest

from wiser_tpu.data.synth import make_docinfo
from wiser_tpu.engine.device import TpuEngine
from wiser_tpu.index.builder import build_index
from wiser_tpu.types import SearchQuery


@pytest.fixture(scope="module")
def dense_corpus():
    # small vocab -> every list is long -> windowed path for AND queries
    rng = np.random.default_rng(5)
    vocab = [f"w{i}" for i in range(10)]
    docs = []
    for _ in range(3000):
        n = rng.integers(3, 12)
        docs.append(make_docinfo(list(rng.choice(vocab, size=n)), with_blooms=False))
    return build_index(docs)


def assert_same(oracle_res, tpu_res, msg=""):
    o = [(e.doc_id, e.doc_score) for e in oracle_res.entries]
    t = [(e.doc_id, e.doc_score) for e in tpu_res.entries]
    assert o == t, f"{msg}\noracle={o}\ntpu={t}"


class TestWindowedParity:
    def test_windowed_path_engages(self, dense_corpus):
        packed, _ = dense_corpus
        engine = TpuEngine(packed)
        # both lists long and similar -> windowed key has L2 != 0
        from wiser_tpu.engine.device import _PlannedQuery

        pq = _PlannedQuery(0, [packed.lookup("w0"), packed.lookup("w1")],
                           SearchQuery(["w0", "w1"]))
        pq.plan_slots(packed.df)
        T, L, L2, _iters = engine._flat_key(pq)
        assert L2 != 0, "expected the windowed strategy for long similar lists"

    def test_and_parity_on_long_lists(self, dense_corpus):
        packed, oracle = dense_corpus
        engine = TpuEngine(packed)
        for terms in (["w0", "w1"], ["w2", "w3", "w4"], ["w0", "w5", "w1", "w9"]):
            q = SearchQuery(terms, n_results=10)
            assert_same(oracle.search(q), engine.search(q), f"AND {terms}")

    def test_single_term_still_exact(self, dense_corpus):
        packed, oracle = dense_corpus
        engine = TpuEngine(packed)
        q = SearchQuery(["w3"], n_results=10)
        assert_same(oracle.search(q), engine.search(q))


class TestOverflowFallback:
    def test_skewed_distribution_falls_back_exactly(self):
        # term 'b' dense in docs 0..1999; term 'a' spread every 16 docs:
        # b's 16 blocks all overlap a's first candidate block -> window
        # overflow -> binary-search fallback must produce exact results.
        docs = []
        for i in range(40000):
            toks = [f"f{i}"]
            if i % 16 == 0:
                toks.append("a")
            if i < 2000:
                toks.append("b")
            docs.append(make_docinfo(toks, with_blooms=False))
        packed, oracle = build_index(docs)
        engine = TpuEngine(packed)
        q = SearchQuery(["a", "b"], n_results=10)
        assert_same(oracle.search(q), engine.search(q), "skewed AND")
        q2 = SearchQuery(["b", "a"], n_results=10)
        assert_same(oracle.search(q2), engine.search(q2), "skewed AND rev")


class TestWindowedExactPayloads:
    """The windowed route's payload pick is exact for payloads that a
    reduced-precision (TF32, 10-bit mantissa) contraction would round: f32
    scores with low mantissa bits set, and tc codes above 2^11."""

    @pytest.mark.parametrize("columns", ["raw", "tc"])
    def test_bit_exact_vs_host(self, dense_corpus, columns):
        import jax.numpy as jnp

        from wiser_tpu.engine import kernels as K
        from wiser_tpu.engine.device import _PlannedQuery, host_exact_search

        packed, _ = dense_corpus
        engine = TpuEngine(packed, columns=columns, single_term_depth=0,
                           dense_budget_bytes=0)
        if columns == "tc":
            assert (np.asarray(engine.d_postings_tc) >= 2**11).any()
        else:
            sc = np.asarray(engine.d_postings_score)
            assert ((sc[sc > 0].view(np.uint32) & 0x1FFF) != 0).any()
        queries = [SearchQuery(t, n_results=10) for t in (
            ["w0", "w1"], ["w2", "w3", "w4"], ["w5", "w6"], ["w7", "w8"])]
        keys = []
        for q in queries:
            pq = _PlannedQuery(0, [packed.lookup(t) for t in q.terms], q)
            pq.plan_slots(packed.df)
            keys.append(engine._flat_key(pq))
        assert all(k[2] for k in keys), keys  # every query windowed
        engine.stats_take()
        results = engine.search_batch(queries)
        assert engine.stats_take().get("host_fallback_q", 0) < len(queries)
        for q, r in zip(queries, results):
            d, s = host_exact_search(packed, engine.cache64,
                                     [packed.lookup(t) for t in q.terms], 10)
            assert [(e.doc_id, e.doc_score) for e in r.entries] == \
                list(zip(d.tolist(), s.tolist())), q.terms
        # no contraction in the lowered kernel may run below f32 precision
        T, L, L2, _ = keys[0]
        kern = K.make_windowed_search_kernel(T, L, L2 // 128, 64, mode=columns)
        z = jnp.zeros((8, T), jnp.int32)
        f = jnp.zeros((8, T), jnp.float32)
        cols = ((engine.d_postings_tc, engine.d_avg32) if columns == "tc"
                else (engine.d_postings_score, engine.d_postings_tf))
        text = kern.lower(engine.d_postings_doc, *cols, z, z, f).as_text()
        for line in text.splitlines():
            if "dot_general" in line:
                assert "HIGHEST" in line, line
