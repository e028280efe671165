"""Randomized oracle↔device equivalence sweep (property test).

Random corpora with varied shapes (vocab size, doc length, skew) and
random query mixes; every query's (doc_id, f64 score) list must be
bit-identical between the oracle and the device engine. This is the fuzzing
layer on top of the targeted equivalence tests.
"""

import numpy as np
import pytest

from wiser_tpu.data.synth import make_docinfo
from wiser_tpu.engine.device import TpuEngine
from wiser_tpu.index.builder import build_index
from wiser_tpu.types import SearchQuery

SEEDS = [101, 202, 303]


def random_corpus(rng):
    n_docs = int(rng.integers(30, 400))
    vocab = int(rng.integers(5, 150))
    docs = []
    for _ in range(n_docs):
        n_tok = int(rng.integers(1, 60))
        ranks = np.minimum(rng.zipf(float(rng.uniform(1.1, 2.0)), n_tok) - 1,
                           vocab - 1)
        docs.append(make_docinfo([f"v{r}" for r in ranks]))
    return docs, vocab


def random_queries(rng, vocab, n=60):
    out = []
    for _ in range(n):
        nt = int(rng.integers(1, 5))
        terms = [f"v{rng.integers(0, vocab)}" for _ in range(nt)]
        out.append(SearchQuery(
            terms,
            n_results=int(rng.integers(1, 15)),
            is_phrase=bool(rng.random() < 0.25 and nt >= 2),
        ))
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_fuzz_equivalence(seed):
    rng = np.random.default_rng(seed)
    docs, vocab = random_corpus(rng)
    packed, oracle = build_index(docs, with_blooms=True)
    engine = TpuEngine(packed, bloom_enable_factor=int(rng.integers(1, 11)))
    queries = random_queries(rng, vocab)
    batch = engine.search_batch(queries)
    for q, r in zip(queries, batch):
        o = oracle.search(q)
        assert [(e.doc_id, e.doc_score) for e in r.entries] == \
               [(e.doc_id, e.doc_score) for e in o.entries], \
               f"seed={seed} terms={q.terms} phrase={q.is_phrase} k={q.n_results}"
