"""Experiment harness — reference: tools/run_exp.py (1270 LoC of config
matrix: engine x memory cap x query type x readahead x bloom factor,
iostat/blktrace watchers, result-table parsing).

The device analog sweeps the dimensions that matter here — corpus scale,
batch size, workload mix, bloom factor, engine kind — runs each treatment
through the local engine (or a gRPC target), and writes one JSON row per
treatment (the parse_client_output + ResultTable analog). OS-level I/O
control (cgroups, page-cache drops) has no device equivalent; the analogous
knob, device-memory budget, is recorded per treatment via
jax.local_devices()[0].memory_stats() when available.

Run: python -m wiser_tpu.bench.run_exp --out results.jsonl [--quick]
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys
import time
from dataclasses import asdict, dataclass, field
from typing import List, Optional


@dataclass
class Treatment:
    name: str
    n_docs: int = 5000
    vocab: int = 5000
    mean_len: int = 80
    workload: str = "aol_mix"  # aol_mix | single | two_term | phrase
    n_queries: int = 8192
    batch: int = 8192
    n_results: int = 10
    bloom_factor: Optional[int] = 1
    engine: str = "tpu"  # tpu | oracle | staged
    # device-memory budget as a fraction of the full posting-column bytes
    # (engine="staged") — the cgroup-cap axis of the reference harness
    # (run_exp.py:628-696) mapped to HBM: the hot tier keeps this share of
    # posting bytes resident and the rest is staged per batch.
    hbm_budget_frac: Optional[float] = None
    columns: str = "raw"  # raw | tc (compressed device columns)
    # prebuilt PackedIndex directory: skip corpus synthesis and serve this
    # index instead (the reference grid runs against a prebuilt on-flash
    # index too; building 1M+ docs per treatment would swamp the sweep)
    index_dir: Optional[str] = None
    # hot-tier admission policy (engine="staged"): "df" = df-greedy prior;
    # "qfreq" = per-term access counts from the first half of the query
    # log (train split), evaluated on the second half
    residency: str = "df"


@dataclass
class ExpResult:
    treatment: dict
    qps: float
    wall_s: float
    warmup_s: float
    batch_p50_s: float
    device_mem_bytes: Optional[int] = None
    hot_fraction: Optional[float] = None  # staged: share of terms resident
    # staged: share of terms with phrase components (positions + blooms)
    # resident — component-granular admission fills cores first
    phrase_hot_fraction: Optional[float] = None
    # staged: share of terms servable from a dense row alone (head-term
    # tier built from the full index; non-phrase shapes need no CSR)
    dense_fraction: Optional[float] = None
    budget_bytes: Optional[int] = None
    # staged: bytes the hot tier actually charged against the budget and
    # the engine's measured resident footprint — published so the grid
    # is auditable (budget >= hot_bytes_used + dense tier by design)
    hot_bytes_used: Optional[int] = None
    resident_bytes: Optional[dict] = None


def default_matrix(quick: bool = False) -> List[Treatment]:
    if quick:
        return [
            Treatment("quick_mix", n_docs=500, vocab=500, mean_len=30,
                      n_queries=512, batch=512),
            Treatment("quick_phrase", n_docs=500, vocab=80, mean_len=30,
                      workload="phrase", n_queries=256, batch=256),
        ]
    out = []
    for workload, batch in itertools.product(
            ["single", "two_term", "aol_mix", "phrase"], [1024, 8192]):
        out.append(Treatment(
            name=f"{workload}_b{batch}", workload=workload, batch=batch))
    return out


def memory_matrix(quick: bool = False, n_docs: int = 50_000,
                  vocab: int = 20_000, batch: int = 8192,
                  index_dir: Optional[str] = None,
                  columns: str = "raw",
                  n_queries: Optional[int] = None,
                  fracs=None) -> List[Treatment]:
    """The memory-cap grid — the reference's core experiment axis
    (run_exp.py:628-696 sweeps cgroup memory limits over a fixed engine +
    workload and reads the QPS curve). Here the cap is the HBM budget of
    the StagedEngine hot tier: at frac=1.0 everything is resident (pure
    in-memory engine); lower fractions force per-batch host->device
    staging of the cold posting runs ("read as needed")."""
    if quick:
        n_docs, vocab = 3000, 2000
    out = []
    for frac in fracs or (0.05, 0.1, 0.25, 0.5, 1.0):
        out.append(Treatment(
            name=f"membudget_{frac}", n_docs=n_docs, vocab=vocab,
            workload="aol_mix", engine="staged", hbm_budget_frac=frac,
            n_queries=2048 if quick else (n_queries or 8192),
            batch=2048 if quick else batch, index_dir=index_dir,
            columns=columns))
    return out


def residency_matrix(index_dir: Optional[str], batch: int = 8192,
                     fracs=(0.05, 0.1, 0.25), n_queries: int = 16384,
                     columns: str = "raw") -> List[Treatment]:
    """df-greedy vs workload-aware (qfreq) hot-tier admission at equal
    budget, on a workload whose access pattern DIVERGES from df order
    (worklocal_mix: half the queries hit a small working set of mid-df
    terms). On pure Zipf-by-df-rank logs the two policies admit the same
    set — divergence is what the reference's locality logs model
    (gen_synthetic_log.py)."""
    out = []
    for frac in fracs:
        for residency in ("df", "qfreq"):
            out.append(Treatment(
                name=f"residency_{residency}_{frac}",
                workload="worklocal_mix", engine="staged",
                hbm_budget_frac=frac, residency=residency,
                n_queries=n_queries, batch=batch, index_dir=index_dir,
                columns=columns))
    return out


def build_workload(packed, oracle, t: Treatment):
    from wiser_tpu.data.synth_log import (
        aol_shape_mixed_log, gen_phrase_log, gen_single_term_log,
        gen_two_term_log, mine_phrases_from_index)

    terms, dfs = packed.terms, packed.df
    if t.workload == "single":
        qs = gen_single_term_log(terms, t.n_queries)
        for q in qs:
            q.n_results = t.n_results
        return qs
    if t.workload == "two_term":
        qs = gen_two_term_log(terms, terms, t.n_queries)
        for q in qs:
            q.n_results = t.n_results
        return qs
    if t.workload == "phrase":
        pairs = mine_phrases_from_index(oracle, max_phrases=500)
        qs = gen_phrase_log(pairs, t.n_queries)
        for q in qs:
            q.n_results = t.n_results
        return qs
    if t.workload == "worklocal_mix":
        # half the traffic hits a small working set of mid-df terms (usage
        # hot, byte cheap), half is the Zipf-by-df-rank mix — the access
        # pattern the locality logs model, where df order is a BAD
        # residency predictor
        import numpy as np

        from wiser_tpu.types import SearchQuery

        rng = np.random.default_rng(23)
        order = np.argsort(np.asarray(dfs))[::-1]
        n = len(order)
        band = order[min(n - 1, n // 50) : max(1, n // 2)]  # mid-df band
        ws = rng.choice(band, size=min(2000, len(band)), replace=False)
        base = aol_shape_mixed_log(terms, dfs, t.n_queries,
                                   n_results=t.n_results)
        out = []
        for q in base:
            if rng.random() < 0.5:
                nt = len(q.terms)
                out.append(SearchQuery(
                    [terms[r] for r in rng.choice(ws, size=nt)],
                    n_results=t.n_results))
            else:
                out.append(q)
        return out
    return aol_shape_mixed_log(terms, dfs, t.n_queries, n_results=t.n_results)


def run_treatment(t: Treatment) -> ExpResult:
    if t.index_dir:
        from dataclasses import replace as _replace

        from wiser_tpu.index.format import PackedIndex

        packed = PackedIndex.load(t.index_dir)
        # record the SERVED corpus shape, not the synthetic defaults
        # (round-3 grid rows said n_docs=50000 against idx_c1m)
        t = _replace(t, n_docs=packed.n_docs, vocab=packed.n_terms)
        oracle = None  # phrase mining needs the oracle; other workloads
        # only touch terms/dfs
    else:
        from wiser_tpu.data.synth import synth_docinfos
        from wiser_tpu.index.builder import build_index

        docs = synth_docinfos(t.n_docs, t.vocab, t.mean_len, seed=42,
                              with_blooms=(t.workload == "phrase"))
        packed, oracle = build_index(
            docs, with_blooms=(t.workload == "phrase"))
    queries = build_workload(packed, oracle, t)

    term_weights = None
    if t.engine == "staged" and t.residency == "qfreq":
        # Workload-aware admission weight = per-BATCH presence rate from
        # the TRAIN half (the timed run sees only the EVAL half). Staging
        # is deduplicated per batch, so a cold term costs its run bytes
        # once per batch it APPEARS IN, not once per query — benefit/byte
        # of residency is the batch-presence probability (raw query
        # counts over-admit rarely-batched tail terms and measured
        # SLOWER than df-greedy on this very workload).
        import numpy as np

        lookup = packed.term_to_row.get
        term_weights = np.zeros(packed.n_terms, dtype=np.int64)
        train = queries[: len(queries) // 2]
        win = min(t.batch, 1024)  # finer windows: same ranking, better
        # resolution when the train split spans few engine batches
        for b0 in range(0, len(train), win):
            rows = {lookup(term, -1)
                    for q in train[b0 : b0 + win] for term in q.terms}
            rows.discard(-1)
            for r in rows:
                term_weights[r] += 1
    if t.engine == "staged" and t.residency in ("df", "qfreq") \
            and t.workload == "worklocal_mix":
        queries = queries[len(queries) // 2 :]

    if t.engine == "oracle":
        t0 = time.time()
        for q in queries:
            oracle.search(q)
        wall = time.time() - t0
        return ExpResult(asdict(t), len(queries) / wall, wall, 0.0, wall)

    hot_fraction = None
    phrase_hot = None
    dense_frac = None
    budget = None
    doc_bodies = oracle.doc_bodies if oracle is not None else None
    if t.engine == "staged":
        from wiser_tpu.engine.staged import StagedEngine, full_device_bytes

        # budget frac is relative to the FULL served device footprint
        # (postings + positions + blooms + dense tier at frac=1.0) —
        # the reference grid's cgroup cap is a fraction of total index
        # bytes, and a posting-bytes-only base left the dense tier
        # outside the budget (so a "50%" point ran the full dense tier)
        total_bytes = full_device_bytes(packed, t.columns)
        budget = int(total_bytes * (t.hbm_budget_frac or 1.0))
        engine = StagedEngine(packed, budget, doc_bodies=doc_bodies,
                              columns=t.columns, term_weights=term_weights)
        hot_fraction = round(engine.hot_fraction, 4)
        phrase_hot = round(engine.phrase_hot_fraction, 4)
        dense_frac = round(float(engine.dense_mask.mean()), 4)
    else:
        from wiser_tpu.engine.device import TpuEngine

        engine = TpuEngine(packed, doc_bodies=doc_bodies,
                           bloom_enable_factor=t.bloom_factor,
                           columns=t.columns)
    w0 = time.time()
    for i in range(0, len(queries), t.batch):
        engine.search_batch(queries[i : i + t.batch])
    warmup = time.time() - w0
    # shapes/compiles warm = steady-state serving; a primed RESULT cache
    # is not (the timed pass re-runs the same list) — drop the memoized
    # host merges so every timed query pays its real cost. Repeats
    # WITHIN the timed pass still hit, as they would in production.
    if hasattr(engine, "clear_result_memos"):
        engine.clear_result_memos()

    import numpy as np

    lat = []
    t0 = time.time()
    for i in range(0, len(queries), t.batch):
        bt = time.time()
        engine.search_batch(queries[i : i + t.batch])
        lat.append(time.time() - bt)
    wall = time.time() - t0

    mem = None
    try:
        import jax

        stats = jax.local_devices()[0].memory_stats()
        if stats:
            mem = int(stats.get("bytes_in_use", 0))
    except Exception:
        pass
    hot_used = getattr(engine, "hot_bytes_used", None)
    resident = None
    try:
        inner = getattr(engine, "hot", engine)
        resident = {k: int(v) for k, v in inner.device_bytes().items()}
    except Exception:
        pass
    return ExpResult(asdict(t), round(len(queries) / wall, 1), round(wall, 3),
                     round(warmup, 2), round(float(np.median(lat)), 3), mem,
                     hot_fraction=hot_fraction, phrase_hot_fraction=phrase_hot,
                     dense_fraction=dense_frac,
                     budget_bytes=budget,
                     hot_bytes_used=hot_used, resident_bytes=resident)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="exp_results.jsonl")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--memory", action="store_true",
                    help="run the HBM-budget grid (the cgroup-cap analog)")
    ap.add_argument("--batch", type=int, default=8192,
                    help="memory-grid batch width (smaller batches stage "
                         "less cold scratch per dispatch)")
    ap.add_argument("--index", default=None,
                    help="prebuilt PackedIndex dir (reference-scale grids)")
    ap.add_argument("--columns", default="raw", choices=["raw", "tc"])
    ap.add_argument("--n-queries", type=int, default=None)
    ap.add_argument("--fracs", default=None,
                    help="comma list of hot-tier budget fractions "
                         "(--memory); default 0.05,0.1,0.25,0.5,1.0")
    ap.add_argument("--residency-compare", action="store_true",
                    help="df-greedy vs workload-aware hot-tier admission "
                         "at equal budget (worklocal_mix workload)")
    args = ap.parse_args(argv)

    from wiser_tpu.utils import enable_compile_cache

    enable_compile_cache()
    fracs = (tuple(float(x) for x in args.fracs.split(","))
             if args.fracs else None)
    if args.residency_compare:
        matrix = residency_matrix(args.index, batch=args.batch,
                                  n_queries=args.n_queries or 16384,
                                  columns=args.columns,
                                  **({"fracs": fracs} if fracs else {}))
    elif args.memory:
        matrix = memory_matrix(args.quick, batch=args.batch,
                               index_dir=args.index, columns=args.columns,
                               n_queries=args.n_queries, fracs=fracs)
    else:
        matrix = default_matrix(args.quick)
    with open(args.out, "a") as f:
        for t in matrix:
            print(f"== {t.name}", file=sys.stderr)
            r = run_treatment(t)
            f.write(json.dumps(asdict(r)) + "\n")
            f.flush()
            extra = (f" (hot {r.hot_fraction})" if r.hot_fraction is not None
                     else "")
            print(f"   {r.qps} qps{extra}", file=sys.stderr)


if __name__ == "__main__":
    main()
