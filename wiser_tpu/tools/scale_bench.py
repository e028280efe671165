"""BASELINE config ladder at reference scale: QPS + p50/p99 latency per
query type over a prebuilt PackedIndex (the engine_bench `locallog` mode
at scale, engine_bench.cc:240-279 + BASELINE.md targets).

Configs (BASELINE.md): (1) single-term, (2) two-term AND, (3) AOL-shaped
1-4-term mix, (4) two-term phrase. Each config reports aggregate QPS,
batch p50/p99, amortized per-query latency, and a sampled bit-parity
check against the exact host search (host_exact_search is itself
oracle-validated by the test suite).

Run:
  python -m wiser_tpu.tools.scale_bench --index .scale_cache/idx_c1m \
      [--linedoc .scale_cache/c1m.linedoc] [--n-queries 65536] \
      [--out BENCH_SCALE.json]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


_DF_ORDER = {}


def zipf_rows(packed, rng, n, nt):
    """Zipf draw over DF RANK (frequent terms queried most — the AOL
    shape): rank 0 = highest-df term. The t{i} synth corpora happened to
    alias rank and name; pseudo-word corpora need the explicit mapping."""
    key = id(packed)
    if key not in _DF_ORDER:
        _DF_ORDER[key] = np.argsort(packed.df)[::-1].astype(np.int64)
    order = _DF_ORDER[key]
    ranks = np.minimum(rng.zipf(1.25, size=(n, nt)) - 1, packed.n_terms - 1)
    return order[ranks]


def build_configs(packed, linedoc: str, n_queries: int, k: int, seed=7):
    from wiser_tpu.types import SearchQuery

    rng = np.random.default_rng(seed)
    configs = {}
    rows1 = zipf_rows(packed, rng, n_queries, 1)
    configs["1_single_term"] = [
        SearchQuery([packed.terms[r]], n_results=k) for (r,) in rows1]
    rows2 = zipf_rows(packed, rng, n_queries, 2)
    configs["2_two_term_and"] = [
        SearchQuery([packed.terms[a], packed.terms[b]], n_results=k)
        for a, b in rows2]
    nt = rng.choice([1, 2, 3, 4], size=n_queries, p=[0.43, 0.29, 0.20, 0.08])
    mix = []
    for t in nt:
        rr = zipf_rows(packed, rng, 1, int(t))[0]
        mix.append(SearchQuery([packed.terms[r] for r in rr], n_results=k))
    configs["3_aol_mix"] = mix

    pairs = mine_phrases_from_linedoc(linedoc, packed, max_pairs=2000) \
        if linedoc else []
    if pairs:
        idx = rng.integers(0, len(pairs), size=n_queries)
        configs["4_phrase"] = [
            SearchQuery(list(pairs[i]), n_results=k, is_phrase=True)
            for i in idx]
    else:
        log("no linedoc given; skipping phrase config")
    return configs


def mine_phrases_from_linedoc(path: str, packed, max_pairs: int = 2000,
                              max_rows: int = 2000):
    """Adjacent-token pairs from document bodies (both terms indexed)."""
    pairs = []
    seen = set()
    with open(path, encoding="utf-8", errors="replace") as f:
        f.readline()
        for i, line in enumerate(f):
            if i >= max_rows or len(pairs) >= max_pairs:
                break
            body = line.split("\t")[1]
            toks = body.split(" ")
            for a, b in zip(toks, toks[1:]):
                if a != b and (a, b) not in seen \
                        and packed.lookup(a) >= 0 and packed.lookup(b) >= 0:
                    seen.add((a, b))
                    pairs.append((a, b))
                    if len(pairs) >= max_pairs:
                        break
    return pairs


def run_config(engine, queries, batch: int, pipeline: int = 2):
    # warmup: one full pass compiles every shape bucket (steady state)
    t0 = time.time()
    for i in range(0, len(queries), batch):
        engine.search_batch(queries[i : i + batch])
    warm = time.time() - t0
    # compile warmth is steady state; a primed result memo is not (the
    # timed pass re-runs the same list) — every timed query pays its
    # real cost, repeats within the pass still coalesce/hit naturally
    if hasattr(engine, "clear_result_memos"):
        engine.clear_result_memos()

    lat = []
    done = 0
    in_flight = []
    t0 = time.time()
    for i in range(0, len(queries), batch):
        bt = time.time()
        in_flight.append((bt, engine.submit_batch(queries[i : i + batch])))
        while len(in_flight) > pipeline:
            bt0, (res, pending) = in_flight.pop(0)
            for f in pending:
                f(res)
            lat.append(time.time() - bt0)
            done += len(res)
    for bt0, (res, pending) in in_flight:
        for f in pending:
            f(res)
        lat.append(time.time() - bt0)
        done += len(res)
    wall = time.time() - t0
    lat = np.array(lat)
    return {
        "qps": round(done / wall, 1),
        "wall_s": round(wall, 2),
        "warmup_s": round(warm, 2),
        "n_queries": done,
        "batch": batch,
        "batch_p50_s": round(float(np.median(lat)), 3),
        "batch_p99_s": round(float(np.percentile(lat, 99)), 3),
        "per_query_us": round(1e6 * wall / max(done, 1), 1),
    }


def parity_sample(engine, packed, queries, n_sample: int, seed=11) -> int:
    """Exact host re-search on a sample; returns mismatch count."""
    from wiser_tpu.engine.device import host_exact_search

    rng = np.random.default_rng(seed)
    idx = rng.choice(len(queries), size=min(n_sample, len(queries)),
                     replace=False)
    bad = 0
    for i in idx:
        q = queries[int(i)]
        rows = [packed.lookup(t) for t in q.terms]
        if min(rows) < 0:
            continue
        got = engine.search(q)
        d, s = host_exact_search(packed, engine.cache64, rows, q.n_results,
                                 is_phrase=q.is_phrase and len(rows) >= 2)
        want = list(zip(d.tolist(), s.tolist()))
        have = [(e.doc_id, e.doc_score) for e in got.entries]
        if want != have:
            bad += 1
            log(f"PARITY MISMATCH {q.terms} phrase={q.is_phrase}\n"
                f"  want={want[:3]}...\n  have={have[:3]}...")
    return bad


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--index", required=True)
    ap.add_argument("--linedoc", default=None)
    ap.add_argument("--n-queries", type=int, default=65536)
    ap.add_argument("--batch", type=int, default=16384)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--parity-sample", type=int, default=50)
    ap.add_argument("--configs", default=None,
                    help="comma-separated subset, e.g. 1_single_term,3_aol_mix")
    ap.add_argument("--columns", default="raw", choices=["raw", "tc"],
                    help="device column layout (tc = compressed uint16)")
    ap.add_argument("--engine", default="device",
                    choices=["device", "staged"],
                    help="staged: bigger-than-HBM serving — hot tier + "
                         "dense rows within --budget-bytes, cold terms "
                         "host-staged (the reference's read-as-needed "
                         "flash mode, vacuum_engine.h:144-166)")
    ap.add_argument("--budget-bytes", type=int, default=12 << 30,
                    help="staged device-memory budget (default 12 GiB)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from wiser_tpu.utils import enable_compile_cache

    enable_compile_cache()
    import jax

    log(f"devices: {jax.devices()}")
    from wiser_tpu.engine.device import TpuEngine
    from wiser_tpu.index.format import PackedIndex

    t0 = time.time()
    # offsets feed only the highlighter (never benched here): skipping
    # them saves ~15 GB host RAM at 10M docs
    packed = PackedIndex.load(args.index, skip_offsets=True)
    log(f"index loaded in {time.time()-t0:.1f}s: {packed.n_docs} docs, "
        f"{packed.n_terms} terms, {packed.n_postings} padded postings")
    t0 = time.time()
    if args.engine == "staged":
        from wiser_tpu.engine.staged import StagedEngine

        engine = StagedEngine(packed, args.budget_bytes,
                              columns=args.columns)
        log(f"staged engine up in {time.time()-t0:.1f}s; budget "
            f"{args.budget_bytes}; hot {engine.hot_fraction:.4f} "
            f"phrase_hot {engine.phrase_hot_fraction:.4f} "
            f"dense {float(engine.dense_mask.mean()):.4f}; device bytes: "
            f"{json.dumps(engine.hot.device_bytes())}")
    else:
        engine = TpuEngine(packed, columns=args.columns)
        log(f"engine up in {time.time()-t0:.1f}s; device bytes: "
            f"{json.dumps(engine.device_bytes())}")

    configs = build_configs(packed, args.linedoc, args.n_queries, args.k)
    if args.configs:
        keep = set(args.configs.split(","))
        configs = {k: v for k, v in configs.items() if k in keep}

    results = {}
    summary = {
        "index": args.index,
        "n_docs": packed.n_docs,
        "n_terms": packed.n_terms,
        "postings_padded": packed.n_postings,
        "columns": args.columns,
        "device_bytes": engine.device_bytes(),
        "configs": results,
    }
    for name, queries in configs.items():
        log(f"== {name}: {len(queries)} queries ==")
        r = run_config(engine, queries, args.batch)
        r["unique_queries"] = len({(tuple(q.terms), q.n_results, q.is_phrase)
                                   for q in queries})
        bad = parity_sample(engine, packed, queries, args.parity_sample)
        r["parity_mismatches"] = bad
        r["parity_sample"] = args.parity_sample
        results[name] = r
        log(json.dumps({name: r}))
        if args.out:  # incremental: completed configs survive a crash
            with open(args.out, "w") as f:
                json.dump(summary, f, indent=1)

    print(json.dumps(summary))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)


if __name__ == "__main__":
    main()
