"""Per-route microbench over a real PackedIndex: crafts query sets that
pin each execution tier (ARCHITECTURE.md "Execution tiers") and times
them separately, so scale-ladder regressions attribute to a route instead
of an aggregate. The profiling companion of tools/scale_bench.py.

Run: python -m wiser_tpu.tools.route_bench --index .scale_cache/idx_c1m
           [--columns tc] [--n-queries 8192] [--batch 4096]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def build_phrase_route_sets(packed, engine, linedoc: str, n: int, k: int,
                            seed=3):
    """Phrase routes from text-mined adjacent pairs, split by the tier
    that executes them: list (compact fused kernel), mega (pruned dense
    phrase scan), mixed (one dense + one list term)."""
    from wiser_tpu.tools.scale_bench import mine_phrases_from_linedoc
    from wiser_tpu.types import SearchQuery

    rng = np.random.default_rng(seed)
    pairs = mine_phrases_from_linedoc(linedoc, packed, max_pairs=4000)
    if not pairs:
        return {}
    dense = lambda t: engine._dense_slot[packed.lookup(t)] >= 0
    classes = {"phrase_list": [], "phrase_mega": [], "phrase_mixed": []}
    for a, b in pairs:
        da, db = dense(a), dense(b)
        key = ("phrase_mega" if (da and db)
               else "phrase_list" if not (da or db) else "phrase_mixed")
        classes[key].append((a, b))
    sets = {}
    for name, cls in classes.items():
        if not cls:
            continue
        idx = rng.integers(0, len(cls), size=n)
        sets[name] = [SearchQuery(list(cls[i]), n_results=k, is_phrase=True)
                      for i in idx]
    return sets


def build_route_sets(packed, engine, n: int, k: int, seed=3):
    """Query sets keyed by the route they exercise, derived from df/tier
    boundaries the same way the planner routes them."""
    from wiser_tpu.types import SearchQuery

    rng = np.random.default_rng(seed)
    df = packed.df
    dense_min = max(1024, packed.n_docs // engine.DENSE_MIN_DF_FRACTION)
    dense_rows = np.nonzero(engine._dense_slot >= 0)[0] \
        if engine._dense_H else np.zeros(0, np.int64)
    head = dense_rows
    # windowed: 1024 <= df <= WINDOWED_MAX_L, similar sizes, NOT all-dense
    wlo, whi = engine.WINDOWED_MIN_L, engine.WINDOWED_MAX_L
    windowed_rows = np.nonzero((df >= wlo) & (df <= whi)
                               & (engine._dense_slot < 0))[0]
    tail_rows = np.nonzero((df >= 8) & (df < min(wlo, dense_min)))[0]

    def pick(rows, m):
        if len(rows) == 0:
            return None
        return rows[rng.integers(0, len(rows), size=m)]

    sets = {}
    if len(head) >= 2:
        a, b = pick(head, n), pick(head, n)
        sets["dense_all_head_pair"] = [
            SearchQuery([packed.terms[x], packed.terms[y]], n_results=k)
            for x, y in zip(a, b) if x != y]
    if len(head) >= 1 and len(tail_rows) >= 1:
        a, b = pick(tail_rows, n), pick(head, n)
        sets["semidense_tail_x_head"] = [
            SearchQuery([packed.terms[x], packed.terms[y]], n_results=k)
            for x, y in zip(a, b)]
    if len(windowed_rows) >= 2:
        a, b = pick(windowed_rows, n), pick(windowed_rows, n)
        sets["windowed_mid_pair"] = [
            SearchQuery([packed.terms[x], packed.terms[y]], n_results=k)
            for x, y in zip(a, b) if x != y]
    if len(tail_rows) >= 2:
        a, b = pick(tail_rows, n), pick(tail_rows, n)
        sets["bsearch_tail_pair"] = [
            SearchQuery([packed.terms[x], packed.terms[y]], n_results=k)
            for x, y in zip(a, b) if x != y]
    if len(tail_rows) >= 1:
        sets["single_term_table"] = [
            SearchQuery([packed.terms[x]], n_results=k)
            for x in pick(tail_rows, n)]
    # the ladder's config-3 device traffic: Zipf-drawn 2-4 term
    # conjunctions (single-term excluded — it never reaches the device)
    order = np.argsort(df)[::-1].astype(np.int64)
    for nt in (2, 3, 4):
        ranks = np.minimum(rng.zipf(1.25, size=(n, nt)) - 1,
                           packed.n_terms - 1)
        sets[f"zipf_t{nt}"] = [
            SearchQuery([packed.terms[r] for r in rr], n_results=k)
            for rr in order[ranks]]
    # T=3 decomposition: which tier makes multi-term queries slow?
    if len(head) >= 3:
        picks = [pick(head, n) for _ in range(3)]
        sets["dense_t3"] = [
            SearchQuery([packed.terms[x], packed.terms[y], packed.terms[z]],
                        n_results=k)
            for x, y, z in zip(*picks) if len({x, y, z}) == 3]
    if len(head) >= 2 and len(tail_rows) >= 1:
        a = pick(tail_rows, n)
        b, c = pick(head, n), pick(head, n)
        sets["semidense_t3"] = [
            SearchQuery([packed.terms[x], packed.terms[y], packed.terms[z]],
                        n_results=k)
            for x, y, z in zip(a, b, c) if y != z]
    if len(windowed_rows) >= 1 and len(head) >= 2:
        a = pick(windowed_rows, n)
        b, c = pick(head, n), pick(head, n)
        sets["midcand_x_2head_t3"] = [
            SearchQuery([packed.terms[x], packed.terms[y], packed.terms[z]],
                        n_results=k)
            for x, y, z in zip(a, b, c) if y != z]
    return sets


def run_set(engine, queries, batch):
    for i in range(0, len(queries), batch):  # warmup/compile pass
        engine.search_batch(queries[i : i + batch])
    if hasattr(engine, "stats_take"):
        engine.stats_take()  # reset: attribute counters to the timed pass
    if hasattr(engine, "clear_result_memos"):
        engine.clear_result_memos()  # timed queries pay their real cost
    t0 = time.time()
    done = 0
    n_dispatch = 0
    submit_s = 0.0
    final_s = 0.0
    for i in range(0, len(queries), batch):
        ts = time.time()
        res, pending = engine.submit_batch(queries[i : i + batch])
        submit_s += time.time() - ts
        n_dispatch += len(pending)
        ts = time.time()
        if hasattr(engine, "run_pending"):
            engine.run_pending(res, pending)
        else:
            for f in pending:
                f(res)
        final_s += time.time() - ts
        done += len(res)
    wall = time.time() - t0
    out = {"qps": round(done / wall, 1), "wall_s": round(wall, 2),
           "n": done, "per_query_us": round(1e6 * wall / max(done, 1), 1),
           "dispatch_groups": n_dispatch,
           "submit_s": round(submit_s, 2),  # host planning + async dispatch
           "finalize_s": round(final_s, 2)}  # fetch waits + host re-rank
    if hasattr(engine, "stats_take"):
        out["stats"] = {k: round(v, 3) for k, v in
                        sorted(engine.stats_take().items())}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--index", required=True)
    ap.add_argument("--columns", default="raw", choices=["raw", "tc"])
    ap.add_argument("--coarse-buckets", action="store_true")
    ap.add_argument("--n-queries", type=int, default=8192)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--routes", default=None, help="comma-separated subset")
    ap.add_argument("--linedoc", default=None,
                    help="mine adjacent pairs for the phrase routes")
    ap.add_argument("--pruned-c", type=int, default=None,
                    help="override PRUNED_DENSE_C (block budget A/B)")
    ap.add_argument("--phrase-kv", type=int, default=None,
                    help="override PRUNED_PHRASE_KV (compaction width A/B "
                         "— top_k cost scales with KV)")
    ap.add_argument("--phrase-c", type=int, default=None,
                    help="override PRUNED_PHRASE_C")
    ap.add_argument("--no-full-phrase", action="store_true",
                    help="A/B: block-pruned mega phrases instead of the "
                         "full-scan kernel")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from wiser_tpu.utils import enable_compile_cache

    enable_compile_cache()
    import jax

    log(f"devices: {jax.devices()}")
    from wiser_tpu.engine.device import TpuEngine
    from wiser_tpu.index.format import PackedIndex

    packed = PackedIndex.load(args.index)
    engine = TpuEngine(packed, columns=args.columns,
                       coarse_buckets=args.coarse_buckets)
    if args.pruned_c:
        engine.PRUNED_DENSE_C = args.pruned_c
    if args.phrase_kv:
        engine.PRUNED_PHRASE_KV = args.phrase_kv
    if args.phrase_c:
        engine.PRUNED_PHRASE_C = args.phrase_c
    if args.no_full_phrase:
        engine.FULL_PHRASE_SCAN = False
    log(f"engine up; columns={args.columns}; dense_H={engine._dense_H}")
    sets = build_route_sets(packed, engine, args.n_queries, args.k)
    if args.linedoc:
        sets.update(build_phrase_route_sets(
            packed, engine, args.linedoc, min(args.n_queries, 4096), args.k))
    if args.routes:
        keep = set(args.routes.split(","))
        sets = {k: v for k, v in sets.items() if k in keep}
    results = {}
    for name, queries in sets.items():
        log(f"== {name}: {len(queries)} queries")
        results[name] = run_set(engine, queries, args.batch)
        log(json.dumps({name: results[name]}))
    out = {"index": args.index, "columns": args.columns, "routes": results}
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
