"""Headline benchmark: aggregate QPS on an AOL-shaped mixed query workload.

Workload shape follows the AOL trace statistics shipped with the reference
(data/AOL_QueryLog_analysis/stat.txt: 36.8% 1-term / 25.2% 2-term /
17.3% 3-term, rest longer), over a Zipf-distributed synthetic corpus.
Queries run in mega-batches through the TpuEngine (BASELINE.json
config 3), end-to-end including host-side exact f64 re-ranking.

vs_baseline: the reference publishes no absolute QPS (SURVEY.md §6).
BASELINE.md's target is >=10x the reference's single-node aggregate
throughput on the AOL trace; we anchor that at an estimated 10k QPS for
the reference's 25-thread server on cached indexes (FAST'20 setup), so
vs_baseline = qps / 10_000 and the target is vs_baseline >= 10.

Prints ONE JSON line on stdout; diagnostics go to stderr.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

CACHE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".bench_cache")
REFERENCE_QPS_ESTIMATE = 10_000.0

# Scale knobs (env-overridable so the same driver runs the 100k/1M-doc
# scale ladder: WISER_BENCH_DOCS=100000 WISER_BENCH_VOCAB=50000 python
# bench.py). Defaults = the headline 20k-doc config.
N_DOCS = int(os.environ.get("WISER_BENCH_DOCS", 20_000))
VOCAB = int(os.environ.get("WISER_BENCH_VOCAB", 20_000))
MEAN_LEN = int(os.environ.get("WISER_BENCH_MEAN_LEN", 120))
N_QUERIES = int(os.environ.get("WISER_BENCH_QUERIES", 262_144))
COLUMNS = os.environ.get("WISER_BENCH_COLUMNS", "raw")  # raw | tc
COARSE = bool(int(os.environ.get("WISER_BENCH_COARSE", "0")))
IO_WORKERS = int(os.environ.get("WISER_BENCH_IO_WORKERS", "8"))
# the engine default is "both"; the 20k headline uses fetch pooling only
# (dispatch threads contend with finalizers at short group runtimes)
IO_MODE = os.environ.get("WISER_BENCH_IO_MODE", "fetch")
# Max-throughput operating point: one mega-batch per pipeline slot
# amortizes planning + fetch waits and maximizes request coalescing. Its
# knee on the GPU is not measured yet.
BATCH = int(os.environ.get("WISER_BENCH_BATCH", 131_072))
K = 10


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def get_index():
    from wiser_tpu.index.format import PackedIndex

    idx_dir = os.path.join(CACHE_DIR, f"idx_{N_DOCS}_{VOCAB}_{MEAN_LEN}")
    if os.path.isdir(idx_dir):
        log(f"loading cached index {idx_dir}")
        return PackedIndex.load(idx_dir)
    log("building synthetic corpus + index (first run only)...")
    t0 = time.time()
    from wiser_tpu.data.synth import synth_docinfos
    from wiser_tpu.index.builder import build_index

    docs = synth_docinfos(N_DOCS, VOCAB, MEAN_LEN, zipf_a=1.25, seed=42,
                          with_blooms=False)
    packed, _ = build_index(docs)
    packed.save(idx_dir)
    log(f"built in {time.time()-t0:.1f}s: {packed.n_postings} postings, "
        f"{packed.n_terms} terms")
    return packed


def aol_mixed_queries(packed, n_queries, seed=7):
    """1-4 term conjunctive queries with the AOL length mix."""
    from wiser_tpu.types import SearchQuery

    rng = np.random.default_rng(seed)
    # AOL: 36.8/25.2/17.3/rest -> normalized over 1..4 terms
    n_terms = rng.choice([1, 2, 3, 4], size=n_queries,
                         p=[0.43, 0.29, 0.20, 0.08])
    queries = []
    for nt in n_terms:
        ranks = np.minimum(rng.zipf(1.25, size=int(nt)) - 1, packed.n_terms - 1)
        terms = [packed.terms[r] for r in ranks]
        queries.append(SearchQuery(terms, n_results=K))
    return queries


def main():
    os.makedirs(CACHE_DIR, exist_ok=True)
    import jax

    from wiser_tpu.utils import enable_compile_cache

    enable_compile_cache()
    log(f"devices: {jax.devices()}")

    packed = get_index()
    from wiser_tpu.engine.device import TpuEngine

    engine = TpuEngine(packed, columns=COLUMNS, coarse_buckets=COARSE,
                       io_workers=IO_WORKERS, io_mode=IO_MODE)
    log(f"columns={COLUMNS}; device bytes: {engine.device_bytes()}")
    queries = aol_mixed_queries(packed, N_QUERIES)
    uniq = len({(tuple(q.terms), q.n_results) for q in queries})
    log(f"{len(queries)} queries, {uniq} unique (batch request "
        f"coalescing executes repeats once)")

    # warmup / compile: run the whole workload once so every shape bucket
    # is compiled before timing (steady-state serving behavior).
    # warmup_s is published: it labels the machine state (~15s = warm
    # persistent compile cache; minutes = cold cache, e.g. a fresh
    # machine) so headline swings attribute to compile state instead of
    # silently tracking it (r04's 262s-warmup run also overlapped the
    # 10M index build on this single-core host).
    t0 = time.time()
    for i in range(0, len(queries), BATCH):
        engine.search_batch(queries[i : i + BATCH])
    warmup_s = time.time() - t0
    log(f"warmup (incl. compile): {warmup_s:.1f}s")
    # Result-memo honesty (same policy as scale_bench/route_bench/run_exp):
    # drop memoized host merges so the timed pass pays the real cost of
    # flagged queries; compile/shape warmth stays, and repeats WITHIN the
    # timed pass still coalesce/memo-hit naturally.
    if hasattr(engine, "clear_result_memos"):
        engine.clear_result_memos()

    # pipelined: keep PIPELINE batches in flight (device works on batch
    # i+1's kernels while batch i's results are fetched and finalized)
    PIPELINE = int(os.environ.get("WISER_BENCH_PIPELINE", "2"))
    PROFILE = bool(int(os.environ.get("WISER_BENCH_PROFILE", "0")))
    # two timed passes, best-of (VERDICT r4 item 9): on this single-core
    # host a transient background process skews one pass; best-of-2 makes
    # the headline track the engine, not machine load. Both published.
    N_PASSES = int(os.environ.get("WISER_BENCH_PASSES", "2"))

    def timed_pass():
        submit_s = finalize_s = 0.0
        lat = []
        t0 = time.time()
        done = 0
        in_flight = []
        for i in range(0, len(queries), BATCH):
            bt = time.time()
            in_flight.append((bt, engine.submit_batch(queries[i : i + BATCH])))
            submit_s += time.time() - bt
            while len(in_flight) > PIPELINE:
                bt0, (res, pending) = in_flight.pop(0)
                ft = time.time()
                engine.run_pending(res, pending)  # overlapped group fetches
                finalize_s += time.time() - ft
                lat.append(time.time() - bt0)
                done += len(res)
        for bt0, (res, pending) in in_flight:
            ft = time.time()
            engine.run_pending(res, pending)
            finalize_s += time.time() - ft
            lat.append(time.time() - bt0)
            done += len(res)
        wall = time.time() - t0
        if PROFILE:
            log(f"profile: submit {submit_s:.2f}s, run_pending "
                f"{finalize_s:.2f}s of {wall:.2f}s wall ({len(lat)} batches)")
        return done, wall, lat

    passes = []
    for p in range(N_PASSES):
        if p and hasattr(engine, "clear_result_memos"):
            engine.clear_result_memos()
        passes.append(timed_pass())
        log(f"pass {p + 1}/{N_PASSES}: "
            f"{passes[-1][0] / passes[-1][1]:,.0f} QPS")
    done, wall, lat = max(passes, key=lambda t: t[0] / t[1])
    pass_qps = [round(d / w, 1) for d, w, _ in passes]
    qps = done / wall
    # Both denominators (VERDICT r3 item 9): replayed-log QPS (repeats
    # re-served via coalescing — legitimate trace replay, and what the
    # reference's log-replay benches count) AND unique-query throughput,
    # so the coalescing win is visible instead of implicit.
    unique_qps = uniq * done / (len(queries) * wall)
    lat_ms = 1000.0 * np.array(lat) / BATCH  # per-query amortized
    log(f"{done} queries in {wall:.2f}s -> {qps:,.0f} QPS replayed "
        f"({unique_qps:,.0f} unique-QPS over {uniq} uniques); "
        f"batch lat p50={np.median(lat):.3f}s p99={np.percentile(lat,99):.3f}s; "
        f"amortized/query {lat_ms.mean()*1000:.1f}us")

    print(json.dumps({
        "metric": "aggregate_qps_aol_mix",
        "value": round(qps, 1),
        "unit": "queries/s",
        "vs_baseline": round(qps / REFERENCE_QPS_ESTIMATE, 3),
        "unique_queries": uniq,
        "replayed_queries": done,
        "unique_qps": round(unique_qps, 1),
        "warmup_s": round(warmup_s, 1),
        "compile_cache": ("warm" if warmup_s < 60.0 else "cold"),
        "pass_qps": pass_qps,
    }))


if __name__ == "__main__":
    main()
