"""Smoke run of the search engine on an NVIDIA GPU, in one process.

Generates a seeded wiki-shaped corpus (1M documents by default), indexes it,
and drives the engines through their public entry points, checking every
query set against exact host search:

  1. device: card name and power limit, versions, native codec library;
  2. corpus and index (cached under .scale_cache/), with set-up seconds;
  3. TpuEngine with raw and tc columns over every route set (mega phrases
     through both the full-scan and the block-pruned kernel), plus the
     binary-search kernel at its largest shape (T=2, L=2^21) and the gRPC
     server answering Search RPCs on localhost;
  4. StagedEngine under a device budget below the index size, with cold
     terms staged to the device and decoded there;
  5. the small-corpus oracle parity suites (tests marked `gpu`).

With --four it runs only the four-card phase: ShardedEngine (raw, tc) and
ShardedStagedEngine on a 4-GPU mesh over the same corpus.

Findings are printed as they come. The last stdout line is one JSON object,
{"ok": true, "device": {...}}. Any failure (no GPU, a failed phase, a
parity mismatch) raises, so the process exits non-zero without that line.

  python chip_smoke.py            # one card, phases 1-5
  python chip_smoke.py --four     # four cards, the sharded engines only
"""

from __future__ import annotations

import argparse
import gc
import glob
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(ROOT, ".scale_cache")

# the 1M-document wiki-shaped ladder (data/scale_corpus.py defaults)
CORPUS = dict(vocab_size=200_000, mean_len=120, zipf_a=1.25, seed=42)
K = 10
N_QUERIES = 256  # per route set
N_PARITY = 64  # per set, compared with host_exact_search

# kernel families of engine/kernels.py that the single-card phase must
# exercise at least once (factory names; raw and tc forms pooled)
FAMILIES = {
    "bs_search": ["make_search_kernel"],
    "windowed": ["make_windowed_search_kernel"],
    "semidense": ["make_semidense_kernel", "make_semidense_kernel_tc"],
    "dense": ["make_dense_search_kernel", "make_dense_search_kernel_tc"],
    "pruned_dense": ["make_pruned_dense_kernel",
                     "make_pruned_dense_kernel_tc"],
    "phrase_compact": ["make_compact_phrase_kernel"],
    "phrase_semidense": ["make_semidense_phrase_kernel"],
    "phrase_pruned": ["make_pruned_phrase_kernel",
                      "make_pruned_phrase_kernel_tc"],
    "phrase_full": ["make_full_phrase_kernel", "make_full_phrase_kernel_tc"],
}


def log(*a):
    print(*a, flush=True)


def require_gpu(devices) -> None:
    """Refuse any backend but an NVIDIA GPU: no CPU fallback."""
    if not devices or devices[0].platform != "gpu":
        plat = devices[0].platform if devices else "none"
        raise SystemExit(
            f"chip_smoke: needs an NVIDIA GPU, JAX found {plat!r}")


class CompileClock:
    """Sums JAX's own tracing/lowering/compile durations."""

    def __init__(self):
        import jax.monitoring

        self.seconds = 0.0
        self.compiles = 0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event, duration, **_):
        if event.startswith("/jax/core/compile/"):
            self.seconds += duration
            if event.endswith("backend_compile_duration"):
                self.compiles += 1


# -- phase 1 -----------------------------------------------------------------


def phase_device(jax):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    log(f"nvidia-smi: {smi.stdout.strip()}")
    import jaxlib

    from wiser_tpu.native import lib as native

    dev = jax.devices()[0]
    log(f"jax {jax.__version__} jaxlib {jaxlib.__version__}; "
        f"{len(jax.devices())} x {dev.device_kind}; "
        f"native codec library loaded: {native.available()}")


def probe_top_k_ties(jax):
    """Which index lax.top_k returns first among equal values. Printed
    only: the engine's tie canon never depends on it."""
    import jax.numpy as jnp

    x = jnp.zeros((4, 1 << 20), jnp.float32).at[:, ::7].set(1.0)
    _, idx = jax.lax.top_k(x, 64)
    idx = np.asarray(idx)
    lowest = bool((np.diff(idx, axis=1) > 0).all() and (idx[:, 0] == 0).all())
    log(f"lax.top_k tie order (4 x 2^20, 64 of many equal values): "
        f"lowest index first = {lowest}")


# -- phase 2 -----------------------------------------------------------------


def phase_index(n_docs: int):
    """Seeded corpus + index, cached at a fixed path in the checkout."""
    from wiser_tpu.data.scale_corpus import generate_linedoc
    from wiser_tpu.index.fast_builder import build_packed_fast
    from wiser_tpu.index.format import PackedIndex

    d = os.path.join(CACHE, f"smoke_{n_docs}")
    linedoc = os.path.join(d, "corpus.linedoc")
    idx_dir = os.path.join(d, "idx")
    setup = {"corpus_s": 0.0, "build_s": 0.0, "load_s": 0.0}
    if os.path.exists(os.path.join(idx_dir, "meta.json")):
        t0 = time.perf_counter()
        packed = PackedIndex.load(idx_dir)
        setup["load_s"] = time.perf_counter() - t0
    else:
        os.makedirs(d, exist_ok=True)
        t0 = time.perf_counter()
        generate_linedoc(linedoc, n_docs, with_blooms=True, verbose=False,
                         **CORPUS)
        setup["corpus_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        packed = build_packed_fast(linedoc, "WITH_BI_BLOOM", with_blooms=True)
        packed.save(idx_dir)
        setup["build_s"] = time.perf_counter() - t0
    log(f"index: {packed.n_docs} docs, {packed.n_terms} terms, "
        f"{packed.n_postings} padded postings, {len(packed.positions)} "
        f"positions; corpus {setup['corpus_s']:.1f}s, build+save "
        f"{setup['build_s']:.1f}s, load {setup['load_s']:.1f}s")
    return packed, linedoc, setup


# -- parity ------------------------------------------------------------------


def check_parity(name, packed, cache64, queries, results, n_sample=N_PARITY,
                 seed=11):
    """(doc_id, f64 score) lists equal bit for bit with host_exact_search
    on a seeded sample; raises on any mismatch."""
    from wiser_tpu.engine.device import host_exact_search

    rng = np.random.default_rng(seed)
    idx = rng.choice(len(queries), size=min(n_sample, len(queries)),
                     replace=False)
    checked = bad = 0
    for i in idx.tolist():
        q = queries[i]
        rows = [packed.lookup(t) for t in q.terms]
        if min(rows) < 0:
            continue
        d, s = host_exact_search(packed, cache64, rows, q.n_results,
                                 is_phrase=q.is_phrase and len(rows) >= 2)
        want = list(zip(d.tolist(), s.tolist()))
        have = [(e.doc_id, e.doc_score) for e in results[i].entries]
        checked += 1
        if want != have:
            bad += 1
            log(f"  MISMATCH {name} {q.terms} phrase={q.is_phrase}: "
                f"want {want[:3]} have {have[:3]}")
    if bad:
        raise AssertionError(f"{name}: {bad}/{checked} parity mismatches")
    return checked


def run_set(name, engine, packed, queries, stats=None, cache64=None):
    t0 = time.perf_counter()
    results = engine.search_batch(queries)
    wall = time.perf_counter() - t0
    checked = check_parity(name, packed,
                           engine.cache64 if cache64 is None else cache64,
                           queries, results)
    line = (f"  {name}: {len(queries)} queries, {checked} checked, "
            f"0 mismatches, first pass {wall:.2f}s")
    if stats is not None:
        st = stats()
        line += " " + json.dumps({k: int(st.get(k, 0)) for k in (
            "host_fallback_q", "prune_rescued", "host_exact_calls")})
    log(line)


def kernel_shapes():
    from wiser_tpu.engine import kernels as Kn

    return {name: getattr(Kn, name).cache_info().currsize
            for name in sorted(dir(Kn)) if name.startswith("make_")
            and hasattr(getattr(Kn, name), "cache_info")}


def peak_bytes(jax):
    return max(int((d.memory_stats() or {}).get("peak_bytes_in_use", 0))
               for d in jax.devices())


# -- phase 3 -----------------------------------------------------------------


def phase_serving(engine, packed, queries):
    """The gRPC server (serve/server.py) in this process on localhost:
    Search RPCs from client threads must equal the engine's own answers."""
    import socket
    from concurrent.futures import ThreadPoolExecutor

    import grpc

    from wiser_tpu.serve.client import request_from_query
    from wiser_tpu.serve.protocol import WiserEngineStub
    from wiser_tpu.serve.server import create_server

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    server, executor = create_server(engine, port, n_threads=16)
    server.start()
    try:
        with grpc.insecure_channel(f"localhost:{port}") as channel:
            stub = WiserEngineStub(channel)
            with ThreadPoolExecutor(8) as pool:
                replies = list(pool.map(
                    lambda q: stub.UnarySearch(request_from_query(q),
                                               timeout=300), queries))
    finally:
        executor.stop()
        server.stop(grace=1)
    local = engine.search_batch(queries)
    for q, rep, loc in zip(queries, replies, local):
        if [(e.doc_id, e.doc_score) for e in rep.entries] != \
                [(e.doc_id, e.doc_score) for e in loc.entries]:
            raise AssertionError(f"served != engine for {q.terms}")
    log(f"  serving: {len(queries)} Search RPCs over localhost gRPC, "
        f"all equal to engine.search_batch")


def probe_bs_giant(engine, packed, k=K):
    """The binary-search kernel at T=2, L=2^21 (candidate df in (2^19,
    2^21]), dispatched through the engine's own flat path."""
    from wiser_tpu.engine.device import _PlannedQuery
    from wiser_tpu.types import SearchQuery, SearchResult

    df = packed.df
    giant = np.nonzero((df > 1 << 19) & (df <= 1 << 21))[0]
    if len(giant) < 2:
        log(f"  bs T=2 L=2^21: skipped, {len(giant)} terms with df in "
            f"(2^19, 2^21] at this corpus size")
        return
    pairs = [(int(giant[i]), int(giant[j]))
             for i in range(len(giant)) for j in range(i + 1, len(giant))][:8]
    planned, queries = [], []
    for qi, (a, b) in enumerate(pairs):
        q = SearchQuery([packed.terms[a], packed.terms[b]], n_results=k)
        pq = _PlannedQuery(qi, [a, b], q)
        pq.plan_slots(df)
        if engine._flat_key(pq)[:3] != (2, 1 << 21, 0):
            raise AssertionError(f"not the T=2, L=2^21 bs route: "
                                 f"{engine._flat_key(pq)}")
        planned.append(pq)
        queries.append(q)
    results = [SearchResult() for _ in queries]
    engine.stats_take()
    for f in engine._submit_flat(planned):
        f(results)
    check_parity("bs_T2_L2^21", packed, engine.cache64, queries, results)
    fallback = int(engine.stats_take().get("host_fallback_q", 0))
    log(f"  bs T=2 L=2^21: {len(queries)} giant pairs ran, 0 mismatches, "
        f"host_fallback_q={fallback}")


def phase_tpu_engine(jax, packed, linedoc, columns, setup):
    from wiser_tpu.engine.device import TpuEngine
    from wiser_tpu.tools.route_bench import (build_phrase_route_sets,
                                             build_route_sets)
    from wiser_tpu.tools.scale_bench import build_configs

    t0 = time.perf_counter()
    engine = TpuEngine(packed, columns=columns)
    up = time.perf_counter() - t0
    setup[f"upload_{columns}_s"] = up
    log(f"TpuEngine columns={columns}: up in {up:.1f}s, dense_H="
        f"{engine._dense_H}, device bytes {json.dumps(engine.device_bytes())}")
    sets = build_route_sets(packed, engine, N_QUERIES, K)
    sets.update(build_phrase_route_sets(packed, engine, linedoc,
                                        N_QUERIES, K))
    sets.update(build_configs(packed, linedoc, N_QUERIES, K))
    engine.stats_take()
    for name, queries in sets.items():
        engine.clear_result_memos()
        run_set(f"{columns}/{name}", engine, packed, queries,
                stats=engine.stats_take)
    # mega phrases again through the block-pruned phrase kernel (the
    # full-scan kernel serves them by default)
    engine.FULL_PHRASE_SCAN = False
    engine.clear_result_memos()
    run_set(f"{columns}/phrase_mega_pruned", engine, packed,
            sets["phrase_mega"], stats=engine.stats_take)
    if columns == "raw":
        probe_bs_giant(engine, packed)
        phase_serving(engine, packed, sets["3_aol_mix"][:32])
    log(f"  peak device bytes: {peak_bytes(jax)}")
    del engine
    gc.collect()


# -- phase 4 -----------------------------------------------------------------


def phase_staged(jax, packed, linedoc, full_bytes):
    from wiser_tpu.engine import staged as S
    from wiser_tpu.tools.scale_bench import build_configs

    budget = full_bytes // 4
    t0 = time.perf_counter()
    eng = S.StagedEngine(packed, budget)
    eng.COLD_COMPUTE = "device"  # stage cold runs to the card
    log(f"StagedEngine: budget {budget} B (a quarter of the resident "
        f"index), up in {time.perf_counter() - t0:.1f}s, hot terms "
        f"{eng.hot_fraction:.4f}, phrase-hot {eng.phrase_hot_fraction:.4f}")
    cfg = build_configs(packed, linedoc, N_QUERIES, K, seed=13)
    for name in ("3_aol_mix", "4_phrase"):
        eng.clear_result_memos()
        run_set(f"staged/{name}", eng, packed, cfg[name],
                stats=eng.hot.stats_take)
    n_unpack = S._make_doc_combine.cache_info().currsize
    log(f"  on-device unpack shapes: {n_unpack}; "
        f"peak device bytes: {peak_bytes(jax)}")
    if not n_unpack:
        raise AssertionError("staged phase never decoded a cold run on device")
    del eng
    gc.collect()


# -- phase 5 -----------------------------------------------------------------


class _Outcomes:
    def __init__(self):
        self.counts = {"passed": 0, "failed": 0, "skipped": 0}

    def pytest_runtest_logreport(self, report):
        if report.when == "call" or report.outcome != "passed":
            self.counts[report.outcome] += 1


def phase_oracle_suites():
    import pytest

    out = _Outcomes()
    files = sorted(glob.glob(os.path.join(ROOT, "tests", "test_gpu_*.py")))
    rc = pytest.main(["--noconftest", "-q", "-m", "gpu", "-p",
                      "no:cacheprovider", *files], plugins=[out])
    log(f"oracle parity suites on the card: {json.dumps(out.counts)}")
    if rc != 0 or out.counts["failed"] or out.counts["skipped"] \
            or not out.counts["passed"]:
        raise AssertionError(f"gpu-marked suites: rc={rc} {out.counts}")


# -- four cards --------------------------------------------------------------


def phase_four(jax, packed, linedoc):
    from jax.sharding import Mesh

    from wiser_tpu.engine.shard import ShardedEngine, ShardedIndex
    from wiser_tpu.engine.staged_shard import ShardedStagedEngine
    from wiser_tpu.tools.scale_bench import build_configs

    devs = jax.devices()
    if len(devs) < 4:
        raise SystemExit(f"chip_smoke --four: needs 4 GPUs, found {len(devs)}")
    mesh = Mesh(np.array(devs[:4]), ("d",))
    cfg = build_configs(packed, linedoc, N_QUERIES, K)
    t0 = time.perf_counter()
    sharded = ShardedIndex.from_packed(packed, n_shards=4)
    log(f"sharded 4 ways in {time.perf_counter() - t0:.1f}s")
    full_bytes = 0
    for columns in ("raw", "tc"):
        t0 = time.perf_counter()
        eng = ShardedEngine(sharded, mesh=mesh, columns=columns)
        log(f"ShardedEngine columns={columns}: up in "
            f"{time.perf_counter() - t0:.1f}s")
        for name, queries in cfg.items():
            run_set(f"sharded_{columns}/{name}", eng, packed, queries)
        full_bytes = full_bytes or sum(
            int(a.nbytes) for a in (eng.d_postings_doc, eng.d_postings_score,
                                    eng.d_postings_tf, eng.d_positions))
        del eng
        gc.collect()
    budget = full_bytes // 4
    t0 = time.perf_counter()
    eng = ShardedStagedEngine(packed, 4, budget, mesh=mesh)
    log(f"ShardedStagedEngine: budget {budget} B, up in "
        f"{time.perf_counter() - t0:.1f}s, hot terms {eng.hot_fraction:.4f}")
    for name, queries in cfg.items():
        run_set(f"sharded_staged/{name}", eng, packed, queries,
                cache64=eng.hot.cache64)
    log(f"  peak device bytes (max over cards): {peak_bytes(jax)}")


# -- driver ------------------------------------------------------------------


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded phase")
    ap.add_argument("--n-docs", type=int, default=1_000_000)
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    from wiser_tpu.utils import enable_compile_cache

    log(f"compile cache: {enable_compile_cache()}")
    import jax

    require_gpu(jax.devices())
    clock = CompileClock()
    t_start = time.perf_counter()
    phase_device(jax)
    packed, linedoc, setup = phase_index(args.n_docs)
    if args.four:
        phase_four(jax, packed, linedoc)
    else:
        probe_top_k_ties(jax)
        for columns in ("raw", "tc"):
            phase_tpu_engine(jax, packed, linedoc, columns, setup)
        shapes = kernel_shapes()
        log(f"kernel shapes built: {json.dumps(shapes)}")
        missing = [fam for fam, names in FAMILIES.items()
                   if not sum(shapes[n] for n in names)]
        if missing:
            raise AssertionError(f"kernel families never ran: {missing}")
        from wiser_tpu.engine.staged import per_term_device_cost

        phase_staged(jax, packed, linedoc,
                     int(per_term_device_cost(packed).sum()))
        phase_oracle_suites()
    setup["compile_s"] = clock.seconds
    rounded = {k: round(v, 1) for k, v in setup.items()}
    log(f"set-up seconds: {json.dumps(rounded)}"
        f" (compile_s sums JAX's compile events over the dispatch threads); "
        f"{clock.compiles} XLA compiles; total "
        f"{time.perf_counter() - t_start:.1f}s")
    dev = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": dev[0].platform, "kind": dev[0].device_kind,
        "count": len(dev)}}), flush=True)


if __name__ == "__main__":
    main()
