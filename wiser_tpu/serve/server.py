"""gRPC search server — reference: grpc_server_impl.h + qq_server.cc.

The reference's AsyncServer achieves throughput with N completion queues x
5000 preallocated call state machines (grpc_server_impl.h:209-458). The
accelerator-native equivalent of that design is a *batching executor*: request
handler threads enqueue queries into a shared queue; a dispatcher thread
drains up to `max_batch` queries (or waits `max_wait_ms`), executes them
as ONE batched device program via TpuEngine.search_batch, and fulfills the
per-request futures. Device efficiency comes from cross-request batching,
not thread count.

Run: python -m wiser_tpu.serve.server --index <dir> --port 50051
     [--engine tpu|oracle] [--linedoc path --format WITH_POSITIONS]
"""

from __future__ import annotations

import argparse
import queue
import signal
import sys
import threading
import time
from concurrent import futures
from typing import List, Optional

import grpc

from wiser_tpu.serve import protocol, wiser_pb2 as pb
from wiser_tpu.types import SearchQuery, SearchResult


class BatchingExecutor:
    def __init__(self, engine, max_batch: int = 4096, max_wait_ms: float = 2.0,
                 trace_path: Optional[str] = None):
        self.engine = engine
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1000.0
        self._q: "queue.Queue[tuple[SearchQuery, futures.Future, float]]" = queue.Queue()
        self._stop = False
        # tail diagnosis (WISER_SERVE_TRACE=<path>): one JSONL line per
        # executor batch — queue age of its oldest item, submit wall,
        # finalize wall (where flagged-query host merges run) — so a p99
        # spike is attributable to queueing vs device vs host post-pass
        self._trace = open(trace_path, "a") if trace_path else None
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def search(self, query: SearchQuery, timeout: float = 60.0) -> SearchResult:
        fut: futures.Future = futures.Future()
        self._q.put((query, fut, time.monotonic()))
        return fut.result(timeout=timeout)

    def search_many(self, queries: List[SearchQuery],
                    timeout: float = 120.0) -> List[SearchResult]:
        """Enqueue a whole wire batch at once; the dispatcher still
        coalesces across streams through the shared queue."""
        futs = []
        now = time.monotonic()
        for q in queries:
            fut: futures.Future = futures.Future()
            self._q.put((q, fut, now))
            futs.append(fut)
        return [f.result(timeout=timeout) for f in futs]

    def _drain(self) -> List[tuple]:
        items = []
        try:
            items.append(self._q.get(timeout=0.05))
        except queue.Empty:
            return items
        deadline = time.time() + self.max_wait
        while len(items) < self.max_batch:
            remaining = deadline - time.time()
            if remaining <= 0:
                break
            try:
                items.append(self._q.get(timeout=remaining))
            except queue.Empty:
                break
        return items

    def _loop(self) -> None:
        # pipelined: dispatch batch N+1 before finalizing batch N, so the
        # device->host fetch latency of one batch overlaps the dispatch
        # and device compute of the next (the completion-queue analog)
        in_flight = None  # (items, results, pending, submit_wall, q_age)
        while not self._stop:
            items = self._drain()
            submitted = None
            if items:
                queries = [q for q, _, _ in items]
                t_sub = time.monotonic()
                q_age = t_sub - min(ts for _, _, ts in items)
                try:
                    if hasattr(self.engine, "submit_batch"):
                        results, pending = self.engine.submit_batch(queries)
                        submitted = (items, results, pending,
                                     time.monotonic() - t_sub, q_age)
                    else:
                        results = self.engine.search_batch(queries)
                        for (_, fut, _), res in zip(items, results):
                            fut.set_result(res)
                        if self._trace is not None:
                            self._trace_line(len(items), q_age,
                                             time.monotonic() - t_sub, 0.0)
                except Exception as e:
                    for _, fut, _ in items:
                        if not fut.done():
                            fut.set_exception(e)
            if in_flight is not None:
                f_items, f_results, f_pending, sub_s, f_age = in_flight
                t_fin = time.monotonic()
                try:
                    if hasattr(self.engine, "run_pending"):
                        self.engine.run_pending(f_results, f_pending)
                    else:
                        for f in f_pending:
                            f(f_results)
                    for (_, fut, _), res in zip(f_items, f_results):
                        fut.set_result(res)
                except Exception as e:
                    for _, fut, _ in f_items:
                        if not fut.done():
                            fut.set_exception(e)
                if self._trace is not None:
                    self._trace_line(len(f_items), f_age, sub_s,
                                     time.monotonic() - t_fin)
            in_flight = submitted
        if in_flight is not None:  # flush on shutdown
            f_items, f_results, f_pending, _, _ = in_flight
            try:
                for f in f_pending:
                    f(f_results)
                for (_, fut, _), res in zip(f_items, f_results):
                    fut.set_result(res)
            except Exception as e:
                for _, fut, _ in f_items:
                    if not fut.done():
                        fut.set_exception(e)

    def _trace_line(self, n: int, q_age: float, submit_s: float,
                    finalize_s: float) -> None:
        import json as _json

        self._trace.write(_json.dumps({
            "t": round(time.monotonic(), 3), "n": n,
            "q_age_ms": round(q_age * 1e3, 1),
            "submit_ms": round(submit_s * 1e3, 1),
            "finalize_ms": round(finalize_s * 1e3, 1)}) + "\n")
        self._trace.flush()

    def stop(self) -> None:
        self._stop = True


class WiserServicer:
    """reference: the service impl inside grpc_server_impl.h."""

    def __init__(self, executor: BatchingExecutor, mutable_engine=None):
        self.executor = executor
        self.mutable_engine = mutable_engine  # oracle engine supports adds

    def UnarySearch(self, request, context):
        q = protocol.query_from_request(request)
        return protocol.reply_from_result(self.executor.search(q))

    def StreamingSearch(self, request_iterator, context):
        for request in request_iterator:
            q = protocol.query_from_request(request)
            yield protocol.reply_from_result(self.executor.search(q))

    def BatchSearch(self, request_iterator, context):
        # N queries per wire message (see wiser.proto note): one
        # serialize/deserialize round amortizes over the whole batch
        for batch in request_iterator:
            queries = [protocol.query_from_request(r)
                       for r in batch.requests]
            results = self.executor.search_many(queries)
            out = pb.SearchReplyBatch()
            for res in results:
                reply = out.replies.add()
                for e in res.entries:
                    reply.entries.add(doc_id=e.doc_id, snippet=e.snippet,
                                      doc_score=e.doc_score)
            yield out

    def AddDocument(self, request, context):
        # The packed engine is immutable after load (the index IS the
        # checkpoint, vacuum_engine.h:144-166); only the in-memory oracle
        # engine accepts documents, like QQ-Mem (qq_mem_engine.h:298).
        if self.mutable_engine is None:
            return pb.StatusReply(ok=False, message="engine is read-only")
        from wiser_tpu.types import DocInfo

        self.mutable_engine.add_document(DocInfo(
            body=request.body, tokens=request.tokens,
            token_offsets=request.offsets, token_positions=request.positions,
            format="WITH_POSITIONS"))
        return pb.StatusReply(ok=True, message="added")

    def Echo(self, request, context):
        return pb.EchoData(message=request.message)


def warmup_engine(engine, batch_sizes=(16, 128, 1024), seed: int = 0) -> int:
    """Pre-compile the common shape buckets before serving traffic —
    first-compile on this stack takes tens of seconds and would otherwise
    land on live requests (the analog of the reference loading the whole
    index before accepting connections, grpc_server_impl.h:169-205).

    Exercises 1..4-term queries over low/high-df terms at several batch
    widths. Returns the number of warmup queries executed."""
    import numpy as np

    packed = getattr(engine, "packed", None)
    if packed is None or not getattr(packed, "terms", None):
        return 0
    rng = np.random.default_rng(seed)
    by_df = np.argsort(packed.df)
    probe_rows = np.unique(np.concatenate([
        by_df[-8:], by_df[: 8], by_df[len(by_df) // 2 : len(by_df) // 2 + 8]
    ]))
    probe_terms = [packed.terms[r] for r in probe_rows]
    total = 0
    for B in batch_sizes:
        queries = []
        for _ in range(B):
            nt = int(rng.integers(1, 5))
            terms = [probe_terms[rng.integers(0, len(probe_terms))]
                     for _ in range(nt)]
            queries.append(SearchQuery(terms, n_results=10))
        engine.search_batch(queries)
        total += len(queries)
    return total


def create_server(engine, port: int, n_threads: int = 512,
                  max_batch: int = 4096, max_wait_ms: float = 2.0,
                  mutable_engine=None, warmup: bool = False):
    # n_threads caps the number of IN-FLIGHT requests (each blocked
    # handler occupies one pool thread while it waits on the batch
    # future), NOT parallel CPU work — closed-loop throughput is
    # concurrency / batch_latency, so the pool must exceed the offered
    # stream count. 512 python threads blocked on futures are cheap; the
    # reference sizes the same way (5000 call states, grpc_server_impl.h).
    if warmup:
        t0 = time.time()
        n = warmup_engine(engine)
        print(f"warmed {n} queries in {time.time()-t0:.1f}s", file=sys.stderr)
    import os

    executor = BatchingExecutor(engine, max_batch, max_wait_ms,
                                trace_path=os.environ.get("WISER_SERVE_TRACE"))
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=n_threads))
    protocol.add_service(server, WiserServicer(executor, mutable_engine))
    server.add_insecure_port(f"[::]:{port}")
    return server, executor


class OracleExecutorAdapter:
    """Lets the batching executor drive the oracle engine too."""

    def __init__(self, oracle):
        self.oracle = oracle

    def search_batch(self, queries):
        return [self.oracle.search(q) for q in queries]


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description="wiser_tpu search server")
    ap.add_argument("--index", help="PackedIndex directory")
    ap.add_argument("--linedoc", help="linedoc to index at startup")
    ap.add_argument("--format", default="WITH_POSITIONS")
    ap.add_argument("--engine", default="tpu", choices=["tpu", "oracle"])
    ap.add_argument("--port", type=int, default=50051)
    ap.add_argument("--n-threads", type=int, default=512,
                    help="in-flight request cap (see create_server note)")
    ap.add_argument("--columns", default="raw", choices=["raw", "tc"])
    ap.add_argument("--coarse-buckets", action="store_true",
                    help="merge shape buckets so batches span fewer "
                         "dispatch groups (closed-loop latency lever)")
    ap.add_argument("--max-batch", type=int, default=4096)
    ap.add_argument("--max-wait-ms", type=float, default=2.0)
    ap.add_argument("--io-mode", default="both",
                    choices=["off", "dispatch", "fetch", "both"],
                    help="engine dispatch/fetch overlap thread pools")
    ap.add_argument("--warmup", action="store_true",
                    help="pre-compile generic shape buckets before serving")
    ap.add_argument("--warmup-log",
                    help="query log to replay at serving batch widths "
                         "before accepting traffic (covers the exact "
                         "compile shapes of the live workload)")
    ap.add_argument("--warmup-batch", type=int, default=128,
                    help="batch width for --warmup-log (should match the "
                         "live batching width)")
    args = ap.parse_args(argv)

    from wiser_tpu.utils import enable_compile_cache

    enable_compile_cache()

    mutable = None
    if args.engine == "oracle" or args.index is None:
        from wiser_tpu.linedoc import parse_linedoc
        from wiser_tpu.oracle import OracleEngine

        oracle = OracleEngine()
        if args.linedoc:
            n = oracle.load_linedocs(parse_linedoc(args.linedoc, args.format))
            print(f"indexed {n} docs ({oracle.term_count()} terms)", file=sys.stderr)
        if args.engine == "oracle":
            engine = OracleExecutorAdapter(oracle)
            mutable = oracle
        else:
            from wiser_tpu.engine.device import TpuEngine
            from wiser_tpu.index.builder import pack_oracle

            engine = TpuEngine(pack_oracle(oracle),
                               doc_bodies=oracle.doc_bodies,
                               coarse_buckets=args.coarse_buckets,
                               io_mode=args.io_mode)
    else:
        from wiser_tpu.engine.device import TpuEngine
        from wiser_tpu.index.format import PackedIndex

        engine = TpuEngine(PackedIndex.load(args.index),
                           columns=args.columns,
                           coarse_buckets=args.coarse_buckets,
                           io_mode=args.io_mode)

    if args.warmup_log:
        from wiser_tpu.bench.query_pool import QueryLogReader

        qs = QueryLogReader(args.warmup_log).read_all(n_results=10)
        t0 = time.time()
        for i in range(0, len(qs), args.warmup_batch):
            engine.search_batch(qs[i : i + args.warmup_batch])
        print(f"warmup-log: {len(qs)} queries in {time.time()-t0:.1f}s",
              file=sys.stderr)

    server, executor = create_server(
        engine, args.port, args.n_threads, args.max_batch, args.max_wait_ms,
        mutable_engine=mutable, warmup=args.warmup)
    server.start()
    print(f"wiser_tpu serving on :{args.port}", file=sys.stderr)

    stop = threading.Event()
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    stop.wait()
    executor.stop()
    server.stop(grace=2)


if __name__ == "__main__":
    main()
