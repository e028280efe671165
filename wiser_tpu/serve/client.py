"""Closed-loop multithreaded benchmark client — reference:
grpc_client_impl.h (SyncStreamingClient :557, SyncUnaryClient :728,
per-thread latency histograms merged for percentiles :468-492, QPS =
roundtrips/duration :448-466).

Run: python -m wiser_tpu.serve.client --target localhost:50051 \
       --query-log queries.txt --n-threads 8 --duration 10 [--unary]
"""

from __future__ import annotations

import argparse
import sys
import threading
import time
from typing import List, Optional

import grpc

from wiser_tpu.bench.histogram import Histogram, format_latency_table
from wiser_tpu.bench.query_pool import QueryLogReader, QueryProducer
from wiser_tpu.serve import wiser_pb2 as pb
from wiser_tpu.serve.protocol import WiserEngineStub
from wiser_tpu.types import SearchQuery


def request_from_query(q: SearchQuery) -> pb.SearchRequest:
    return pb.SearchRequest(
        terms=q.terms, n_results=q.n_results,
        return_snippets=q.return_snippets,
        n_snippet_passages=q.n_snippet_passages, is_phrase=q.is_phrase,
    )


class Client:
    """reference: Client (grpc_client_impl.h:342-554)."""

    def __init__(self, target: str, producer: QueryProducer,
                 n_threads: int = 8, streaming: bool = True,
                 duration_s: float = 10.0, n_channels: int = 4,
                 wire_batch: int = 1, warmup_s: float = 0.0):
        self.target = target
        self.producer = producer
        self.n_threads = n_threads
        self.streaming = streaming
        self.duration_s = duration_s
        self.wire_batch = wire_batch
        # steady-state window: roundtrips completing in the first warmup_s
        # are driven (they keep the closed loop loaded) but not recorded —
        # channel setup + first-batch transients otherwise land in p99+
        # (the reference client also measures against a warm server,
        # grpc_client_impl.h:448-466)
        self.warmup_s = warmup_s
        self.channels = [grpc.insecure_channel(target) for _ in range(n_channels)]
        self.hists = [Histogram() for _ in range(n_threads)]
        self.counts = [0] * n_threads
        self._stop = threading.Event()
        self._record = threading.Event()
        if warmup_s <= 0:
            self._record.set()

    def _thread_fn(self, tid: int) -> None:
        stub = WiserEngineStub(self.channels[tid % len(self.channels)])
        hist = self.hists[tid]
        if self.wire_batch > 1:
            # batched transport (wiser.proto SearchRequestBatch): one
            # message per N queries — the CPython-side cost is per
            # MESSAGE, so the closed loop measures the wire batch as one
            # roundtrip and counts N queries against it
            W = self.wire_batch

            def gen():
                while not self._stop.is_set():
                    b = pb.SearchRequestBatch()
                    for _ in range(W):
                        b.requests.append(
                            request_from_query(self.producer.next_query(tid)))
                    yield b

            t0 = time.monotonic_ns()
            for reply in stub.BatchSearch(gen()):
                t1 = time.monotonic_ns()
                if self._record.is_set():
                    hist.add(t1 - t0)
                    self.counts[tid] += len(reply.replies)
                t0 = t1
                if self._stop.is_set():
                    break
        elif self.streaming:
            reqs_done = threading.Event()

            def gen():
                while not self._stop.is_set():
                    yield request_from_query(self.producer.next_query(tid))
                reqs_done.set()

            # closed loop over a bidirectional stream: time per roundtrip
            t0 = time.monotonic_ns()
            for _reply in stub.StreamingSearch(gen()):
                t1 = time.monotonic_ns()
                if self._record.is_set():
                    hist.add(t1 - t0)
                    self.counts[tid] += 1
                t0 = t1
                if self._stop.is_set():
                    break
        else:
            while not self._stop.is_set():
                q = self.producer.next_query(tid)
                t0 = time.monotonic_ns()
                stub.UnarySearch(request_from_query(q))
                if self._record.is_set():
                    hist.add(time.monotonic_ns() - t0)
                    self.counts[tid] += 1

    def run(self) -> dict:
        threads = [threading.Thread(target=self._thread_fn, args=(i,))
                   for i in range(self.n_threads)]
        for t in threads:
            t.start()
        if not self._record.is_set():
            time.sleep(self.warmup_s)
            self._record.set()
        t0 = time.time()
        time.sleep(self.duration_s)
        self._stop.set()
        for t in threads:
            t.join(timeout=10)
        wall = time.time() - t0
        total = sum(self.counts)
        merged = Histogram.merged(self.hists)
        return {
            "qps": total / wall,
            "total": total,
            "wall_s": wall,
            "histogram": merged,
        }


def _proc_worker(target, queries, n_threads, streaming, duration,
                 n_channels, out_q, wire_batch=1, warmup_s=0.0) -> None:
    """One load-generating process (forked): runs a threaded Client and
    ships mergeable histogram state back over the queue."""
    producer = QueryProducer(queries, n_threads)
    client = Client(target, producer, n_threads=n_threads,
                    streaming=streaming, duration_s=duration,
                    n_channels=n_channels, wire_batch=wire_batch,
                    warmup_s=warmup_s)
    stats = client.run()
    h = stats["histogram"]
    out_q.put((stats["total"], stats["wall_s"],
               h.buckets, h.count, h.sum, h.min, h.max))


def run_multiprocess(target, queries, n_procs, n_threads, streaming,
                     duration, n_channels, wire_batch: int = 1,
                     warmup_s: float = 0.0) -> dict:
    """Closed-loop load from n_procs forked processes x n_threads streams.

    The reference client runs 128 C++ threads (grpc_client_impl.h:393-399);
    one CPython process is bounded by the GIL on proto+gRPC work, so
    offered concurrency scales with PROCESSES here. Each
    child returns its gpr-style histogram; buckets merge exactly."""
    import multiprocessing as mp

    ctx = mp.get_context("fork")  # queries shared copy-on-write
    out_q = ctx.Queue()
    procs = [ctx.Process(target=_proc_worker,
                         args=(target, queries, n_threads, streaming,
                               duration, n_channels, out_q, wire_batch,
                               warmup_s),
                         daemon=True)
             for _ in range(n_procs)]
    t0 = time.time()
    for p in procs:
        p.start()
    merged = Histogram()
    total = 0
    walls = []
    for _ in procs:
        t, w, buckets, count, s, mn, mx = out_q.get(
            timeout=duration + warmup_s + 120)
        total += t
        walls.append(w)
        other = Histogram()
        other.buckets = list(buckets)
        other.count, other.sum, other.min, other.max = count, s, mn, mx
        merged.merge(other)
    for p in procs:
        p.join(timeout=30)
    wall = max(walls) if walls else time.time() - t0
    return {"qps": total / wall, "total": total, "wall_s": wall,
            "histogram": merged, "n_procs": n_procs}


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description="wiser_tpu benchmark client")
    ap.add_argument("--target", default="localhost:50051")
    ap.add_argument("--query-log", required=True)
    ap.add_argument("--n-procs", type=int, default=1,
                    help="load-generating processes (GIL escape hatch)")
    ap.add_argument("--n-threads", type=int, default=8,
                    help="closed-loop streams per process")
    ap.add_argument("--n-channels", type=int, default=4)
    ap.add_argument("--duration", type=float, default=10.0)
    ap.add_argument("--n-results", type=int, default=10)
    ap.add_argument("--unary", action="store_true")
    ap.add_argument("--wire-batch", type=int, default=1,
                    help="queries per wire message (BatchSearch); 1 = "
                         "per-query streaming like the reference client")
    ap.add_argument("--warmup-s", type=float, default=0.0,
                    help="drive but don't record the first N seconds")
    args = ap.parse_args(argv)

    queries = QueryLogReader(args.query_log).read_all(n_results=args.n_results)
    if args.n_procs > 1:
        stats = run_multiprocess(
            args.target, queries, args.n_procs, args.n_threads,
            not args.unary, args.duration, args.n_channels,
            wire_batch=args.wire_batch, warmup_s=args.warmup_s)
    else:
        producer = QueryProducer(queries, args.n_threads)
        client = Client(args.target, producer, n_threads=args.n_threads,
                        streaming=not args.unary, duration_s=args.duration,
                        n_channels=args.n_channels,
                        wire_batch=args.wire_batch, warmup_s=args.warmup_s)
        stats = client.run()
    print(f"QPS\t{stats['qps']:.1f}")
    print(f"total\t{stats['total']}")
    print(format_latency_table(stats["histogram"]))


if __name__ == "__main__":
    main()
