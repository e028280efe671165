"""Spawn a server, wait for readiness, run the benchmark client, report —
reference: tools/run_client_server2.py (and the two-node runners; pass
--server-host to drive a remote server instead of spawning one).

Run: python -m wiser_tpu.tools.run_client_server --index <dir> \
       --query-log q.txt [--port 50931] [--n-threads 16] [--duration 15]
     python -m wiser_tpu.tools.run_client_server --server-host node2:50051 \
       --query-log q.txt
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time


def wait_ready(target: str, timeout_s: float = 900.0) -> bool:
    import grpc

    from wiser_tpu.serve import wiser_pb2 as pb
    from wiser_tpu.serve.protocol import WiserEngineStub

    deadline = time.time() + timeout_s
    stub = WiserEngineStub(grpc.insecure_channel(target))
    while time.time() < deadline:
        try:
            stub.Echo(pb.EchoData(message="ping"), timeout=2)
            return True
        except Exception:
            time.sleep(1.0)
    return False


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--index")
    ap.add_argument("--query-log", required=True)
    ap.add_argument("--server-host", help="use an already-running server")
    ap.add_argument("--port", type=int, default=50931)
    ap.add_argument("--n-procs", type=int, default=1,
                    help="client processes (GIL escape; see serve.client)")
    ap.add_argument("--n-threads", type=int, default=16)
    ap.add_argument("--duration", type=float, default=15.0)
    ap.add_argument("--warmup-log", default=None)
    ap.add_argument("--columns", default="raw", choices=["raw", "tc"])
    ap.add_argument("--coarse-buckets", action="store_true")
    ap.add_argument("--wire-batch", type=int, default=1,
                    help="queries per wire message (see serve.client)")
    # latency-oriented server knobs: a shallow executor batch + a short
    # drain window trade peak QPS for per-query latency (the reference
    # client's operating point is per-query roundtrips,
    # grpc_client_impl.h:476-489)
    ap.add_argument("--max-batch", type=int, default=4096,
                    help="server executor batch ceiling")
    ap.add_argument("--max-wait-ms", type=float, default=20.0,
                    help="server executor drain window")
    ap.add_argument("--io-mode", default="both",
                    choices=["off", "dispatch", "fetch", "both"],
                    help="server engine dispatch/fetch overlap pools")
    ap.add_argument("--warmup-s", type=float, default=0.0,
                    help="closed-loop steady-state window: drive but don't "
                         "record the first N seconds (channel setup + "
                         "first-batch transients otherwise land in p99+)")
    ap.add_argument("--out", default=None, help="write the stats JSON here")
    args = ap.parse_args(argv)

    proc = None
    if args.server_host:
        target = args.server_host
    else:
        target = f"localhost:{args.port}"
        cmd = [sys.executable, "-m", "wiser_tpu.serve.server",
               "--index", args.index, "--port", str(args.port),
               "--columns", args.columns,
               "--n-threads", str(max(args.n_procs * args.n_threads * 2, 64)),
               "--max-batch", str(args.max_batch),
               "--max-wait-ms", str(args.max_wait_ms),
               "--io-mode", args.io_mode]
        if args.coarse_buckets:
            cmd += ["--coarse-buckets"]
        if args.warmup_log or args.query_log:
            cmd += ["--warmup-log", args.warmup_log or args.query_log]
        proc = subprocess.Popen(cmd, stderr=subprocess.DEVNULL)
        print(f"spawned server pid {proc.pid}", file=sys.stderr)

    try:
        if not wait_ready(target):
            print("server never became ready", file=sys.stderr)
            sys.exit(1)
        from wiser_tpu.bench.query_pool import QueryLogReader, QueryProducer
        from wiser_tpu.serve.client import Client, run_multiprocess

        queries = QueryLogReader(args.query_log).read_all(n_results=10)
        if args.n_procs > 1:
            stats = run_multiprocess(target, queries, args.n_procs,
                                     args.n_threads, True, args.duration, 4,
                                     wire_batch=args.wire_batch,
                                     warmup_s=args.warmup_s)
        else:
            client = Client(target, QueryProducer(queries, args.n_threads),
                            n_threads=args.n_threads, duration_s=args.duration,
                            wire_batch=args.wire_batch,
                            warmup_s=args.warmup_s)
            stats = client.run()
        h = stats.pop("histogram")
        from wiser_tpu.bench.histogram import PERCENTILES, format_latency_table

        # full reference-shaped table: percentiles 0/25/50/75/90/95/99/100
        # of the per-ROUNDTRIP latency (per-QUERY when --wire-batch 1)
        stats["latency_us"] = {f"p{p}": round(h.percentile(p) / 1e3, 1)
                               for p in PERCENTILES}
        stats["latency_mean_us"] = round(h.mean() / 1e3, 1)
        stats["wire_batch"] = args.wire_batch
        stats["max_batch"] = args.max_batch
        stats["max_wait_ms"] = args.max_wait_ms
        stats["warmup_s_excluded"] = args.warmup_s
        print(format_latency_table(h), file=sys.stderr)
        print(json.dumps(stats))
        if args.out:
            with open(args.out, "w") as f:
                json.dump(stats, f, indent=1)
    finally:
        if proc is not None:
            proc.terminate()
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()  # e.g. still inside the warmup loop
                proc.wait(timeout=10)


if __name__ == "__main__":
    main()
