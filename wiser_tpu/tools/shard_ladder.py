"""Sharded-engine ladder on the virtual CPU mesh — correctness evidence
for the config-5 mesh path at reference scale (BASELINE.json config 5).

Runs the BASELINE query configs through ShardedEngine over an 8-shard
document partition of a prebuilt PackedIndex, on
xla_force_host_platform_device_count CPU devices, and verifies BIT
parity against the exact host search per sampled query. QPS on a
CPU mesh is meaningless (one physical core); the published result is
route coverage + parity counts. The same code path on four GPUs runs
in `python chip_smoke.py --four`.

Run: XLA_FLAGS=--xla_force_host_platform_device_count=8 \
     JAX_PLATFORMS=cpu python -m wiser_tpu.tools.shard_ladder \
       --index .scale_cache/idx_c1m --linedoc .scale_cache/c1m.linedoc \
       --n-queries 2048 --out SHARD_LADDER_1M.json
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--index", required=True)
    ap.add_argument("--linedoc", default=None)
    ap.add_argument("--n-shards", type=int, default=8)
    ap.add_argument("--n-queries", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--parity-sample", type=int, default=100)
    ap.add_argument("--dense-budget", type=int, default=1 << 30)
    ap.add_argument("--columns", default="raw", choices=["raw", "tc"])
    ap.add_argument("--configs", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import os

    if "cpu" not in os.environ.get("JAX_PLATFORMS", ""):
        log("note: forcing jax_platforms=cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    if len(jax.devices()) < args.n_shards:
        raise SystemExit(
            f"need XLA_FLAGS=--xla_force_host_platform_device_count="
            f"{args.n_shards} BEFORE jax import (got "
            f"{len(jax.devices())} devices)")

    from wiser_tpu.engine.device import host_exact_search
    from wiser_tpu.engine.shard import ShardedEngine, ShardedIndex
    from wiser_tpu.index.format import PackedIndex
    from wiser_tpu.tools.scale_bench import build_configs

    t0 = time.time()
    packed = PackedIndex.load(args.index)
    log(f"index loaded in {time.time()-t0:.1f}s")
    t0 = time.time()
    sharded = ShardedIndex.from_packed(packed, args.n_shards)
    engine = ShardedEngine(sharded, dense_budget_bytes=args.dense_budget,
                           columns=args.columns)
    log(f"sharded engine up in {time.time()-t0:.1f}s "
        f"(dense_H={engine._dense_H}, columns={args.columns})")

    configs = build_configs(packed, args.linedoc, args.n_queries, 10)
    if args.configs:
        keep = set(args.configs.split(","))
        configs = {k: v for k, v in configs.items() if k in keep}

    rng = np.random.default_rng(11)
    results = {}
    summary = {"index": args.index, "n_docs": packed.n_docs,
               "n_shards": args.n_shards,
               "mesh_devices": len(jax.devices()),
               "dense_H": int(engine._dense_H),
               "columns": args.columns,
               "configs": results}
    for name, queries in configs.items():
        log(f"== {name}: {len(queries)} queries ==")
        t0 = time.time()
        res = []
        for i in range(0, len(queries), args.batch):
            res += engine.search_batch(queries[i : i + args.batch])
        wall = time.time() - t0
        bad = 0
        idx = rng.choice(len(queries),
                         size=min(args.parity_sample, len(queries)),
                         replace=False)
        for i in idx:
            q = queries[int(i)]
            rows = [packed.lookup(t) for t in q.terms]
            if min(rows) < 0:
                continue
            d, s = host_exact_search(
                packed, engine.cache64, rows, q.n_results,
                is_phrase=q.is_phrase and len(rows) >= 2)
            want = list(zip(d.tolist(), s.tolist()))
            have = [(e.doc_id, e.doc_score) for e in res[int(i)].entries]
            if want != have:
                bad += 1
                log(f"PARITY MISMATCH {q.terms} phrase={q.is_phrase}\n"
                    f"  want={want[:3]}\n  have={have[:3]}")
        results[name] = {
            "n_queries": len(queries),
            # round to ms: config 1 (single-term, impact-table-served)
            # reads 0.0 at 1 decimal
            "wall_s": round(wall, 3),
            "parity_mismatches": int(bad),
            "parity_sample": len(idx),
        }
        log(json.dumps({name: results[name]}))
        if args.out:
            with open(args.out, "w") as f:
                json.dump(summary, f, indent=1)

    print(json.dumps(summary))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)


if __name__ == "__main__":
    main()
