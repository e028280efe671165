"""Exhaustive device-vs-host parity audit at scale (VERDICT item: replace
the sampled-parity probabilistic argument with measured evidence).

Runs N queries per config through the engine in strict_parity mode (every
FLAG_TRUNC boundary-class truncation takes the exact host path, not just
provably-unsafe flags) AND verifies every result against the exact host
search (memoized — repeated queries are cheap). Reports, per config:

  - mismatches (must be 0)
  - flag rates per route-visible flag class (trunc / tf_sat / prune_miss /
    overflow), measured by instrumenting the engine's force-host decisions
  - the measured throughput cost of strict_parity vs default mode

The reference's equivalence doctrine (SURVEY.md §4: QQMem-vs-Vacuum
identical top-k) applied at 1M-doc scale with six-figure query counts.

Run:
  python -m wiser_tpu.tools.parity_audit --index .scale_cache/idx_c1m \
      --linedoc .scale_cache/c1m.linedoc --n-queries 100000 \
      --out PARITY_1M.json
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


class FlagCounter:
    """Wraps TpuEngine._flags_to_force to count per-class flag rates."""

    def __init__(self, engine):
        from wiser_tpu.engine import kernels as K

        self.engine = engine
        self.counts = {"trunc": 0, "overflow": 0, "tf_sat": 0,
                       "prune_miss": 0, "forced": 0, "total": 0}
        self._orig = engine._flags_to_force
        self._K = K

    def __enter__(self):
        K = self._K
        counts = self.counts
        orig = self._orig

        def counted(flags):
            flags = np.asarray(flags)
            counts["total"] += len(flags)
            counts["trunc"] += int(((flags & K.FLAG_TRUNC) != 0).sum())
            counts["overflow"] += int(((flags & K.FLAG_OVERFLOW) != 0).sum())
            counts["tf_sat"] += int(((flags & K.FLAG_TF_SAT) != 0).sum())
            counts["prune_miss"] += int(
                ((flags & K.FLAG_PRUNE_MISS) != 0).sum())
            force = orig(flags)
            counts["forced"] += int(np.asarray(force).sum())
            return force

        self.engine._flags_to_force = counted
        return self

    def __exit__(self, *exc):
        self.engine._flags_to_force = self._orig
        return False


def verify_config(engine, packed, queries, batch):
    """Run all queries batched; verify EVERY result against the exact
    host search. Returns (mismatches, wall_s, examples)."""
    from wiser_tpu.engine.device import host_exact_search

    t0 = time.time()
    results = []
    for i in range(0, len(queries), batch):
        results.extend(engine.search_batch(queries[i : i + batch]))
    wall = time.time() - t0

    host_memo = {}
    bad = 0
    examples = []
    for q, got in zip(queries, results):
        rows = tuple(packed.lookup(t) for t in q.terms)
        if min(rows) < 0:
            if got.entries:
                bad += 1
            continue
        key = (rows, q.n_results, q.is_phrase and len(rows) >= 2)
        want = host_memo.get(key)
        if want is None:
            d, s = host_exact_search(packed, engine.cache64, list(rows),
                                     q.n_results, is_phrase=key[2])
            want = list(zip(d.tolist(), s.tolist()))
            host_memo[key] = want
        have = [(e.doc_id, e.doc_score) for e in got.entries]
        if want != have:
            bad += 1
            if len(examples) < 5:
                examples.append({"terms": q.terms, "phrase": q.is_phrase,
                                 "want": want[:3], "have": have[:3]})
    return bad, wall, examples


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--index", required=True)
    ap.add_argument("--linedoc", default=None)
    ap.add_argument("--n-queries", type=int, default=100_000)
    ap.add_argument("--batch", type=int, default=16384)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--columns", default="raw", choices=["raw", "tc"])
    ap.add_argument("--configs", default=None)
    ap.add_argument("--compare-default", action="store_true",
                    help="also time default (non-strict) mode for the "
                         "strict-mode cost row")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from wiser_tpu.utils import enable_compile_cache

    enable_compile_cache()
    import jax

    log(f"devices: {jax.devices()}")
    from wiser_tpu.engine.device import TpuEngine
    from wiser_tpu.index.format import PackedIndex
    from wiser_tpu.tools.scale_bench import build_configs

    packed = PackedIndex.load(args.index)
    engine = TpuEngine(packed, columns=args.columns, strict_parity=True)
    log(f"strict-parity engine up; device bytes "
        f"{json.dumps(engine.device_bytes())}")
    configs = build_configs(packed, args.linedoc, args.n_queries, args.k)
    if args.configs:
        keep = set(args.configs.split(","))
        configs = {k: v for k, v in configs.items() if k in keep}

    summary = {"index": args.index, "columns": args.columns,
               "strict_parity": True, "n_queries": args.n_queries,
               "configs": {}}
    for name, queries in configs.items():
        log(f"== {name}: {len(queries)} queries (strict, exhaustive host "
            f"verify) ==")
        # warmup/compile pass
        for i in range(0, len(queries), args.batch):
            engine.search_batch(queries[i : i + args.batch])
        with FlagCounter(engine) as fc:
            bad, wall, examples = verify_config(
                engine, packed, queries, args.batch)
        row = {
            "n_queries": len(queries),
            "unique": len({(tuple(q.terms), q.n_results, q.is_phrase)
                           for q in queries}),
            "mismatches": bad,
            "strict_qps": round(len(queries) / wall, 1),
            "flags": dict(fc.counts),
        }
        if examples:
            row["examples"] = examples
        if args.compare_default:
            eng2 = getattr(main, "_default_engine", None)
            if eng2 is None:
                eng2 = TpuEngine(packed, columns=args.columns,
                                 strict_parity=False)
                main._default_engine = eng2
            for i in range(0, len(queries), args.batch):  # warmup
                eng2.search_batch(queries[i : i + args.batch])
            t0 = time.time()
            for i in range(0, len(queries), args.batch):
                eng2.search_batch(queries[i : i + args.batch])
            row["default_qps"] = round(len(queries) / (time.time() - t0), 1)
        summary["configs"][name] = row
        log(json.dumps({name: row}))
        if args.out:
            with open(args.out, "w") as f:
                json.dump(summary, f, indent=1)

    print(json.dumps(summary))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)


if __name__ == "__main__":
    main()
