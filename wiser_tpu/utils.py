"""Tracing/profiling utilities — the aux-subsystem analog of the
reference's gperftools hooks (vacuum_engine.h:173-179 ProfilerStart behind
-profile_vacuum, Makefile google-pprof targets) and its tab-separated
ResultTable output (utils.h:112-143).

- PhaseTimer: named wall-clock phases with a report table.
- trace(): context manager around jax.profiler for device traces viewable
  in XProf/TensorBoard (the CPU-profiler analog).
- ResultTable: tab-separated experiment rows.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import OrderedDict
from typing import Dict, List


# fixed in-checkout default: the cache directory is part of the cache key,
# so a path that moves between processes never hits
DEFAULT_COMPILE_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def enable_compile_cache() -> str:
    """Persistent XLA compilation cache shared by every entry point:
    `$JAX_COMPILATION_CACHE_DIR` when set, else DEFAULT_COMPILE_CACHE_DIR.
    Returns the directory used."""
    import jax

    cache_dir = (os.environ.get("JAX_COMPILATION_CACHE_DIR")
                 or DEFAULT_COMPILE_CACHE_DIR)
    os.makedirs(cache_dir, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return cache_dir


class PhaseTimer:
    def __init__(self):
        self.totals: "OrderedDict[str, float]" = OrderedDict()
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        rows = ["phase\ttotal_s\tcalls\tavg_ms"]
        for name, tot in self.totals.items():
            n = self.counts[name]
            rows.append(f"{name}\t{tot:.3f}\t{n}\t{1000*tot/n:.2f}")
        return "\n".join(rows)


@contextlib.contextmanager
def trace(log_dir: str):
    """Device trace capture (jax.profiler); view with xprof/tensorboard.
    The -profile_vacuum / ProfilerStart analog."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class ResultTable:
    """reference: utils::ResultTable/ResultRow (utils.h:112-143) —
    tab-separated rows with a header derived from the union of keys."""

    def __init__(self):
        self.rows: List[Dict[str, object]] = []

    def add_row(self, **kv) -> None:
        self.rows.append(kv)

    def to_str(self) -> str:
        cols: List[str] = []
        for r in self.rows:
            for k in r:
                if k not in cols:
                    cols.append(k)
        out = ["\t".join(cols)]
        for r in self.rows:
            out.append("\t".join(str(r.get(c, "NA")) for c in cols))
        return "\n".join(out)
