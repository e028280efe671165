"""Micro-probe: semidense doc-indexed gather alternatives on the device.

The semidense kernel's per-lane membership test is ONE element gather
into a (H, N_pad) dense score row per dense other
(kernels.make_semidense_kernel). Which form of that lookup is fastest
depends on the device's element- vs row-gather rates — this probe
measures the candidates for reformulating the lookup before committing a
kernel rewrite:

  a. element          — today's gather (baseline)
  b. rowgather_onehot — gather the 128-wide doc block per lane, select
                        within-block via a one-hot contraction
  c. rowgather_local  — gather the doc block per lane, select via
                        take_along_axis into the (B, L, 128) tensor
  d. allblock_scan    — no gather: scan ALL doc blocks of the row and
                        one-hot match per candidate (the dense-kernel
                        shape, N-dependent)

Run: python -m wiser_tpu.tools.gather_probe [--n-pad 1000448] [--L 8192]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-pad", type=int, default=1_000_448)
    ap.add_argument("--B", type=int, default=128)
    ap.add_argument("--L", type=int, default=8192)
    ap.add_argument("--reps", type=int, default=8)
    args = ap.parse_args(argv)

    from wiser_tpu.utils import enable_compile_cache

    enable_compile_cache()
    import jax
    import jax.numpy as jnp

    log("devices:", jax.devices())
    B, L, N = args.B, args.L, args.n_pad
    NB = N // 128
    rng = np.random.default_rng(0)
    dense = rng.random((N,), dtype=np.float32)
    # ascending per-row candidate docs (the semidense layout)
    docs = np.sort(rng.integers(0, N, size=(B, L)), axis=1).astype(np.int32)
    d_dense = jax.device_put(jnp.asarray(dense))
    d_docs = jax.device_put(jnp.asarray(docs))

    def run(name, fn):
        out = np.asarray(fn(d_dense, d_docs))  # compile + warm
        t0 = time.time()
        for _ in range(args.reps):
            out = np.asarray(fn(d_dense, d_docs))
        dt = (time.time() - t0) / args.reps
        log(f"{name}: {dt*1e3:.1f} ms  ({B*L/dt/1e9:.2f} G lane/s)  "
            f"checksum {float(out.sum()):.1f}")
        return dt

    @jax.jit
    def element(dense, docs):
        return jnp.take(dense, docs, axis=0)

    @jax.jit
    def rowgather_onehot(dense, docs):
        blocks = dense.reshape(NB, 128)
        blk = docs >> 7
        off = docs & 127
        w = jnp.take(blocks, blk, axis=0)  # (B, L, 128) row gathers
        oh = (off[..., None] == jnp.arange(128, dtype=jnp.int32)
              ).astype(jnp.float32)
        return jnp.einsum("blk,blk->bl", w, oh,
                          preferred_element_type=jnp.float32)

    @jax.jit
    def rowgather_local(dense, docs):
        blocks = dense.reshape(NB, 128)
        blk = docs >> 7
        off = docs & 127
        w = jnp.take(blocks, blk, axis=0)
        return jnp.take_along_axis(w, off[..., None], axis=2)[..., 0]

    @jax.jit
    def allblock_scan(dense, docs):
        # (B, L) lanes x NB blocks is too big; emulate the dense-kernel
        # cost instead: full row scan + segment reduce per 128-block.
        blocks = dense.reshape(NB, 128)
        s = jnp.sum(blocks, axis=1)
        blk = docs >> 7
        return jnp.take(s, blk, axis=0)

    run("element         ", element)
    run("rowgather_onehot", rowgather_onehot)
    run("rowgather_local ", rowgather_local)
    run("blocksum_gather ", allblock_scan)


if __name__ == "__main__":
    main()
