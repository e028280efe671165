"""Host-side viability probe for CANDIDATE-side block-max pruning of the
semidense route (the roadmap's "posting-block maxima + coarse doc-block
range-max" lever).

The semidense kernel's cost is L x (T-1) doc-indexed element gathers.
Compacting the candidate list to the
top-C 128-lane posting blocks by score upper bound would cut that to
C*128 x (T-1) — IF the prune guard (next_ub < k-th kept score, the
pruned-dense proof) passes often enough on real workloads. The all-head
sparse case measured ~95% flag rate at 1M (device.py routing note), so
this measures the achievable pass rate per workload class BEFORE any
kernel is built.

Three upper-bound variants per candidate posting block:
  oracle   — exact max total score in the block (selection upper bound:
             if even this fails the guard, pruning is dead here);
  g128     — cand block max + per-term range-max over the block's doc
             span at 128-doc blockmax granularity (implementable but
             costs a wide in-kernel gather per block);
  coarse   — same with the range-max at 8192-doc granularity (the cheap
             masked-max the kernel would actually run) + per-term GLOBAL
             max for non-dense (bs) others.

Pure numpy over the PackedIndex — no jax, no device.

Run: python -m wiser_tpu.tools.prune_probe --index .scale_cache/idx_c1m \
         [--n 200] [--C 32,64,128] [--k 10]

MEASURED VERDICT (idx_c1m, 2026-08-18): DEAD END at this corpus shape.
The dense tier's byte budget admits EVERY term with df >= dense_min
(1,586 rows at 1M; cap 1,878), so any semidense candidate has
df < 2,604 -> <= 21 posting blocks; mean candidate span in the only
non-empty class (tail_x_head_t2) was 6.8 blocks, prunable_frac 0.0 at
C=32. There is nothing to prune: the semidense gather cost is set by
the BUCKET padding (L up to 4096), not by giant candidate lists. The
mid-df/zipf classes are structurally empty because dense admission
subsumes the whole df >= 4096 range. Keep the probe: it re-answers the
question automatically for corpora whose dense tier IS budget-pruned
(e.g. >=20M docs, where the cutoff rises and big non-dense candidates
reappear).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


COARSE_DOCS = 8192  # 64 x 128-doc blocks per coarse cell


class Probe:
    def __init__(self, packed, columns="tc",
                 dense_budget_bytes=7 << 29):
        from wiser_tpu.scoring import Bm25Similarity

        self.packed = packed
        sim = Bm25Similarity(packed.avg_len)
        self.score32 = packed.partial_scores(sim.cache).astype(np.float32)
        n = packed.n_docs
        # replicate the engine's dense-tier admission (device.py
        # _build_dense_rows): eligible df >= max(floor, n/384), budget-
        # capped largest-df-first, int32 flat-index cap
        dense_min = max(1024, n // 384)
        rows = np.nonzero(packed.df >= dense_min)[0]
        n_pad = (n + 127) // 128 * 128
        row_bytes = 2 if columns == "tc" else 8
        cap = max(1, int(dense_budget_bytes // (n_pad * row_bytes)))
        cap = min(cap, (2**31 - 1) // n_pad - 1)
        if len(rows) > cap:
            rows = rows[np.argsort(packed.df[rows])[::-1][:cap]]
        self.dense = np.zeros(packed.n_terms, dtype=bool)
        self.dense[rows] = True
        self.n_pad = n_pad
        self.nb_docs = n_pad // 128
        self.ncoarse = (n_pad + COARSE_DOCS - 1) // COARSE_DOCS
        # per-term global max partial score (the bs-other bound)
        self.term_max = np.maximum.reduceat(
            self.score32, packed.term_starts[:-1].astype(np.int64))
        self._bm_cache: dict = {}

    def _blockmax(self, r):
        """(nb_docs,) 128-doc blockmax + (ncoarse,) coarse max for term r."""
        got = self._bm_cache.get(r)
        if got is not None:
            return got
        p = self.packed
        s, e = int(p.term_starts[r]), int(p.term_starts[r] + p.df[r])
        docs = p.postings_doc[s:e].astype(np.int64)
        sc = self.score32[s:e]
        bm = np.zeros(self.nb_docs, dtype=np.float32)
        np.maximum.at(bm, docs >> 7, sc)
        cm = np.zeros(self.ncoarse, dtype=np.float32)
        np.maximum.at(cm, docs // COARSE_DOCS, sc)
        if len(self._bm_cache) < 4096:
            self._bm_cache[r] = (bm, cm)
        return bm, cm

    def run_query(self, rows, k, Cs, eps3=3e-5):
        """-> dict per ub variant: {C: pass_bool}, plus stats."""
        p = self.packed
        dfs = p.df[rows]
        cslot = int(np.argmin(dfs))
        crow = rows[cslot]
        s0 = int(p.term_starts[crow])
        Lr = int(p.df[crow])
        cd = p.postings_doc[s0 : s0 + Lr].astype(np.int64)
        cs = self.score32[s0 : s0 + Lr].astype(np.float64)
        others = [r for t, r in enumerate(rows) if t != cslot]

        total = cs.copy()
        match = np.ones(Lr, dtype=bool)
        per_term_lane = []  # exact per-lane contribution for the oracle ub
        for r in others:
            s, e = int(p.term_starts[r]), int(p.term_starts[r] + p.df[r])
            run = p.postings_doc[s:e]
            lo = np.searchsorted(run, cd)
            found = (lo < (e - s)) & (run[np.minimum(lo, e - s - 1)] == cd)
            contrib = np.where(found, self.score32[s + np.minimum(lo, e - s - 1)], 0.0)
            per_term_lane.append((found, contrib))
            match &= found
            total += contrib
        mtotal = np.where(match, total, -np.inf)
        n_match = int(match.sum())

        nb = (Lr + 127) // 128
        pad = nb * 128 - Lr
        cd_p = np.pad(cd, (0, pad), constant_values=np.int64(2**31 - 1))
        cs_p = np.pad(cs, (0, pad), constant_values=-np.inf).reshape(nb, 128)
        mt_p = np.pad(mtotal, (0, pad), constant_values=-np.inf).reshape(nb, 128)
        valid = np.pad(np.ones(Lr, bool), (0, pad)).reshape(nb, 128)
        dmin = np.where(valid, cd_p.reshape(nb, 128), 2**31 - 1).min(axis=1)
        dmax = np.where(valid, cd_p.reshape(nb, 128), -1).max(axis=1)

        ub_oracle = mt_p.max(axis=1)
        cand_bm = np.where(valid, cs_p, -np.inf).max(axis=1)
        ub_g128 = cand_bm.copy()
        ub_coarse = cand_bm.copy()
        for r in others:
            if self.dense[r]:
                bm, cm = self._blockmax(r)
                blo, bhi = dmin >> 7, dmax >> 7
                clo, chi = dmin // COARSE_DOCS, dmax // COARSE_DOCS
                g128 = np.array([bm[a : b + 1].max(initial=0.0)
                                 for a, b in zip(blo, bhi)])
                gco = np.array([cm[a : b + 1].max(initial=0.0)
                                for a, b in zip(clo, chi)])
                ub_g128 += g128
                ub_coarse += gco
            else:
                tm = float(self.term_max[r])
                ub_g128 += tm
                ub_coarse += tm

        out = {}
        order_m = np.sort(mtotal)[::-1]
        for name, ub in (("oracle", ub_oracle), ("g128", ub_g128),
                         ("coarse", ub_coarse)):
            res = {}
            srt = np.argsort(ub)[::-1]  # block ids by ub desc
            for C in Cs:
                if nb <= C:
                    res[C] = True  # nothing pruned; trivially exact
                    continue
                sel = srt[:C]
                next_ub = ub[srt[C]]
                exam = mt_p[sel].reshape(-1)
                exam = exam[np.isfinite(exam)]
                if len(exam) < k:
                    res[C] = bool(next_ub <= 0.0)
                    continue
                kth = np.sort(exam)[::-1][k - 1]
                res[C] = bool(next_ub < kth * (1.0 - eps3))
            out[name] = res
        return out, dict(Lr=Lr, nb=nb, n_match=n_match,
                         kth=(float(order_m[k - 1]) if n_match >= k
                              else None))


def build_classes(packed, probe, n, k, seed=3):
    from wiser_tpu.types import SearchQuery  # noqa: F401  (query shapes only)

    rng = np.random.default_rng(seed)
    df = packed.df
    n_docs = packed.n_docs
    dense_rows = np.nonzero(probe.dense)[0]
    # mid-df candidates big enough that pruning matters (>= 32 blocks)
    mid = np.nonzero((df >= 4096) & (df < max(1024, n_docs // 384)))[0]
    tail = np.nonzero((df >= 256) & (df < 4096))[0]

    def pick(rows, m):
        return rows[rng.integers(0, len(rows), size=m)]

    classes = {}
    if len(mid) and len(dense_rows) >= 2:
        a = pick(mid, n)
        b, c = pick(dense_rows, n), pick(dense_rows, n)
        classes["midcand_x_2head_t3"] = [[x, y, z]
                                         for x, y, z in zip(a, b, c)]
        classes["midcand_x_head_t2"] = [[x, y] for x, y in zip(a, b)]
    if len(tail) and len(dense_rows):
        a, b = pick(tail, n), pick(dense_rows, n)
        classes["tail_x_head_t2"] = [[x, y] for x, y in zip(a, b)]
    order = np.argsort(df)[::-1].astype(np.int64)
    for nt in (3, 4):
        ranks = np.minimum(rng.zipf(1.25, size=(n * 3, nt)) - 1,
                           packed.n_terms - 1)
        rows_all = order[ranks]
        keep = []
        for rr in rows_all:
            rr = list(dict.fromkeys(int(x) for x in rr))
            if len(rr) < 2:
                continue
            cslot = int(np.argmin(df[rr]))
            others = [r for t, r in enumerate(rr) if t != cslot]
            if any(probe.dense[r] for r in others) \
                    and not all(probe.dense[r] for r in rr) \
                    and df[rr[cslot]] >= 4096:
                keep.append(rr)
            if len(keep) >= n:
                break
        if keep:
            classes[f"zipf_t{nt}_semidense_bigL"] = keep
    return classes


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--index", required=True)
    ap.add_argument("--n", type=int, default=200)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--C", default="32,64,128")
    ap.add_argument("--columns", default="tc")
    args = ap.parse_args(argv)
    Cs = [int(x) for x in args.C.split(",")]

    from wiser_tpu.index.format import PackedIndex

    packed = PackedIndex.load(args.index)
    probe = Probe(packed, columns=args.columns)
    log(f"index: {packed.n_docs} docs, {packed.n_terms} terms, "
        f"dense rows {int(probe.dense.sum())}")
    classes = build_classes(packed, probe, args.n, args.k)
    report = {}
    for name, queries in classes.items():
        counts = {v: {C: 0 for C in Cs} for v in ("oracle", "g128", "coarse")}
        prunable = 0
        tot_nb = 0
        for rows in queries:
            out, st = probe.run_query(rows, args.k, Cs)
            if st["nb"] > min(Cs):
                prunable += 1
            tot_nb += st["nb"]
            for v, res in out.items():
                for C, ok in res.items():
                    counts[v][C] += int(ok)
        nq = len(queries)
        report[name] = {
            "n": nq, "mean_blocks": round(tot_nb / max(nq, 1), 1),
            "prunable_frac": round(prunable / max(nq, 1), 3),
            "pass_rate": {v: {C: round(c / max(nq, 1), 3)
                              for C, c in cs.items()}
                          for v, cs in counts.items()},
        }
        log(f"{name}: {report[name]}")
    print(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
