#!/usr/bin/env python
"""Measure the read de-Bruijn ordering's effect on the native meta scorer
(VERDICT r3 #6): pt_score_simple wall time with identity order, RDG
component order, and a random shuffle, on the real rsv_4K meta index.

Run CPU-only:  JAX_PLATFORMS=cpu python tools/bench_rdg.py
"""

import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

from panmap_tpu.io.panman import load_panman  # noqa: E402
from panmap_tpu.meta.engine import MetaScorer, sketch_meta_reads_full  # noqa: E402
from panmap_tpu.meta.index import load_meta_index  # noqa: E402
from panmap_tpu.native import score_simple_native  # noqa: E402
from panmap_tpu.sketch.cpu import reverse_complement  # noqa: E402


def main():
    midx = load_meta_index(os.path.join(REPO, ".cache", "rsv4k.ptmidx.npz"))
    tree = load_panman("/root/reference/src/test/data/rsv_4K.panman")
    rng = np.random.default_rng(5)
    hap_ids = ["MZ515733.1", "MZ515704.1", "node_1330", "node_2500"]
    seqs = []
    for hid in hap_ids:
        g = tree.get_string(hid)
        for _ in range(6000):
            i = int(rng.integers(0, len(g) - 150))
            s = g[i:i + 150]
            seqs.append(reverse_complement(s) if rng.random() < 0.5 else s)
    p = midx.params
    reads, _, _ = sketch_meta_reads_full(seqs, p.k, p.s, p.t, p.l, p.open)
    scorer = MetaScorer(midx, reads)
    cands = sorted(rng.choice(len(midx.node_ids), 64, replace=False).tolist())

    lens = np.array([len(r.hashes) for r in reads], dtype=np.int64)
    read_off = np.concatenate(([0], np.cumsum(lens)))
    read_hash = np.concatenate([r.hashes for r in reads])
    read_rev = np.concatenate([np.asarray(r.revs, bool) for r in reads])

    def run_with(perm, label, reps=5):
        if perm is None:
            off, h, rv = read_off, read_hash, read_rev
        else:
            lp = lens[perm]
            starts = read_off[:-1][perm]
            csum = np.concatenate(([0], np.cumsum(lp)))
            g = (np.repeat(starts, lp)
                 + (np.arange(int(lp.sum())) - np.repeat(csum[:-1], lp)))
            off, h, rv = csum, read_hash[g], read_rev[g]
        best = 1e9
        for _ in range(reps):
            t0 = time.perf_counter()
            res = score_simple_native(scorer.midx, off, h, rv,
                                      scorer._relevant,
                                      np.asarray(cands, np.int64))
            best = min(best, time.perf_counter() - t0)
        assert res is not None
        ms = res[0]
        if perm is not None:
            out = np.empty_like(ms)
            out[perm] = ms
            ms = out
        print(f"  {label:10s} best-of-{reps}: {best*1000:8.1f} ms")
        return best, ms

    print(f"[rdg-bench] {len(reads)} unique read sets, "
          f"{len(read_hash)} seedmers, {len(midx.node_ids)} nodes, "
          f"{len(cands)} candidates")
    t0 = time.perf_counter()
    from panmap_tpu.meta.rdg import debruijn_read_order

    perm_rdg = debruijn_read_order(read_off, read_hash)
    t_build = time.perf_counter() - t0
    print(f"  rdg order build: {t_build*1000:.1f} ms")
    perm_shuf = rng.permutation(len(reads))

    t_id, ms_id = run_with(None, "identity")
    t_rdg, ms_rdg = run_with(perm_rdg, "rdg")
    t_shuf, ms_shuf = run_with(perm_shuf, "shuffle")
    assert np.array_equal(ms_id, ms_rdg) and np.array_equal(ms_id, ms_shuf)
    print(f"[rdg-bench] rdg vs identity: {t_id/t_rdg:.3f}x  "
          f"rdg vs shuffle: {t_shuf/t_rdg:.3f}x  "
          f"(build cost {t_build/t_rdg:.2f}x one scoring pass)")


if __name__ == "__main__":
    main()
