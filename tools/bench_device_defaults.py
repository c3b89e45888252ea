#!/usr/bin/env python
"""Each device default on a GPU, timed against its host alternative.

1. Short-read DP stage (align/batch.py): the native front-end defers the
   reads that need the full-window DP; the device stage scores those windows,
   drops the ones below MIN_DP_MAX and leaves the survivors' CIGARs to the
   host DP.  Times the synchronous align stage on N deferred reads, all-host
   against the device stage, with the survivor share that bounds what the
   device can save, on a sample with planted indels and on the least a read
   needs to be deferred (two 25-base genome pieces in random filler); then the
   pipeline's alignment stage with the device stage on and off, in turns.
2. Long-read DP (align/long_device.py): ONT-like reads, device (first call
   with compile, then warm) against the host DP.

    python tools/bench_device_defaults.py [--seed 7]

Needs a GPU; prints the card's name and power limit beside the numbers.
"""

import argparse
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _median_time(fn, reps=5):
    fn()  # warm: compiles each shape tier once
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def _two_piece_reads(ref, n, seed):
    """150-base reads of random filler holding two 25-base genome pieces on
    nearby diagonals: seed hits on two diagonals, so the front-end defers
    them, with as few matching bases as a deferred read can have."""
    rng = np.random.default_rng(seed)
    g = np.frombuffer(ref.encode(), np.uint8)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    out = []
    for _ in range(n):
        r = acgt[rng.integers(0, 4, 150)]
        p = int(rng.integers(1000, len(g) - 1000))
        d = int(rng.integers(3, 40))
        r[10:35] = g[p:p + 25]
        r[80:105] = g[p + 70 + d:p + 95 + d]
        out.append(r.tobytes().decode())
    return out


def bench_dp_stage(work, seed, card):
    """Part 1."""
    from panmap_tpu import synth
    from panmap_tpu.align.batch import BatchAligner
    from panmap_tpu.io import fastq
    from panmap_tpu.native import align_sr_native
    from panmap_tpu.pipeline import PipelineConfig, run_alignment

    tree = synth.make_tree(seed, 50, 30000)
    leaf = synth.leaf_names(tree)[0]
    ref = tree.get_string(leaf)
    genome, _ = synth.sample_genome(tree, leaf, 10, seed, n_indels=40)
    p1, p2 = synth.write_pairs(os.path.join(work, "s"),
                               *synth.simulate_pairs(genome, 51169, seed))
    _, seqs, _ = fastq.read_paired_for_alignment(p1, p2)
    a = BatchAligner(ref)
    for label, pool in (("planted-indel sample", seqs),
                        ("two-piece construction",
                         _two_piece_reads(ref, 20000, seed))):
        res = align_sr_native(pool, a.index.codes2, a.index.h, a.index.pos,
                              a.index.strand, a.k, a.w, defer_dp=True)
        deferred = np.flatnonzero(res["mapped"] == 3)
        print(f"[dp] {label}: {len(pool)} reads, {len(deferred)} deferred "
              f"windows [{card}]", flush=True)
        sizes = (16, 64, 256, 1024, len(deferred)) if label[0] == "p" \
            else (len(deferred),)
        for n in sizes:
            if n == 0:
                continue
            sub = [pool[i] for i in deferred[:n]]
            host = BatchAligner(ref)
            host.device_mode = None
            dev = BatchAligner(ref)
            dev.device_mode = "device"
            dev.MIN_DEVICE_WINDOWS = 0
            t_host = _median_time(lambda: host.align_batch_arrays(sub))
            dev.device_stats = None
            t_dev = _median_time(lambda: dev.align_batch_arrays(sub))
            st = dev.device_stats
            print(f"[dp] {label} N={n}: all-host {t_host * 1e3:.2f} ms, "
                  f"device stage {t_dev * 1e3:.2f} ms (device wait "
                  f"{st['device_s'] / 6 * 1e3:.2f} ms/run), survivors "
                  f"{st['survivors'] / 6:.0f}/{n} [{card}]", flush=True)

    cfg = PipelineConfig(reads1=p1, reads2=p2,
                         output=os.path.join(work, "out"))
    cfg.log = lambda *a, **k: None
    floors = {"device stage on": 0, "device stage off": 1 << 30}
    times = {k: [] for k in floors}
    for rep in range(4):
        for name in (floors if rep % 2 == 0 else reversed(list(floors))):
            BatchAligner.MIN_DEVICE_WINDOWS = floors[name]
            t0 = time.perf_counter()
            run_alignment(cfg, tree, leaf)
            times[name].append(time.perf_counter() - t0)
    for name, ts in times.items():
        print(f"[dp] pipeline alignment stage, {name}: median "
              f"{np.median(ts[1:]) * 1e3:.1f} ms over {len(ts) - 1} runs "
              f"(first {ts[0] * 1e3:.1f} ms) [{card}]", flush=True)


def bench_long(seed, card, n_reads=16):
    """Part 2."""
    from chip_smoke import _ont_read
    from panmap_tpu import synth
    from panmap_tpu.align.long_device import long_dp_device_batch
    from panmap_tpu.align.longread import (MAP_ONT, LongReadAligner,
                                           banded_dp_shifted)

    tree = synth.make_tree(seed, 4, 60000)
    genome = tree.get_string(synth.leaf_names(tree)[0])
    al = LongReadAligner(genome, MAP_ONT)
    rng = np.random.default_rng(seed)
    fronts = [al._chain_front(_ont_read(rng, genome, int(n)))
              for n in rng.integers(5000, 20001, n_reads)]
    items = [f[:3] for f in fronts if f is not None]
    codes = al.index.codes2
    t0 = time.perf_counter()
    dev = long_dp_device_batch(items, codes, MAP_ONT)
    t_first = time.perf_counter() - t0
    t_warm = _median_time(lambda: long_dp_device_batch(items, codes,
                                                       MAP_ONT), reps=3)
    t0 = time.perf_counter()
    host = [banded_dp_shifted(q, codes, a, b, MAP_ONT) for q, a, b in items]
    t_host = time.perf_counter() - t0
    same = sum(h == g for h, g in zip(host, dev))
    print(f"[long] {len(items)} ONT-like reads of 5-20 kb: exact "
          f"{same}/{len(items)}; device {t_warm:.3f} s warm, {t_first:.2f} s "
          f"first call incl. compile; host DP {t_host:.2f} s [{card}]",
          flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=7)
    opts = ap.parse_args()
    import jax

    if jax.devices()[0].platform != "gpu":
        print("no GPU: nothing to measure")
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    with tempfile.TemporaryDirectory() as work:
        bench_dp_stage(work, opts.seed, card)
        bench_long(opts.seed, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
