#!/usr/bin/env python
"""Scaling-efficiency harness: sharded placement scoring throughput at
1..N devices (BASELINE.json north star: reads/s at 1 chip / 1 host / N hosts).

On several GPUs (--real) this measures the mesh scaling: the seed-change row
table is sharded over the devices, per-node partial metric sums merge with a
psum (NCCL all-reduce over NVLink), reads shard data-parallel for sketching.
By default the harness runs on a virtual CPU mesh
(XLA_FLAGS=--xla_force_host_platform_device_count=8) — that validates the
sharding/collective program and reports its scaling *shape* (virtual devices
timeshare the host's cores, so absolute numbers are not device numbers).

Usage:
  bash -c 'JAX_PLATFORMS=cpu \
    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
    python tools/bench_scaling.py'          # virtual mesh
  python tools/bench_scaling.py --real      # real devices (all visible chips)
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

PANMAN = "/root/reference/examples/data/panmans/sars_20000_twilight_dipper.panman"
R1 = "/root/reference/examples/data/reads/isolate_R1.fastq.gz"
R2 = "/root/reference/examples/data/reads/isolate_R2.fastq.gz"
CACHE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     ".cache")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--real", action="store_true",
                    help="use real devices instead of requiring a virtual mesh")
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()

    import jax

    from panmap_tpu.io import fastq
    from panmap_tpu.io.index_io import load_index
    from panmap_tpu.parallel.mesh import (make_mesh, make_sharded_score_fn,
                                          pad_rows)
    from panmap_tpu.place.engine import prepare_read_sketch, sketch_reads

    devs = jax.devices()
    print(f"# backend={devs[0].platform} devices={len(devs)}", file=sys.stderr)

    idx = load_index(os.path.join(CACHE, "sars20000.ptidx.npz"))
    seqs = fastq.read_paired_for_placement(R1, R2)
    n_reads = len(seqs)
    p = idx.params
    freq = sketch_reads(seqs, p.k, p.s, p.t, p.l, p.open)
    sk = prepare_read_sketch(freq, p.k, n_reads)

    n_nodes = len(idx.node_offsets) - 1
    offs = idx.node_offsets.astype(np.int64)
    row_node = np.repeat(np.arange(n_nodes, dtype=np.int32),
                         np.diff(offs)).astype(np.int32)
    parent = idx.parent_index.astype(np.int64)
    # euler intervals for the prefix finish
    order = np.arange(n_nodes)
    sizes = np.ones(n_nodes, np.int64)
    for i in range(n_nodes - 1, 0, -1):
        sizes[parent[i]] += sizes[i]
    depth = np.zeros(n_nodes, np.int64)
    for i in range(1, n_nodes):
        depth[i] = depth[parent[i]] + 1
    euler_in = (2 * order - depth).astype(np.int32)
    euler_out = (euler_in + 2 * sizes - 1).astype(np.int32)

    # the sharded kernel joins on i32 ids; replace u64 hashes by their rank
    # in the sorted read table (identical join result)
    row_rank = np.searchsorted(sk.sorted_hashes, idx.seed_hashes)
    row_rank = np.minimum(row_rank, max(len(sk.sorted_hashes) - 1, 0))
    found = sk.sorted_hashes[row_rank] == idx.seed_hashes
    row_id = np.where(found, row_rank, -1).astype(np.int32)
    read_ids32 = np.arange(len(sk.sorted_hashes), dtype=np.int32)
    read_logc = sk.log_counts.astype(np.float32)

    results = []
    counts = []
    n = 1
    while n <= len(devs):
        counts.append(n)
        n *= 2
    if counts[-1] != len(devs):
        counts.append(len(devs))
    for nd in counts:
        mesh = make_mesh(nd)
        score = make_sharded_score_fn(mesh, n_nodes)
        rp = pad_rows(idx.parent_counts.astype(np.float32), nd)
        rc = pad_rows(idx.child_counts.astype(np.float32), nd)
        ri = pad_rows(row_id, nd, fill=-1)
        rn = pad_rows(row_node, nd)
        argv = (ri, rp, rc, rn, euler_in, euler_out, read_ids32, read_logc)
        out = score(*argv)
        out.block_until_ready()  # compile + warmup
        times = []
        for _ in range(args.repeats):
            t0 = time.time()
            out = score(*argv)
            out.block_until_ready()
            times.append(time.time() - t0)
        dt = min(times)
        rps = n_reads / dt
        results.append((nd, dt, rps))
        base = results[0][2]
        eff = rps / (base * nd)
        print(f"devices={nd:2d}  score_step={dt*1e3:8.1f} ms  "
              f"reads/s={rps:12,.0f}  scaling_eff={eff:.2f}", file=sys.stderr)
    print(json.dumps({
        "metric": "sharded_score_scaling",
        "backend": devs[0].platform,
        "points": [{"devices": nd, "step_s": round(dt, 4),
                    "reads_per_s": round(rps, 1)} for nd, dt, rps in results],
    }))


if __name__ == "__main__":
    main()
