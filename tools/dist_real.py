#!/usr/bin/env python
"""Multi-process checks on REAL data (VERDICT r3 #3).

Unlike tools/dist_smoke.py (synthetic 7-node table), this drives the
PRODUCTION placement path — TpuPlacer.place_exact over a global 2-process x
4-virtual-device mesh — on the real rsv_4K index and the MZ515733.1 read set,
and asserts in EVERY process that the result is byte-identical to the
single-process f64 host engine (engine.score_nodes): same best node, same
best score, same tie set, for all five metrics.

Usage:  python tools/dist_real.py [nprocs] [devices-per-proc] [index.npz] [reads]
        python tools/dist_real.py [nprocs] [devs] --em     (sharded EM check)
Child:  python tools/dist_real.py --child <pid> <nprocs> <devs> <port> <index> <reads>

The index is built on demand (once, parent process, host-only) when the
cache file is absent.
"""

import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_IDX = os.path.join(REPO, ".cache", "rsv4k.ptidx.npz")
DEFAULT_READS = "/root/reference/src/test/data/MZ515733.1.fastq"
PANMAN = "/root/reference/src/test/data/rsv_4K.panman"


def _ensure_index(path: str):
    if os.path.exists(path):
        return
    sys.path.insert(0, REPO)
    from panmap_tpu.index.builder import IndexParams, build_index
    from panmap_tpu.io.index_io import save_index
    from panmap_tpu.io.panman import load_panman

    os.makedirs(os.path.dirname(path), exist_ok=True)
    save_index(path, build_index(load_panman(PANMAN), IndexParams()))


def child_em(pid: int, nprocs: int, devs: int, port: int, reads: str) -> int:
    """Sharded SQUAREM EM over the GLOBAL multi-process mesh on a REAL
    score matrix (rsv_4K meta index + the MZ515733.1 read set).  The check
    is sharding-invariance: the same fused EM body over the global
    2-process mesh must match a process-LOCAL mesh run of the same body
    (what multi-processing could break is the psum'd E-step, not the EM
    semantics — those have their own oracles)."""
    import jax

    jax.distributed.initialize(coordinator_address=f"localhost:{port}",
                               num_processes=nprocs, process_id=pid)
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    sys.path.insert(0, REPO)
    from panmap_tpu.io import fastq
    from panmap_tpu.meta.engine import MetaScorer, sketch_meta_reads_full
    from panmap_tpu.meta.index import load_meta_index
    from panmap_tpu.parallel.mesh import make_mesh, make_sharded_em_full_fn

    midx = load_meta_index(os.path.join(REPO, ".cache", "rsv4k.ptmidx.npz"))
    seqs = fastq.read_paired_for_placement(reads, None)
    p = midx.params
    rd, _dup, _ = sketch_meta_reads_full(seqs, p.k, p.s, p.t, p.l, p.open)
    scorer = MetaScorer(midx, rd)
    oc = scorer.overlap_coefficients()
    cands = sorted(oc, key=lambda n: -oc[n])[:64]
    ms, snap = scorer.score_all(cands)
    lens = np.array([len(r.hashes) for r in rd], dtype=np.int64)
    w = np.array([r.n_dup for r in rd], dtype=np.float64)
    w[ms == 0] = 0.0

    mesh = make_mesh()  # ALL global devices
    nd = int(mesh.devices.size)
    R = len(rd)
    Rpad = -(-R // nd) * nd
    S = np.zeros((Rpad, len(cands)), np.uint16)
    S[:R] = snap.T
    lens_p = np.zeros(Rpad, np.int32)
    lens_p[:R] = lens
    w_p = np.zeros(Rpad, np.float32)
    w_p[:R] = w
    alive = np.ones(len(cands), bool)

    # reference: the SAME body over this process's local mesh
    lmesh = make_mesh(local=True)
    fn_l = make_sharded_em_full_fn(lmesh, eta=1e-5, max_rounds=1)
    lsh = NamedSharding(lmesh, P("data"))
    lrep = NamedSharding(lmesh, P())
    import jax.numpy as jnp

    props_l, _al, it_l = fn_l(
        jax.device_put(jnp.asarray(S), lsh),
        jax.device_put(jnp.asarray(lens_p), lsh),
        jax.device_put(jnp.asarray(w_p), lsh),
        jax.device_put(jnp.asarray(alive), lrep))
    want = np.asarray(props_l.addressable_shards[0].data)

    fn_g = make_sharded_em_full_fn(mesh, eta=1e-5, max_rounds=1)
    gsh = NamedSharding(mesh, P("data"))
    grep = NamedSharding(mesh, P())

    def g(x, sh):
        return jax.make_array_from_callback(x.shape, sh, lambda i: x[i])

    props_g, _ag, it_g = fn_g(g(S, gsh), g(lens_p, gsh), g(w_p, gsh),
                              g(alive, grep))
    got = np.asarray(props_g.addressable_shards[0].data)
    err = float(np.max(np.abs(got - want)))
    ok = err < 1e-5 and int(it_g) == int(it_l)
    print(f"[child {pid}] EM devices={len(jax.devices())} reads={R} "
          f"cands={len(cands)} iters={int(it_g)}/{int(it_l)} "
          f"max_err={err:.2e} {'OK' if ok else 'MISMATCH'}", flush=True)
    return 0 if ok else 1


def child(pid: int, nprocs: int, devs: int, port: int, idx_path: str,
          reads: str) -> int:
    import jax

    jax.distributed.initialize(coordinator_address=f"localhost:{port}",
                               num_processes=nprocs, process_id=pid)
    import numpy as np

    sys.path.insert(0, REPO)
    from panmap_tpu.io import fastq
    from panmap_tpu.io.index_io import load_index
    from panmap_tpu.parallel.mesh import make_mesh
    from panmap_tpu.place.engine import (
        METRICS,
        prepare_read_sketch,
        score_nodes,
        sketch_reads,
    )
    from panmap_tpu.place.query_tpu import TpuPlacer

    ndev = len(jax.devices())
    assert ndev == nprocs * devs, (ndev, nprocs, devs)
    idx = load_index(idx_path)
    seqs = fastq.read_paired_for_placement(reads, None)
    p = idx.params
    freq = sketch_reads(seqs, p.k, p.s, p.t, p.l, p.open)
    sk = prepare_read_sketch(freq, p.k, len(seqs))

    exact = score_nodes(idx, sk)  # single-process f64 oracle (host)

    mesh = make_mesh()  # ALL global devices: rows shard across processes
    placer = TpuPlacer(idx, mesh=mesh)
    got = placer.place_exact(sk)
    assert got is not None, "place_exact fell back on the real index"
    bad = []
    for m in METRICS:
        if (got.best_index[m] != exact.best_index[m]
                or got.best_score[m] != exact.best_score[m]
                or got.tied_indices[m] != exact.tied_indices[m]):
            bad.append(m)
    n_nodes = len(idx.node_ids)
    best = exact.best_index["log_containment"]
    print(f"[child {pid}] devices={ndev} nodes={n_nodes} "
          f"rows={len(idx.seed_hashes)} best={idx.node_ids[best]} "
          f"{'OK' if not bad else 'MISMATCH ' + ','.join(bad)}", flush=True)
    return 0 if not bad else 1


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "--child":
        return child(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
                     int(sys.argv[5]), sys.argv[6], sys.argv[7])
    if len(sys.argv) > 1 and sys.argv[1] == "--child-em":
        return child_em(int(sys.argv[2]), int(sys.argv[3]),
                        int(sys.argv[4]), int(sys.argv[5]), sys.argv[6])
    em_mode = "--em" in sys.argv
    argv = [a for a in sys.argv if a != "--em"]
    nprocs = int(argv[1]) if len(argv) > 1 else 2
    devs = int(argv[2]) if len(argv) > 2 else 4
    idx_path = argv[3] if len(argv) > 3 else DEFAULT_IDX
    reads = argv[4] if len(argv) > 4 else DEFAULT_READS
    if em_mode:
        midx_path = os.path.join(REPO, ".cache", "rsv4k.ptmidx.npz")
        if not os.path.exists(midx_path):
            sys.path.insert(0, REPO)
            from panmap_tpu.index.builder import IndexParams
            from panmap_tpu.io.panman import load_panman
            from panmap_tpu.meta.index import build_meta_index, \
                save_meta_index

            save_meta_index(midx_path,
                            build_meta_index(load_panman(PANMAN),
                                             IndexParams()))
        import socket as _socket
        import subprocess as _sp

        with _socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS=f"--xla_force_host_platform_device_count={devs}")
        procs = [_sp.Popen(
            [sys.executable, os.path.abspath(__file__), "--child-em",
             str(i), str(nprocs), str(devs), str(port), reads],
            env=env, cwd=REPO) for i in range(nprocs)]
        rcs = [p.wait(timeout=600) for p in procs]
        print(f"[parent] EM child exit codes: {rcs}")
        return 0 if all(rc == 0 for rc in rcs) else 1
    _ensure_index(idx_path)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    env.update(
        JAX_PLATFORMS="cpu",
        XLA_FLAGS=f"--xla_force_host_platform_device_count={devs}",
        JAX_TRACEBACK_FILTERING="off",
    )
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--child", str(i),
             str(nprocs), str(devs), str(port), idx_path, reads],
            env=env, cwd=REPO)
        for i in range(nprocs)
    ]
    rcs = [p.wait(timeout=600) for p in procs]
    print(f"[parent] child exit codes: {rcs}")
    return 0 if all(rc == 0 for rc in rcs) else 1


if __name__ == "__main__":
    sys.exit(main())
