#!/usr/bin/env python
"""Multi-process "multi-host without a cluster" smoke (SURVEY §4.5).

Parent mode (default): spawns N child processes.  Each child is an
independent JAX process with K virtual CPU devices; children initialize
``jax.distributed`` against a localhost coordinator (panmap_tpu.parallel.dist
scaffolding), build the GLOBAL 1-D mesh spanning all N*K devices, and run the
sharded placement-scoring program (parallel/mesh.make_sharded_score_fn — the
same shared metric body as the product path) on a deterministic synthetic row
table.  Every child checks the replicated result against an independent
numpy-f64 oracle of the same math; any mismatch exits non-zero.

Usage: python tools/dist_smoke.py [nprocs] [devices-per-proc]
Child: python tools/dist_smoke.py --child <pid> <nprocs> <devs> <port>
"""

import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _synthetic(n_nodes=7, T=512):
    import numpy as np

    rng = np.random.default_rng(42)
    row_id = rng.integers(0, 40, T).astype(np.int32)
    rp = rng.integers(0, 3, T).astype(np.float32)
    rc = rng.integers(0, 3, T).astype(np.float32)
    row_node = np.sort(rng.integers(0, n_nodes, T)).astype(np.int32)
    # random tree in PREORDER numbering (required by the Euler-tour prefix)
    parent = np.zeros(n_nodes, dtype=np.int64)
    chain = [0]
    for i in range(1, n_nodes):
        d = int(rng.integers(0, len(chain)))
        parent[i] = chain[d]
        chain = chain[: d + 1] + [i]
    # Euler tour from the parent array (preorder ids)
    sizes = np.ones(n_nodes, dtype=np.int64)
    for i in range(n_nodes - 1, 0, -1):
        sizes[parent[i]] += sizes[i]
    depth = np.zeros(n_nodes, dtype=np.int64)
    for i in range(1, n_nodes):
        depth[i] = depth[parent[i]] + 1
    euler_in = (2 * np.arange(n_nodes) - depth).astype(np.int32)
    euler_out = (euler_in + 2 * sizes - 1).astype(np.int32)
    read_ids = np.arange(0, 40, 2, dtype=np.int32)
    read_logc = rng.random(len(read_ids)).astype(np.float32)
    return (row_id, rp, rc, row_node, euler_in, euler_out, read_ids,
            read_logc, parent, n_nodes)


def _oracle(row_id, rp, rc, row_node, euler_in, euler_out, read_ids,
            read_logc, n_nodes):
    """Independent f64 oracle of the sharded program's math."""
    import numpy as np

    from panmap_tpu.place.metrics import row_metric_deltas

    pos = np.searchsorted(read_ids, row_id)
    posc = np.minimum(pos, len(read_ids) - 1)
    found = read_ids[posc] == row_id
    lrc = np.where(found, read_logc[posc].astype(np.float64), 0.0)
    deltas = np.stack(row_metric_deltas(
        np, lrc, rp.astype(np.float64), rc.astype(np.float64), found), axis=1)
    node_sums = np.zeros((n_nodes, 6))
    np.add.at(node_sums, row_node, deltas)
    slots = np.zeros((2 * n_nodes + 1, 6))
    np.add.at(slots, euler_in, node_sums)
    np.add.at(slots, euler_out + 1, -node_sums)
    return np.cumsum(slots, axis=0)[euler_in]


def child(pid: int, nprocs: int, devs: int, port: int) -> int:
    import jax

    jax.distributed.initialize(coordinator_address=f"localhost:{port}",
                               num_processes=nprocs, process_id=pid)
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    sys.path.insert(0, REPO)
    from panmap_tpu.parallel.mesh import make_mesh, make_sharded_score_fn

    ndev = len(jax.devices())
    assert ndev == nprocs * devs, (ndev, nprocs, devs)
    (row_id, rp, rc, row_node, euler_in, euler_out, read_ids, read_logc,
     _parent, n_nodes) = _synthetic()

    mesh = make_mesh()  # all global devices
    shard = NamedSharding(mesh, P("data"))
    rep = NamedSharding(mesh, P())

    def g(x, sh):
        # every process holds the full array; hand JAX each device's shard
        return jax.make_array_from_callback(x.shape, sh, lambda i: x[i])

    fn = make_sharded_score_fn(mesh, n_nodes)
    acc = fn(g(row_id, shard), g(rp, shard), g(rc, shard),
             g(row_node, shard), g(euler_in, rep), g(euler_out, rep),
             g(read_ids, rep), g(read_logc, rep))
    got = np.asarray(acc.addressable_shards[0].data)

    want = _oracle(row_id, rp, rc, row_node, euler_in, euler_out, read_ids,
                   read_logc, n_nodes)
    err = np.max(np.abs(got - want))
    ok = err < 1e-3
    print(f"[child {pid}] global devices={ndev} max_err={err:.2e} "
          f"{'OK' if ok else 'MISMATCH'}", flush=True)
    return 0 if ok else 1


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "--child":
        return child(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
                     int(sys.argv[5]))
    nprocs = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    devs = int(sys.argv[2]) if len(sys.argv) > 2 else 4
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
             str(nprocs), str(devs), str(port)],
            env=env, cwd=REPO)
        for i in range(nprocs)
    ]
    rcs = [p.wait(timeout=300) for p in procs]
    print(f"[parent] child exit codes: {rcs}")
    return 0 if all(rc == 0 for rc in rcs) else 1


if __name__ == "__main__":
    sys.exit(main())
