"""Device placement scoring: per-row metric deltas -> per-node scores, in JAX.

The fast path of the parity engine (place/engine.py), expressed as one fused
device program:

 - row hashes are re-mapped once per index to dense int32 ids (host-side), so
   the row<->read join is a native int32 searchsorted on device — no u64
   keys on the device (x64 is off);
 - per-row deltas are f32 vector math; per-node sums use segment_sum;
 - the ancestor accumulation down the DFS uses an Euler-tour signed prefix sum
   (+delta at subtree entry, -delta at exit, one cumsum over 2N slots), turning
   the reference's level-synchronous BFS (src/placement.cpp:701-918) into a
   single parallel scan;
 - the whole thing jits to one XLA program and shards over a device mesh by
   splitting rows (see parallel/mesh.py): per-shard partial node sums combine
   with a psum across the devices.

Exact f64 scoring for golden-output parity stays in place/engine.py; this path
is for throughput (the driver's reads/s metric) with f32 scores + optional f64
re-scoring of the top candidates.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

import jax
import jax.numpy as jnp

from ..index.builder import IndexArrays


@dataclass
class DeviceIndex:
    """Host-prepared, device-resident index tensors."""

    unique_hashes: np.ndarray  # u64[U] sorted (host only, for query mapping)
    row_id: jnp.ndarray  # i32[T] index into unique_hashes
    row_parent: jnp.ndarray  # f32[T]
    row_child: jnp.ndarray  # f32[T]
    row_node: jnp.ndarray  # i32[T]
    euler_in: jnp.ndarray  # i32[N]
    euler_out: jnp.ndarray  # i32[N]
    n_nodes: int
    root_rows: tuple  # (start, end) row range of the root node
    # static blocked-segment structure (metrics.BlockSegments) for the
    # scatter-free per-node reduction; None under a mesh (the sharded path
    # keeps the per-shard sorted scatter + psum)
    blk: object = None
    # static CSC structure (metrics.CscIndex): rows grouped by unique hash,
    # for the sparse found-rows-only scoring path; None under a mesh
    csc: object = None
    # host copies of the root node's row ids / child counts (for the host
    # f64 weighted-containment denominator when the query table is compact)
    root_rid_np: object = None
    root_child_np: object = None


def prepare_device_index(idx: IndexArrays, mesh=None) -> DeviceIndex:
    """Host->device index preparation.  With ``mesh`` (a 1-D
    jax.sharding.Mesh over the "data" axis), the row tensors are padded to a
    multiple of the mesh size with inert rows (P == C == 0: every metric
    delta is exactly 0) and placed SHARDED across the devices — the
    multi-device product path (SURVEY §5.8: seed-change rows split over
    devices, partial per-node metric sums psum'd across them)."""
    from ..utils.fastnp import unique_inverse

    uniq, row_id = unique_inverse(idx.seed_hashes)
    n_nodes = len(idx.node_offsets) - 1
    offs = idx.node_offsets.astype(np.int64)
    row_node = np.repeat(np.arange(n_nodes, dtype=np.int32), np.diff(offs))

    # Euler tour from the parent array (children in DFS order)
    parent = idx.parent_index.astype(np.int64)
    # subtree sizes via reverse DFS-order accumulation
    sizes = np.ones(n_nodes, dtype=np.int64)
    for i in range(n_nodes - 1, 0, -1):
        sizes[parent[i]] += sizes[i]
    # entry = dfs index + number of exits before it; with pre-order numbering,
    # euler_in[i] = 2*i - ... simpler: compute via stack simulation vectorized:
    # in a preorder DFS, euler_in[i] = i + (#nodes that closed before i) =
    # i + (i - depth[i]) where depth = number of open ancestors.
    depth = np.zeros(n_nodes, dtype=np.int64)
    for i in range(1, n_nodes):
        depth[i] = depth[parent[i]] + 1
    euler_in = 2 * np.arange(n_nodes, dtype=np.int64) - depth
    euler_out = euler_in + 2 * sizes - 1  # exit slot
    # the Euler-tour prefix is only valid for PREORDER numbering (subtree of
    # i = [i, i+sizes[i])); the builder emits DFS preorder — this guards
    # against synthetic test trees that merely satisfy parent[i] < i
    if n_nodes > 1:
        ii = np.arange(1, n_nodes)
        pp = parent[ii]
        if not np.all((pp < ii) & (ii < pp + sizes[pp])):
            raise ValueError("index parent_index is not in DFS preorder")

    rid = row_id.astype(np.int32)
    # counts upload as i16 (their storage dtype): halves the host->device
    # transfer of two of the four row tensors; device programs cast to f32
    # at entry (row_node_sums) — i16 -> f32 is exact
    rp = idx.parent_counts.astype(np.int16)
    rc = idx.child_counts.astype(np.int16)
    rn = row_node
    if mesh is None:
        put = jnp.asarray
    else:
        nd = int(mesh.devices.size)
        pad = (-len(rid)) % nd
        if pad:
            rid = np.concatenate([rid, np.zeros(pad, np.int32)])
            rp = np.concatenate([rp, np.zeros(pad, np.int16)])
            rc = np.concatenate([rc, np.zeros(pad, np.int16)])
            # pad rows carry node id n_nodes-1 (NOT 0) so row_node stays
            # SORTED — row_node_sums promises indices_are_sorted to the
            # scatter; the pad rows' deltas are identically 0 (P == C == 0),
            # so the last segment absorbs them without effect
            rn = np.concatenate([rn, np.full(pad, n_nodes - 1, np.int32)])
        from jax.sharding import NamedSharding, PartitionSpec

        sh = NamedSharding(mesh, PartitionSpec("data"))

        def put(x):
            return jax.device_put(x, sh)

    blk = None
    csc = None
    if mesh is None:
        # single-device path: precompute the static blocked-segment structure
        # (scatter-free full-stream reduction, the large-query fallback) and
        # the CSC structure (sparse found-rows-only scoring, the default)
        from .metrics import make_block_segments, make_csc_index

        blk = make_block_segments(rn, n_nodes)
        csc = make_csc_index(rid, idx.parent_counts, idx.child_counts,
                             row_node, len(uniq), n_nodes,
                             parent_index=parent)
    a, b = int(offs[0]), int(offs[1])
    return DeviceIndex(
        unique_hashes=uniq,
        blk=blk,
        csc=csc,
        root_rid_np=rid[a:b].copy(),
        root_child_np=idx.child_counts[a:b].astype(np.float64),
        row_id=put(rid),
        row_parent=put(rp),
        row_child=put(rc),
        row_node=put(rn),
        euler_in=jnp.asarray(euler_in.astype(np.int32)),
        euler_out=jnp.asarray(euler_out.astype(np.int32)),
        n_nodes=n_nodes,
        root_rows=(int(offs[0]), int(offs[1])),
    )


def map_read_table(dev: DeviceIndex, seed_freq: dict, min_support: int):
    """Host: read seed-frequency dict -> (sorted ids i32, log counts f32)."""
    if not seed_freq:
        return (np.empty(0, np.int32), np.empty(0, np.float32), 0.0, 0, 0.0)
    hashes = np.fromiter(seed_freq.keys(), dtype=np.uint64, count=len(seed_freq))
    counts = np.fromiter(seed_freq.values(), dtype=np.int64, count=len(seed_freq))
    keep = counts >= min_support
    hashes, counts = hashes[keep], counts[keep]
    log_counts = np.log1p(counts.astype(np.float64))
    log_mag = float(np.sqrt((log_counts**2).sum()))
    logcont_den = float(log_counts.sum())
    n_unique = len(hashes)
    ii = np.searchsorted(dev.unique_hashes, hashes)
    iic = np.minimum(ii, max(len(dev.unique_hashes) - 1, 0))
    found = (len(dev.unique_hashes) > 0) & (dev.unique_hashes[iic] == hashes)
    ids = iic[found].astype(np.int32)
    lc = log_counts[found].astype(np.float32)
    order = np.argsort(ids)
    return ids[order], lc[order], log_mag, n_unique, logcont_den


def make_score_fn(n_nodes: int, n_rows: int, blk=None):
    """Jitted scoring over fixed-size row/read tables.  With ``blk`` (the
    index's static BlockSegments) the per-node reduction runs scatter-free
    (metrics.row_node_sums_blocked); without it, the sorted scatter."""

    from .metrics import euler_prefix, row_node_sums, row_node_sums_blocked

    @jax.jit
    def score(row_id, row_parent, row_child, row_node, euler_in, euler_out,
              read_ids, read_logc):
        # join rows -> read table
        pos = jnp.searchsorted(read_ids, row_id)
        posc = jnp.clip(pos, 0, jnp.maximum(read_ids.shape[0] - 1, 0))
        found = jnp.where(read_ids.shape[0] > 0, read_ids[posc] == row_id, False)
        lrc = jnp.where(found, read_logc[posc], 0.0)
        # shared delta body + Euler-tour ancestor prefix (place/metrics.py)
        if blk is not None:
            node_sums = row_node_sums_blocked(lrc, row_parent, row_child,
                                              found, blk, n_nodes)
        else:
            node_sums = row_node_sums(lrc, row_parent, row_child, found,
                                      row_node, n_nodes)
        return euler_prefix(node_sums, euler_in, euler_out, n_nodes)

    return score


def compute_scores_device(dev: DeviceIndex, read_ids, read_logc, log_mag: float,
                       read_unique: int, logcont_den: float,
                       seed_inv_root=None):
    """Returns f32 scores [N,5] in METRICS order."""
    fn = make_score_fn(dev.n_nodes, int(dev.row_id.shape[0]), blk=dev.blk)
    acc = np.asarray(
        fn(dev.row_id, dev.row_parent, dev.row_child, dev.row_node,
           dev.euler_in, dev.euler_out, jnp.asarray(read_ids),
           jnp.asarray(read_logc))
    )
    # weighted containment denominator from root rows (host, f64)
    a, b = dev.root_rows
    rc = np.asarray(dev.row_child[a:b]).astype(np.float64)
    rid = np.asarray(dev.row_id[a:b])
    pos = np.searchsorted(read_ids, rid)
    posc = np.minimum(pos, max(len(read_ids) - 1, 0))
    found = (len(read_ids) > 0) & (read_ids[posc] == rid)
    from .metrics import finalize_scores, wc_denominator

    wc_den = float(wc_denominator(np, rc, rc, found))
    return finalize_scores(np, acc.astype(np.float64), log_mag, read_unique,
                           logcont_den, wc_den)
