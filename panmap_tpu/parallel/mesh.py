"""Multi-chip sharding for placement scoring and read sketching.

The reference is single-node shared-memory (SURVEY §2.3); this module is the
multi-device replacement: a 1-D `jax.sharding.Mesh` over GPUs, seed-change
rows split across devices, per-shard partial per-node metric sums combined
with a `psum` (an NCCL all-reduce over NVLink), and the (cheap, replicated)
Euler-tour prefix finishing the scores on every device.  Read batches shard the same way for sketching (data
parallel per chip).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map


def make_mesh(n_devices: int | None = None, local: bool = False) -> Mesh:
    """1-D "data" mesh.  ``local=True`` restricts to THIS process's devices —
    required whenever different processes run the mesh program on DIFFERENT
    data (e.g. the manifest-sharded batch mode, where each host places its
    own samples: a global mesh's psum would mix partial sums across
    samples)."""
    devs = jax.local_devices() if local else jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), ("data",))


def pad_rows(arr: np.ndarray, multiple: int, fill=0):
    n = len(arr)
    pad = (-n) % multiple
    if pad == 0:
        return arr
    return np.concatenate([arr, np.full(pad, fill, dtype=arr.dtype)])


def make_sharded_score_fn(mesh: Mesh, n_nodes: int):
    """Placement scoring with rows sharded over the mesh.

    Row tensors are sharded on axis 0; the read table and tree tensors are
    replicated. Per-shard segment sums reduce with psum so every chip holds the
    full per-node metric accumulators.
    """

    from ..place.metrics import euler_prefix, row_node_sums

    def _shard_body(row_id, row_parent, row_child, row_node,
                    read_ids, read_logc):
        pos = jnp.searchsorted(read_ids, row_id)
        posc = jnp.clip(pos, 0, jnp.maximum(read_ids.shape[0] - 1, 0))
        found = jnp.where(read_ids.shape[0] > 0, read_ids[posc] == row_id, False)
        lrc = jnp.where(found, read_logc[posc], 0.0)
        # shared delta body (place/metrics.py) over this shard's rows
        partial = row_node_sums(lrc, row_parent, row_child, found, row_node,
                                n_nodes)
        return jax.lax.psum(partial, "data")  # all-reduce of partial sums

    sharded = shard_map(
        _shard_body,
        mesh=mesh,
        in_specs=(P("data"), P("data"), P("data"), P("data"), P(None), P(None)),
        out_specs=P(None),
        
    )

    @jax.jit
    def score(row_id, row_parent, row_child, row_node, euler_in, euler_out,
              read_ids, read_logc):
        node_sums = sharded(row_id, row_parent, row_child, row_node,
                            read_ids, read_logc)
        return euler_prefix(node_sums, euler_in, euler_out, n_nodes)

    return score


def make_sharded_sketch_fn(mesh: Mesh, k: int, s: int, t: int, open_: bool):
    """Data-parallel read sketching over the mesh: reads shard on axis 0,
    each chip sketches its shard (see sketch/tpu.py for the kernel math)."""
    from ..sketch.tpu import syncmer_scan_batch

    def _body(reads, lengths):
        return syncmer_scan_batch(reads, lengths, k, s, t, open_)

    return shard_map(
        _body,
        mesh=mesh,
        in_specs=(P("data"), P("data")),
        out_specs=(P("data"), P("data"), P("data")),
        
    )


def make_sharded_em_fn(mesh: Mesh, eta: float = 1e-5,
                       max_change_threshold: float = 0.0,
                       max_iterations: int = 1000, max_rounds: int = 1):
    """SQUAREM EM with READS sharded over the mesh (SURVEY §5.8: E-step
    sufficient statistics — per-node responsibility sums and the log
    likelihood — are psum'd across the devices every iteration; proportions
    stay replicated).  Delegates to THE shared fused-rounds body
    (meta.engine._squarem_body with axis_name="data") — one EM definition
    site for the single-device and mesh paths.

    Inputs: S u16[R, M] score matrix (sharded on axis 0), lens i32[R],
    w f32[R] (sharded), alive bool[M] (replicated).  R must divide the mesh.
    Returns the replicated proportions f32[M]."""
    from ..meta.engine import _squarem_body

    body = _squarem_body(eta, max_change_threshold, max_iterations,
                         max_rounds, axis_name="data")

    def _props_only(S, lens, w, alive):
        return body(S, lens, w, alive)[0]

    sharded = shard_map(
        _props_only, mesh=mesh,
        in_specs=(P("data"), P("data"), P("data"), P(None)),
        out_specs=P(None))
    return jax.jit(sharded)


def make_sharded_em_full_fn(mesh: Mesh, eta: float = 1e-5,
                            max_change_threshold: float = 0.0,
                            max_iterations: int = 1000,
                            max_rounds: int = 5):
    """Like make_sharded_em_fn but returns the full (props, alive,
    iterations) triple — the drop-in the production run_squarem_device
    routes through under --mesh."""
    from ..meta.engine import _squarem_body

    body = _squarem_body(eta, max_change_threshold, max_iterations,
                         max_rounds, axis_name="data")
    sharded = shard_map(
        body, mesh=mesh,
        in_specs=(P("data"), P("data"), P("data"), P(None)),
        out_specs=(P(None), P(None), P()))  # iterations is a scalar
    return jax.jit(sharded)
