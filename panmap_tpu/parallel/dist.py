"""Multi-host distribution scaffolding (SURVEY §5.8).

The reference is strictly single-node shared-memory (TBB); its batch mode
parallelizes samples across threads (main.cpp:1575-1658).  The multi-host
story here is the standard JAX one: ONE PROCESS PER HOST calls
``jax.distributed.initialize`` against a shared coordinator, after which
``jax.devices()`` spans every GPU in the cluster and the mesh programs in
parallel/mesh.py + place/query_tpu.py run unchanged.  The collectives are
XLA's: on GPUs it hands each psum to NCCL, over NVLink between the cards of
one host and over the network between hosts.  Nothing here detects a
cluster: the coordinator address, process count and process id are always
given (flags or the JAX_* variables).

"Multi-host without a cluster" (SURVEY §4.5): N local processes, each with
virtual CPU devices (XLA_FLAGS=--xla_force_host_platform_device_count=K),
initialize against a localhost coordinator — exercised by
tools/dist_smoke.py and tests/test_dist.py.
"""

from __future__ import annotations

import os


def maybe_initialize(coordinator: str = "", num_processes: int = 0,
                     process_id: int = -1, local_device_ids=None,
                     log=print) -> bool:
    """Initialize jax.distributed when multi-process flags/env are present.

    Flag precedence: explicit arguments (--dist-coordinator/--dist-nprocs/
    --dist-pid), then the standard JAX env vars (JAX_COORDINATOR_ADDRESS,
    JAX_NUM_PROCESSES, JAX_PROCESS_ID — honored by initialize() itself when
    called with no arguments).  Returns True when distributed mode is
    active.  Idempotent: repeat calls are no-ops."""
    import jax

    if getattr(maybe_initialize, "_done", False):
        return True
    if coordinator and num_processes > 0 and process_id >= 0:
        jax.distributed.initialize(
            coordinator_address=coordinator, num_processes=num_processes,
            process_id=process_id, local_device_ids=local_device_ids)
        maybe_initialize._done = True
        log(f"[dist] process {process_id}/{num_processes} via {coordinator}: "
            f"{len(jax.devices())} global / "
            f"{len(jax.local_devices())} local devices")
        return True
    if os.environ.get("JAX_COORDINATOR_ADDRESS"):
        jax.distributed.initialize()  # env-driven
        maybe_initialize._done = True
        log(f"[dist] env-initialized: {len(jax.devices())} global devices")
        return True
    return False


def process_rank_safe() -> tuple:
    """(process_index, process_count) WITHOUT forcing a backend handshake in
    single-process mode (forked host-stage workers must never spin up their
    own device clients).  Only consults jax when distributed mode was
    actually initialized (maybe_initialize ran, or the env announces a
    coordinator)."""
    import sys

    jax = sys.modules.get("jax")
    if jax is None:
        return 0, 1
    if not (getattr(maybe_initialize, "_done", False)
            or os.environ.get("JAX_COORDINATOR_ADDRESS")):
        return 0, 1
    try:
        return jax.process_index(), jax.process_count()
    except Exception:
        return 0, 1


def process_read_shard(n_items: int, pid: int | None = None,
                       nprocs: int | None = None) -> slice:
    """This process's contiguous shard of a host-side work list (FASTQ
    streaming, BAM/VCF writing stay per-host data-parallel, mirroring the
    reference's batch mode).  Identity slice in single-process mode.
    Explicit ``pid``/``nprocs`` compute another rank's shard (dryrun /
    planning); by default the live jax.distributed rank is used."""
    if pid is not None or nprocs is not None:
        np_, pid = int(nprocs or 1), int(pid or 0)
    else:
        import jax

        np_, pid = jax.process_count(), jax.process_index()
    if np_ <= 1:
        return slice(0, n_items)
    per = (n_items + np_ - 1) // np_
    return slice(pid * per, min((pid + 1) * per, n_items))
