"""SQUAREM EM backends: the device-resident masked implementation must agree
with the f64 numpy reference path (same surviving nodes, close proportions,
same identical-column collapse)."""

import numpy as np
import pytest


def _synthetic(M=10, R=400, seed=0):
    rng = np.random.default_rng(seed)
    # two dominant haplotypes + noise nodes; duplicate one column pair
    read_lens = rng.integers(10, 20, R).astype(np.int64)
    truth = np.zeros((M, R), dtype=np.uint16)
    owner = rng.choice([0, 1], R, p=[0.7, 0.3])
    for j in range(R):
        truth[owner[j], j] = read_lens[j]
        for i in range(M):
            if i != owner[j]:
                truth[i, j] = max(0, int(read_lens[j]) - int(rng.integers(2, 8)))
    truth[3] = truth[2]  # identical pair -> must collapse
    weights = rng.integers(1, 4, R).astype(np.float64)
    names = [f"n{i}" for i in range(M)]
    return truth, read_lens, weights, names


def test_device_em_matches_host_f64():
    from panmap_tpu.meta.engine import run_squarem

    S, lens, w, names = _synthetic()
    host = run_squarem(S, lens, w, names, backend="none")
    import jax.numpy as jnp

    dev = run_squarem(jnp.asarray(S.T), lens, w, names)

    # identical-column collapse found the duplicate pair in both
    assert any("n3" in v for v in host.identical_groups.values())
    assert any("n3" in v for v in dev.identical_groups.values())

    h = dict(zip(host.node_names, host.props))
    d = dict(zip(dev.node_names, dev.props))
    assert set(h) == set(d)
    for k in h:
        assert abs(h[k] - d[k]) < 2e-3, (k, h[k], d[k])
    assert abs(sum(d.values()) - 1.0) < 1e-3


def test_device_em_drops_low_prop_nodes():
    from panmap_tpu.meta.engine import run_squarem
    import jax.numpy as jnp

    S, lens, w, names = _synthetic(M=8, R=300, seed=5)
    res = run_squarem(jnp.asarray(S.T), lens, w, names)
    # every surviving proportion is at or above the removal threshold
    assert (res.props >= 0.005).all()
    assert abs(res.props.sum() - 1.0) < 1e-3


def test_masked_em_compile_cache_reuse():
    """Same padded shapes -> same compiled fn object (no recompile per
    workload)."""
    from panmap_tpu.meta.engine import _MASKED_EM_CACHE, _get_masked_squarem

    a = _get_masked_squarem(256, 16384, 1e-5, 0.0, 1000)
    b = _get_masked_squarem(256, 16384, 1e-5, 0.0, 1000)
    assert a is b
    assert (256, 16384, 1e-5, 0.0, 1000, 5) in _MASKED_EM_CACHE


def test_sharded_em_matches_single_device():
    """Read-sharded SQUAREM over a virtual 8-device mesh must agree with the
    single-device masked EM (psum'd sufficient statistics are exact sums)."""
    import jax

    if len(jax.devices()) < 2:
        pytest.skip("needs virtual multi-device CPU")
    import jax.numpy as jnp

    from panmap_tpu.meta.engine import _get_masked_squarem
    from panmap_tpu.parallel.mesh import make_mesh, make_sharded_em_fn

    S, lens, w, names = _synthetic(M=8, R=512, seed=2)
    Srm = np.ascontiguousarray(S.T)  # [R, M]
    alive = np.ones(8, dtype=bool)

    single = _get_masked_squarem(8, 512, 1e-5, 0.0, 500, max_rounds=1)
    p1, _, _ = single(jnp.asarray(Srm), jnp.asarray(lens.astype(np.int32)),
                      jnp.asarray(w.astype(np.float32)), jnp.asarray(alive))
    p1 = np.asarray(p1)

    mesh = make_mesh(8)
    fn = make_sharded_em_fn(mesh, eta=1e-5, max_iterations=500)
    p8 = np.asarray(fn(jnp.asarray(Srm), jnp.asarray(lens.astype(np.int32)),
                       jnp.asarray(w.astype(np.float32)), jnp.asarray(alive)))
    assert np.allclose(p1, p8, atol=2e-4), np.abs(p1 - p8).max()


def test_device_em_rescales_after_round_drop():
    """Round-transition re-scaling: reads whose dominant column is dropped
    after round 1 must keep contributing.  Before the fix, Ps was scaled once
    at the round-1 alive set; a surviving column sitting >88 nats below the
    stale row max underflowed to an exact f32 zero and the read silently
    vanished (reference restarts its plane every round, main.cpp:1263-1272)."""
    from panmap_tpu.meta.engine import run_squarem
    import jax.numpy as jnp

    rng = np.random.default_rng(11)
    R, M = 1000, 12  # cols 0/1 real haplotypes; cols 2..11 traps
    read_lens = np.full(R, 40, dtype=np.int64)
    S = np.zeros((M, R), dtype=np.uint16)
    owner = rng.choice([0, 1], R, p=[0.7, 0.3])
    for j in range(R):
        S[owner[j], j] = 40
        S[1 - owner[j], j] = 40 - int(rng.integers(3, 7))
    # 40 trap reads: each trap column dominates 4 of them by 20 score units
    # (~106 nats at err=0.005, beyond f32 exp range); their best SURVIVING
    # column is 1, so after the traps drop they must all flow to column 1.
    trap_reads = np.arange(40)
    for t, j in enumerate(trap_reads):
        S[:, j] = 0
        S[2 + t % 10, j] = 40
        S[1, j] = 20
        S[0, j] = 15
    w = np.ones(R, dtype=np.float64)
    names = [f"n{i}" for i in range(M)]

    host = run_squarem(S, read_lens, w, names, backend="none")
    dev = run_squarem(jnp.asarray(S.T), read_lens, w, names)

    h = dict(zip(host.node_names, host.props))
    d = dict(zip(dev.node_names, dev.props))
    # traps dropped in both; n0/n1 survive with the trap reads reassigned
    assert set(h) == {"n0", "n1"}
    assert set(d) == {"n0", "n1"}
    for k in h:
        assert abs(h[k] - d[k]) < 2e-3, (k, h[k], d[k])


def test_run_squarem_device_mesh_matches_single():
    """Production EM routing under --mesh: run_squarem_device(mesh=8) must
    agree with the single-device fused-rounds EM (same shared body, E-step
    statistics psum'd over the read shards)."""
    import jax

    if len(jax.devices()) < 2:
        pytest.skip("needs virtual multi-device CPU")
    import jax.numpy as jnp

    from panmap_tpu.meta.engine import run_squarem_device
    from panmap_tpu.parallel.mesh import make_mesh

    S, lens, w, names = _synthetic(M=10, R=4096, seed=5)
    Srm = jnp.asarray(np.ascontiguousarray(S.T))  # [R, M] device-resident
    one = run_squarem_device(Srm, lens, w, names, max_rounds=5)
    eight = run_squarem_device(Srm, lens, w, names, max_rounds=5,
                               mesh=make_mesh(8))
    assert one.node_names == eight.node_names
    assert np.allclose(one.props, eight.props, atol=2e-4), \
        np.abs(one.props - eight.props).max()
