"""Device-path tests: batched JAX sketching and scoring must agree with the
bit-exact CPU implementations (run on the CPU backend with a virtual 8-device
mesh, per the conftest)."""

import numpy as np
import pytest

from panmap_tpu.sketch import cpu as sk


def random_dna(rng, n):
    return "".join(rng.choice(list("ACGT")) for _ in range(n))


@pytest.fixture
def rng():
    import random

    return random.Random(7)


def test_syncmer_scan_batch_matches_cpu(rng):
    from panmap_tpu.sketch.tpu import encode_reads_batch, syncmer_scan_batch

    k, s, t = 19, 8, 0
    seqs = [random_dna(rng, 150) for _ in range(8)]
    seqs[3] = seqs[3][:40] + "N" + seqs[3][41:]
    seqs[5] = seqs[5][:97]  # shorter read exercises the length mask
    reads, lens = encode_reads_batch(seqs, pad_to=150)
    hh, hl, is_sync = syncmer_scan_batch(reads, lens, k, s, t, False)
    hh, hl, is_sync = np.asarray(hh), np.asarray(hl), np.asarray(is_sync)
    for i, seq in enumerate(seqs):
        hashes, is_rev, ref_sync = sk.rolling_syncmers(seq, k, s, False, t)
        m = len(hashes)
        assert np.array_equal(is_sync[i, :m], ref_sync)
        got = (hh[i, :m].astype(np.uint64) << np.uint64(32)) | hl[i, :m].astype(np.uint64)
        assert np.array_equal(got[ref_sync], hashes[ref_sync])
        assert not is_sync[i, m:].any()


def test_kminmer_batch_matches_cpu(rng):
    from panmap_tpu.sketch.tpu import (
        encode_reads_batch,
        kminmer_batch,
        syncmer_scan_batch,
    )

    k, s, t, l = 19, 8, 0, 3
    seqs = [random_dna(rng, 150) for _ in range(6)]
    reads, lens = encode_reads_batch(seqs, pad_to=150)
    hh, hl, is_sync = syncmer_scan_batch(reads, lens, k, s, t, False)
    kh, kl, valid = kminmer_batch(hh, hl, is_sync, k, l)
    kh, kl, valid = np.asarray(kh), np.asarray(kl), np.asarray(valid)
    for i, seq in enumerate(seqs):
        _, H, _ = sk.syncmer_list(seq, k, s, False, t)
        km, vmask = sk.kminmer_hashes(H, k, l)
        expect = km[vmask]
        got = (kh[i].astype(np.uint64) << np.uint64(32)) | kl[i].astype(np.uint64)
        got = got[valid[i]]
        assert np.array_equal(np.sort(got), np.sort(expect))


def test_device_scoring_matches_f64_engine():
    """Device scoring path vs the exact engine on a small synthetic index."""
    from panmap_tpu.index.builder import IndexArrays, IndexParams
    from panmap_tpu.place.engine import ReadSketch, score_nodes
    from panmap_tpu.place import engine_tpu as et

    rng = np.random.default_rng(0)
    n_nodes = 9
    parent = np.array([0, 0, 1, 1, 0, 4, 4, 6, 6], dtype=np.uint32)
    rows_per_node = rng.integers(1, 6, n_nodes)
    offsets = np.zeros(n_nodes + 1, dtype=np.uint64)
    offsets[1:] = np.cumsum(rows_per_node)
    T = int(offsets[-1])
    hashes = rng.integers(0, 50, T).astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
    parents = rng.integers(0, 4, T).astype(np.int16)
    childs = rng.integers(0, 4, T).astype(np.int16)
    idx = IndexArrays(
        params=IndexParams(),
        node_ids=[f"n{i}" for i in range(n_nodes)],
        parent_index=parent,
        identical_to_parent=np.zeros(n_nodes, bool),
        block_ranges=np.zeros((1, 2), np.uint32),
        seed_hashes=hashes,
        parent_counts=parents,
        child_counts=childs,
        node_offsets=offsets,
    )
    # read sketch over a subset of the hashes
    uniq = np.unique(hashes)
    chosen = uniq[::2]
    freq = {int(h): int(c) for h, c in zip(chosen, rng.integers(1, 9, len(chosen)))}

    from panmap_tpu.place.engine import prepare_read_sketch

    sk_ = prepare_read_sketch(freq, 19, 100, min_read_support=1)
    exact = score_nodes(idx, sk_)

    dev = et.prepare_device_index(idx)
    ids, lc, mag, nuniq, lden = et.map_read_table(dev, sk_.seed_freq, 1)
    # prepare_read_sketch removed homopolymer seeds already; recompute stats to match
    scores = et.compute_scores_device(dev, ids, lc, sk_.log_read_magnitude,
                                   sk_.read_unique_seed_count,
                                   sk_.log_containment_denominator)
    assert np.allclose(scores, exact.scores, atol=2e-4)


def test_sharded_scoring_matches_single_device():
    import jax

    if len(jax.devices()) < 2:
        pytest.skip("needs virtual multi-device CPU")
    from panmap_tpu.parallel.mesh import make_mesh, make_sharded_score_fn, pad_rows
    import jax.numpy as jnp

    rng = np.random.default_rng(1)
    n_nodes = 5
    T = 64
    row_id = rng.integers(0, 10, T).astype(np.int32)
    rp = rng.integers(0, 3, T).astype(np.float32)
    rc = rng.integers(0, 3, T).astype(np.float32)
    row_node = np.sort(rng.integers(0, n_nodes, T)).astype(np.int32)
    euler_in = np.array([0, 1, 3, 5, 7], dtype=np.int32)
    euler_out = np.array([9, 2, 4, 6, 8], dtype=np.int32)
    read_ids = np.arange(0, 10, 2, dtype=np.int32)
    read_logc = rng.random(5).astype(np.float32)

    mesh = make_mesh(8)
    fn = make_sharded_score_fn(mesh, n_nodes)
    acc = np.asarray(fn(row_id, rp, rc, row_node,
                        jnp.asarray(euler_in), jnp.asarray(euler_out),
                        jnp.asarray(read_ids), jnp.asarray(read_logc)))

    from panmap_tpu.place.engine_tpu import make_score_fn

    single = make_score_fn(n_nodes, T)
    acc1 = np.asarray(single(jnp.asarray(row_id), jnp.asarray(rp), jnp.asarray(rc),
                             jnp.asarray(row_node), jnp.asarray(euler_in),
                             jnp.asarray(euler_out), jnp.asarray(read_ids),
                             jnp.asarray(read_logc)))
    assert np.allclose(acc, acc1, atol=1e-5)


def test_tpu_placer_matches_f64_engine(rng):
    """Full device placement path (encode -> 2-bit pack -> batched sketch ->
    compacted sort/count -> index join -> row scoring) against the exact host
    engine, on a synthetic index whose seeds come from real read k-min-mers."""
    from panmap_tpu.index.builder import IndexArrays, IndexParams
    from panmap_tpu.place.engine import (
        prepare_read_sketch,
        score_nodes,
        sketch_reads,
    )
    from panmap_tpu.place.query_tpu import TpuPlacer

    k, s, t, l = 19, 8, 0, 3
    nprng = np.random.default_rng(3)
    # reads with duplicates (exercises counts>1) and one N
    base = [random_dna(rng, 150) for _ in range(20)]
    seqs = base + base[:5]
    seqs[2] = seqs[2][:70] + "N" + seqs[2][71:]

    freq = sketch_reads(seqs, k, s, t, l, False)
    read_hashes = (np.sort(freq[0]) if isinstance(freq, tuple)
                   else np.array(sorted(freq), dtype=np.uint64))
    assert len(read_hashes) > 30

    # index: 9 nodes; rows mix read hashes with absent hashes
    n_nodes = 9
    parent = np.array([0, 0, 1, 1, 0, 4, 4, 6, 6], dtype=np.uint32)
    rows_per_node = nprng.integers(4, 12, n_nodes)
    offsets = np.zeros(n_nodes + 1, dtype=np.uint64)
    offsets[1:] = np.cumsum(rows_per_node)
    T = int(offsets[-1])
    pick = nprng.integers(0, len(read_hashes), T)
    hashes = read_hashes[pick]
    miss = nprng.random(T) < 0.3  # 30% of rows reference absent seeds
    hashes = np.where(
        miss, nprng.integers(1, 1 << 62, T).astype(np.uint64), hashes)
    idx = IndexArrays(
        params=IndexParams(k=k, s=s, t=t, l=l, open=False),
        node_ids=[f"n{i}" for i in range(n_nodes)],
        parent_index=parent,
        identical_to_parent=np.zeros(n_nodes, bool),
        block_ranges=np.zeros((1, 2), np.uint32),
        seed_hashes=hashes,
        parent_counts=nprng.integers(0, 4, T).astype(np.int16),
        child_counts=nprng.integers(0, 4, T).astype(np.int16),
        node_offsets=offsets,
    )

    sk_ = prepare_read_sketch(freq, k, len(seqs), min_read_support=1)
    exact = score_nodes(idx, sk_)

    placer = TpuPlacer(idx, pad_len=152, batch=32)
    got = placer.place(seqs, min_read_support=1)
    assert np.allclose(got, exact.scores, atol=2e-4)

    # auto min-read-support path agrees too
    sk_auto = prepare_read_sketch(freq, k, len(seqs), min_read_support=-1)
    exact_auto = score_nodes(idx, sk_auto)
    got_auto = placer.place(seqs, min_read_support=-1)
    assert np.allclose(got_auto, exact_auto.scores, atol=2e-4)


def test_place_best_host_matches_place_best(rng):
    """Hybrid host-sketch path (native count + join, device scoring) returns
    the same best nodes / tie sets as the all-device path."""
    from panmap_tpu.index.builder import IndexArrays, IndexParams
    from panmap_tpu.native import get_lib
    from panmap_tpu.place.engine import METRICS, sketch_reads
    from panmap_tpu.place.query_tpu import TpuPlacer

    if get_lib() is None:
        import pytest

        pytest.skip("native library unavailable")

    k, s, t, l = 19, 8, 0, 3
    nprng = np.random.default_rng(7)
    base = [random_dna(rng, 150) for _ in range(24)]
    seqs = base + base[:7]  # duplicates exercise counts >= 2
    freq = sketch_reads(seqs, k, s, t, l, False)
    read_hashes = (np.sort(freq[0]) if isinstance(freq, tuple)
                   else np.array(sorted(freq), dtype=np.uint64))

    n_nodes = 9
    parent = np.array([0, 0, 1, 1, 0, 4, 4, 6, 6], dtype=np.uint32)
    rows_per_node = nprng.integers(4, 12, n_nodes)
    offsets = np.zeros(n_nodes + 1, dtype=np.uint64)
    offsets[1:] = np.cumsum(rows_per_node)
    T = int(offsets[-1])
    pick = nprng.integers(0, len(read_hashes), T)
    hashes = read_hashes[pick]
    miss = nprng.random(T) < 0.3
    hashes = np.where(
        miss, nprng.integers(1, 1 << 62, T).astype(np.uint64), hashes)
    idx = IndexArrays(
        params=IndexParams(k=k, s=s, t=t, l=l, open=False),
        node_ids=[f"n{i}" for i in range(n_nodes)],
        parent_index=parent,
        identical_to_parent=np.zeros(n_nodes, bool),
        block_ranges=np.zeros((1, 2), np.uint32),
        seed_hashes=hashes,
        parent_counts=nprng.integers(0, 4, T).astype(np.int16),
        child_counts=nprng.integers(0, 4, T).astype(np.int16),
        node_offsets=offsets,
    )

    placer = TpuPlacer(idx, pad_len=152, batch=32)
    for ms in (-1, 1, 2):
        a = placer.place_best(seqs, min_read_support=ms)
        b = placer.place_best_host(seqs, min_read_support=ms)
        for m in METRICS:
            assert a.best_index[m] == b.best_index[m], (ms, m)
            assert abs(a.best_score[m] - b.best_score[m]) < 1e-4, (ms, m)
            assert a.tied_indices[m] == b.tied_indices[m], (ms, m)


def test_native_sketch_count_matches_python(rng):
    """pt_sketch_count is a bit-exact twin of the pure-Python
    seedFreqInReads oracle (dedup multiplicities, N handling, trim, l=1)."""
    from panmap_tpu.native import get_lib, sketch_count_native
    from panmap_tpu.place.engine import _sketch_reads_py

    if get_lib() is None:
        import pytest

        pytest.skip("native library unavailable")

    seqs = [random_dna(rng, rng.randint(30, 220)) for _ in range(300)]
    seqs += seqs[:50]  # duplicates
    seqs[3] = seqs[3][:40] + "NN" + seqs[3][42:]
    seqs[11] = "ACGT"  # shorter than k
    for k, s, t, l, open_ in ((19, 8, 0, 3, False), (15, 8, 2, 1, False),
                              (21, 11, 0, 2, True)):
        ref = _sketch_reads_py(seqs, k, s, t, l, open_)
        out = sketch_count_native(seqs, k, s, t, open_, l)
        # documented contract: hashes come back SORTED ascending (the index
        # join downstream may rely on a merge scan)
        assert np.all(np.diff(out[0]) > 0), (k, s, t, l)
        got = dict(zip(out[0].tolist(), out[1].tolist()))
        assert got == {int(h): int(c) for h, c in ref.items()}, (k, s, t, l)
    # trim path
    ref = _sketch_reads_py(seqs, 19, 8, 0, 3, False, trim_start=11,
                           trim_end=7)
    out = sketch_count_native(seqs, 19, 8, 0, False, 3, trim_start=11,
                              trim_end=7)
    got = dict(zip(out[0].tolist(), out[1].tolist()))
    assert got == {int(h): int(c) for h, c in ref.items()}


def test_tree_accumulate_native_matches_python(rng):
    """pt_tree_accumulate must be bit-exact with the numpy cumsum loop."""
    from panmap_tpu.native import get_lib, tree_accumulate_native

    if get_lib() is None:
        import pytest

        pytest.skip("native library unavailable")
    nprng = np.random.default_rng(11)
    n_nodes = 200
    parent = np.zeros(n_nodes, dtype=np.uint32)
    for i in range(1, n_nodes):
        parent[i] = nprng.integers(0, i)
    rows = nprng.integers(0, 9, n_nodes)
    offs = np.zeros(n_nodes + 1, dtype=np.uint64)
    offs[1:] = np.cumsum(rows)
    T = int(offs[-1])
    dfs = [nprng.standard_normal(T) * 10.0 ** float(nprng.integers(-8, 8))
           for _ in range(5)]
    dis = [nprng.integers(-3, 4, T).astype(np.int64) for _ in range(2)]
    acc_f, acc_i = tree_accumulate_native(dfs, dis, offs, parent)
    # python reference (the exact formulation score_nodes used)
    ref_f = np.zeros((n_nodes, 5))
    ref_i = np.zeros((n_nodes, 2), dtype=np.int64)
    for i in range(n_nodes):
        a, b = int(offs[i]), int(offs[i + 1])
        base_f = ref_f[parent[i]].copy() if i else np.zeros(5)
        base_i = ref_i[parent[i]].copy() if i else np.zeros(2, np.int64)
        for m in range(5):
            ref_f[i, m] = np.cumsum(np.concatenate(([base_f[m]], dfs[m][a:b])))[-1]
        for m in range(2):
            ref_i[i, m] = base_i[m] + dis[m][a:b].sum()
    assert np.array_equal(acc_f, ref_f)
    assert np.array_equal(acc_i, ref_i)


def _synthetic_index(nprng, read_hashes, n_nodes=9, lo=4, hi=12, miss=0.3,
                     k=19, s=8, t=0, l=3):
    from panmap_tpu.index.builder import IndexArrays, IndexParams

    parent = np.array([0, 0, 1, 1, 0, 4, 4, 6, 6], dtype=np.uint32)[:n_nodes]
    rows_per_node = nprng.integers(lo, hi, n_nodes)
    offsets = np.zeros(n_nodes + 1, dtype=np.uint64)
    offsets[1:] = np.cumsum(rows_per_node)
    T = int(offsets[-1])
    pick = nprng.integers(0, len(read_hashes), T)
    hashes = read_hashes[pick]
    m = nprng.random(T) < miss
    hashes = np.where(m, nprng.integers(1, 1 << 62, T).astype(np.uint64),
                      hashes)
    return IndexArrays(
        params=IndexParams(k=k, s=s, t=t, l=l, open=False),
        node_ids=[f"n{i}" for i in range(n_nodes)],
        parent_index=parent,
        identical_to_parent=np.zeros(n_nodes, bool),
        block_ranges=np.zeros((1, 2), np.uint32),
        seed_hashes=hashes,
        parent_counts=nprng.integers(0, 4, T).astype(np.int16),
        child_counts=nprng.integers(0, 4, T).astype(np.int16),
        node_offsets=offsets,
    )


def test_rescore_paths_is_bit_exact(rng):
    """Path-replay rescoring must equal score_nodes EXACTLY (==) at every
    node: same sequential f64 addition order, same shared metric body."""
    from panmap_tpu.place.engine import (
        prepare_read_sketch,
        rescore_paths,
        score_nodes,
        sketch_reads,
    )

    k, s, t, l = 19, 8, 0, 3
    nprng = np.random.default_rng(13)
    base = [random_dna(rng, 150) for _ in range(20)]
    seqs = base + base[:5]
    freq = sketch_reads(seqs, k, s, t, l, False)
    read_hashes = (np.sort(freq[0]) if isinstance(freq, tuple)
                   else np.array(sorted(freq), dtype=np.uint64))
    idx = _synthetic_index(nprng, read_hashes)

    sk_ = prepare_read_sketch(freq, k, len(seqs), min_read_support=1)
    full = score_nodes(idx, sk_)
    all_nodes = list(range(len(idx.node_ids)))
    replay = rescore_paths(idx, sk_, all_nodes)
    assert np.array_equal(replay, full.scores)  # bit-exact, not allclose


def test_place_exact_matches_host_engine(rng):
    """The DEFAULT pipeline placement path (device widened tie selection +
    exact f64 path rescue) must reproduce the host engine's best scores, best
    indices and tie sets EXACTLY, including under force_leaf."""
    from panmap_tpu.place.engine import (
        METRICS,
        prepare_read_sketch,
        score_nodes,
        sketch_reads,
    )
    from panmap_tpu.place.query_tpu import TpuPlacer

    k, s, t, l = 19, 8, 0, 3
    nprng = np.random.default_rng(17)
    base = [random_dna(rng, 150) for _ in range(24)]
    seqs = base + base[:7]
    freq = sketch_reads(seqs, k, s, t, l, False)
    read_hashes = (np.sort(freq[0]) if isinstance(freq, tuple)
                   else np.array(sorted(freq), dtype=np.uint64))
    idx = _synthetic_index(nprng, read_hashes, miss=0.25)

    placer = TpuPlacer(idx, pad_len=152, batch=32)
    for ms in (-1, 1, 2):
        for fl in (False, True):
            sk_ = prepare_read_sketch(freq, k, len(seqs), min_read_support=ms)
            exact = score_nodes(idx, sk_, force_leaf=fl)
            got = placer.place_exact(sk_, force_leaf=fl)
            assert got is not None, (ms, fl)
            for m in METRICS:
                assert got.best_index[m] == exact.best_index[m], (ms, fl, m)
                assert got.best_score[m] == exact.best_score[m], (ms, fl, m)
                assert got.tied_indices[m] == exact.tied_indices[m], (ms, fl, m)


def test_place_exact_zero_wc_denominator(rng):
    """A root whose rows match no read seed gives wc_den == 0: the wc column
    is identically zero and place_exact must still return the host engine's
    exact result (best 0.0, no ties) instead of falling back (the rsv_4K
    self-placement sample hits exactly this)."""
    from panmap_tpu.place.engine import (
        METRICS,
        prepare_read_sketch,
        score_nodes,
        sketch_reads,
    )
    from panmap_tpu.place.query_tpu import TpuPlacer

    k, s, t, l = 19, 8, 0, 3
    nprng = np.random.default_rng(23)
    base = [random_dna(rng, 150) for _ in range(16)]
    freq = sketch_reads(base, k, s, t, l, False)
    read_hashes = (np.sort(freq[0]) if isinstance(freq, tuple)
                   else np.array(sorted(freq), dtype=np.uint64))
    idx = _synthetic_index(nprng, read_hashes, miss=0.25)
    # overwrite the ROOT's rows with absent hashes -> wc_den == 0
    a, b = int(idx.node_offsets[0]), int(idx.node_offsets[1])
    idx.seed_hashes[a:b] = nprng.integers(1, 1 << 62, b - a).astype(np.uint64)

    sk_ = prepare_read_sketch(freq, k, len(base), min_read_support=1)
    exact = score_nodes(idx, sk_)
    assert exact.best_score["weighted_containment"] == 0.0
    placer = TpuPlacer(idx, pad_len=152, batch=32)
    got = placer.place_exact(sk_)
    assert got is not None
    for m in METRICS:
        assert got.best_index[m] == exact.best_index[m], m
        assert got.best_score[m] == exact.best_score[m], m
        assert got.tied_indices[m] == exact.tied_indices[m], m


def test_place_exact_on_mesh_matches_host_engine(rng):
    """--mesh product path: rows sharded over the virtual 8-device mesh,
    per-node metric partials psum'd; place_exact must stay bit-identical to
    the host engine (the exact-rescue contract is sharding-independent)."""
    import jax

    if len(jax.devices()) < 2:
        pytest.skip("needs virtual multi-device CPU")
    from panmap_tpu.parallel.mesh import make_mesh
    from panmap_tpu.place.engine import (
        METRICS,
        prepare_read_sketch,
        score_nodes,
        sketch_reads,
    )
    from panmap_tpu.place.query_tpu import TpuPlacer

    k, s, t, l = 19, 8, 0, 3
    # seed 17 = the single-device exactness test's index (positive best
    # scores; adversarial all-non-positive columns are covered there)
    nprng = np.random.default_rng(17)
    base = [random_dna(rng, 150) for _ in range(24)]
    seqs = base + base[:7]
    freq = sketch_reads(seqs, k, s, t, l, False)
    read_hashes = (np.sort(freq[0]) if isinstance(freq, tuple)
                   else np.array(sorted(freq), dtype=np.uint64))
    idx = _synthetic_index(nprng, read_hashes, miss=0.25)

    placer = TpuPlacer(idx, pad_len=152, batch=32, mesh=make_mesh(8))
    for ms in (-1, 1):
        sk_ = prepare_read_sketch(freq, k, len(seqs), min_read_support=ms)
        exact = score_nodes(idx, sk_)
        got = placer.place_exact(sk_)
        assert got is not None, ms
        for m in METRICS:
            assert got.best_index[m] == exact.best_index[m], (ms, m)
            assert got.best_score[m] == exact.best_score[m], (ms, m)
            assert got.tied_indices[m] == exact.tied_indices[m], (ms, m)


def test_place_exact_large_index_stress(rng):
    """Stress the widened-selection error bound at scale: a 20k-node /
    ~600k-row preorder tree with counts up to 100 (large accumulator
    magnitudes).  place_exact must either match the host engine EXACTLY or
    refuse (None -> host fallback) — a silently wrong tie set is the only
    failure mode this guards against."""
    from panmap_tpu.index.builder import IndexArrays, IndexParams
    from panmap_tpu.place.engine import (
        METRICS,
        prepare_read_sketch,
        score_nodes,
    )
    from panmap_tpu.place.query_tpu import TpuPlacer

    nprng = np.random.default_rng(41)
    NN = 20000
    parent = np.zeros(NN, np.uint32)
    chain = [0]
    for i in range(1, NN):
        d = int(nprng.integers(0, len(chain)))
        parent[i] = chain[d]
        chain = chain[: d + 1] + [i]
    rows = nprng.integers(8, 52, NN)
    offs = np.zeros(NN + 1, np.uint64)
    offs[1:] = np.cumsum(rows)
    T = int(offs[-1])
    hashes = nprng.integers(1, 1 << 62, T).astype(np.uint64)
    read_h = np.unique(nprng.choice(hashes, size=T // 3))
    freq = {int(h): int(c)
            for h, c in zip(read_h, nprng.integers(1, 40, len(read_h)))}
    matched = np.isin(hashes, read_h)
    pc = nprng.integers(0, 100, T).astype(np.int16)
    cc = nprng.integers(0, 100, T).astype(np.int16)
    pc[matched] = nprng.integers(0, 3, int(matched.sum()))
    cc[matched] = nprng.integers(1, 100, int(matched.sum()))
    idx = IndexArrays(
        params=IndexParams(), node_ids=[f"n{i}" for i in range(NN)],
        parent_index=parent, identical_to_parent=np.zeros(NN, bool),
        block_ranges=np.zeros((1, 2), np.uint32), seed_hashes=hashes,
        parent_counts=pc, child_counts=cc, node_offsets=offs)

    sk_ = prepare_read_sketch(freq, 19, 100000, min_read_support=1)
    exact = score_nodes(idx, sk_)
    placer = TpuPlacer(idx)
    got = placer.place_exact(sk_)
    if got is None:
        return  # measured-error guard refused: falls back to host (valid)
    for m in METRICS:
        assert got.best_index[m] == exact.best_index[m], m
        assert got.best_score[m] == exact.best_score[m], m
        assert got.tied_indices[m] == exact.tied_indices[m], m

def test_place_exact_closure_guard_refuses_bad_candidate_set(rng):
    """Candidate-set CLOSURE guard (ADVICE r2): if the widened f32 selection
    wrongly excludes a node the exact f64 rule would pick (simulated here by
    clearing the true argmax's candidate bit), place_exact must detect it via
    the f64 rescore of the best excluded node and return None (host fallback)
    — never a silently wrong tie set."""
    from panmap_tpu.place.engine import (
        METRICS,
        prepare_read_sketch,
        score_nodes,
        sketch_reads,
    )
    from panmap_tpu.place.query_tpu import TpuPlacer

    k, s, t, l = 19, 8, 0, 3
    nprng = np.random.default_rng(59)
    base = [random_dna(rng, 150) for _ in range(24)]
    freq = sketch_reads(base, k, s, t, l, False)
    read_hashes = (np.sort(freq[0]) if isinstance(freq, tuple)
                   else np.array(sorted(freq), dtype=np.uint64))
    idx = _synthetic_index(nprng, read_hashes, miss=0.25)

    sk_ = prepare_read_sketch(freq, k, len(base), min_read_support=1)
    exact = score_nodes(idx, sk_)
    placer = TpuPlacer(idx, pad_len=152, batch=32)
    # sanity: the unmolested path matches
    got = placer.place_exact(sk_)
    assert got is not None
    assert got.best_index == exact.best_index

    # wrap the in-use selection path (the sparse dispatch on this index;
    # _widened_select_fn when the dense fallback fires): forcibly clear the
    # true best node's candidate bit for one metric with a non-trivial tie set
    inner = placer._score_sparse_dispatch
    n = len(idx.node_ids)
    victim_m = 0
    victim_node = exact.best_index[METRICS[victim_m]]
    assert victim_node is not None

    def tampered(*args, **kw):
        out = inner(*args, **kw)
        assert out is not None, "sparse path must be in use on this index"
        packed, best, col = out
        cand = np.unpackbits(np.asarray(packed), axis=0, count=n).astype(bool)
        cand[victim_node, victim_m] = False
        return np.packbits(cand, axis=0), best, col

    placer._score_sparse_dispatch = tampered
    got2 = placer.place_exact(sk_)
    # the true best is now the best f32 node OUTSIDE the candidate set; its
    # f64 rescore sits at/above best - tol -> the closure guard must refuse
    assert got2 is None


def test_place_exact_adversarial_sweep(rng):
    """Adversarial sweep over index shapes/magnitudes (VERDICT r3 #7): across
    many random trees — deep chains, wide fans, large counts, heavy hash
    aliasing — place_exact must EITHER bit-match the host engine on every
    metric's best/tie set OR refuse (None -> host fallback).  Also pins the
    quantified-closure behavior: with a tiny tree (excluded <= WITNESS_J) the
    closure is complete and place_exact must NOT refuse."""
    from panmap_tpu.index.builder import IndexArrays, IndexParams
    from panmap_tpu.place.engine import (
        METRICS,
        prepare_read_sketch,
        score_nodes,
    )
    from panmap_tpu.place.query_tpu import TpuPlacer

    refused = matched = 0
    for seed in range(8):
        nprng = np.random.default_rng(100 + seed)
        NN = int(nprng.choice([6, 40, 300, 1500]))
        parent = np.zeros(NN, np.uint32)
        chain = [0]
        for i in range(1, NN):
            # alternate deep chains and wide fans across seeds
            d = (len(chain) - 1 if seed % 2 == 0
                 else int(nprng.integers(0, len(chain))))
            parent[i] = chain[d]
            chain = chain[: d + 1] + [i]
        rows = nprng.integers(2, 30, NN)
        offs = np.zeros(NN + 1, np.uint64)
        offs[1:] = np.cumsum(rows)
        T = int(offs[-1])
        pool = nprng.integers(1, 1 << 62, max(T // 4, 8)).astype(np.uint64)
        hashes = pool[nprng.integers(0, len(pool), T)]  # heavy aliasing
        read_h = np.unique(nprng.choice(pool, size=len(pool) // 2))
        freq = {int(h): int(c) for h, c in
                zip(read_h, nprng.integers(1, 200, len(read_h)))}
        hi_counts = seed % 3 == 0
        cmax = 120 if hi_counts else 5
        idx = IndexArrays(
            params=IndexParams(), node_ids=[f"n{i}" for i in range(NN)],
            parent_index=parent, identical_to_parent=np.zeros(NN, bool),
            block_ranges=np.zeros((1, 2), np.uint32), seed_hashes=hashes,
            parent_counts=nprng.integers(0, cmax, T).astype(np.int16),
            child_counts=nprng.integers(0, cmax, T).astype(np.int16),
            node_offsets=offs)
        sk_ = prepare_read_sketch(freq, 19, 5000, min_read_support=1)
        exact = score_nodes(idx, sk_)
        placer = TpuPlacer(idx)
        got = placer.place_exact(sk_)
        if NN <= placer.WITNESS_J:
            # complete closure (every node enumerable in f64): must not refuse
            assert got is not None, (seed, NN)
        if got is None:
            refused += 1
            continue
        matched += 1
        for m in METRICS:
            assert got.best_index[m] == exact.best_index[m], (seed, m)
            assert got.best_score[m] == exact.best_score[m], (seed, m)
            assert got.tied_indices[m] == exact.tied_indices[m], (seed, m)
    # the sweep must actually exercise the exact path (not refuse everything)
    assert matched >= refused, (matched, refused)


def test_mesh_pad_keeps_row_node_sorted(rng):
    """row_node_sums promises indices_are_sorted to the scatter; the mesh
    pad must therefore append node ids at the TAIL (n_nodes-1), never 0
    (regression: round-4 review)."""
    import jax

    if len(jax.devices()) < 2:
        pytest.skip("needs virtual multi-device CPU")
    from panmap_tpu.parallel.mesh import make_mesh
    from panmap_tpu.place.engine_tpu import prepare_device_index

    nprng = np.random.default_rng(3)
    base = [random_dna(rng, 150) for _ in range(8)]
    from panmap_tpu.place.engine import sketch_reads

    freq = sketch_reads(base, 19, 8, 0, 3, False)
    read_hashes = (np.sort(freq[0]) if isinstance(freq, tuple)
                   else np.array(sorted(freq), dtype=np.uint64))
    idx = _synthetic_index(nprng, read_hashes)  # row count not % 8
    assert len(idx.seed_hashes) % 8 != 0, "fixture must need padding"
    dev = prepare_device_index(idx, mesh=make_mesh(8))
    rn = np.asarray(dev.row_node)
    assert np.all(np.diff(rn) >= 0), "padded row_node must remain sorted"
    assert rn[-1] == dev.n_nodes - 1


def test_place_best_host_batch_matches_single(rng):
    """The B-query batched program (metrics.batched_prefix_acc) returns the
    same best nodes / tie sets as per-sample place_best_host, including
    heterogeneous samples and a repeated sample."""
    from panmap_tpu.native import get_lib
    from panmap_tpu.place.engine import METRICS, sketch_reads
    from panmap_tpu.place.query_tpu import TpuPlacer

    if get_lib() is None:
        pytest.skip("native library unavailable")

    k, s, t, l = 19, 8, 0, 3
    nprng = np.random.default_rng(11)
    base = [random_dna(rng, 150) for _ in range(40)]
    samples = [base[:20], base[15:35], base[5:30] + base[5:9], base[:20]]
    freq = sketch_reads(base, k, s, t, l, False)
    read_hashes = (np.sort(freq[0]) if isinstance(freq, tuple)
                   else np.array(sorted(freq), dtype=np.uint64))
    idx = _synthetic_index(nprng, read_hashes, miss=0.3)

    placer = TpuPlacer(idx, pad_len=152, batch=32)
    got = placer.place_best_host_batch(samples)
    assert len(got) == len(samples)
    for i, s_ in enumerate(samples):
        ref = placer.place_best_host(s_)
        for m in METRICS:
            assert got[i].best_index[m] == ref.best_index[m], (i, m)
            assert abs(got[i].best_score[m] - ref.best_score[m]) < 1e-4
            assert got[i].tied_indices[m] == ref.tied_indices[m], (i, m)
    # identical samples in one batch agree with each other exactly
    for m in METRICS:
        assert got[0].best_score[m] == got[3].best_score[m]
        assert got[0].tied_indices[m] == got[3].tied_indices[m]
