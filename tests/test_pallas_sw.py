"""Device banded-SW scoring program: equality with the numpy DP oracle, and
the production aligner's device-scoring stage (deferred full-window DP rows)
producing identical alignments to the all-host path.

Reference analog: the ksw2 extension kernels inside minimap2
(src/3rdparty/minimap2/ksw2_extz2_sse.c, driven via src/mm_align.c:148-199).
Here the program runs on XLA:CPU; chip_smoke.py runs the same program
compiled for the GPU at every shape tier against the same oracle.
"""

import numpy as np
import pytest

from panmap_tpu.align.core import MIN_DP_MAX, banded_affine_dp
from panmap_tpu.align.sw_device import banded_sw_scores


def _random_case(rng, lq, lr):
    q = rng.integers(0, 4, lq).astype(np.uint8)
    r = rng.integers(0, 4, lr).astype(np.uint8)
    # plant a homologous segment with an indel so scores are non-trivial
    seg = rng.integers(0, lr - lq // 2 - 8)
    core = r[seg : seg + lq // 2].copy()
    muts = rng.integers(0, len(core), 3)
    core[muts] = (core[muts] + 1) % 4
    if rng.random() < 0.5 and len(core) > 12:
        cut = rng.integers(4, len(core) - 4)
        gap = int(rng.integers(1, 6))
        core = np.concatenate([core[:cut], core[cut + gap :]])
    q[: len(core)] = core[: lq]
    return q, r


def test_kernel_matches_numpy_dp():
    rng = np.random.default_rng(7)
    B = 16
    cases = [_random_case(rng, int(rng.integers(40, 151)), 360)
             for _ in range(B)]
    LQ = max(len(q) for q, _ in cases)
    LW = 360
    qb = np.full((B, LQ), 4, dtype=np.uint8)
    rb = np.full((B, LW), 4, dtype=np.uint8)
    ql = np.zeros(B, dtype=np.int32)
    for i, (q, r) in enumerate(cases):
        qb[i, : len(q)] = q
        rb[i, : len(r)] = r
        ql[i] = len(q)
    out = np.asarray(banded_sw_scores(qb, rb, ql))
    for i, (q, r) in enumerate(cases):
        score, qs, bi, rs, bj, cig = banded_affine_dp(q, r)
        if score <= 0:
            assert out[i, 0] <= 0 or out[i, 0] < MIN_DP_MAX
            continue
        assert out[i, 0] == score, f"case {i}: {out[i,0]} != {score}"
        assert out[i, 1] == bi, f"case {i} query end"
        assert out[i, 2] == bj, f"case {i} window end"


def test_kernel_window_padding_upper_bounds():
    """Padding the window with code-4 columns must never lower the score
    (the production gate relies on the padded score upper-bounding the
    real-window score)."""
    rng = np.random.default_rng(11)
    q, r = _random_case(rng, 120, 300)
    score, *_ = banded_affine_dp(q, r)
    qb = q[None, :]
    ql = np.array([len(q)], np.int32)
    for pad in (0, 57, 212):
        rb = np.full((1, len(r) + pad), 4, dtype=np.uint8)
        rb[0, : len(r)] = r
        out = np.asarray(banded_sw_scores(qb, rb, ql))
        assert out[0, 0] >= score


def _mutate_read(rng, ref, pos, ln):
    read = list(ref[pos : pos + ln])
    kind = rng.random()
    if kind < 0.45:  # deletion in the read (ref bases skipped)
        cut = int(rng.integers(20, ln - 30))
        gap = int(rng.integers(3, 9))
        read = list(ref[pos : pos + cut]) + list(
            ref[pos + cut + gap : pos + ln + gap])
    elif kind < 0.9:  # insertion in the read
        cut = int(rng.integers(20, ln - 30))
        ins = "".join("ACGT"[i] for i in rng.integers(0, 4, int(rng.integers(3, 9))))
        read = list(ref[pos : pos + cut]) + list(ins) + list(
            ref[pos + cut : pos + ln - len(ins)])
    else:  # heavy clip tail
        tail = "".join("ACGT"[i] for i in rng.integers(0, 4, 35))
        read = list(ref[pos : pos + ln - 35]) + list(tail)
    return "".join(read)[:ln]


def test_aligner_device_stage_identical_to_host():
    """BatchAligner with the device scoring stage (on XLA:CPU) returns
    alignments identical to the all-host native path — the device stage is a
    pure gate + survivor-recompute, never a numeric substitute."""
    from panmap_tpu.align.batch import BatchAligner
    from panmap_tpu.native import get_lib

    if get_lib() is None:
        pytest.skip("native library unavailable")
    rng = np.random.default_rng(23)
    ref = "".join("ACGT"[i] for i in rng.integers(0, 4, 4000))
    reads = []
    for _ in range(80):
        pos = int(rng.integers(0, len(ref) - 180))
        reads.append(_mutate_read(rng, ref, pos, 151))

    host = BatchAligner(ref)
    host.device_mode = None
    base = host.align_batch(reads)

    dev = BatchAligner(ref)
    dev.device_mode = "device"
    dev.MIN_DEVICE_WINDOWS = 0
    got = dev.align_batch(reads)

    assert dev.device_stats is not None and dev.device_stats["deferred"] > 0, \
        "test reads never reached the deferred DP path"
    assert dev.device_stats["device_scored"] > 0, \
        "device scoring stage never ran"
    for i, (a, b) in enumerate(zip(base, got)):
        assert (a.mapped, a.rs, a.re, a.qs, a.qe, a.rev, a.score, a.mapq,
                a.nm, a.cigar) == (
            b.mapped, b.rs, b.re, b.qs, b.qe, b.rev, b.score, b.mapq,
            b.nm, b.cigar), f"read {i} diverged"


def test_aligner_arrays_device_stage_identical():
    """Columnar twin: align_batch_arrays with the device stage matches the
    all-host arrays field-for-field."""
    from panmap_tpu.align.batch import BatchAligner
    from panmap_tpu.native import get_lib

    if get_lib() is None:
        pytest.skip("native library unavailable")
    rng = np.random.default_rng(31)
    ref = "".join("ACGT"[i] for i in rng.integers(0, 4, 4000))
    reads = []
    for _ in range(60):
        pos = int(rng.integers(0, len(ref) - 180))
        reads.append(_mutate_read(rng, ref, pos, 151))

    host = BatchAligner(ref)
    host.device_mode = None
    base = host.align_batch_arrays(reads)
    dev = BatchAligner(ref)
    dev.device_mode = "device"
    dev.MIN_DEVICE_WINDOWS = 0
    got = dev.align_batch_arrays(reads)
    assert dev.device_stats is not None and dev.device_stats["deferred"] > 0
    assert dev.device_stats["device_scored"] > 0
    for key in ("mapped", "rev", "rs", "re", "qs", "qe", "score", "mapq",
                "nm", "ncig"):
        np.testing.assert_array_equal(base[key], got[key], err_msg=key)
    np.testing.assert_array_equal(base["cig"], got["cig"])
    assert base["extra_cigars"] == got["extra_cigars"]

def test_breakeven_routing_host_path_identical():
    """mode="device" with a deferred set below MIN_DEVICE_WINDOWS routes the
    windows to the host DP (the host DP beats a device dispatch at small
    counts) — outputs must equal the all-host path exactly, and the stats
    must record the routing."""
    from panmap_tpu.align.batch import BatchAligner
    from panmap_tpu.native import get_lib

    if get_lib() is None:
        pytest.skip("native library unavailable")
    rng = np.random.default_rng(31)
    ref = "".join("ACGT"[i] for i in rng.integers(0, 4, 4000))
    reads = []
    for _ in range(80):
        pos = int(rng.integers(0, len(ref) - 180))
        reads.append(_mutate_read(rng, ref, pos, 151))

    host = BatchAligner(ref)
    host.device_mode = None
    base = host.align_batch(reads)

    routed = BatchAligner(ref)
    routed.device_mode = "device"
    routed.MIN_DEVICE_WINDOWS = len(reads) + 1  # every deferred set is below
    got = routed.align_batch(reads)

    st = routed.device_stats
    assert st["deferred"] < routed.MIN_DEVICE_WINDOWS
    assert st is not None and st["deferred"] > 0
    assert st.get("routed_host", 0) == st["deferred"]
    assert st["device_scored"] == 0
    for i, (a, b) in enumerate(zip(base, got)):
        assert (a.mapped, a.rs, a.re, a.qs, a.qe, a.rev, a.score, a.mapq,
                a.nm, a.cigar) == (
            b.mapped, b.rs, b.re, b.qs, b.qe, b.rev, b.score, b.mapq,
            b.nm, b.cigar), f"read {i} diverged"


def test_native_rows_resolution_matches_python_loop(monkeypatch):
    """The deferred rows are resolved by ONE native pt_align_sr_rows call;
    the python per-row DP loop remains the fallback/oracle.  Both must
    produce identical arrays."""
    from panmap_tpu.align.batch import BatchAligner
    import panmap_tpu.native as native

    if native.get_lib() is None:
        pytest.skip("native library unavailable")
    rng = np.random.default_rng(77)
    ref = "".join("ACGT"[i] for i in rng.integers(0, 4, 4000))
    reads = []
    for _ in range(90):
        pos = int(rng.integers(0, len(ref) - 180))
        reads.append(_mutate_read(rng, ref, pos, 151))

    fast = BatchAligner(ref)
    fast.device_mode = "device"  # small set -> host routing, native call
    fast.MIN_DEVICE_WINDOWS = len(reads) + 1
    a = fast.align_batch_arrays(reads)
    assert fast.device_stats and fast.device_stats["routed_host"] > 0

    monkeypatch.setattr(native, "align_sr_rows_native",
                        lambda *args, **kw: None)
    slow = BatchAligner(ref)
    slow.device_mode = "device"
    slow.MIN_DEVICE_WINDOWS = len(reads) + 1
    b = slow.align_batch_arrays(reads)

    for key in ("mapped", "rev", "rs", "re", "qs", "qe", "score", "mapq",
                "nm", "ncig"):
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    for i in range(len(reads)):
        nc = int(a["ncig"][i])
        np.testing.assert_array_equal(a["cig"][i, :nc], b["cig"][i, :nc],
                                      err_msg=f"cigar row {i}")


def test_aligner_arrays_async_deferred_identical():
    """deferred_async: the dispatch-now/finish-later split (res["_fin"]) must
    produce arrays identical to the synchronous device stage, with the device
    actually scoring (device_scored > 0) — the production single-sample
    path, which must fire the device stage on the flagship workload."""
    from panmap_tpu.align.batch import BatchAligner
    from panmap_tpu.native import get_lib

    if get_lib() is None:
        pytest.skip("native library unavailable")
    rng = np.random.default_rng(33)
    ref = "".join("ACGT"[i] for i in rng.integers(0, 4, 4000))
    reads = []
    for _ in range(60):
        pos = int(rng.integers(0, len(ref) - 180))
        reads.append(_mutate_read(rng, ref, pos, 151))

    sync = BatchAligner(ref)
    sync.device_mode = "device"
    sync.MIN_DEVICE_WINDOWS = 0
    base = sync.align_batch_arrays(reads)
    a = BatchAligner(ref)
    a.device_mode = "device"
    a.MIN_DEVICE_WINDOWS = 0
    got = a.align_batch_arrays(reads, deferred_async=True)
    fin = got.pop("_fin", None)
    if fin is not None:  # deferred rows existed: rows still pending here
        assert (got["mapped"] == 3).sum() > 0
        fin()
    assert (got["mapped"] == 3).sum() == 0
    assert a.device_stats is not None and a.device_stats["device_scored"] > 0
    for key in ("mapped", "rev", "rs", "re", "qs", "qe", "score", "mapq",
                "nm", "ncig"):
        np.testing.assert_array_equal(base[key], got[key], err_msg=key)
    np.testing.assert_array_equal(base["cig"], got["cig"])
    assert base["extra_cigars"] == got["extra_cigars"]


def test_kernel_tier_shape_and_padding_rows():
    """At a production tier shape the program returns [B, 3] int32, padding
    rows (qlen 0, all code 4) score 0 with no end, and real rows are
    unaffected by the padding rows beside them."""
    rng = np.random.default_rng(3)
    B, LQ, LW = 64, 256, 512
    qb = np.full((B, LQ), 4, np.uint8)
    rb = np.full((B, LW), 4, np.uint8)
    ql = np.zeros(B, np.int32)
    cases = [_random_case(rng, 151, 400) for _ in range(5)]
    for i, (q, r) in enumerate(cases):
        qb[i, : len(q)] = q
        rb[i, : len(r)] = r
        ql[i] = len(q)
    out = np.asarray(banded_sw_scores(qb, rb, ql))
    assert out.shape == (B, 3) and out.dtype == np.int32
    assert (out[len(cases):] == 0).all()
    alone = np.asarray(banded_sw_scores(qb[:8], rb[:8], ql[:8]))
    np.testing.assert_array_equal(out[:8], alone)


def test_device_stage_pads_to_shape_tiers(monkeypatch):
    """Every dispatch shape of the device stage comes from the static
    (LQ, LW, B) tier grid, so the set of compiled programs does not depend
    on the workload; windows are bucketed by their own (LQ, LW) tier."""
    from panmap_tpu.align import sw_device
    from panmap_tpu.align.batch import BatchAligner
    from panmap_tpu.native import get_lib

    if get_lib() is None:
        pytest.skip("native library unavailable")
    shapes = []
    real = sw_device.banded_sw_scores

    def spy(qb, rb, ql):
        shapes.append((qb.shape, rb.shape, ql.shape))
        return real(qb, rb, ql)

    monkeypatch.setattr(sw_device, "banded_sw_scores", spy)
    rng = np.random.default_rng(23)
    ref = "".join("ACGT"[i] for i in rng.integers(0, 4, 4000))
    reads = [_mutate_read(rng, ref, int(rng.integers(0, len(ref) - 180)),
                          151) for _ in range(80)]
    dev = BatchAligner(ref)
    dev.device_mode = "device"
    dev.MIN_DEVICE_WINDOWS = 0
    dev.align_batch(reads)
    assert shapes
    for (b, lq), (b2, lw), (b3,) in shapes:
        assert b == b2 == b3 and b in BatchAligner._B_TIERS
        assert lq in BatchAligner._LQ_TIERS and lw in BatchAligner._LW_TIERS
    assert len(set(shapes)) == len(shapes)  # one dispatch per tier bucket
