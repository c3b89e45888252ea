"""Long-read aligner (map-ont / map-hifi presets): mapping accuracy and
cigar consistency on synthetic error-laden reads."""

import random

import numpy as np

from panmap_tpu.align.longread import (
    LongReadAligner,
    MAP_HIFI,
    MAP_ONT,
    pick_preset,
)


def _rc(s):
    return s[::-1].translate(str.maketrans("ACGT", "TGCA"))


def _mutate(rng, s, err):
    out = []
    for ch in s:
        r = rng.random()
        if r < err * 0.4:
            out.append(rng.choice("ACGT"))
        elif r < err * 0.7:
            pass
        elif r < err:
            out.append(ch)
            out.append(rng.choice("ACGT"))
        else:
            out.append(ch)
    return "".join(out)


def test_preset_selection():
    assert pick_preset(800) is MAP_ONT
    assert pick_preset(4999) is MAP_ONT
    assert pick_preset(5000) is MAP_HIFI


def test_ont_reads_map_to_truth_locus():
    rng = random.Random(7)
    ref = "".join(rng.choice("ACGT") for _ in range(20000))
    alner = LongReadAligner(ref, MAP_ONT)
    for trial in range(6):
        start = rng.randint(0, 16000)
        ln = rng.randint(800, 2500)
        read = _mutate(rng, ref[start : start + ln], err=0.08)
        if trial % 2:
            read = _rc(read)
        a = alner.align_read(read)
        assert a.mapped
        assert abs(a.rs - start) < 50
        assert a.rev == bool(trial % 2)
        # cigar spans must match the reported intervals
        mref = sum(l for l, op in a.cigar if op in "MD")
        mq = sum(l for l, op in a.cigar if op in "MI")
        assert mref == a.re - a.rs
        assert mq == a.qe - a.qs


def test_hifi_low_error_high_identity():
    rng = random.Random(11)
    ref = "".join(rng.choice("ACGT") for _ in range(30000))
    alner = LongReadAligner(ref, MAP_HIFI)
    start, ln = 4000, 6000
    read = _mutate(rng, ref[start : start + ln], err=0.01)
    a = alner.align_read(read)
    assert a.mapped and abs(a.rs - start) < 20
    matches = sum(l for l, op in a.cigar if op == "M")
    assert matches / ln > 0.97


def test_garbage_read_unmapped():
    rng = random.Random(3)
    ref = "".join(rng.choice("ACGT") for _ in range(20000))
    alner = LongReadAligner(ref, MAP_ONT)
    junk = "".join(rng.choice("ACGT") for _ in range(1500))
    a = alner.align_read(junk)
    assert not a.mapped


def test_long_gap_tier_spans_big_deletion():
    """A 300bp deletion costs 24+300*1 via the long-gap tier (vs 4+300*2
    single-tier, which would make clipping to one flank score higher): the
    read must align across the deletion as one alignment with a ~300D op."""
    rng = random.Random(11)
    ref = "".join(rng.choice("ACGT") for _ in range(1200))
    read = ref[100:300] + ref[600:800]  # 200bp flanks, 300bp deletion

    la = LongReadAligner(ref, MAP_ONT)
    aln = la.align_read(read)
    assert aln.mapped
    dels = [n for n, op in aln.cigar if op == "D"]
    assert dels and max(dels) == 300
    span = aln.re - aln.rs
    assert span >= 650  # covers both flanks plus the deletion


def test_chain_dp_spans_large_deletion():
    """A read whose genome copy lacks a 2kb segment must chain across the
    deletion (mm2 chain DP; the old per-diagonal-band clustering picked one
    side only) and the banded DP must emit a D run of about that size."""
    rng = random.Random(5)
    ref = "".join(rng.choice("ACGT") for _ in range(12000))
    # read = 2kb left flank + 2kb right flank with a 2000bp deletion between
    read = ref[1000:3000] + ref[5000:7000]
    la = LongReadAligner(ref, MAP_ONT)
    aln = la.align_read(read)
    assert aln.mapped
    dels = sum(ln for ln, op in aln.cigar if op == "D")
    assert 1900 <= dels <= 2100, aln.cigar
    m = sum(ln for ln, op in aln.cigar if op == "M")
    assert m >= 3800
    assert aln.rs <= 1010 and aln.re >= 6990


def test_chain_dp_prefers_colinear_chain_over_bigger_scatter():
    """chain_dp picks the colinear run, not a larger set of scattered
    repeat anchors."""
    from panmap_tpu.align.longread import chain_dp

    # colinear: 10 anchors on one diagonal; scatter: 14 anchors at random
    q = np.concatenate([np.arange(10) * 50, np.arange(14) * 37 + 7])
    r = np.concatenate([np.arange(10) * 50 + 100,
                        (np.arange(14) * 1931 + 13) % 9000])
    score, chain, sub = chain_dp(q, r, 15, 5000)
    d = r[chain] - q[chain]
    assert len(chain) >= 9
    assert (np.abs(d - 100) < 5).sum() >= 9


def test_long_device_dp_bit_equal_host():
    """The device long-read DP (direction bytes + z-drop replay +
    direction-walk traceback, align/long_device.py) must be BIT-EQUAL to
    the host banded_dp_shifted on random windows covering mismatches,
    short indels, long deletions (the E2 tier) and z-drop stops."""
    from panmap_tpu.align.core import encode
    from panmap_tpu.align.longread import MAP_ONT, banded_dp_shifted
    from panmap_tpu.align.long_device import long_dp_device_batch

    rng = np.random.default_rng(61)
    ref = "".join("ACGT"[i] for i in rng.integers(0, 4, 12000))
    refc = encode(np.frombuffer(ref.encode(), np.uint8))
    items = []
    host = []
    for t in range(10):
        L = int(rng.integers(600, 2400))
        p = int(rng.integers(0, len(ref) - L - 600))
        frag = list(ref[p:p + L])
        for j in range(L):
            if rng.random() < 0.05:
                frag[j] = "ACGT"[(("ACGT".find(frag[j])) + 1) % 4]
        if t % 3 == 1:  # long deletion: E2 tier
            d = int(rng.integers(80, 300))
            frag = frag[: L // 2] + list(ref[p + L // 2 + d: p + L + d])
        if t % 3 == 2:  # insertion
            frag = frag[: L // 3] + ["ACGT"[int(rng.integers(4))]
                                     for _ in range(int(rng.integers(20, 60)))] \
                + frag[L // 3:]
        q = encode(np.frombuffer("".join(frag).encode(), np.uint8))
        dlo, dhi = p - 400, p + 400
        items.append((q, dlo, dhi))
        host.append(banded_dp_shifted(q, refc, dlo, dhi, MAP_ONT))
    dev = long_dp_device_batch(items, refc, MAP_ONT)
    for t, (h, d) in enumerate(zip(host, dev)):
        assert h == d, (t, h[:5], d[:5])


def test_long_aligner_device_batch_matches_host():
    """LongReadAligner.align_batch(device="device") must reproduce the
    host path field-for-field on a mixed read set (the map-ont device
    product path)."""
    from panmap_tpu.align.longread import MAP_ONT, LongReadAligner

    rng = np.random.default_rng(71)
    ref = "".join("ACGT"[i] for i in rng.integers(0, 4, 16000))
    reads = []
    for t in range(12):
        L = int(rng.integers(700, 3000))
        p = int(rng.integers(0, len(ref) - L - 400))
        frag = list(ref[p:p + L])
        for j in range(L):
            if rng.random() < 0.06:
                frag[j] = "ACGT"[(("ACGT".find(frag[j])) + 1) % 4]
        if t % 4 == 1:
            d = int(rng.integers(50, 200))
            frag = frag[: L // 2] + list(ref[p + L // 2 + d: p + L + d])
        s = "".join(frag)
        if t % 2:
            s = s[::-1].translate(str.maketrans("ACGT", "TGCA"))
        reads.append(s)
    reads.append("ACGT" * 10)  # unmapped short junk
    lr = LongReadAligner(ref, MAP_ONT)
    base = lr.align_batch(reads, device=None)
    got = lr.align_batch(reads, device="device")
    for i, (a, b) in enumerate(zip(base, got)):
        assert (a.mapped, a.rev, a.rs, a.re, a.qs, a.qe, a.score, a.mapq,
                a.cigar) == (b.mapped, b.rev, b.rs, b.re, b.qs, b.qe,
                             b.score, b.mapq, b.cigar), i


def test_long_device_dp_narrow_band_padding_masked():
    """W pads to a multiple of 128 for the device, but the EXTRA columns
    must stay out of band — a narrow band (W_orig=129 -> padded 256) must
    give the host oracle's exact result, not explore wider diagonals."""
    from panmap_tpu.align.core import encode
    from panmap_tpu.align.longread import MAP_ONT, banded_dp_shifted
    from panmap_tpu.align.long_device import long_dp_device_batch

    rng = np.random.default_rng(5)
    ref = "".join("ACGT"[i] for i in rng.integers(0, 4, 6000))
    refc = encode(np.frombuffer(ref.encode(), np.uint8))
    q = refc[3000:3800].copy()
    cases = [(q, 2800, 2928), (q, 3000 - 64, 3000 + 64),
             (refc[100:900].copy(), 40, 168)]
    host = [banded_dp_shifted(qq, refc, a, b, MAP_ONT) for qq, a, b in cases]
    dev = long_dp_device_batch(cases, refc, MAP_ONT)
    for t, (h, d) in enumerate(zip(host, dev)):
        assert h == d, (t, h[:5], d[:5])


def test_long_device_batch_pads_to_shape_steps(monkeypatch):
    """Compiled shapes come from a small grid: LQ a multiple of ROW_STEP, W
    of COL_STEP, the batch a power of two; results stay equal to the host
    DP for every item of a padded batch."""
    from panmap_tpu.align import long_device as LD
    from panmap_tpu.align.core import encode
    from panmap_tpu.align.longread import MAP_ONT, banded_dp_shifted

    shapes = []
    real = LD._long_scan

    def spy(q8, ref8, dlo, worig, lr, W, *a):
        shapes.append((q8.shape, W))
        return real(q8, ref8, dlo, worig, lr, W, *a)

    monkeypatch.setattr(LD, "_long_scan", spy)
    rng = np.random.default_rng(8)
    refc = encode(np.frombuffer("".join(
        "ACGT"[i] for i in rng.integers(0, 4, 5000)).encode(), np.uint8))
    items = [(refc[p:p + n].copy(), p - 60, p + 60)
             for p, n in ((500, 700), (2000, 900), (3100, 650))]
    got = LD.long_dp_device_batch(items, refc, MAP_ONT)
    assert shapes == [((4, LD.ROW_STEP * 2), LD.COL_STEP)]
    for (q, a, b), g in zip(items, got):
        assert g == banded_dp_shifted(q, refc, a, b, MAP_ONT)


def test_long_device_oversized_item_runs_host(monkeypatch):
    """An item whose direction matrix would exceed MAX_ITEM_CELLS runs the
    host DP instead of allocating it on the device."""
    from panmap_tpu.align import long_device as LD
    from panmap_tpu.align.core import encode
    from panmap_tpu.align.longread import MAP_ONT, banded_dp_shifted

    def no_device(*a, **k):
        raise AssertionError("device program called")

    monkeypatch.setattr(LD, "_long_scan", no_device)
    monkeypatch.setattr(LD, "MAX_ITEM_CELLS", 1000)
    rng = np.random.default_rng(9)
    refc = encode(np.frombuffer("".join(
        "ACGT"[i] for i in rng.integers(0, 4, 3000)).encode(), np.uint8))
    q = refc[1000:1600].copy()
    assert LD.long_dp_device_batch([(q, 950, 1050)], refc, MAP_ONT) == \
        [banded_dp_shifted(q, refc, 950, 1050, MAP_ONT)]
