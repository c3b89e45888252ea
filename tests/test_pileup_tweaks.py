"""Vectorized mate-overlap quality tweak must match the legacy per-pair oracle
(_apply_overlap_tweaks, the direct transcription of bcftools tweak_overlap_quality
semantics used by pileup_call before vectorization)."""

import copy
import random

import numpy as np

from panmap_tpu.genotype.caller import (
    PlacedRead,
    _apply_overlap_tweaks,
    _apply_overlap_tweaks_flat,
)

BASES = "ACGT"


def _mk_reads(rng, n_pairs, ref_len):
    reads = []
    for p in range(n_pairs):
        name = f"pair{p}"
        rs1 = rng.randrange(0, ref_len - 120)
        rs2 = rs1 + rng.randrange(-30, 80)  # often overlapping, sometimes not
        rs2 = max(0, min(rs2, ref_len - 120))
        for rs in (rs1, rs2):
            L = rng.randrange(80, 120)
            # cigars with indels sometimes
            if rng.random() < 0.3:
                m1 = L // 2
                cig = [(m1, "M"), (rng.randrange(1, 4), "D"), (L - m1, "M")]
            elif rng.random() < 0.3:
                m1 = L // 2
                ins = rng.randrange(1, 4)
                cig = [(m1, "M"), (ins, "I"), (L - m1 - ins, "M")]
            else:
                cig = [(L, "M")]
            seq = "".join(rng.choice(BASES) for _ in range(L + 8))
            quals = [rng.randrange(2, 60) for _ in range(L + 8)]
            reads.append(PlacedRead(
                rs=rs, cigar=cig, seq=seq, quals=quals, qs=rng.randrange(0, 4),
                qname=name, is_proper=rng.random() < 0.9, is_paired=True,
                mapq=60, rev=bool(rng.getrandbits(1))))
    # a few unpaired reads and a triplicate name
    for j in range(3):
        L = 100
        reads.append(PlacedRead(
            rs=rng.randrange(0, ref_len - L), cigar=[(L, "M")],
            seq="".join(rng.choice(BASES) for _ in range(L)),
            quals=[rng.randrange(2, 60) for _ in range(L)], qs=0,
            qname="pair0" if j == 0 else f"solo{j}", is_proper=True,
            is_paired=(j == 0), mapq=60, rev=False))
    return reads


def _flat_arrays(kept, n):
    seg_p0, seg_q0, seg_len, seg_rid = [], [], [], []
    for rid, r in enumerate(kept):
        rpos, qpos = r.rs, r.qs
        for ln, op in r.cigar:
            if op in ("M", "=", "X"):
                seg_p0.append(rpos)
                seg_q0.append(qpos)
                seg_len.append(ln)
                seg_rid.append(rid)
                rpos += ln
                qpos += ln
            elif op in ("I", "S"):
                qpos += ln
            elif op in ("D", "N"):
                rpos += ln
    sl = np.asarray(seg_len, dtype=np.int64)
    csum = np.concatenate(([0], np.cumsum(sl)))
    rel = np.arange(csum[-1]) - np.repeat(csum[:-1], sl)
    flat_p = np.repeat(np.asarray(seg_p0, dtype=np.int64), sl) + rel
    flat_qi = np.repeat(np.asarray(seg_q0, dtype=np.int64), sl) + rel
    flat_rid = np.repeat(np.asarray(seg_rid, dtype=np.int64), sl)
    in_ref = (flat_p >= 0) & (flat_p < n)
    return flat_p[in_ref], flat_qi[in_ref], flat_rid[in_ref]


def test_flat_tweaks_match_legacy():
    rng = random.Random(7)
    n = 1000
    for trial in range(20):
        kept = _mk_reads(rng, n_pairs=12, ref_len=n)
        legacy = copy.deepcopy(kept)
        _apply_overlap_tweaks(legacy)
        q_legacy = np.concatenate(
            [np.asarray(r.quals, dtype=np.int64) for r in legacy])

        flat_p, flat_qi, flat_rid = _flat_arrays(kept, n)
        rlens = np.array([len(r.seq) for r in kept], dtype=np.int64)
        roffs = np.concatenate(([0], np.cumsum(rlens)))
        Qcat = np.concatenate(
            [np.asarray(r.quals, dtype=np.int64) for r in kept])
        Scat = np.frombuffer("".join(r.seq for r in kept).encode(), np.uint8)
        aqi = roffs[flat_rid] + flat_qi
        pairedok = np.fromiter((r.is_paired and r.is_proper for r in kept),
                               bool, len(kept))
        qnames = [r.qname for r in kept]
        rs_arr = np.fromiter((r.rs for r in kept), np.int64, len(kept))
        _apply_overlap_tweaks_flat(pairedok, qnames, rs_arr, flat_p, aqi,
                                   flat_rid, Qcat, Scat, n)

        assert np.array_equal(Qcat, q_legacy), f"trial {trial} diverged"


def test_cal_arrays_matches_scalar():
    """Vectorized errmod (cal_arrays) must be float-exact vs the scalar walk."""
    from panmap_tpu.genotype.caller import ErrMod

    rng = random.Random(3)
    em = ErrMod()
    em2 = ErrMod()
    for trial in range(200):
        n = rng.choice([1, 2, 3, 7, 40, 200, 255, 300])
        entries = [(rng.randrange(4, 64), rng.getrandbits(1),
                    rng.choice([0, 1, 2, 3, 4]))
                   for _ in range(n)]
        q = np.array([e[0] for e in entries], dtype=np.int64)
        s = np.array([e[1] for e in entries], dtype=np.int8)
        b = np.array([e[2] for e in entries], dtype=np.int64)
        out1, bsum1, c1 = em.cal(entries)
        out2, bsum2, c2 = em2.cal_arrays(q, s, b)
        assert np.array_equal(out1, out2), trial
        assert np.array_equal(bsum1, bsum2), trial
        assert np.array_equal(c1, c2), trial


def test_cal_columns_matches_cal_arrays():
    """All-columns errmod must equal the per-column oracle float-exact."""
    from panmap_tpu.genotype.caller import ERRMOD_MAXN, ErrMod, _cumcount

    rng = random.Random(9)
    em = ErrMod()
    ncol = 60
    cols, qs, ss, bs = [], [], [], []
    for c in range(ncol):
        n = rng.choice([0, 1, 2, 5, 30, 200, 255, 300])
        for _ in range(n):
            cols.append(c)
            qs.append(rng.randrange(4, 64))
            ss.append(rng.getrandbits(1))
            bs.append(rng.choice([0, 1, 2, 3, 4]))
    col = np.array(cols, np.int64)
    q = np.array(qs, np.int64)
    s = np.array(ss, np.int8)
    b = np.array(bs, np.int64)
    capped = _cumcount(col) < ERRMOD_MAXN
    diag, bsum, cc = em.cal_columns(col[capped], q[capped], s[capped],
                                    b[capped], ncol)
    for c in range(ncol):
        m = col == c
        out1, bsum1, c1 = em.cal_arrays(q[m], s[m], b[m])
        assert np.array_equal(np.diag(out1)[:5], diag[c]), c
        assert np.array_equal(bsum1, bsum[c]), c
        assert np.array_equal(c1, cc[c]), c


def _random_columnar(rng, ref, nreads=240, paired=True):
    """Random aligned read set in columnar form (cigars incl. soft clips,
    oriented blobs), mirroring what _emit_columnar produces."""
    import numpy as np

    from panmap_tpu.genotype.caller import ColumnarReads

    n = len(ref)
    rs, stream, coff, seqs, quals, mapq, rev, proper, names = \
        [], [], [0], [], [], [], [], [], []
    for i in range(nreads):
        L = int(rng.integers(60, 120))
        p0 = int(rng.integers(0, n - L - 20))
        words = []
        # optional 5' clip
        c5 = int(rng.integers(0, 8)) if rng.random() < 0.3 else 0
        if c5:
            words.append((c5 << 4) | 4)
        qleft = L - c5
        # body: M with occasional I/D
        while qleft > 0:
            m = min(qleft, int(rng.integers(20, 60)))
            words.append((m << 4) | 0)
            qleft -= m
            if qleft > 3 and rng.random() < 0.35:
                if rng.random() < 0.5:
                    ln = int(rng.integers(1, 3))
                    words.append((ln << 4) | 1)  # I
                    qleft -= ln
                else:
                    ln = int(rng.integers(1, 4))
                    words.append((ln << 4) | 2)  # D
        # optional 3' clip folded from the tail M
        seq = "".join(rng.choice(list("ACGT"), L))
        qual = rng.integers(8, 42, L).astype(np.uint8)
        rs.append(p0)
        stream.extend(words)
        coff.append(len(stream))
        seqs.append(seq)
        quals.append(qual)
        mapq.append(int(rng.integers(20, 60)))
        rev.append(bool(rng.random() < 0.5))
        proper.append(bool(rng.random() < 0.9) if paired else False)
        names.append(f"r{i//2}" if paired else f"r{i}")
    soff = np.concatenate(([0], np.cumsum([len(s) for s in seqs])))
    return ColumnarReads(
        rs=np.array(rs, np.int64),
        stream=np.array(stream, np.uint32),
        coff=np.array(coff, np.int64),
        seq_blob=np.frombuffer("".join(seqs).encode(), np.uint8).copy(),
        qual_blob=np.concatenate(quals),
        soff=soff.astype(np.int64),
        mapq=np.array(mapq, np.int64),
        rev=np.array(rev, bool),
        proper=np.array(proper, bool),
        paired=paired,
        qnames=names)


def test_pileup_columnar_matches_object_front_end():
    """pileup_call_columnar (vectorized cigar walk over the flat stream) must
    produce record-identical output to pileup_call on PlacedRead objects —
    incl. indel events, soft clips, orphan skip and mate-overlap tweaks."""
    import numpy as np

    from panmap_tpu.genotype.caller import pileup_call, pileup_call_columnar
    from panmap_tpu.pipeline import _columnar_to_placed

    rng = np.random.default_rng(31)
    ref = "".join(rng.choice(list("ACGT"), 3000))
    for paired in (True, False):
        cols = _random_columnar(rng, ref, paired=paired)
        rec_c = pileup_call_columnar(ref, cols)
        # object twin via the pipeline's converter
        placed = _columnar_to_placed(cols)
        rec_o = pileup_call(ref, placed)
        assert len(rec_c) == len(rec_o), paired
        for a, b in zip(rec_c, rec_o):
            assert (a.pos, a.ref, a.alts, a.gt, a.pls, a.ads, a.dp, a.qual) \
                == (b.pos, b.ref, b.alts, b.gt, b.pls, b.ads, b.dp, b.qual)


def test_device_tally_matches_numpy(monkeypatch):
    """PANMAP_DEVICE=1 (the device decision's force switch) routes the
    column tallies through the jitted scatter-add program; records must be
    identical (int quality sums are exact in f32)."""
    import numpy as np

    from panmap_tpu.genotype.caller import pileup_call_columnar

    rng = np.random.default_rng(33)
    ref = "".join(rng.choice(list("ACGT"), 2000))
    cols = _random_columnar(rng, ref, nreads=160)
    from panmap_tpu.genotype.caller import TALLY_STATS

    base = pileup_call_columnar(ref, cols)
    calls = TALLY_STATS["calls"]
    monkeypatch.setenv("PANMAP_DEVICE", "1")
    dev = pileup_call_columnar(ref, cols)
    assert TALLY_STATS["calls"] > calls
    assert len(base) == len(dev)
    for a, b in zip(base, dev):
        assert (a.pos, a.ref, a.alts, a.gt, a.pls, a.ads, a.dp, a.qual) \
            == (b.pos, b.ref, b.alts, b.gt, b.pls, b.ads, b.dp, b.qual)


def test_pair_ids_branch_matches_qname_branch_with_duplicate_names():
    """The structural pair_ids fast path must reproduce the qname branch
    exactly — including the oracle's skip of names seen != 2 times among the
    kept paired reads (two distinct pairs sharing a qname get NO tweak)."""
    rng = random.Random(13)
    n = 1000
    for trial in range(10):
        kept = _mk_reads(rng, n_pairs=10, ref_len=n)
        # give two distinct pairs the same name (4 reads share "dupname")
        for r in kept[0:2] + kept[4:6]:
            r.qname = "dupname"

        flat_p, flat_qi, flat_rid = _flat_arrays(kept, n)
        rlens = np.array([len(r.seq) for r in kept], dtype=np.int64)
        roffs = np.concatenate(([0], np.cumsum(rlens)))
        Qcat_a = np.concatenate(
            [np.asarray(r.quals, dtype=np.int64) for r in kept])
        Qcat_b = Qcat_a.copy()
        Scat = np.frombuffer("".join(r.seq for r in kept).encode(), np.uint8)
        aqi = roffs[flat_rid] + flat_qi
        pairedok = np.fromiter((r.is_paired and r.is_proper for r in kept),
                               bool, len(kept))
        qnames = [r.qname for r in kept]
        rs_arr = np.fromiter((r.rs for r in kept), np.int64, len(kept))
        # reads were built pairwise adjacent: structural ids = i // 2
        pair_ids = np.arange(len(kept), dtype=np.int64) // 2

        _apply_overlap_tweaks_flat(pairedok, qnames, rs_arr, flat_p, aqi,
                                   flat_rid, Qcat_a, Scat, n)
        _apply_overlap_tweaks_flat(pairedok, qnames, rs_arr, flat_p, aqi,
                                   flat_rid, Qcat_b, Scat, n,
                                   pair_ids=pair_ids)
        assert np.array_equal(Qcat_a, Qcat_b), f"trial {trial} diverged"


def test_duplicate_qname_cross_pairs_intentional_divergence():
    """Documented intentional divergence (malformed input): a qname seen
    exactly TWICE among kept paired reads but in two different structural
    pairs (each fragment's true mate dropped).  The qname branch pairs the
    two unrelated reads and tweaks them; the structural pair_ids branch sees
    two singleton groups and applies no tweak — the more correct answer,
    kept deliberately (see caller._apply_overlap_tweaks_flat)."""
    n = 1000
    mk = lambda rs, name, L=100: PlacedRead(
        rs=rs, cigar=[(L, "M")], seq="A" * L, quals=[30] * L, qs=0,
        qname=name, is_proper=True, is_paired=True, mapq=60, rev=False)
    # two fragments, same qname, heavily overlapping; their true mates are
    # NOT in `kept` (structural groups 0 and 1 are singletons)
    kept = [mk(100, "dup"), mk(120, "dup")]
    flat_p, flat_qi, flat_rid = _flat_arrays(kept, n)
    rlens = np.array([len(r.seq) for r in kept], dtype=np.int64)
    roffs = np.concatenate(([0], np.cumsum(rlens)))
    Qcat_q = np.concatenate([np.asarray(r.quals, np.int64) for r in kept])
    Qcat_s = Qcat_q.copy()
    orig = Qcat_q.copy()
    Scat = np.frombuffer("".join(r.seq for r in kept).encode(), np.uint8)
    aqi = roffs[flat_rid] + flat_qi
    pairedok = np.array([True, True])
    qnames = [r.qname for r in kept]
    rs_arr = np.array([r.rs for r in kept], dtype=np.int64)
    _apply_overlap_tweaks_flat(pairedok, qnames, rs_arr, flat_p, aqi,
                               flat_rid, Qcat_q, Scat, n)
    _apply_overlap_tweaks_flat(pairedok, qnames, rs_arr, flat_p, aqi,
                               flat_rid, Qcat_s, Scat, n,
                               pair_ids=np.array([0, 1], dtype=np.int64))
    assert not np.array_equal(Qcat_q, orig), "qname branch should tweak"
    assert np.array_equal(Qcat_s, orig), "structural branch must not tweak"


def test_snp_prefilter_sound():
    """The spectrum-driven SNP column prefilter must be SOUND: records
    surviving apply_spectrum are identical with and without pruning, for
    no-prior (None), realistic priors, and a degenerate prior that disables
    the prune (off-diagonal <= diagonal)."""
    import random

    from panmap_tpu.genotype.caller import apply_spectrum, pileup_call

    rng = random.Random(23)
    n = 600
    ref = "".join(rng.choice(BASES) for _ in range(n))
    reads = []
    for i in range(300):
        L = 90
        p = rng.randrange(0, n - L)
        frag = list(ref[p:p + L])
        for j in range(L):
            if rng.random() < 0.02:  # errors
                frag[j] = BASES[(BASES.find(frag[j]) + 1) % 4]
        if rng.random() < 0.05:  # a few strong alt sites
            frag[L // 2] = BASES[(BASES.find(frag[L // 2]) + 2) % 4]
        reads.append(PlacedRead(
            rs=p, cigar=[(L, "M")], seq="".join(frag),
            quals=[rng.randrange(15, 50) for _ in range(L)], qs=0,
            qname=f"r{i}", is_proper=False, is_paired=False, mapq=60,
            rev=bool(rng.getrandbits(1))))
    spectra = [
        None,
        np.array([[0.5, 30, 25, 30], [30, 0.2, 30, 22],
                  [25, 30, 0.0, 30], [30, 22, 30, 0.1]], float),
        np.array([[10.0, 5, 5, 5], [5, 10, 5, 5],
                  [5, 5, 10, 5], [5, 5, 5, 10]], float),  # guard-fail: no prune
    ]
    for sp in spectra:
        base = pileup_call(ref, [copyreads(r) for r in reads])
        pruned = pileup_call(ref, [copyreads(r) for r in reads], spectrum=sp)
        fa = apply_spectrum(base, sp, 1, 0.0)
        fb = apply_spectrum(pruned, sp, 1, 0.0)
        key = lambda r: (r.pos, r.ref, tuple(r.alts), r.gt, tuple(r.pls))
        assert [key(r) for r in fa] == [key(r) for r in fb]
        assert len(pruned) <= len(base)


def copyreads(r):
    import copy

    return copy.deepcopy(r)
