"""Seed-and-extend short-read aligner (minimap2-sr-equivalent behavior).

Replaces the reference's embedded minimap2 (src/mm_align.c:48-118 preset: k=21,
w=11, match=2, mismatch=8, gapo=12/24, gape=2/1, end_bonus=10, max_gap=100,
min_cnt=2, min_chain_score=25, min_dp_max=40, FR pairing) with an array program:

 - reference and reads are sketched with (w=11,k=21) canonical minimizers using
   minimap2's invertible hash (public scheme), so the anchor sets — and with
   them which reads map at all — closely track the reference aligner;
 - anchors vote on (diagonal, strand); the best cluster must clear min_cnt and
   an approximate chain score before extension;
 - extension: gather+compare along the diagonal with a prefix-max soft-clip trim
   (end bonus), then a banded affine-gap DP rescue whenever clips could hide
   indels; alignments below min_dp_max are dropped;
 - pairing (mm_pair semantics, src/3rdparty/minimap2/pe.c:76-180): both mates
   mapped on the same strand of the pre-reverse-complemented pair, left mate
   first in (rs, seg) order, gap under max_gap_ref -> proper_frag; bcftools'
   default orphan skip makes this flag load-bearing downstream.

The batch path (align/batch.py) reuses this module's plumbing with a
vectorized front-end; its full-window DP scoring runs on the device
(align/sw_device.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# sr scoring (mm_align.c:79-101)
MATCH = 2
MISMATCH = 8
GAP_OPEN = 12
GAP_EXT = 2
GAP_OPEN2 = 24
GAP_EXT2 = 1
END_BONUS = 10
MAX_GAP = 100
MAX_GAP_REF = 5000
MAX_FRAG_LEN = 800
KMER = 21
WINDOW = 11
MIN_CNT = 2
MIN_CHAIN_SCORE = 25
MIN_DP_MAX = 40

_ENC = np.full(256, 4, dtype=np.uint8)
for i, c in enumerate("ACGT"):
    _ENC[ord(c)] = i
    _ENC[ord(c.lower())] = i
_RC_CODE = np.array([3, 2, 1, 0, 4], dtype=np.uint8)


def encode(seq_bytes: np.ndarray) -> np.ndarray:
    return _ENC[seq_bytes]


def _hash64(key: np.ndarray, mask: np.uint64) -> np.ndarray:
    """minimap2's invertible integer hash (sketch.c hash64)."""
    key = (~key + (key << np.uint64(21))) & mask
    key = key ^ (key >> np.uint64(24))
    key = (key + (key << np.uint64(3)) + (key << np.uint64(8))) & mask
    key = key ^ (key >> np.uint64(14))
    key = (key + (key << np.uint64(2)) + (key << np.uint64(4))) & mask
    key = key ^ (key >> np.uint64(28))
    key = (key + (key << np.uint64(31))) & mask
    return key


def _packed_kmers(codes2: np.ndarray, k: int):
    """(fwd u64, rc u64, valid bool) 2-bit packed k-mers at every position."""
    n = len(codes2)
    if n < k:
        z = np.empty(0, np.uint64)
        return z, z, np.empty(0, bool)
    m = n - k + 1
    x = codes2.astype(np.uint64)
    xr = (np.uint64(3) - np.minimum(codes2, 3).astype(np.uint64))  # complement
    fwd = np.zeros(m, dtype=np.uint64)
    rev = np.zeros(m, dtype=np.uint64)
    for i in range(k):
        fwd = (fwd << np.uint64(2)) | x[i : i + m]
        rev |= xr[i : i + m] << np.uint64(2 * i)
    bad = (codes2 >= 4).astype(np.int32)
    cb = np.concatenate(([0], np.cumsum(bad)))
    valid = (cb[k:] - cb[:-k]) == 0
    mask = np.uint64((1 << (2 * k)) - 1)
    return fwd & mask, rev & mask, valid


def minimizer_sketch(codes2: np.ndarray, k: int = KMER, w: int = WINDOW):
    """Canonical (w,k)-minimizers: (positions, hash, strand) — mm_sketch
    equivalent (strand-ambiguous and N-containing k-mers skipped)."""
    fwd, rev, valid = _packed_kmers(codes2, k)
    m = len(fwd)
    if m == 0:
        return (np.empty(0, np.int32), np.empty(0, np.uint64), np.empty(0, np.uint8))
    mask = np.uint64((1 << (2 * k)) - 1)
    strand = (rev < fwd).astype(np.uint8)
    canon = np.where(strand == 1, rev, fwd)
    ok = valid & (fwd != rev)
    h = _hash64(canon, mask)
    BIG = np.uint64(0xFFFFFFFFFFFFFFFF)
    h = np.where(ok, h, BIG)
    if m <= w:
        j = int(np.argmin(h))
        if h[j] == BIG:
            return (np.empty(0, np.int32), np.empty(0, np.uint64), np.empty(0, np.uint8))
        return (np.array([j], np.int32), h[j : j + 1], strand[j : j + 1])
    from numpy.lib.stride_tricks import sliding_window_view

    wm = sliding_window_view(h, w).min(axis=-1)
    # position j is a minimizer if h[j] equals the min of some window containing j
    nwin = len(wm)
    is_min = np.zeros(m, dtype=bool)
    # expand: for each window i (positions i..i+w-1) mark matches
    for off in range(w):
        idx = np.arange(nwin) + off
        is_min[idx] |= h[idx] == wm
    is_min &= h != BIG
    pos = np.flatnonzero(is_min).astype(np.int32)
    return pos, h[pos], strand[pos]


@dataclass
class Alignment:
    mapped: bool = False
    rs: int = 0  # 0-based ref start
    re: int = 0  # ref end (exclusive)
    qs: int = 0  # query start on ORIGINAL strand
    qe: int = 0
    rev: bool = False
    mapq: int = 0
    score: int = 0
    proper_frag: bool = False
    cigar: list = field(default_factory=list)  # [(len, op)] ref-orientation, no clips
    nm: int = 0


class RefIndex:
    """Minimizer table over the reference: sorted hashes -> (pos, strand) lists."""

    def __init__(self, ref: str, k: int = KMER, w: int = WINDOW):
        self.k = k
        self.w = w
        self.ref_bytes = np.frombuffer(ref.encode(), dtype=np.uint8)
        self.codes2 = encode(self.ref_bytes)
        self.n = len(ref)
        pos, h, strand = minimizer_sketch(self.codes2, k, w)
        order = np.argsort(h, kind="stable")
        self.h = h[order]
        self.pos = pos[order]
        self.strand = strand[order]
        # occurrence bounds per unique hash
        self.uh, self.ustart = np.unique(self.h, return_index=True)
        self.uend = np.append(self.ustart[1:], len(self.h))

    def lookup_many(self, hashes: np.ndarray):
        """(start, end) ranges into (pos,strand) arrays; start==end => miss."""
        ii = np.searchsorted(self.uh, hashes)
        iic = np.minimum(ii, max(len(self.uh) - 1, 0))
        hit = len(self.uh) > 0
        if not hit:
            z = np.zeros(len(hashes), np.int64)
            return z, z
        found = self.uh[iic] == hashes
        start = np.where(found, self.ustart[iic], 0)
        end = np.where(found, self.uend[iic], 0)
        return start, end


def banded_affine_dp(q: np.ndarray, r: np.ndarray):
    """Local affine-gap DP (Gotoh) with query-end bonus; returns (score, qs, qe,
    rs, re, cigar). Row-vectorized; the same formulation the Pallas kernel uses."""
    lq, lr = len(q), len(r)
    NEG = np.int32(-(1 << 28))
    H = np.zeros((lq + 1, lr + 1), dtype=np.int32)
    # query-start bonus: paths that include the first query base start from
    # END_BONUS, mirroring minimap2's end_bonus on both query ends
    H[0, :] = END_BONUS
    E = np.full((lq + 1, lr + 1), NEG, dtype=np.int32)
    F = np.full((lq + 1, lr + 1), NEG, dtype=np.int32)
    sub = np.where(
        (q[:, None] == r[None, :]) & (q[:, None] < 4), MATCH, -MISMATCH
    ).astype(np.int32)
    idx = np.arange(lr + 1, dtype=np.int32)
    best = (0, 0, 0)
    for i in range(1, lq + 1):
        F[i] = np.maximum(H[i - 1] - GAP_OPEN, F[i - 1] - GAP_EXT)
        base = np.zeros(lr + 1, dtype=np.int32)
        base[1:] = np.maximum(H[i - 1, :-1] + sub[i - 1], F[i, 1:])
        base = np.maximum(base, 0)
        pm = np.maximum.accumulate(base + idx * GAP_EXT)
        E[i, 1:] = pm[:-1] - GAP_OPEN - (idx[1:] - 1) * GAP_EXT
        H[i] = np.maximum(base, E[i])
        jmax = int(np.argmax(H[i]))
        sc = int(H[i][jmax])
        bonus = END_BONUS if i == lq else 0
        if sc + bonus > best[0]:
            best = (sc + bonus, i, jmax)
    score, bi, bj = best
    if score <= 0 or bi == 0 or bj == 0:
        return 0, 0, 0, 0, 0, []
    i, j = bi, bj
    ops = []
    state = "H"
    while i > 0 and j > 0:
        if state == "H":
            h = H[i, j]
            if h == 0:
                break
            if h == H[i - 1, j - 1] + sub[i - 1, j - 1]:
                ops.append("M")
                i -= 1
                j -= 1
            elif h == E[i, j]:
                state = "E"
            elif h == F[i, j]:
                state = "F"
            else:
                ops.append("M")
                i -= 1
                j -= 1
        elif state == "E":
            ops.append("D")
            if j > 1 and E[i, j] == E[i, j - 1] - GAP_EXT:
                j -= 1
            else:
                j -= 1
                state = "H"
        else:
            ops.append("I")
            if i > 1 and F[i, j] == F[i - 1, j] - GAP_EXT:
                i -= 1
            else:
                i -= 1
                state = "H"
    ops.reverse()
    cigar = []
    for op in ops:
        if cigar and cigar[-1][1] == op:
            cigar[-1] = (cigar[-1][0] + 1, op)
        else:
            cigar.append((1, op))
    return score, i, bi, j, bj, cigar


def _collapse(ops: list) -> list:
    out = []
    for ln, op in ops:
        if out and out[-1][1] == op:
            out[-1] = (out[-1][0] + ln, op)
        else:
            out.append((ln, op))
    return out


def extension_dp(q: np.ndarray, r: np.ndarray):
    """Affine-gap extension from the origin (ksw2-extension equivalent): the
    alignment is anchored at (0,0) and may end anywhere; reaching the query end
    earns END_BONUS.  Returns (score, qe, re, cigar) with score<=0 => no gain.
    Small inputs only (clipped tails), row-vectorized like banded_affine_dp."""
    lq, lr = len(q), len(r)
    if lq == 0 or lr == 0:
        return 0, 0, 0, []
    NEG = np.int32(-(1 << 28))
    H = np.full((lq + 1, lr + 1), NEG, dtype=np.int32)
    E = np.full((lq + 1, lr + 1), NEG, dtype=np.int32)
    F = np.full((lq + 1, lr + 1), NEG, dtype=np.int32)
    H[0, 0] = 0
    idx = np.arange(lr + 1, dtype=np.int32)
    H[0, 1:] = -(GAP_OPEN + (idx[1:] - 1) * GAP_EXT)
    sub = np.where((q[:, None] == r[None, :]) & (q[:, None] < 4),
                   MATCH, -MISMATCH).astype(np.int32)
    best = (0, 0, 0)
    for i in range(1, lq + 1):
        F[i] = np.maximum(H[i - 1] - GAP_OPEN, F[i - 1] - GAP_EXT)
        base = np.full(lr + 1, NEG, dtype=np.int32)
        base[1:] = np.maximum(H[i - 1, :-1] + sub[i - 1], F[i, 1:])
        base[0] = -(GAP_OPEN + (i - 1) * GAP_EXT)
        pm = np.maximum.accumulate(base + idx * GAP_EXT)
        E[i, 1:] = pm[:-1] - GAP_OPEN - (idx[1:] - 1) * GAP_EXT
        H[i] = np.maximum(base, E[i])
        jmax = int(np.argmax(H[i]))
        sc = int(H[i][jmax]) + (END_BONUS if i == lq else 0)
        if sc > best[0]:
            best = (sc, i, jmax)
    score, bi, bj = best
    if score <= 0:
        return 0, 0, 0, []
    i, j = bi, bj
    ops = []
    state = "H"
    while i > 0 or j > 0:
        if state == "H":
            if i == 0:
                ops.extend("D" * j)
                break
            if j == 0:
                ops.extend("I" * i)
                break
            h = H[i, j]
            if h == H[i - 1, j - 1] + sub[i - 1, j - 1]:
                ops.append("M")
                i -= 1
                j -= 1
            elif h == E[i, j]:
                state = "E"
            elif h == F[i, j]:
                state = "F"
            else:
                ops.append("M")
                i -= 1
                j -= 1
        elif state == "E":
            ops.append("D")
            if j > 1 and E[i, j] == E[i, j - 1] - GAP_EXT:
                j -= 1
            else:
                j -= 1
                state = "H"
        else:
            ops.append("I")
            if i > 1 and F[i, j] == F[i - 1, j] - GAP_EXT:
                i -= 1
            else:
                i -= 1
                state = "H"
    ops.reverse()
    cigar = []
    for op in ops:
        if cigar and cigar[-1][1] == op:
            cigar[-1] = (cigar[-1][0] + 1, op)
        else:
            cigar.append((1, op))
    return score, bi, bj, cigar


class Aligner:
    """Map a batch of reads against one reference (minimap2-sr equivalent)."""

    def __init__(self, ref: str, k: int = KMER, w: int = WINDOW):
        self.ref = ref
        self.index = RefIndex(ref, k, w)
        self.k = k
        self.w = w

    def align_read(self, seq: str) -> Alignment:
        codes2 = encode(np.frombuffer(seq.encode(), dtype=np.uint8))
        lq = len(codes2)
        qpos, qh, qstrand = minimizer_sketch(codes2, self.k, self.w)
        aln = Alignment()
        if len(qpos) == 0:
            return aln
        start, end = self.index.lookup_many(qh)
        # build anchors (ref_pos, q_pos, rel_strand)
        counts = (end - start).astype(np.int64)
        tot = int(counts.sum())
        if tot == 0:
            return aln
        rpos = np.empty(tot, np.int64)
        qq = np.empty(tot, np.int64)
        rel = np.empty(tot, np.uint8)
        o = 0
        for a in range(len(qpos)):
            c = int(counts[a])
            if c == 0:
                continue
            s0, e0 = int(start[a]), int(end[a])
            rpos[o : o + c] = self.index.pos[s0:e0]
            qq[o : o + c] = qpos[a]
            rel[o : o + c] = self.index.strand[s0:e0] ^ qstrand[a]
            o += c
        # diagonal clusters per strand; for rev anchors the read coordinate flips
        best = None
        second_votes = 0
        for strand_rel in (0, 1):
            m = rel == strand_rel
            if not m.any():
                continue
            if strand_rel == 0:
                diags = rpos[m] - qq[m]
                qv = qq[m]
            else:
                # reverse: read pos p maps near ref pos diag + (lq - k - p)
                diags = rpos[m] - (lq - self.k - qq[m])
                qv = lq - self.k - qq[m]
            # cluster diagonals within MAX_GAP
            order = np.argsort(diags, kind="stable")
            d = diags[order]
            q_o = qv[order]
            # split where diag jumps > MAX_GAP
            splits = np.flatnonzero(np.diff(d) > MAX_GAP)
            starts = np.concatenate(([0], splits + 1))
            ends = np.concatenate((splits + 1, [len(d)]))
            for a0, b0 in zip(starts, ends):
                votes = b0 - a0
                qmin, qmax = int(q_o[a0:b0].min()), int(q_o[a0:b0].max())
                span = min(qmax - qmin + self.k, lq)
                cand = (votes, span, int(np.median(d[a0:b0])), strand_rel,
                        int(d[a0:b0].min()), int(d[a0:b0].max()))
                if best is None or (votes, span) > (best[0], best[1]):
                    if best is not None:
                        second_votes = max(second_votes, best[0])
                    best = cand
                elif votes > second_votes:
                    second_votes = votes
        if best is None:
            return aln
        votes, span, diag, strand_rel, dmin, dmax = best
        if votes < MIN_CNT or span < MIN_CHAIN_SCORE:
            return aln
        oriented = codes2 if strand_rel == 0 else _RC_CODE[codes2[::-1]]
        aln = self._extend(oriented, diag, dmin, dmax, votes, second_votes)
        if not aln.mapped:
            return aln
        aln.rev = bool(strand_rel)
        if aln.rev:
            aln.qs, aln.qe = lq - aln.qe, lq - aln.qs
        return aln

    def _extend(self, q: np.ndarray, diag: int, dmin: int, dmax: int,
                votes: int, second_votes: int) -> Alignment:
        lq = len(q)
        ref = self.index.codes2
        lr = len(ref)
        aln = Alignment()

        def finish(score, qs, qe, rs, re, cigar, nm):
            if score < MIN_DP_MAX:
                return aln
            aln.mapped = True
            aln.score = score
            aln.qs, aln.qe, aln.rs, aln.re = qs, qe, rs, re
            aln.cigar = cigar
            aln.nm = nm
            if votes >= 3 and second_votes * 2 <= votes:
                aln.mapq = 60
            else:
                aln.mapq = max(1, min(60, int(40 * (1 - (second_votes + 1) / (votes + 1)))))
            return aln

        rs0 = diag
        q_lo = max(0, -rs0)
        q_hi = min(lq, lr - rs0)
        if q_hi - q_lo >= self.k and dmin == dmax:
            seg_q = q[q_lo:q_hi]
            seg_r = ref[rs0 + q_lo : rs0 + q_hi]
            match = (seg_q == seg_r) & (seg_q < 4)
            contrib = np.where(match, MATCH, -MISMATCH).astype(np.int64)
            S = np.concatenate(([0], np.cumsum(contrib)))
            n = len(contrib)
            start_bonus = np.zeros(n + 1, dtype=np.int64)
            if q_lo == 0:
                start_bonus[0] = END_BONUS
            lead = -S + start_bonus
            best_lead = np.maximum.accumulate(lead)
            end_bonus = np.zeros(n + 1, dtype=np.int64)
            if q_hi == lq:
                end_bonus[n] = END_BONUS
            totals = S + end_bonus + best_lead
            j = int(np.argmax(totals[1:]) + 1)
            i = int(np.argmax(lead[: j + 1]))
            score = int(totals[j])
            raw_score = score
            if q_lo == 0 and i == 0:
                raw_score -= END_BONUS
            if q_hi == lq and j == n:
                raw_score -= END_BONUS
            qs = q_lo + i
            qe = q_lo + j
            clip5 = qs
            clip3 = lq - qe
            if score > 0 and (clip5 < 10 and clip3 < 10):
                return finish(raw_score, qs, qe, rs0 + qs, rs0 + qe,
                              [(qe - qs, "M")], int((~match[i:j]).sum()))
            if score > 0:
                # gapped tail rescue: extend clipped ends from the core segment
                # (minimap2 extends outward from the terminal anchors)
                core_score = raw_score
                cigar = [(qe - qs, "M")]
                nm = int((~match[i:j]).sum())
                rs = rs0 + qs
                re_ = rs0 + qe
                if clip3 >= 10:
                    tail = q[qe:]
                    rwin = ref[re_: min(lr, re_ + len(tail) + MAX_GAP + 16)]
                    esc, qext, rext, ecig = extension_dp(tail, rwin)
                    if esc > 0 and ecig:
                        cigar = _collapse(cigar + ecig)
                        nm += sum(ln for ln, op in ecig if op != "M")
                        qe += qext
                        re_ += rext
                        core_score += esc - (END_BONUS if qe == lq else 0)
                if clip5 >= 10:
                    head = q[:qs][::-1]
                    wlo = max(0, rs - len(head) - MAX_GAP - 16)
                    rwin = ref[wlo:rs][::-1]
                    esc, qext, rext, ecig = extension_dp(head, rwin)
                    if esc > 0 and ecig:
                        ecig = list(reversed(ecig))
                        cigar = _collapse(ecig + cigar)
                        nm += sum(ln for ln, op in ecig if op != "M")
                        qs -= qext
                        rs -= rext
                        core_score += esc - (END_BONUS if qs == 0 else 0)
                return finish(core_score, qs, qe, rs, re_, cigar, nm)
        # DP path (multi-diagonal cluster => likely indel inside the span)
        lo = max(0, min(dmin, dmax) - MAX_GAP - 10)
        hi = min(lr, max(dmin, dmax) + lq + MAX_GAP + 10)
        if hi <= lo:
            return aln
        if lq * (hi - lo) > 8_000_000 and dmin != dmax:
            # genome-scale query: full DP would blow up; anchor on the best
            # diagonal and let the verify+extension path handle it
            return self._extend(q, diag, diag, diag, votes, second_votes)
        window = ref[lo:hi]
        score, qs, qe, rsw, rew, cigar = banded_affine_dp(q, window)
        if score <= 0 or not cigar:
            return aln
        nm = sum(ln for ln, op in cigar if op != "M")
        return finish(score, qs, qe, lo + rsw, lo + rew, cigar, nm)

    def align_pairs(self, seqs: list, paired: bool):
        """mm_align.c:238-279 pairing semantics over pre-interleaved reads
        (R2 already reverse-complemented)."""
        out = []
        if paired:
            for i in range(0, len(seqs) - 1, 2):
                a1 = self.align_read(seqs[i])
                a2 = self.align_read(seqs[i + 1])
                if a1.mapped and a2.mapped:
                    a1.proper_frag = a2.proper_frag = self._proper(a1, a2)
                else:
                    a1.mapped = a2.mapped = False
                out.append((a1, a2))
        else:
            for s in seqs:
                out.append((self.align_read(s), None))
        return out

    @staticmethod
    def _proper(a1: Alignment, a2: Alignment) -> bool:
        """mm_pair (pe.c:104-139): same strand; the left mate must be seg0 for
        forward pairs / seg1 for reverse pairs (ties broken in seg order); ref
        gap below max_gap_ref."""
        if a1.rev != a2.rev:
            return False
        if not a1.rev:
            left, right = a1, a2
            ok_order = a1.rs <= a2.rs
        else:
            left, right = a2, a1
            ok_order = a2.rs <= a1.rs
        if not ok_order:
            return False
        return right.rs - left.re <= MAX_GAP_REF
