"""Batched short-read alignment: the whole read set as array programs.

Same semantics as align/core.py (minimap2-sr-equivalent seeding, thresholds,
verify + prefix-max soft-clip trim, DP rescue), but vectorized across the full
batch: one minimizer scan over the [N, L] read matrix, one searchsorted join
into the reference minimizer table, sort+reduceat diagonal clustering, and a
batched gather/compare/trim for the (dominant) substitution-only path.  Only
reads that need indel rescue drop into the per-read banded DP.
"""

from __future__ import annotations

import numpy as np

from .core import (
    Alignment,
    END_BONUS,
    KMER,
    MATCH,
    MAX_GAP,
    MIN_CHAIN_SCORE,
    MIN_CNT,
    MIN_DP_MAX,
    MISMATCH,
    WINDOW,
    Aligner,
    _hash64,
    banded_affine_dp,
    encode,
)

_RC = np.array([3, 2, 1, 0, 4], dtype=np.uint8)
# windows scored by the device DP stage in this process (smoke reporting)
DEVICE_TOTALS = {"scored": 0}


def batch_minimizers(reads: np.ndarray, lens: np.ndarray, k: int = KMER,
                     w: int = WINDOW):
    """[N, L] u8 codes -> flattened minimizer anchors (read, qpos, hash, strand)."""
    N, L = reads.shape
    m = L - k + 1
    if m <= 0:
        z = np.empty(0, np.int64)
        return z, z, np.empty(0, np.uint64), np.empty(0, np.uint8)
    x = reads.astype(np.uint64)
    xr = (np.uint64(3) - np.minimum(reads, 3).astype(np.uint64))
    fwd = np.zeros((N, m), dtype=np.uint64)
    rev = np.zeros((N, m), dtype=np.uint64)
    for i in range(k):
        fwd = (fwd << np.uint64(2)) | x[:, i : i + m]
        rev |= xr[:, i : i + m] << np.uint64(2 * i)
    mask = np.uint64((1 << (2 * k)) - 1)
    fwd &= mask
    rev &= mask
    bad = (reads >= 4).astype(np.int32)
    cb = np.cumsum(bad, axis=1)
    amb = (cb[:, k - 1 :] - np.concatenate(
        [np.zeros((N, 1), np.int32), cb[:, : m - 1]], axis=1)) > 0
    in_read = (np.arange(m)[None, :] + k) <= lens[:, None]
    strand = (rev < fwd).astype(np.uint8)
    canon = np.where(strand == 1, rev, fwd)
    ok = ~amb & (fwd != rev) & in_read
    h = _hash64(canon, mask)
    BIG = np.uint64(0xFFFFFFFFFFFFFFFF)
    h = np.where(ok, h, BIG)
    if m <= w:
        jm = h.argmin(axis=1)
        sel = np.zeros((N, m), dtype=bool)
        sel[np.arange(N), jm] = h[np.arange(N), jm] != BIG
    else:
        from numpy.lib.stride_tricks import sliding_window_view

        wm = sliding_window_view(h, w, axis=1).min(axis=-1)
        nwin = wm.shape[1]
        # pad-independence: a window is real only if it lies fully within
        # the read's own k-mer positions (i + w <= lens - k + 1); windows
        # born from batch padding must not mint minimizers, else a read's
        # alignment would depend on its chunk's max length
        nvalid = (lens.astype(np.int64) - k - w + 2)[:, None]
        wm = np.where(np.arange(nwin)[None, :] < nvalid, wm, BIG)
        sel = np.zeros((N, m), dtype=bool)
        for off in range(w):
            idx = np.arange(nwin) + off
            sel[:, idx] |= h[:, idx] == wm
        sel &= h != BIG
        # reads with no full window (m_read <= w): single argmin, matching
        # core.minimizer_sketch's short-sequence branch
        short = np.flatnonzero((lens - k + 1 <= w) & (lens >= k))
        if len(short):
            jm = h[short].argmin(axis=1)
            sel[short] = False
            sel[short, jm] = h[short, jm] != BIG
    ridx, qpos = np.nonzero(sel)
    return ridx.astype(np.int64), qpos.astype(np.int64), h[ridx, qpos], strand[ridx, qpos]


class BatchAligner(Aligner):
    """Aligner with a vectorized batch front-end (native C++ core when the
    host library is available; the numpy path below is its bit-exact oracle,
    cross-checked by tests/test_align_native.py).

    The full-window banded DP (the ksw2-extension analog,
    src/mm_align.c:148-199 + 3rdparty/minimap2/ksw2_extz2_sse.c) is staged:
    the native front-end defers those rows (mapped==3), the device program
    (align/sw_device.py) scores the whole batch, rows below MIN_DP_MAX are
    dropped without traceback, and the host DP reruns only the survivors for
    their CIGARs.  Window padding only adds columns, so the device score is
    an upper bound of the real-window score — the gate is exact, and
    survivors are recomputed in full: outputs are identical to the all-host
    path by construction (tests/test_pallas_sw.py asserts it)."""

    CHUNK = 16384  # reads per vectorized pass: bounds the temporary matrices
    # (a single 102k-read pass allocated ~1.8 GB of fresh int64 planes; per-
    # chunk passes reuse the allocator's warm pages)

    use_native = True
    # "auto" -> utils.device.device_mode(); or "device" / None (host only)
    device_mode = "auto"
    # rolling stats of the device scoring stage (bench and smoke reporting)
    device_stats = None

    def _resolve_device_mode(self):
        if self.device_mode == "auto":
            from ..utils.device import device_mode

            self.device_mode = device_mode()
        return self.device_mode

    @staticmethod
    def precompute_minimizers(seqs: list, k: int = KMER, w: int = WINDOW):
        """Reference-independent phase 1 of the native aligner: per-read
        minimizer triples.  Run this while placement's device program is in
        flight (the alignment reference — the best node — is not known yet),
        then pass the handle as align_batch*(pre=...).  None without the
        native library (callers just skip the overlap)."""
        from ..native import min_sr_native

        return min_sr_native(seqs, k, w)

    def align_batch(self, seqs: list, pre: dict | None = None):
        """Returns list[Alignment] (one per read)."""
        if self.use_native:
            out = self._align_batch_native(seqs, pre)
            if out is not None:
                return out
        if len(seqs) > self.CHUNK:
            out = []
            for off in range(0, len(seqs), self.CHUNK):
                out.extend(self._align_chunk(seqs[off : off + self.CHUNK]))
            return out
        return self._align_chunk(seqs)

    _CIG_OPS = "MIDNSHP=X"

    def _align_batch_native(self, seqs: list, pre: dict | None = None):
        from ..native import align_sr_native

        mode = self._resolve_device_mode()
        res = align_sr_native(seqs, self.index.codes2, self.index.h,
                              self.index.pos, self.index.strand,
                              self.k, self.w, defer_dp=bool(mode), pre=pre)
        if res is None:
            return None
        if mode:
            self._resolve_deferred(seqs, res)
        n = len(seqs)
        out = [Alignment() for _ in range(n)]
        mapped = res["mapped"]
        lens = res["lens"]
        cig = res["cig"]
        ncig = res["ncig"]
        OPS = self._CIG_OPS
        for i in np.flatnonzero(mapped == 1):
            a = out[i]
            a.mapped = True
            a.rev = bool(res["rev"][i])
            a.rs = int(res["rs"][i])
            a.re = int(res["re"][i])
            q0, q1 = int(res["qs"][i]), int(res["qe"][i])
            if a.rev:
                lq = int(lens[i])
                a.qs, a.qe = lq - q1, lq - q0
            else:
                a.qs, a.qe = q0, q1
            a.score = int(res["score"][i])
            a.mapq = int(res["mapq"][i])
            a.nm = int(res["nm"][i])
            row = cig[i]
            a.cigar = [(int(row[c]) >> 4, OPS[int(row[c]) & 0xF])
                       for c in range(int(ncig[i]))]
        # cigar-capacity overflows: redo with the oracle path (per-read
        # independent, so a sub-list realignment is semantics-preserving)
        over = np.flatnonzero(mapped == 2)
        if len(over):
            redo = self._align_chunk([seqs[i] for i in over])
            for j, i in enumerate(over):
                out[i] = redo[j]
        return out

    # static shape tiers for the device scoring stage: every dispatch shape
    # is drawn from this small grid, so the set of compiled programs is
    # workload-independent and typical read sets land in ONE dispatch
    _LQ_TIERS = (256, 512)
    _LW_TIERS = (512, 1024, 2048)
    _B_TIERS = (64, 256, 1024, 4096)
    _B_CAP = 4096

    # Smaller deferred sets run the host DP.  This is not a measured
    # breakeven: on an H100 (tools/bench_device_defaults.py) the device stage
    # lost to the all-host DP at every set size measured, because every
    # deferred window survived the gate and the host then recomputes it for
    # its CIGAR.  The stage saves host work only for windows it drops, and a
    # read deferred for its multi-diagonal seed cluster scores above
    # MIN_DP_MAX.  64 (one B tier) keeps the device program on the main path
    # where the GPU smoke run checks it.
    MIN_DEVICE_WINDOWS = 64

    def _new_stats(self):
        if self.device_stats is None:
            self.device_stats = dict(deferred=0, device_scored=0,
                                     survivors=0, cells=0, device_s=0.0,
                                     routed_host=0)
        return self.device_stats

    def _resolve_deferred(self, seqs: list, res: dict):
        """Synchronous deferred resolution: dispatch + finish back-to-back."""
        fin = self._start_deferred(seqs, res)
        if fin is not None:
            fin()

    def _start_deferred(self, seqs: list, res: dict):
        """Score the mapped==3 rows (full-window banded DP) on the device.
        DISPATCHES the device programs (JAX dispatch is asynchronous) and
        returns a zero-arg finisher that blocks on the scores, drops rows
        under MIN_DP_MAX, and runs the host DP only for the survivors' CIGAR
        traceback.  Sets below the active breakeven run the host DP
        immediately (returns None, already resolved)."""
        rows = np.flatnonzero(res["mapped"] == 3)
        if len(rows) == 0:
            return None
        stats = self._new_stats()
        stats["deferred"] += len(rows)
        if len(rows) < self.MIN_DEVICE_WINDOWS:
            stats["survivors"] += len(rows)
            stats["routed_host"] += len(rows)
            self._host_dp_rows(seqs, res, rows.tolist())
            return None
        ref = self.index.codes2
        lens = res["lens"]

        queries = {}
        host_rows = []
        buckets = {}  # (lq_tier, lw_tier) -> list of row indices
        for r in rows.tolist():
            seq = seqs[r]
            codes = encode(np.frombuffer(seq.encode(), dtype=np.uint8))
            if res["rev"][r]:
                codes = _RC[codes[::-1]]
            queries[r] = codes
            lq = int(lens[r])
            lw = int(res["re"][r]) - int(res["rs"][r])
            lqt = next((t for t in self._LQ_TIERS if lq <= t), None)
            lwt = next((t for t in self._LW_TIERS if lw <= t), None)
            if lqt is None or lwt is None:
                host_rows.append(r)  # out-of-tier (rare): plain host DP
            else:
                buckets.setdefault((lqt, lwt), []).append(r)

        from .sw_device import banded_sw_scores
        import time as _time

        pending = []  # (chunk_rows, device out3, n, lqt, lwt, t_dispatch)
        for (lqt, lwt), blist in sorted(buckets.items()):
            for off in range(0, len(blist), self._B_CAP):
                chunk = blist[off : off + self._B_CAP]
                n = len(chunk)
                bpad = next(t for t in self._B_TIERS if n <= t)
                qb = np.full((bpad, lqt), 4, dtype=np.uint8)
                rb = np.full((bpad, lwt), 4, dtype=np.uint8)
                ql = np.zeros(bpad, dtype=np.int32)
                for i, r in enumerate(chunk):
                    q = queries[r]
                    qb[i, : len(q)] = q
                    lo, hi = int(res["rs"][r]), int(res["re"][r])
                    rb[i, : hi - lo] = ref[lo:hi]
                    ql[i] = len(q)
                t0 = _time.perf_counter()
                out3 = banded_sw_scores(qb, rb, ql)
                # dispatch time: in async mode the wait happens at finish();
                # only dispatch + wait count as device_s (the host work
                # interleaved between them must not)
                disp_s = _time.perf_counter() - t0
                pending.append((chunk, out3, n, lqt, lwt, disp_s))

        def finish():
            for chunk, out3, n, lqt, lwt, disp_s in pending:
                t1 = _time.perf_counter()
                sc = np.asarray(out3)[:n, 0]  # blocks on the device
                stats["device_s"] += disp_s + (_time.perf_counter() - t1)
                stats["device_scored"] += n
                DEVICE_TOTALS["scored"] += n
                stats["cells"] += int(n) * lqt * lwt
                for i, r in enumerate(chunk):
                    if sc[i] >= MIN_DP_MAX:
                        host_rows.append(r)  # survivor: host traceback
                    else:
                        # window padding only widens the DP, so the device
                        # score upper-bounds the real one: below-threshold
                        # here is below-threshold in the exact DP too
                        res["mapped"][r] = 0
            stats["survivors"] += len(host_rows)
            self._host_dp_rows(seqs, res, host_rows, queries)

        return finish

    def _host_dp_rows(self, seqs: list, res: dict, host_rows: list,
                      queries: dict | None = None):
        """Exact banded DP + CIGAR traceback on host for the given deferred
        rows.  Fast path: ONE native call realigns the whole subset with the
        full DP enabled (pt_align_sr_rows — same window formula, same banded
        DP, so outputs are identical to the per-row loop below, which remains
        the fallback/oracle)."""
        if res.get("_buf") is not None and len(host_rows):
            from ..native import align_sr_rows_native

            if align_sr_rows_native(res, host_rows,
                                    cigar_cap=res["cig"].shape[1]):
                return
        ref = self.index.codes2
        if queries is None:
            queries = {}
            for r in host_rows:
                codes = encode(np.frombuffer(seqs[r].encode(), dtype=np.uint8))
                if res["rev"][r]:
                    codes = _RC[codes[::-1]]
                queries[r] = codes
        cap = res["cig"].shape[1]
        code = {c: i for i, c in enumerate(self._CIG_OPS)}
        from ..native import banded_dp_native

        def _dp_row(r):
            dp = banded_dp_native(queries[r],
                                  ref[int(res["rs"][r]) : int(res["re"][r])])
            if dp is None:
                dp = banded_affine_dp(
                    queries[r], ref[int(res["rs"][r]) : int(res["re"][r])])
            return dp

        if len(host_rows) > 64:
            # the native DP releases the GIL: thread the survivor traceback
            from concurrent.futures import ThreadPoolExecutor
            import os as _os

            with ThreadPoolExecutor(min(8, _os.cpu_count() or 1)) as ex:
                dps = list(ex.map(_dp_row, host_rows))
        else:
            dps = [_dp_row(r) for r in host_rows]

        for r, dp in zip(host_rows, dps):
            lo = int(res["rs"][r])
            votes, second = int(res["score"][r]), int(res["nm"][r])
            score, qs, qe, rsw, rew, cigar = dp
            if score < MIN_DP_MAX or not cigar:
                res["mapped"][r] = 0
                continue
            res["mapped"][r] = 1
            res["rs"][r] = lo + rsw
            res["re"][r] = lo + rew
            res["qs"][r] = qs
            res["qe"][r] = qe
            res["score"][r] = score
            res["nm"][r] = sum(ln for ln, op in cigar if op != "M")
            if votes >= 3 and second * 2 <= votes:
                res["mapq"][r] = 60
            else:
                res["mapq"][r] = max(1, min(60, int(
                    40 * (1 - (second + 1) / (votes + 1)))))
            if len(cigar) <= cap:
                res["ncig"][r] = len(cigar)
                for c, (ln, op) in enumerate(cigar):
                    res["cig"][r, c] = (ln << 4) | code[op]
            else:
                res["mapped"][r] = 2  # oracle redo downstream

    def align_batch_arrays(self, seqs: list, pre: dict | None = None,
                           deferred_async: bool = False):
        """Columnar twin of align_batch: returns the native per-read arrays
        (mapped/rev/rs/re/qs/qe ORIENTED/score/mapq/nm/ncig/cig/lens) with
        cigar-overflow rows merged back from the oracle path; `extra_cigars`
        maps row -> [(len,op)] for rows whose cigar exceeded the array
        capacity.  None when the native library is unavailable.

        With ``deferred_async`` the device window-scoring dispatch is left IN
        FLIGHT and ``res["_fin"]`` holds the finisher (device wait + survivor
        host DP + overflow redo); the caller must invoke it before consuming
        the row arrays — the columnar emit does, after its res-independent
        prep, so the device round-trip hides under host work."""
        from ..native import align_sr_native

        mode = self._resolve_device_mode()
        res = align_sr_native(seqs, self.index.codes2, self.index.h,
                              self.index.pos, self.index.strand,
                              self.k, self.w, defer_dp=bool(mode), pre=pre)
        if res is None:
            return None
        if mode:
            if deferred_async:
                fin = self._start_deferred(seqs, res)
                if fin is not None:
                    res["extra_cigars"] = {}

                    def _finish():
                        fin()
                        self._fix_overflow_arrays(seqs, res)

                    res["_fin"] = _finish
                    return res
            else:
                self._resolve_deferred(seqs, res)
        self._fix_overflow_arrays(seqs, res)
        return res

    def _fix_overflow_arrays(self, seqs: list, res: dict):
        """Redo cigar-capacity-overflow rows (mapped==2) with the oracle
        path and record oversized cigars in res["extra_cigars"]."""
        res["extra_cigars"] = {}
        over = np.flatnonzero(res["mapped"] == 2)
        if len(over):
            redo = self._align_chunk([seqs[i] for i in over])
            OPS = self._CIG_OPS
            code = {c: i for i, c in enumerate(OPS)}
            cap = res["cig"].shape[1]
            for j, i in enumerate(over):
                a = redo[j]
                if not a.mapped:
                    res["mapped"][i] = 0
                    continue
                res["mapped"][i] = 1
                res["rev"][i] = a.rev
                res["rs"][i] = a.rs
                res["re"][i] = a.re
                lq = len(seqs[i])
                # arrays hold ORIENTED coords; Alignment has original-strand
                q0, q1 = ((lq - a.qe, lq - a.qs) if a.rev else (a.qs, a.qe))
                res["qs"][i] = q0
                res["qe"][i] = q1
                res["score"][i] = a.score
                res["mapq"][i] = a.mapq
                res["nm"][i] = a.nm
                if len(a.cigar) <= cap:
                    res["ncig"][i] = len(a.cigar)
                    for c, (ln, op) in enumerate(a.cigar):
                        res["cig"][i, c] = (ln << 4) | code[op]
                else:
                    res["ncig"][i] = 0
                    res["extra_cigars"][int(i)] = list(a.cigar)
        return res

    def _align_chunk(self, seqs: list):
        N = len(seqs)
        out = [Alignment() for _ in range(N)]
        if N == 0:
            return out
        L = max(len(s) for s in seqs)
        from ..sketch.tpu import encode_reads_batch

        reads, lens = encode_reads_batch(seqs, pad_to=L)
        ridx, qpos, qh, qstrand = batch_minimizers(reads, lens, self.k, self.w)

        start, end = self.index.lookup_many(qh)
        counts = (end - start).astype(np.int64)
        tot = int(counts.sum())
        if tot == 0:
            return out
        # expand anchor hits
        rep = np.repeat(np.arange(len(qh)), counts)
        within = np.arange(tot) - np.repeat(
            np.concatenate(([0], np.cumsum(counts)[:-1])), counts)
        tpos = self.index.pos[np.repeat(start, counts) + within].astype(np.int64)
        a_read = ridx[rep]
        a_qpos = qpos[rep]
        a_rel = (self.index.strand[np.repeat(start, counts) + within]
                 ^ qstrand[rep]).astype(np.int64)
        a_len = lens[a_read].astype(np.int64)
        diag = np.where(a_rel == 0, tpos - a_qpos,
                        tpos - (a_len - self.k - a_qpos))
        a_qv = np.where(a_rel == 0, a_qpos, a_len - self.k - a_qpos)

        # cluster per (read, strand): sort then split on diag jumps
        order = np.lexsort((diag, a_rel, a_read))
        r_s = a_read[order]
        rel_s = a_rel[order]
        d_s = diag[order]
        qv_s = a_qv[order]
        new_grp = np.concatenate(
            ([True],
             (r_s[1:] != r_s[:-1]) | (rel_s[1:] != rel_s[:-1])
             | (np.diff(d_s) > MAX_GAP)))
        gstart = np.flatnonzero(new_grp)
        gend = np.append(gstart[1:], len(r_s))
        votes = gend - gstart
        qmin = np.minimum.reduceat(qv_s, gstart)
        qmax = np.maximum.reduceat(qv_s, gstart)
        span = np.minimum(qmax - qmin + self.k, lens[r_s[gstart]])
        dmin = d_s[gstart]
        dmax = d_s[gend - 1]
        # median diagonal per cluster
        med = d_s[(gstart + gend - 1) // 2]
        g_read = r_s[gstart]
        g_rel = rel_s[gstart]

        # best + second-best votes per read
        corder = np.lexsort((-votes, g_read))
        first_of_read = np.concatenate(
            ([True], g_read[corder][1:] != g_read[corder][:-1]))
        best_rows = corder[first_of_read]
        second_votes = np.zeros(N, dtype=np.int64)
        rest = corder[~first_of_read]
        if len(rest):
            fr = np.concatenate(
                ([True], g_read[rest][1:] != g_read[rest][:-1]))
            second_rows = rest[fr]
            second_votes[g_read[second_rows]] = votes[second_rows]

        sel = best_rows[(votes[best_rows] >= MIN_CNT)
                        & (span[best_rows] >= MIN_CHAIN_SCORE)]
        if len(sel) == 0:
            return out

        # ---- vectorized verify for single-diagonal clusters ----
        ref = self.index.codes2
        lr = len(ref)
        b_read = g_read[sel]
        b_rel = g_rel[sel]
        b_diag = med[sel]
        b_single = dmin[sel] == dmax[sel]
        b_votes = votes[sel]
        b_sec = second_votes[b_read]

        oriented = np.where(b_rel[:, None] == 0, reads[b_read],
                            _RC[reads[b_read][:, ::-1]])
        lq = lens[b_read].astype(np.int64)
        # align oriented reads so base j corresponds to original padded... for
        # reversed reads the padding ends up on the LEFT; shift per row
        pad = (reads.shape[1] - lq)
        shift = np.where(b_rel == 1, pad, 0)
        # gather ref at diag + j - shift (reversed reads' content starts at pad)
        j = np.arange(reads.shape[1])[None, :]
        qcol = j - shift[:, None]
        rpos = b_diag[:, None] + qcol
        okcol = (qcol >= 0) & (qcol < lq[:, None]) & (rpos >= 0) & (rpos < lr)
        refg = np.where(okcol, ref[np.clip(rpos, 0, lr - 1)], 255)
        qg = oriented
        match = okcol & (qg == refg) & (qg < 4)
        contrib = np.where(okcol, np.where(match, MATCH, -MISMATCH),
                           0).astype(np.int32)

        # best sub-segment with end bonuses, batched prefix-max over columns
        S = np.concatenate(
            [np.zeros((len(sel), 1), np.int32),
             np.cumsum(contrib, axis=1, dtype=np.int32)], axis=1)
        n_col = contrib.shape[1]
        q_lo = np.maximum(0, -b_diag)  # first in-ref query column
        q_hi = np.minimum(lq, lr - b_diag)
        col = np.arange(n_col + 1)[None, :]
        lo_col = (np.maximum(q_lo, 0) + shift)[:, None]
        hi_col = (q_hi + shift)[:, None]
        NEG = np.int32(-(1 << 29))
        start_bonus = np.where(col == lo_col,
                               np.where(q_lo == 0, END_BONUS, 0)[:, None], 0)
        lead = np.where((col >= lo_col) & (col <= hi_col), -S + start_bonus, NEG)
        best_lead = np.maximum.accumulate(lead, axis=1)
        end_bonus = np.where(col == hi_col,
                             np.where(q_hi == lq, END_BONUS, 0)[:, None], 0)
        totals = np.where((col >= lo_col) & (col <= hi_col),
                          S + end_bonus + best_lead, NEG)
        jbest = np.argmax(totals[:, 1:], axis=1) + 1
        rows = np.arange(len(sel))
        score = totals[rows, jbest]
        # recover the segment start: first column (<= jbest) where lead hits
        # the prefix max at jbest
        target = best_lead[rows, jbest]
        hitmask = (lead == target[:, None]) & (col <= jbest[:, None])
        ibest = np.argmax(hitmask, axis=1)

        qs_o = ibest - shift
        qe_o = jbest - shift
        rawsc = score.copy()
        rawsc -= np.where((q_lo == 0) & (qs_o == q_lo), END_BONUS, 0)
        rawsc -= np.where((q_hi == lq) & (qe_o == q_hi), END_BONUS, 0)
        clip5 = qs_o
        clip3 = lq - qe_o
        needs_dp = (~b_single) | (clip5 >= 10) | (clip3 >= 10) | (score <= 0)
        fast_ok = (~needs_dp) & (rawsc >= MIN_DP_MAX) & (qe_o - qs_o >= self.k)

        # nm per fast row: mismatches inside the kept segment
        seg_mask = (col[:, :-1] >= (shift + qs_o)[:, None]) & (
            col[:, :-1] < (shift + qe_o)[:, None])
        nm_all = (seg_mask & ~match).sum(axis=1)
        mapq_all = np.where(
            (b_votes >= 3) & (b_sec * 2 <= b_votes), 60,
            np.clip((40 * (1 - (b_sec + 1) / (b_votes + 1))).astype(np.int64), 1, 60))

        for r in np.flatnonzero(fast_ok):
            i = int(b_read[r])
            aln = out[i]
            aln.mapped = True
            aln.score = int(rawsc[r])
            aln.rev = bool(b_rel[r])
            q0, q1 = int(qs_o[r]), int(qe_o[r])
            aln.rs = int(b_diag[r]) + q0
            aln.re = int(b_diag[r]) + q1
            aln.cigar = [(q1 - q0, "M")]
            aln.nm = int(nm_all[r])
            aln.mapq = int(mapq_all[r])
            if aln.rev:
                aln.qs, aln.qe = int(lq[r]) - q1, int(lq[r]) - q0
            else:
                aln.qs, aln.qe = q0, q1

        b_dmin = dmin[sel]
        b_dmax = dmax[sel]
        for r in np.flatnonzero(~fast_ok):
            i = int(b_read[r])
            res = self._extend(
                oriented[r, shift[r] : shift[r] + lq[r]].copy(),
                int(b_diag[r]), int(b_dmin[r]), int(b_dmax[r]),
                int(b_votes[r]), int(b_sec[r]))
            if res.mapped:
                res.rev = bool(b_rel[r])
                if res.rev:
                    res.qs, res.qe = int(lq[r]) - res.qe, int(lq[r]) - res.qs
                out[i] = res
        return out

    def align_pairs_batch(self, seqs: list, paired: bool):
        alns = self.align_batch(seqs)
        out = []
        if paired:
            for i in range(0, len(seqs) - 1, 2):
                a1, a2 = alns[i], alns[i + 1]
                if a1.mapped and a2.mapped:
                    a1.proper_frag = a2.proper_frag = self._proper(a1, a2)
                else:
                    a1.mapped = a2.mapped = False
                out.append((a1, a2))
        else:
            out = [(a, None) for a in alns]
        return out
