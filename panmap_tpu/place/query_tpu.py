"""End-to-end device placement query: read batch -> seed table -> node scores.

The throughput path the bench measures.  Everything stays on device: the read
batch is sketched with the batched syncmer/k-min-mer kernels (sketch/tpu.py),
per-read k-min-mers are sorted + run-length-counted with lax.sort (two u32 keys
= native u64 ordering), support/homopolymer filtering and the log-magnitude
statistics are fused in, the seed table joins against the index's unique-hash
table with a vectorized 2-key binary search, and the row-delta scoring program
(place/engine_tpu.py math) finishes with segment sums + the Euler-tour prefix.
Only the [N,6] accumulator and 4 scalars come back to the host.

Reference equivalent: src/placement.cpp:1128-1930 (read sketching, frequency
table, BFS scoring) as three python loops of jitted programs.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from ..index.builder import IndexArrays
from . import engine_tpu as et
from ..sketch.tpu import (
    encode_reads_batch,
    kminmer_batch,
    pack_reads_2bit,
    syncmer_scan_batch,
    unpack_reads_2bit,
)


def build_cuckoo_table(u_hi: np.ndarray, u_lo: np.ndarray):
    """Host-side 2-table cuckoo hash of the index's unique (hi, lo) hash
    pairs -> (tab_hi, tab_lo, tab_idx) flat arrays of length 2*S.

    Table 0 hashes by the low u32, table 1 by the high u32 (the seeds are
    already ntHash outputs, so the two words are independent uniform bits).
    Device lookup is exactly two probes = six 1D gathers — replacing the
    42-gather binary search that dominated the fused placement program.
    Build is vectorized eviction rounds (numpy); S doubles on the rare
    build failure (classic cuckoo is reliable at load <= 0.5)."""
    n = len(u_hi)
    S = 1 << max(int(np.ceil(np.log2(max(n, 2)))), 4)
    for _ in range(3):
        mask = np.uint32(S - 1)
        H = np.stack([(u_lo & mask).astype(np.int64),
                      (u_hi & mask).astype(np.int64) + S])
        owner = np.full(2 * S, -1, np.int64)
        choice = np.zeros(n, np.int8)
        active = np.arange(n)
        for _round in range(500):
            if active.size == 0:
                break
            slots = H[choice[active], active]
            old = owner[slots]  # pre-round occupants (read before any write)
            owner[slots] = active  # duplicate slots: last write wins
            won = owner[slots] == active
            evicted = old[won]
            evicted = evicted[evicted >= 0]
            losers = active[~won]
            choice[evicted] ^= 1
            choice[losers] ^= 1
            active = np.concatenate([losers, evicted])
        if active.size == 0:
            tab_hi = np.full(2 * S, 0xFFFFFFFF, np.uint32)
            tab_lo = np.full(2 * S, 0xFFFFFFFF, np.uint32)
            tab_idx = np.zeros(2 * S, np.int32)
            placed = owner >= 0
            ids = owner[placed]
            tab_hi[placed] = u_hi[ids]
            tab_lo[placed] = u_lo[ids]
            tab_idx[placed] = ids
            return tab_hi, tab_lo, tab_idx, S
        S *= 2
    raise RuntimeError("cuckoo build failed at load <= 0.125")


def _bsearch2(uhi, ulo, qhi, qlo):
    """Vectorized lexicographic binary search of (qhi,qlo) in sorted (uhi,ulo).
    Returns (idx, found)."""
    n = uhi.shape[0]
    steps = max(int(np.ceil(np.log2(max(n, 2)))) + 1, 1)

    def body(_, lohi):
        lo, hi = lohi
        mid = (lo + hi) // 2
        mhi = uhi[mid]
        mlo = ulo[mid]
        less = (mhi < qhi) | ((mhi == qhi) & (mlo < qlo))
        lo = jnp.where(less, mid + 1, lo)
        hi = jnp.where(less, hi, mid)
        return lo, hi

    lo = jnp.zeros(qhi.shape, dtype=jnp.int32)
    hi = jnp.full(qhi.shape, n, dtype=jnp.int32)
    lo, hi = jax.lax.fori_loop(0, steps, body, (lo, hi))
    idx = jnp.clip(lo, 0, max(n - 1, 0))
    found = (uhi[idx] == qhi) & (ulo[idx] == qlo)
    return idx, found


class TpuPlacer:
    """Device index tensors + compiled programs for repeated placement queries."""

    def __init__(self, idx: IndexArrays, pad_len: int = 160,
                 batch: int = 16384, mesh=None):
        """``mesh``: optional 1-D jax.sharding.Mesh ("data" axis) — index rows
        shard across the devices and per-node metric partials combine with a
        psum across the devices (--mesh; SURVEY §5.8).  None = single
        device."""
        self.idx = idx
        self.mesh = mesh
        # place_exact outcomes: answered on the device, refused by a
        # precision guard (the host f64 engine answers), largest |f32 - f64|
        self.stats = dict(answered=0, guard_trips=0, max_abs_err=0.0)
        self.dev = et.prepare_device_index(idx, mesh=mesh)
        self.params = idx.params
        if mesh is not None:
            # replicate the small tree tensors explicitly so mixed-sharding
            # jits don't guess (euler arrays are ~N*4 bytes)
            from jax.sharding import NamedSharding, PartitionSpec

            rep = NamedSharding(mesh, PartitionSpec())
            d = self.dev
            d.euler_in = jax.device_put(np.asarray(d.euler_in), rep)
            d.euler_out = jax.device_put(np.asarray(d.euler_out), rep)
        self.pad_len = pad_len = ((pad_len + 7) // 8) * 8  # 2-bit pack needs L%8==0
        self.batch = batch
        p = self.params
        k, s, t, l, open_ = p.k, p.s, p.t, p.l, p.open

        U = np.asarray(self.dev.unique_hashes)
        u_hi = (U >> np.uint64(32)).astype(np.uint32)
        u_lo = (U & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        t_hi, t_lo, t_idx, S = build_cuckoo_table(u_hi, u_lo)
        self.tab_hi = jnp.asarray(t_hi)
        self.tab_lo = jnp.asarray(t_lo)
        self.tab_idx = jnp.asarray(t_idx)
        self.tab_size = S

        from .engine import homopolymer_hashes

        hp = np.array(homopolymer_hashes(k), dtype=np.uint64)
        # numpy: closed over inside jits — a device-array constant is
        # fetched back to the host at every lowering (see sketch/tpu.py)
        self.hp_hi = (hp >> np.uint64(32)).astype(np.uint32)
        self.hp_lo = (hp & np.uint64(0xFFFFFFFF)).astype(np.uint32)

        L = self.pad_len
        B = batch
        MB = B * (L // 8)

        def _sketch_core(packed, nmask, lengths):
            reads = unpack_reads_2bit(packed, nmask, L)
            hh, hl, is_sync = syncmer_scan_batch(reads, lengths, k, s, t, open_)
            kh, kl, valid = kminmer_batch(hh, hl, is_sync, k, l)
            return kh.reshape(-1), kl.reshape(-1), valid.reshape(-1)

        self._sketch_flat = jax.jit(_sketch_core)

        @jax.jit
        def sketch_sparse(packed, nidx, nval, lengths):
            # N bytes are rare in real FASTQ: rebuild the dense mask from a
            # small (index, value) list instead of shipping B*L/8 bytes
            nmask = (jnp.zeros(MB, jnp.uint8)
                     .at[nidx].set(nval, mode="drop").reshape(B, L // 8))
            return _sketch_core(packed, nmask, lengths)

        self._sketch_sparse = sketch_sparse
        self._finalize_score = self._make_finalize_score()

    MAXU = 1 << 18  # compacted read-seed slots (>= distinct seeds in any sample)
    MAXN = 4096     # sparse N-mask slots per chunk (else ship the dense mask)

    def _finalize_stats(self, shi, slo, min_support_cfg, tab_hi, tab_lo,
                        tab_idx):
        """Shared post-sort stage: run-length counts over sorted (hi, lo)
        seeds, homopolymer removal, auto min-read-support
        (placement.cpp:931-955), log-count stats, and the join of the kept
        distinct read seeds against the index's unique-hash table via the
        two-probe cuckoo lookup.  Invalid slots carry all-ones hashes, so they
        form one trailing run and every other run is entirely valid: a run's
        count is simply its LENGTH (a genuine all-ones seed hash — p ~ 2^-64 —
        would be dropped).  Indexed ops at full stream width cost ~10 ns/elem
        on this chip regardless of payload, so the distinct seeds are
        compacted with ONE packed row-scatter (hi, lo, logc-bits) and the
        cuckoo probe runs on the compacted table.  Traced inside a jit;
        returns the per-uid logc table (>0 marks a found+kept seed) +
        scalars."""
        n_unique = int(self.dev.unique_hashes.shape[0])
        S = self.tab_size
        MAXU = self.MAXU
        n = shi.shape[0]
        ones = jnp.uint32(0xFFFFFFFF)
        iota = jnp.arange(n, dtype=jnp.int32)
        first = jnp.concatenate(
            [jnp.ones(1, bool), (shi[1:] != shi[:-1]) | (slo[1:] != slo[:-1])])
        # run length without scatters or gathers: next run start per position
        # via a reversed cummin; count at a run start = nxt - iota
        cand = jnp.where(first, iota, n)
        nxt = jnp.concatenate(
            [jax.lax.cummin(cand[1:][::-1])[::-1], jnp.full(1, n, jnp.int32)])
        valid_run = ~((shi == ones) & (slo == ones))
        counts = jnp.where(first & valid_run,
                           (nxt - iota).astype(jnp.float32), 0.0)
        is_seed = first & valid_run

        hp_match = jnp.zeros_like(is_seed)
        for i in range(self.hp_hi.shape[0]):
            hp_match |= (shi == self.hp_hi[i]) & (slo == self.hp_lo[i])
        is_seed &= ~hp_match

        multi = is_seed & (counts >= 2)
        msum = jnp.sum(jnp.where(multi, counts, 0.0))
        mcnt = jnp.sum(multi)
        est = jnp.where(mcnt > 0, msum / jnp.maximum(mcnt, 1), 0.0)
        auto_ms = jnp.where(est > 3.0, 2.0, 1.0)
        ms = jnp.where(min_support_cfg < 0, auto_ms, min_support_cfg)
        keep = is_seed & (counts >= ms)

        logc = jnp.where(keep, jnp.log1p(counts), 0.0)
        log_mag = jnp.sqrt(jnp.sum(logc * logc))
        lden = jnp.sum(logc)
        nuniq = jnp.sum(keep)

        # ONE packed compaction row-scatter: (hi, lo, logc bits) per kept run
        slot = jnp.where(keep, jnp.cumsum(keep.astype(jnp.int32)) - 1, MAXU)
        payload = jnp.stack(
            [shi, slo, jax.lax.bitcast_convert_type(logc, jnp.uint32)], axis=1)
        comp = jnp.zeros((MAXU, 3), jnp.uint32).at[slot].set(
            payload, mode="drop")
        rq_hi, rq_lo = comp[:, 0], comp[:, 1]
        rq_lc = jax.lax.bitcast_convert_type(comp[:, 2], jnp.float32)
        rq_ok = jnp.arange(MAXU) < nuniq
        # cuckoo probe: table 0 keyed by the low word, table 1 by the high
        mask = jnp.uint32(S - 1)
        s0 = (rq_lo & mask).astype(jnp.int32)
        s1 = (rq_hi & mask).astype(jnp.int32) + S
        m0 = (tab_hi[s0] == rq_hi) & (tab_lo[s0] == rq_lo)
        m1 = (tab_hi[s1] == rq_hi) & (tab_lo[s1] == rq_lo)
        uidx = jnp.where(m0, tab_idx[s0], tab_idx[s1])
        hit = m0 | m1
        # misses get distinct out-of-bounds slots (dropped) so the scatter is
        # provably duplicate-free
        put = jnp.where(hit & rq_ok, uidx,
                        n_unique + jnp.arange(MAXU, dtype=jnp.int32))
        uid_logc = jnp.zeros(n_unique, jnp.float32).at[put].set(
            rq_lc, mode="drop", unique_indices=True)
        return uid_logc, log_mag, nuniq, lden

    def _score_rows(self, row_id, row_parent, row_child, row_node, euler_in,
                    euler_out, uid_logc):
        """Row-delta metric accumulation + Euler-tour prefix (traced inside a
        jit).  Same math as place/engine_tpu.py; see placement.cpp:242-345.
        uid_logc > 0 exactly marks found+kept seeds (log1p of a count >= 1 is
        strictly positive), so one gather serves as both value and flag."""
        from .metrics import (euler_prefix, row_node_sums,
                              row_node_sums_blocked, wc_denominator)

        n_nodes = self.dev.n_nodes
        a, b = self.dev.root_rows
        # wc_den from the (few) root rows: slice the global row arrays — under
        # a mesh XLA gathers the slice from shard 0, negligible traffic
        lrc_root = uid_logc[row_id[a:b]]
        wc_den = wc_denominator(jnp, lrc_root,
                                row_child[a:b].astype(lrc_root.dtype),
                                lrc_root > 0)
        if self.mesh is None:
            lrc = uid_logc[row_id]
            if self.dev.blk is not None:
                node_sums = row_node_sums_blocked(lrc, row_parent, row_child,
                                                  lrc > 0, self.dev.blk,
                                                  n_nodes)
            else:
                node_sums = row_node_sums(lrc, row_parent, row_child, lrc > 0,
                                          row_node, n_nodes)
        else:
            from jax import shard_map
            from jax.sharding import PartitionSpec as P

            def body(rid, rp, rc, rn, ul):
                lrc = ul[rid]
                partial = row_node_sums(lrc, rp, rc, lrc > 0, rn, n_nodes)
                return jax.lax.psum(partial, "data")

            node_sums = shard_map(
                body, mesh=self.mesh,
                in_specs=(P("data"), P("data"), P("data"), P("data"),
                          P(None)),
                out_specs=P(None))(
                row_id, row_parent, row_child, row_node, uid_logc)
        return euler_prefix(node_sums, euler_in, euler_out, n_nodes), wc_den

    def _make_finalize_score(self):
        """One fused program: 2-key sort of every padded k-min-mer slot
        (cheaper than compact-then-sort, whose scatter costs more than the
        full sort), then run-length stats, the cuckoo index join, and row
        scoring."""

        @jax.jit
        def run(kh, kl, valid, min_support_cfg, row_id, row_parent, row_child,
                row_node, euler_in, euler_out, tab_hi, tab_lo, tab_idx):
            del valid  # invalid slots already carry all-ones sentinel hashes
            shi, slo = jax.lax.sort((kh, kl), num_keys=2)
            uid_logc, log_mag, nuniq, lden = self._finalize_stats(
                shi, slo, min_support_cfg, tab_hi, tab_lo, tab_idx)
            acc, wc_den = self._score_rows(
                row_id, row_parent, row_child, row_node, euler_in, euler_out,
                uid_logc)
            return acc, wc_den, log_mag, nuniq, lden

        return run

    def sketch_device(self, seqs: list):
        parts = []
        B = self.batch
        for off in range(0, len(seqs), B):
            chunk = seqs[off : off + B]
            reads, lens = encode_reads_batch(chunk, pad_to=self.pad_len)
            if len(chunk) < B:
                pad = B - len(chunk)
                reads = np.concatenate(
                    [reads, np.full((pad, self.pad_len), 4, np.uint8)])
                lens = np.concatenate([lens, np.zeros(pad, np.int32)])
            packed, nmask = pack_reads_2bit(reads)
            flat = nmask.reshape(-1)
            nz = np.flatnonzero(flat)
            if nz.size <= self.MAXN:
                nidx = np.full(self.MAXN, flat.size, np.int32)
                nidx[: nz.size] = nz
                nval = np.zeros(self.MAXN, np.uint8)
                nval[: nz.size] = flat[nz]
                parts.append(self._sketch_sparse(packed, nidx, nval, lens))
            else:
                parts.append(self._sketch_flat(packed, nmask, lens))
        kh = jnp.concatenate([p[0] for p in parts])
        kl = jnp.concatenate([p[1] for p in parts])
        vv = jnp.concatenate([p[2] for p in parts])
        return kh, kl, vv

    def _check_capacity(self, nuniq):
        if int(nuniq) > self.MAXU:
            raise RuntimeError(
                f"distinct read seeds ({int(nuniq)}) exceed the device "
                f"compaction capacity ({self.MAXU}); use the host engine")

    def place(self, seqs: list, min_read_support: int = -1):
        kh, kl, vv = self.sketch_device(seqs)
        dev = self.dev
        acc, wc_den, log_mag, nuniq, lden = self._finalize_score(
            kh, kl, vv, float(min_read_support), dev.row_id, dev.row_parent,
            dev.row_child, dev.row_node, dev.euler_in, dev.euler_out,
            self.tab_hi, self.tab_lo, self.tab_idx)
        self._check_capacity(nuniq)
        self._last_wc_den = float(wc_den)
        return self._finish_scores(np.asarray(acc), float(log_mag), int(nuniq),
                                   float(lden))

    def _device_scores(self, acc, wc_den, log_mag, nuniq, lden):
        """scores[N,5] in METRICS order from the accumulator — the shared
        finalize body (place/metrics.py), traced."""
        from .metrics import finalize_scores

        return finalize_scores(jnp, acc, log_mag, nuniq, lden, wc_den)

    def _make_select_fn(self):
        """Tolerance-aware best/tie selection (placement.cpp:355-401) on
        device: the host only fetches 5 best scores + a bit-packed [N,5]
        tie mask (~25 KB) instead of the [N,6] accumulator."""

        @jax.jit
        def sel(acc, wc_den, log_mag, nuniq, lden, eligible):
            scores = self._device_scores(acc, wc_den, log_mag, nuniq, lden)
            col = jnp.where(eligible[:, None], scores, -jnp.inf)
            best = jnp.max(col, axis=0)
            tol = jnp.maximum(best * 1e-4, 1e-9)
            tied = (col >= best - tol) & (col > 0)
            return best, jnp.packbits(tied, axis=0)

        return sel

    def place_best(self, seqs: list, min_read_support: int = -1,
                   force_leaf: bool = False):
        """Fast path: full placement with on-device best/tie selection.
        Returns a PlacementScores with best/tie fields filled and an empty
        scores matrix (use place() when per-node scores are needed)."""
        from .engine import METRICS, PlacementScores

        kh, kl, vv = self.sketch_device(seqs)
        dev = self.dev
        acc, wc_den, log_mag, nuniq, lden = self._finalize_score(
            kh, kl, vv, float(min_read_support), dev.row_id, dev.row_parent,
            dev.row_child, dev.row_node, dev.euler_in, dev.euler_out,
            self.tab_hi, self.tab_lo, self.tab_idx)
        if not hasattr(self, "_select_fn"):
            self._select_fn = self._make_select_fn()
            n = self.dev.n_nodes
            elig = np.ones(n, dtype=bool)
            is_parent = np.zeros(n, dtype=bool)
            is_parent[self.idx.parent_index[1:]] = True
            self._elig_all = jnp.asarray(elig)
            self._elig_leaf = jnp.asarray(elig & ~is_parent)
        elig = self._elig_leaf if force_leaf else self._elig_all
        best, packed = self._select_fn(acc, wc_den, log_mag, nuniq, lden, elig)
        self._check_capacity(nuniq)
        best = np.asarray(best)
        tied = np.unpackbits(np.asarray(packed), axis=0,
                             count=self.dev.n_nodes).astype(bool)
        res = PlacementScores(scores=np.zeros((0, 5)))
        for m, name in enumerate(METRICS):
            b = float(best[m])
            idxs = np.flatnonzero(tied[:, m])
            res.best_score[name] = b if np.isfinite(b) else 0.0
            res.tied_indices[name] = idxs.tolist()
            res.best_index[name] = int(idxs[0]) if len(idxs) else None
        return res

    def sketch_host(self, seqs: list, min_read_support: int = -1):
        """Host-side native sketch+count+join: returns (uids, logc, log_mag,
        nuniq, lden) over found+kept read seeds, or None when the native
        library is unavailable.  Identical filtering semantics to the device
        finalize (_finalize_stats); only the ~found-seed (uid, logc) pairs
        cross to the device instead of the whole 2-bit read batch."""
        from ..native import sketch_count_native

        p = self.params
        out = sketch_count_native(seqs, p.k, p.s, p.t, p.open, p.l)
        if out is None:
            return None
        H, C = out
        if len(H) == 0:
            return (np.empty(0, np.int32), np.empty(0, np.float32), 0.0, 0,
                    0.0)
        hp = ((self.hp_hi.astype(np.uint64) << np.uint64(32))
              | self.hp_lo.astype(np.uint64))
        if len(hp):
            m = np.ones(len(H), dtype=bool)
            for h in hp:
                m &= H != h
            H, C = H[m], C[m]
        multi = C >= 2
        est = (C[multi].mean() if multi.any() else 0.0)
        auto_ms = 2.0 if est > 3.0 else 1.0
        ms = auto_ms if min_read_support < 0 else float(min_read_support)
        keep = C >= ms
        H, C = H[keep], C[keep]
        logc = np.log1p(C.astype(np.float32))
        log_mag = float(np.sqrt(np.float32(logc @ logc)))
        lden = float(np.sum(logc, dtype=np.float32))
        nuniq = int(len(H))
        U = self.dev.unique_hashes
        from ..native import join_u64_native

        j = join_u64_native(H, U)
        if j is not None:
            posc, found = j
        else:
            pos = np.searchsorted(U, H)
            posc = np.minimum(pos, max(len(U) - 1, 0)).astype(np.int32)
            found = (len(U) > 0) & (U[posc] == H)
        return (posc[found], logc[found], log_mag, nuniq, lden)

    # expanded-row capacity ceiling for the sparse found-rows scoring path;
    # queries touching more index rows fall back to the blocked full stream
    RCAP_MAX = 1 << 20

    def _ensure_elig(self):
        if hasattr(self, "_elig_all"):
            return
        n = self.dev.n_nodes
        elig = np.ones(n, dtype=bool)
        is_parent = np.zeros(n, dtype=bool)
        is_parent[self.idx.parent_index[1:]] = True
        self._elig_all = jnp.asarray(elig)
        self._elig_leaf = jnp.asarray(elig & ~is_parent)

    def _wc_den_host(self, uids):
        """f64 weighted-containment denominator from the compact sorted
        found-uid table (root-row replay on host, sequential accumulation
        order like placement.cpp:1861-1876)."""
        dev = self.dev
        rid = dev.root_rid_np
        if rid is None or len(rid) == 0:
            return 0.0
        if len(uids):
            pos = np.searchsorted(uids, rid)
            posc = np.minimum(pos, len(uids) - 1)
            found = uids[posc] == rid
        else:
            found = np.zeros(len(rid), dtype=bool)
        from .metrics import wc_denominator

        return float(wc_denominator(np, np.zeros(len(rid)),
                                    dev.root_child_np, found))

    def _sparse_fns(self, fcap: int, rcap: int):
        """Compiled sparse scoring programs for one (FCAP, RCAP) bucket:
        (best/tie selection, widened candidate selection).  The CSC tensors
        are passed as arguments (closed-over device arrays are fetched back
        at lowering; see sketch/tpu.py)."""
        if not hasattr(self, "_sparse_cache"):
            self._sparse_cache = {}
        fns = self._sparse_cache.get((fcap, rcap))
        if fns is not None:
            return fns
        n_nodes = self.dev.n_nodes
        from .metrics import CscIndex, finalize_scores, sparse_prefix_acc

        def scores_of(pu, pl, wc_den, log_mag, nuniq, lden, off, Pc, Cc,
                      nodec, magp, euler_in, euler_out):
            csc = CscIndex(off=off, P=Pc, C=Cc, node=nodec, mag_static=None,
                           mag_prefix=magp, off_np=None, n_rows=0)
            accp = sparse_prefix_acc(pu, pl, csc, euler_in, euler_out,
                                     n_nodes, rcap)
            return finalize_scores(jnp, accp, log_mag, nuniq, lden, wc_den)

        @jax.jit
        def best_fn(pu, pl, wc_den, log_mag, nuniq, lden, off, Pc, Cc, nodec,
                    mag, euler_in, euler_out, eligible):
            scores = scores_of(pu, pl, wc_den, log_mag, nuniq, lden, off, Pc,
                               Cc, nodec, mag, euler_in, euler_out)
            col = jnp.where(eligible[:, None], scores, -jnp.inf)
            best = jnp.max(col, axis=0)
            tol = jnp.maximum(best * 1e-4, 1e-9)
            tied = (col >= best - tol) & (col > 0)
            return best, jnp.packbits(tied, axis=0)

        @jax.jit
        def widened_fn(pu, pl, wc_den, log_mag, nuniq, lden, off, Pc, Cc,
                       nodec, mag, euler_in, euler_out, eligible):
            scores = scores_of(pu, pl, wc_den, log_mag, nuniq, lden, off, Pc,
                               Cc, nodec, mag, euler_in, euler_out)
            col = jnp.where(eligible[:, None], scores, -jnp.inf)
            best = jnp.max(col, axis=0)
            tol = jnp.maximum(best * 1e-4, 1e-9)
            cutoff = best - (2.0 * tol + 1e-5)
            cand = (col >= cutoff) & (col > -1e-5)
            return jnp.packbits(cand, axis=0), best, col

        fns = (best_fn, widened_fn)
        self._sparse_cache[(fcap, rcap)] = fns
        return fns

    def _score_sparse_dispatch(self, uids, logc, log_mag, nuniq, lden, elig,
                               widened=False, wc_den=None):
        """Dispatch the sparse found-rows scoring program; returns the
        in-flight device result, or None when the query exceeds the sparse
        caps (caller then uses the blocked full-stream path)."""
        from .metrics import query_found_rows

        csc = self.dev.csc
        if csc is None:
            return None
        F = query_found_rows(csc, uids)
        if F > self.RCAP_MAX:
            return None
        rcap = 1 << max(int(np.ceil(np.log2(max(F, 1)))), 13)
        fcap = 1 << max(int(np.ceil(np.log2(max(len(uids), 1)))), 12)
        if fcap > rcap:
            rcap = fcap  # every non-empty segment start needs a mark slot
        nu = int(self.dev.unique_hashes.shape[0])
        pu = np.full(fcap, nu, np.int32)
        pu[: len(uids)] = uids
        pl = np.zeros(fcap, np.float32)
        pl[: len(uids)] = logc
        if wc_den is None:
            wc_den = self._wc_den_host(uids)
        fn = self._sparse_fns(fcap, rcap)[1 if widened else 0]
        dev = self.dev
        args = (pu, pl, np.float32(wc_den), np.float32(log_mag),
                np.int32(nuniq), np.float32(lden), csc.off, csc.P, csc.C,
                csc.node, csc.mag_prefix, dev.euler_in, dev.euler_out, elig)
        self.last_step = (fn, args)  # for fn.lower(*args) memory reports
        return fn(*args)

    def _batch_score_fn(self, Bq: int, fcap: int):
        """Compiled B-query batched scoring program (metrics.
        batched_prefix_acc): ONE row-stream pass scores Bq queries — the
        per-row gather and the blocked reduction amortize ~Bq-fold, which is
        what batch placement (--batch; main.cpp:1464-1666) and the
        steady-state step metric run on."""
        if not hasattr(self, "_batch_cache"):
            self._batch_cache = {}
        fn = self._batch_cache.get((Bq, fcap))
        if fn is not None:
            return fn
        n_nodes = self.dev.n_nodes
        nu = int(self.dev.unique_hashes.shape[0])
        blk = self.dev.blk
        from .metrics import batched_prefix_acc, finalize_scores_batch

        @jax.jit
        def run(pu, pl, log_mag, nuniq, lden, wc_den, row_id, row_parent,
                row_child, magp, euler_in, euler_out, eligible):
            # per-query dense uid tables from the compact pads (sentinel nu
            # lands in the dropped extra column)
            tabBN = jnp.zeros((Bq, nu + 1), jnp.float32).at[
                jnp.arange(Bq)[:, None], pu].set(pl, mode="drop")
            tab = tabBN[:, :nu].T  # [NU, B]
            acc = batched_prefix_acc(tab, row_id, row_parent, row_child, blk,
                                     euler_in, euler_out, n_nodes, magp)
            scores = finalize_scores_batch(jnp, acc, log_mag, nuniq, lden,
                                           wc_den)
            col = jnp.where(eligible[:, None, None], scores, -jnp.inf)
            best = jnp.max(col, axis=0)  # [B, 5]
            tol = jnp.maximum(best * 1e-4, 1e-9)
            tied = (col >= (best - tol)[None]) & (col > 0)
            return best, jnp.packbits(tied, axis=0)

        self._batch_cache[(Bq, fcap)] = run
        return run

    def place_best_host_batch(self, samples, min_read_support: int = -1,
                              force_leaf: bool = False):
        """Score B samples' read sets in ONE device program.  ``samples`` is
        a list of read-sequence lists; returns a list of PlacementScores
        (best/tie fields, like place_best_host).  Falls back to per-sample
        place_best_host when the native sketcher is unavailable or the
        index has no blocked structure (mesh mode)."""
        from .engine import METRICS, PlacementScores

        if self.dev.blk is None or self.dev.csc is None:
            return [self.place_best_host(s, min_read_support, force_leaf)
                    for s in samples]
        sks = [self.sketch_host(s, min_read_support) for s in samples]
        if any(sk is None for sk in sks):
            return [self.place_best_host(s, min_read_support, force_leaf)
                    for s in samples]
        fin = self.score_batch_dispatch(sks, force_leaf)
        return fin()

    def score_batch_dispatch(self, sks, force_leaf: bool = False):
        """Dispatch the batched program over B host sketches
        [(uids, logc, log_mag, nuniq, lden), ...]; returns a zero-arg
        finisher producing the list of PlacementScores."""
        from .engine import METRICS, PlacementScores

        self._ensure_elig()
        Bq = len(sks)
        fcap = 1 << max(int(np.ceil(np.log2(
            max(max(len(sk[0]) for sk in sks), 1)))), 12)
        nu = int(self.dev.unique_hashes.shape[0])
        pu = np.full((Bq, fcap), nu, np.int32)
        pl = np.zeros((Bq, fcap), np.float32)
        stats = np.zeros((4, Bq), np.float32)
        for b, (uids, lc, log_mag, nuniq, lden) in enumerate(sks):
            pu[b, : len(uids)] = uids
            pl[b, : len(uids)] = lc
            stats[0, b] = log_mag
            stats[1, b] = nuniq
            stats[2, b] = lden
            stats[3, b] = self._wc_den_host(np.sort(uids))
        fn = self._batch_score_fn(Bq, fcap)
        dev = self.dev
        elig = self._elig_leaf if force_leaf else self._elig_all
        best, packed = fn(pu, pl, stats[0], stats[1], stats[2], stats[3],
                          dev.row_id, dev.row_parent, dev.row_child,
                          dev.csc.mag_prefix, dev.euler_in, dev.euler_out,
                          elig)

        def resolve():
            b_ = np.asarray(best)  # [B, 5]
            tied = np.unpackbits(np.asarray(packed), axis=0,
                                 count=self.dev.n_nodes).astype(bool)
            out = []
            for b in range(Bq):
                res = PlacementScores(scores=np.zeros((0, 5)))
                for m, name in enumerate(METRICS):
                    v = float(b_[b, m])
                    idxs = np.flatnonzero(tied[:, b, m])
                    res.best_score[name] = v if np.isfinite(v) else 0.0
                    res.tied_indices[name] = idxs.tolist()
                    res.best_index[name] = int(idxs[0]) if len(idxs) else None
                out.append(res)
            return out

        return resolve

    def _make_host_score_fn(self):
        nu = int(self.dev.unique_hashes.shape[0])

        @jax.jit
        def run(uids, lc, log_mag, nuniq, lden, row_id, row_parent, row_child,
                row_node, euler_in, euler_out, eligible):
            uid_logc = jnp.zeros(nu, jnp.float32).at[uids].set(
                lc, mode="drop", unique_indices=True)
            acc, wc_den = self._score_rows(
                row_id, row_parent, row_child, row_node, euler_in, euler_out,
                uid_logc)
            scores = self._device_scores(acc, wc_den, log_mag, nuniq, lden)
            col = jnp.where(eligible[:, None], scores, -jnp.inf)
            best = jnp.max(col, axis=0)
            tol = jnp.maximum(best * 1e-4, 1e-9)
            tied = (col >= best - tol) & (col > 0)
            return best, jnp.packbits(tied, axis=0)

        return run

    def place_best_host(self, seqs: list, min_read_support: int = -1,
                        force_leaf: bool = False):
        """Hybrid fast path: native host sketch+count+join, device row-delta
        scoring + selection.  Falls back to the all-device path when the
        native library is missing.  Same results as place_best."""
        return self.place_best_host_async(seqs, min_read_support,
                                          force_leaf)()

    def place_best_host_async(self, seqs: list, min_read_support: int = -1,
                              force_leaf: bool = False):
        """Pipelined variant of place_best_host: the host sketch runs now and
        the device program is DISPATCHED (JAX dispatch is asynchronous);
        returns a zero-arg resolver that blocks on the device result.  The
        caller can do reference-independent host work (e.g. the alignment
        stage's read minimizer precompute) between dispatch and resolve —
        that work then runs entirely inside the device's compute window."""
        from .engine import METRICS, PlacementScores

        sk = self.sketch_host(seqs, min_read_support)
        if sk is None:
            res = self.place_best(seqs, min_read_support, force_leaf)
            return lambda: res
        uids, lc, log_mag, nuniq, lden = sk
        self._ensure_elig()
        elig = self._elig_leaf if force_leaf else self._elig_all
        srt = np.argsort(uids, kind="stable")
        out = self._score_sparse_dispatch(uids[srt], lc[srt], log_mag, nuniq,
                                          lden, elig)
        if out is not None:
            best, packed = out
        else:
            if not hasattr(self, "_host_score_fn"):
                self._host_score_fn = self._make_host_score_fn()
            nu = int(self.dev.unique_hashes.shape[0])
            cap = 1 << max(int(np.ceil(np.log2(max(len(uids), 1)))), 12)
            pu = np.full(cap, nu, np.int32)  # out-of-range slots drop
            pu[: len(uids)] = uids
            pl = np.zeros(cap, np.float32)
            pl[: len(uids)] = lc
            dev = self.dev
            best, packed = self._host_score_fn(
                pu, pl, np.float32(log_mag), np.int32(nuniq),
                np.float32(lden), dev.row_id, dev.row_parent, dev.row_child,
                dev.row_node, dev.euler_in, dev.euler_out, elig)

        def resolve():
            b_ = np.asarray(best)  # blocks on the device computation
            tied = np.unpackbits(np.asarray(packed), axis=0,
                                 count=self.dev.n_nodes).astype(bool)
            res = PlacementScores(scores=np.zeros((0, 5)))
            for m, name in enumerate(METRICS):
                b = float(b_[m])
                idxs = np.flatnonzero(tied[:, m])
                res.best_score[name] = b if np.isfinite(b) else 0.0
                res.tied_indices[name] = idxs.tolist()
                res.best_index[name] = int(idxs[0]) if len(idxs) else None
            return res

        return resolve

    def _make_widened_select_fn(self):
        """Candidate-superset selection: like _make_host_score_fn but with the
        tolerance widened by a budget (tol + 1e-5) for f32 accumulation error,
        intended to contain every node the exact f64 rule
        (placement.cpp:355-401) would tie.  The budget is EMPIRICAL, not a
        derived bound, so place_exact verifies it per query (measured f32-vs-
        f64 error at every candidate + f64 closure check on the best excluded
        node) and falls back to the full host engine on any suspicion.  The
        host then replays only the candidates' root->node paths in f64
        (engine.rescore_paths).  Also returns the full f32 score matrix so the
        host can locate the best node OUTSIDE the candidate set."""

        @jax.jit
        def sel(uids, lc, log_mag, nuniq, lden, row_id, row_parent, row_child,
                row_node, euler_in, euler_out, eligible):
            nu = int(self.dev.unique_hashes.shape[0])
            uid_logc = jnp.zeros(nu, jnp.float32).at[uids].set(
                lc, mode="drop", unique_indices=True)
            acc, wc_den = self._score_rows(
                row_id, row_parent, row_child, row_node, euler_in, euler_out,
                uid_logc)
            scores = self._device_scores(acc, wc_den, log_mag, nuniq, lden)
            col = jnp.where(eligible[:, None], scores, -jnp.inf)
            best = jnp.max(col, axis=0)
            tol = jnp.maximum(best * 1e-4, 1e-9)
            cutoff = best - (2.0 * tol + 1e-5)
            cand = (col >= cutoff) & (col > -1e-5)
            return jnp.packbits(cand, axis=0), best, col

        return sel

    # closure witnesses rescored in f64 per metric, and the safety factor the
    # evasion gap must clear over the largest observed f32 error (see
    # place_exact's guard derivation)
    WITNESS_J = 16
    GUARD_FACTOR = 8.0

    def place_exact(self, sk, force_leaf: bool = False):
        """DEFAULT production path: device scoring + widened tie selection,
        then exact f64 path-replay rescore of the candidates on the host.
        The widened cutoff's f32-error budget is verified PER QUERY with a
        QUANTIFIED exclusion bound rather than assumed:

        (a) the measured |f32 - f64| error at EVERY candidate must stay
            within half the widening budget;
        (b) the top-J (J=WITNESS_J) f32 nodes OUTSIDE each metric's
            candidate set are rescored in f64 and must all fall strictly
            below best - tol (candidate-set closure).  When a metric has
            <= J excluded finite nodes the closure is COMPLETE — every
            node's f64 score was checked and the result is exact by
            enumeration;
        (c) otherwise, any still-unrescored excluded node has f32 score
            <= the lowest rescored witness, so evading detection requires a
            single-node f32 error >= G = (best - tol) - max unrescored f32.
            The guard requires G >= max(GUARD_FACTOR x e_obs, 1e-5), where
            e_obs is the largest |f32 - f64| observed across ALL rescored
            nodes (candidates + witnesses) of this query — an evader must
            be a GUARD_FACTOR-times outlier against the measured error
            distribution of the same accumulation program on the same data,
            on top of exceeding the a-priori budget the cutoff already
            spent.

        When every guard passes the result equals engine.score_nodes on the
        same sketch; on any suspicion (guard trip, empty candidate set for
        some metric, or candidate blow-up) this returns None and the caller
        falls back to the full f64 host engine.  The adversarial sweep in
        tests/test_tpu_paths.py (large-index stress + tampered-candidate
        tests) exercises both the exact and the refusal outcomes."""
        return self.place_exact_async(sk, force_leaf)()

    def place_exact_async(self, sk, force_leaf: bool = False):
        """Pipelined place_exact: runs the host prep and DISPATCHES the
        device selection program, returning a zero-arg finisher that blocks
        on the device result and completes the exact f64 rescue.  The caller
        can overlap independent host work (e.g. the NEXT sample's sketch in
        batch mode) with the in-flight device program."""
        from .engine import METRICS, PlacementScores, rescore_paths

        self._ensure_elig()

        # f32 device read table derived from the SAME f64 sketch used for the
        # exact rescore (so the join/filtering is identical by construction)
        U = self.dev.unique_hashes
        H = sk.sorted_hashes
        pos = np.searchsorted(U, H)
        posc = np.minimum(pos, max(len(U) - 1, 0)).astype(np.int32)
        found = (len(U) > 0) & (len(H) > 0) & (U[posc] == H)
        uids = posc[found]
        lc = sk.log_counts[found].astype(np.float32)

        # metrics whose f64 denominator is 0 have an IDENTICALLY-ZERO score
        # column (finalize_scores): exact result is best=0.0, no ties —
        # computable on host without any candidate set (e.g. wc_den == 0
        # when no root row matches a read seed)
        offs = self.idx.node_offsets.astype(np.int64)
        ra, rb = int(offs[0]), int(offs[1])
        Hr = self.idx.seed_hashes[ra:rb]
        Cr = self.idx.child_counts[ra:rb].astype(np.float64)
        if len(sk.sorted_hashes) and rb > ra:
            ri = np.searchsorted(sk.sorted_hashes, Hr)
            ric = np.minimum(ri, len(sk.sorted_hashes) - 1)
            rfound = sk.sorted_hashes[ric] == Hr
        else:
            rfound = np.zeros(rb - ra, dtype=bool)
        from .metrics import wc_denominator

        wc_den64 = float(wc_denominator(np, np.zeros(rb - ra), Cr, rfound)) \
            if rb > ra else 0.0
        dens = (sk.log_read_magnitude, sk.log_read_magnitude,
                float(sk.read_unique_seed_count), wc_den64,
                sk.log_containment_denominator)
        zero_metric = [d == 0.0 for d in dens]
        elig = self._elig_leaf if force_leaf else self._elig_all
        # sparse found-rows program (uids are sorted: derived from the sorted
        # sketch hashes); the f64 wc_den computed above feeds the f32 scores
        out = self._score_sparse_dispatch(
            uids, lc, sk.log_read_magnitude, sk.read_unique_seed_count,
            sk.log_containment_denominator, elig, widened=True,
            wc_den=wc_den64)
        if out is not None:
            packed, best32, col32 = out
        else:
            if not hasattr(self, "_widened_select_fn"):
                self._widened_select_fn = self._make_widened_select_fn()
            nu = len(U)
            cap = 1 << max(int(np.ceil(np.log2(max(len(uids), 1)))), 12)
            pu = np.full(cap, nu, np.int32)
            pu[: len(uids)] = uids
            pl = np.zeros(cap, np.float32)
            pl[: len(uids)] = lc
            dev = self.dev
            args = (pu, pl, np.float32(sk.log_read_magnitude),
                    np.int32(sk.read_unique_seed_count),
                    np.float32(sk.log_containment_denominator),
                    dev.row_id, dev.row_parent, dev.row_child, dev.row_node,
                    dev.euler_in, dev.euler_out, elig)
            self.last_step = (self._widened_select_fn, args)
            packed, best32, col32 = self._widened_select_fn(*args)
        del best32  # superseded: the error guard below checks every candidate

        def _finish():
            return self._place_exact_finish(sk, packed, col32, zero_metric)

        return _finish

    def _place_exact_finish(self, sk, packed, col32, zero_metric):
        """Back half of place_exact: device fetch + exact f64 rescue +
        guards (see place_exact's docstring for the exactness contract).
        Counts each query in ``self.stats``: answered on the device or
        refused by a guard, and the largest |f32 - f64| seen."""
        err = [0.0]
        res = self._place_exact_rescue(sk, packed, col32, zero_metric, err)
        st = self.stats
        st["answered" if res is not None else "guard_trips"] += 1
        st["max_abs_err"] = max(st["max_abs_err"], err[0])
        return res

    def _place_exact_rescue(self, sk, packed, col32, zero_metric, err_seen):
        from .engine import METRICS, PlacementScores, rescore_paths

        col32 = np.asarray(col32, dtype=np.float64)  # [n_nodes, 5], -inf inelig
        cand = np.unpackbits(np.asarray(packed), axis=0,
                             count=self.dev.n_nodes).astype(bool)
        cand[:, zero_metric] = False  # identically-zero columns: no rescue
        union = np.flatnonzero(cand.any(axis=1))
        if len(union) > 16384:
            return None  # exactness not guaranteed: full host engine instead
        # closure witnesses: the top-J f32 nodes OUTSIDE each metric's
        # candidate set (the most likely nodes for the widened cutoff to have
        # wrongly excluded); rescored in f64 alongside the candidates
        J = self.WITNESS_J
        out_col = np.where(cand, -np.inf, col32)
        wit_m: list = []
        closure_complete = []
        for m in range(5):
            if zero_metric[m]:
                wit_m.append(np.empty(0, np.int64))
                closure_complete.append(True)
                continue
            fin = np.flatnonzero(np.isfinite(out_col[:, m]))
            closure_complete.append(len(fin) <= J)
            if len(fin) > J:
                fin = fin[np.argpartition(-out_col[fin, m], J - 1)[:J]]
            wit_m.append(fin.astype(np.int64))
        witnesses = (np.unique(np.concatenate(wit_m)) if any(
            len(w) for w in wit_m) else np.empty(0, np.int64))
        witnesses = witnesses[~np.isin(witnesses, union)]
        allnodes = np.concatenate([union, witnesses]).astype(np.int64)
        exact = rescore_paths(self.idx, sk, allnodes)  # f64 [len, 5]
        rank = {int(n): i for i, n in enumerate(allnodes)}

        res = PlacementScores(scores=np.zeros((0, 5)))
        nu_rows = np.arange(len(union))
        for m, name in enumerate(METRICS):
            if zero_metric[m]:
                # engine.select_best on an all-zero column: best 0.0, no ties
                res.best_score[name] = 0.0
                res.tied_indices[name] = []
                res.best_index[name] = None
                continue
            in_cand = cand[union, m]
            if not in_cand.any():
                return None  # widened f32 set empty => f64 best unknowable
            col = np.where(in_cand, exact[nu_rows, m], -np.inf)
            best = float(col.max())
            if best <= 0:
                # every candidate non-positive: the f64 max over ALL nodes may
                # sit below the f32 candidate floor — not provably exact
                return None
            tol = max(best * 1e-4, 1e-9)
            # MEASURED error guard for the widening assumption: the cutoff
            # budgeted (tol + 1e-5) of f32 accumulation error on top of the
            # exact tie rule.  Check the observed |f32 - f64| at EVERY
            # candidate (not just the argmax): if any node's device score
            # already eats half that budget, the budget cannot be trusted for
            # the excluded nodes either — fall back to the full host engine.
            err = np.abs(col32[union[in_cand], m] - exact[nu_rows[in_cand], m])
            e_obs = float(err.max())
            err_seen[0] = max(err_seen[0], e_obs)
            if e_obs > 0.5 * (tol + 1e-5):
                return None
            # CLOSURE guard: every rescored witness outside the candidate set
            # must sit strictly below the exact tie cutoff in f64, otherwise
            # the widened selection may have dropped a true tie — fall back.
            wm = wit_m[m]
            if len(wm):
                wrows = np.fromiter((rank[int(w)] for w in wm), np.int64,
                                    len(wm))
                wex = exact[wrows, m]
                if float(wex.max()) >= best - tol:
                    return None
                e_obs = max(e_obs, float(np.abs(col32[wm, m] - wex).max()))
                err_seen[0] = max(err_seen[0], e_obs)
                if not closure_complete[m]:
                    # EVASION-GAP guard (quantified bound, see docstring):
                    # unrescored excluded nodes all have f32 <= the lowest
                    # rescored witness; an undetected true tie would need a
                    # single-node f32 error >= G.  Demand G clear the
                    # observed error distribution by GUARD_FACTOR and the
                    # a-priori budget floor.
                    G = (best - tol) - float(col32[wm, m].min())
                    if G < max(self.GUARD_FACTOR * e_obs, 1e-5):
                        return None
            tied = union[(col >= best - tol) & (col > 0)]
            res.best_score[name] = best if best > -np.inf else 0.0
            res.tied_indices[name] = tied.tolist()
            res.best_index[name] = int(tied[0]) if len(tied) else None
        return res

    def _score_by_table(self, uid_logc):
        """Score rows by gathering each row's unique-hash id from the dense
        per-uid logc table built in finalize (one gather per row; the
        expensive join already happened on the compacted read seeds)."""
        dev = self.dev
        if not hasattr(self, "_score_tab_fn"):
            self._score_tab_fn = jax.jit(self._score_rows)
        return self._score_tab_fn(
            dev.row_id, dev.row_parent, dev.row_child, dev.row_node,
            dev.euler_in, dev.euler_out, uid_logc)

    def _finish_scores(self, acc, log_mag, read_unique, logcont_den):
        from .metrics import finalize_scores

        wc_den = getattr(self, "_last_wc_den", 0.0)
        return finalize_scores(np, acc.astype(np.float64), log_mag,
                               read_unique, logcont_den, wc_den)
