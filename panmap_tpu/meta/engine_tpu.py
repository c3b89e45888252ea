"""Device-batched meta read scoring.

Replaces the per-node python DFS of MetaScorer.score_all for large read sets
(mgsr.cpp:7225-7470 scoreReads semantics, identical results).

Shape choice (the reason this is fast on the device): presence-flip events
(meta/events.py) are first densified into a per-orientation presence BITMAP
`P[(orient, uid), node]` over a chunk of the DFS order — one scatter-add +
prefix-sum per chunk.  A read's fwd/rev match counts at every node in the
chunk are then row-gathers of P at its seedmer uids + a segment-sum by read:
pure streaming HBM work.  The per-(read x event) COO expansion this replaces
is quadratic in the worst case — a conserved-but-polymorphic seedmer that
appears in half the reads AND flips at thousands of nodes contributes
|reads| x |flips| pairs, which blew past 10^9 on real 100k-read samples."""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from .events import overlap_coefficients_from_events, presence_events


def sketch_meta_reads_batch(seqs: list, k: int, s: int, t: int, l: int,
                            open_: bool, dust_threshold: float = 100.0,
                            mask_read_ends: int = 0, batch: int = 16384,
                            pad_len: int | None = None):
    """Batched twin of engine.sketch_meta_reads_full for l >= 2: the
    syncmer/k-min-mer scan runs on the accelerator per 16k-read batch and
    dedup keys are row bytes of the canonical (hash, rev, qbeg, qend) lists.
    Returns (reads, dup_index, n_dust)."""
    import functools

    from ..sketch.tpu import (
        encode_reads_batch,
        kminmer_batch_full,
        syncmer_scan_batch,
    )
    from .engine import MetaRead, dust_score

    if mask_read_ends > 0:
        seqs = [x[mask_read_ends : len(x) - mask_read_ends]
                if len(x) > 2 * mask_read_ends else x for x in seqs]
    keep_idx = np.arange(len(seqs))
    n_dust = 0
    if dust_threshold < 100.0:
        ok = np.array([dust_score(x) <= dust_threshold for x in seqs])
        n_dust = int((~ok).sum())
        keep_idx = keep_idx[ok]
        seqs = [seqs[i] for i in keep_idx]
    pad = pad_len or max((len(x) for x in seqs), default=k)
    pad = max(pad, k + 1)

    @functools.partial(jax.jit, static_argnames=())
    def sketch(reads, lens):
        hh, hl, is_sync = syncmer_scan_batch(reads, lens, k, s, t, open_)
        return kminmer_batch_full(hh, hl, is_sync, k, l)

    lists: dict = {}
    order_keys: list = []
    for off in range(0, len(seqs), batch):
        chunk = seqs[off : off + batch]
        enc, lens = encode_reads_batch(chunk, pad_to=pad)
        kh, kl, valid, rv, qb, qe = (np.asarray(x) for x in sketch(enc, lens))
        H = (kh.astype(np.uint64) << np.uint64(32)) | kl.astype(np.uint64)
        H = np.where(valid, H, 0)
        nvalid = valid.sum(axis=1)
        # canonical row key: trimmed-to-count is implied because invalid
        # slots are zeroed and the count is part of the key
        for j in range(len(chunk)):
            nv = int(nvalid[j])
            if nv == 0:
                continue
            key = (nv, H[j].tobytes(), rv[j].tobytes(), qb[j].tobytes(),
                   qe[j].tobytes())
            orig = int(keep_idx[off + j])
            ent = lists.get(key)
            if ent is None:
                m = valid[j]
                lists[key] = [MetaRead(hashes=H[j][m], revs=rv[j][m],
                                       n_dup=0,
                                       qbeg=qb[j][m].astype(np.int64),
                                       qend=qe[j][m].astype(np.int64)),
                              [orig]]
            else:
                ent[1].append(orig)
    reads = []
    dup_index = []
    for rd, members in lists.values():
        rd.n_dup = len(members)
        reads.append(rd)
        dup_index.append(members)
    return reads, dup_index, n_dust


def _pad_pow2(n: int, lo: int = 1 << 12) -> int:
    m = lo
    while m < n:
        m <<= 1
    return m


class TpuMetaScorer:
    """score_all twin over a chunked dense presence bitmap (see module doc)."""

    NODE_CHUNK = 2048
    READ_CHUNK = 4096

    def __init__(self, midx, reads: list, batch: int = 512, mesh=None):
        """``mesh``: optional 1-D jax.sharding.Mesh ("data") — the resident
        read blocks shard across the devices and each chip scores its local
        blocks against the (replicated) per-chunk presence bitmap; the
        node-chunk event scan is duplicated per device (tiny next to the
        row-gather bandwidth the sharding splits).  --mesh product path."""
        del batch  # legacy knob of the COO scorer
        self.midx = midx
        self.reads = reads
        self.mesh = mesh
        self.n_nodes = len(midx.node_ids)

        all_h = (np.concatenate([r.hashes for r in reads])
                 if reads else np.empty(0, np.uint64))
        uniq_h = np.unique(all_h)
        # only hashes that exist somewhere in the INDEX can ever flip
        # presence; error seedmers (the majority on real samples) get no P
        # row and map to the dummy zero row below.  Without this the row
        # space scaled with read errors — 400k reads pushed n_rows * C past
        # int32 in the event scatter.
        idx_h = np.unique(np.asarray(midx.seed_hash, dtype=np.uint64))
        if len(idx_h) and len(uniq_h):
            ii = np.minimum(np.searchsorted(idx_h, uniq_h), len(idx_h) - 1)
            self.read_hashes = uniq_h[idx_h[ii] == uniq_h]
        else:
            self.read_hashes = uniq_h[:0]
        self.ev = presence_events(midx, self.read_hashes)
        U = len(self.read_hashes)
        self.U = U
        self.Upad = _pad_pow2(max(U, 1), lo=1 << 10)
        # P row layout: [fwd uid rows | rev uid rows | one zero dummy row]
        self.n_rows = 2 * self.Upad + 1
        # keep the flat event scatter (ev_key * C + ev_col) within int32
        C = self.NODE_CHUNK
        while C > 32 and self.n_rows * C >= (1 << 31):
            C //= 2
        self.NODE_CHUNK = C

        # flip events sorted by preorder position, keyed by (orient, uid)
        ev = self.ev
        key = (np.where(ev["ev_rev"], self.Upad, 0)
               + ev["ev_uid"]).astype(np.int64)
        order = np.argsort(ev["ev_node"], kind="stable")
        self._evp_pos = ev["ev_node"][order].astype(np.int64)
        self._evp_key = key[order]
        self._evp_delta = ev["ev_delta"][order].astype(np.int32)
        # kept for events introspection / driver log lines
        self.ev_pos = self._evp_pos

        # occurrence arrays, SLOTTED: each read gets S fixed key slots
        # (S = pow2 >= max seedmers per read).  Scoring is then a row-gather
        # of P + a plain axis reduction — no scatter/segment_sum on the
        # device, which halves the per-dispatch cost.
        R = len(reads)
        nseeds = np.array([len(r.hashes) for r in reads], dtype=np.int64)
        if U:
            occ_pos = np.minimum(np.searchsorted(self.read_hashes, all_h),
                                 U - 1)
            occ_found = self.read_hashes[occ_pos] == all_h
        else:
            occ_pos = np.zeros(len(all_h), dtype=np.int64)
            occ_found = np.zeros(len(all_h), dtype=bool)
        occ_uid = occ_pos.astype(np.int64)
        occ_rev = (np.concatenate([np.asarray(r.revs, dtype=bool)
                                   for r in reads])
                   if reads else np.empty(0, bool))
        S = _pad_pow2(int(nseeds.max()) if R else 1, lo=8)
        self.n_slots = S
        dummy = self.n_rows - 1  # the all-zero P row
        B = self.READ_CHUNK
        Rpad = ((R + B - 1) // B) * B if R else B
        if mesh is not None:
            # block axis must divide the mesh; pad with inert dummy blocks
            nd = int(mesh.devices.size)
            nb = Rpad // B
            Rpad = ((nb + nd - 1) // nd) * nd * B
        self.Rpad = Rpad
        fwd_sl = np.full((Rpad, S), dummy, dtype=np.int32)
        rev_sl = np.full((Rpad, S), dummy, dtype=np.int32)
        row_of = np.repeat(np.arange(R, dtype=np.int64), nseeds)
        slot_of = (np.arange(len(occ_uid), dtype=np.int64)
                   - np.repeat(np.cumsum(nseeds) - nseeds, nseeds))
        fwd_sl[row_of, slot_of] = np.where(
            ~occ_found, dummy,
            np.where(occ_rev, self.Upad + occ_uid, occ_uid))
        rev_sl[row_of, slot_of] = np.where(
            ~occ_found, dummy,
            np.where(occ_rev, occ_uid, self.Upad + occ_uid))
        # resident [nB, B, S]: a fused per-node-chunk program scans the read
        # blocks on device, so the whole read set costs ONE dispatch per chunk
        self.n_blocks = Rpad // B
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec

            sh = NamedSharding(mesh, PartitionSpec("data"))
            self._occ_fwd_dev = jax.device_put(
                fwd_sl.reshape(self.n_blocks, B, S), sh)
            self._occ_rev_dev = jax.device_put(
                rev_sl.reshape(self.n_blocks, B, S), sh)
        else:
            self._occ_fwd_dev = jnp.asarray(
                fwd_sl.reshape(self.n_blocks, B, S))
            self._occ_rev_dev = jnp.asarray(
                rev_sl.reshape(self.n_blocks, B, S))
        self._max_occ = int(nseeds.max()) if R else 0

        # per-node-chunk carry-in presence state (flips with pos < chunk lo)
        C = self.NODE_CHUNK
        self._chunk_lo = list(range(0, self.n_nodes + 1, C))
        self._carries = []
        state = np.zeros(self.n_rows, dtype=np.int32)
        prev = 0
        for lo in self._chunk_lo:
            cut = np.searchsorted(self._evp_pos, lo)
            np.add.at(state, self._evp_key[prev:cut],
                      self._evp_delta[prev:cut])
            prev = cut
            self._carries.append(state.copy())
        self._max_ev = 0
        bounds = np.searchsorted(self._evp_pos,
                                 self._chunk_lo + [self.n_nodes + 1])
        if len(bounds) > 1:
            self._max_ev = int(np.max(np.diff(bounds)))
        self._ev_bounds = bounds
        self._evpad = _pad_pow2(max(self._max_ev, 1))
        # stacked padded per-chunk events + carry states, uploaded ONCE.
        # Chunks are processed in GROUPS of G per dispatch (one outer-scan
        # program, compiled once) so the [G, nB, B, C] score output stays
        # under ~3 GB on big trees; the chunk axis is padded to a multiple
        # of G with inert chunks (zero carries, dummy-row events).
        nchunks = len(self._chunk_lo)
        per_chunk_sn = self.n_blocks * B * C  # u8 bytes
        self.group = max(1, min(nchunks, int(3e9 // max(per_chunk_sn, 1))))
        kpad = ((nchunks + self.group - 1) // self.group) * self.group
        self.n_chunks = nchunks
        ev_key_st = np.full((kpad, self._evpad), self.n_rows - 1, np.int32)
        ev_col_st = np.zeros((kpad, self._evpad), np.int16)  # < NODE_CHUNK
        ev_del_st = np.zeros((kpad, self._evpad), np.int8)
        for ci, lo in enumerate(self._chunk_lo):
            a, b = bounds[ci], bounds[ci + 1]
            ev_key_st[ci, : b - a] = self._evp_key[a:b]
            ev_col_st[ci, : b - a] = self._evp_pos[a:b] - lo
            ev_del_st[ci, : b - a] = self._evp_delta[a:b]
        carr = np.zeros((kpad, self.n_rows), np.int32)
        carr[:nchunks] = np.stack(self._carries)
        self._ev_key_dev = jnp.asarray(ev_key_st)
        self._ev_col_dev = jnp.asarray(ev_col_st)
        self._ev_del_dev = jnp.asarray(ev_del_st)
        self._carries_dev = jnp.asarray(carr)
        self._build_fn = None
        self._score_fn = None
        self._assign_fn = None

    def overlap_coefficients(self) -> np.ndarray:
        """OC per dfs index as prefix sums of the presence events."""
        return overlap_coefficients_from_events(self.ev, self.n_nodes)

    # ---- device programs (one compile each; shapes fixed per run) ----

    def _make_build_fn(self):
        n_rows = self.n_rows
        C = self.NODE_CHUNK

        @jax.jit
        def build(state, ev_key, ev_col, ev_delta):
            flat = jnp.zeros(n_rows * C, jnp.int32).at[
                ev_key * C + ev_col.astype(jnp.int32)].add(
                ev_delta.astype(jnp.int32), mode="drop")
            M = flat.reshape(n_rows, C)
            M = M.at[:, 0].add(state)
            return (jnp.cumsum(M, axis=1) > 0).astype(jnp.int8)

        return build

    def _p_chunk(self, ci: int):
        """Presence bitmap for node-chunk ci: i8 [n_rows, NODE_CHUNK]."""
        if self._build_fn is None:
            self._build_fn = self._make_build_fn()
        return self._build_fn(self._carries_dev[ci], self._ev_key_dev[ci],
                              self._ev_col_dev[ci], self._ev_del_dev[ci])

    def _make_score_all_fn(self):
        """ONE dispatch for the whole scoring pass: an outer lax.scan walks
        the node chunks (events + carry states are resident stacked tensors),
        an inner scan walks the resident read blocks (one launch instead of
        one per chunk).

        The program is fully STATIC-shaped (no candidate-dependent gather
        inside): it emits the full [B, C] score plane per block per chunk and
        candidate-column selection happens outside as a trivial gather.
        A candidate-width-parameterized gather inside the scan made XLA
        compile times explode (548s at W=512 vs 12s of actual compute).

        The presence bitmap is BIT-PACKED along the node axis (u32 words):
        the row gathers are the bandwidth bottleneck, and packing cuts their
        HBM traffic 8x (measured ~3x end-to-end vs the i8 bitmap)."""
        n_rows, C = self.n_rows, self.NODE_CHUNK
        C32 = C // 32
        sdt = jnp.uint8 if self.n_slots <= 255 else jnp.uint16
        # numpy, NOT jnp: a device-array closure constant is fetched back
        # to the host at lowering time (mlir ir_constant -> Array._value)
        pack32 = np.arange(32, dtype=np.uint32)

        def run(carries, ev_keys, ev_cols, ev_dels, fwd_all, rev_all):
            def chunk(_, xs):
                state, ev_key, ev_col, ev_delta = xs
                flat = jnp.zeros(n_rows * C, jnp.int32).at[
                    ev_key * C + ev_col.astype(jnp.int32)].add(
                ev_delta.astype(jnp.int32), mode="drop")
                M = flat.reshape(n_rows, C).at[:, 0].add(state)
                P = jnp.cumsum(M, axis=1) > 0
                Pp = jnp.sum(P.reshape(n_rows, C32, 32).astype(jnp.uint32)
                             << pack32[None, None, :], axis=2)

                def blk(_, keys):
                    fwd_key, rev_key = keys
                    # [B, S, C32] u32 row-gathers of the packed bitmap,
                    # bit-expanded and reduced over the slot axis in one
                    # fused streaming pass
                    gf = Pp[fwd_key]
                    gr = Pp[rev_key]
                    fwd = jnp.sum((gf[:, :, :, None] >> pack32) & 1, axis=1,
                                  dtype=jnp.int32).reshape(-1, C)
                    rev = jnp.sum((gr[:, :, :, None] >> pack32) & 1, axis=1,
                                  dtype=jnp.int32).reshape(-1, C)
                    sc = jnp.maximum(fwd, rev)
                    return None, (jnp.max(sc, axis=1), sc.astype(sdt))

                _, (ms, sn) = jax.lax.scan(blk, None, (fwd_all, rev_all))
                return None, (ms, sn)

            _, (ms, sn) = jax.lax.scan(
                chunk, None, (carries, ev_keys, ev_cols, ev_dels))
            return ms, sn  # [K, nB, B], [K, nB, B, C]

        if self.mesh is not None:
            # --mesh: read blocks shard on their leading axis; the event
            # tensors/carries replicate and every device runs the chunk scan
            # over its local blocks (outputs stay sharded on the block axis)
            from jax import shard_map
            from jax.sharding import PartitionSpec as P

            return jax.jit(shard_map(
                run, mesh=self.mesh,
                in_specs=(P(), P(), P(), P(), P("data"), P("data")),
                out_specs=(P(None, "data"), P(None, "data"))))
        return jax.jit(run)

    def _make_gather_fn(self):
        """Candidate-column selection over a group's [G, nB, B, C] score
        block as ONE compiled program (instead of per-chunk eager
        slices)."""

        @jax.jit
        def gather(ms, sn, cols):
            G, nB, B, C = sn.shape
            flat = jnp.moveaxis(sn, 0, 2).reshape(nB * B, G * C)
            return (jnp.max(ms, axis=0).reshape(nB * B),
                    flat[:, cols].astype(jnp.uint16))

        return gather

    def score_all(self, candidate_nodes: list, snap_device: bool = False,
                  tiled: bool = False):
        """Returns (max_score i32[R], snap[, col_map]).

        snap_device=False: snap u16[len(candidates), R] on host (legacy).
        snap_device=True:  snap u16[R, len(candidates)] LEFT ON DEVICE — feed
        it straight to run_squarem's device backend (no matrix round-trip).
        tiled=True: snap u16[Rpad, n_tiles*512] on device in TILE order plus
        col_map (col_map[i] = snap column of candidate i) — every device-side
        shape is bucketed (padded rows, 512-wide tiles), so no per-workload
        program is compiled; run_squarem_device composes col_map into its own
        bucketed gather.  Pad rows/columns carry garbage; consumers must mask
        (zero read weights / alive=False)."""
        R = len(self.reads)
        n_cand = len(candidate_nodes)
        C = self.NODE_CHUNK
        cand = np.asarray(candidate_nodes, dtype=np.int64)
        if self._score_fn is None:
            self._score_fn = self._make_score_all_fn()
        gather_fn = self._make_gather_fn()

        # candidates sorted by group; per-group column ids within the group's
        # [G*C] node span.  The gather runs in FIXED-width tiles of W columns
        # so exactly ONE gather program exists regardless of candidate count:
        # a candidate-count-parameterized shape would miss the persistent
        # compile cache on every new workload.
        G = self.group
        cand_grp = (cand // (G * C)).astype(np.int64)
        cand_order = np.argsort(cand_grp, kind="stable")
        groups = list(range(0, self.n_chunks, G))
        counts = np.bincount(cand_grp[cand_order], minlength=len(groups))
        W = 512

        ms_host = np.zeros(self.Rpad, dtype=np.int64)
        snap_parts: list = []
        tile_sels: list = []
        col_order: list = []
        off = 0
        for gi, g0 in enumerate(groups):
            ms, sn = self._score_fn(
                self._carries_dev[g0 : g0 + G], self._ev_key_dev[g0 : g0 + G],
                self._ev_col_dev[g0 : g0 + G], self._ev_del_dev[g0 : g0 + G],
                self._occ_fwd_dev, self._occ_rev_dev)
            sel_g = cand_order[off : off + counts[gi]]
            off += counts[gi]
            for ti in range(0, max(len(sel_g), 1), W):
                sel = sel_g[ti : ti + W]
                cols = np.zeros(W, dtype=np.int32)
                cols[: len(sel)] = (cand[sel] - g0 * C).astype(np.int32)
                ms_g, snap_g = gather_fn(ms, sn, jnp.asarray(cols))
                if ti == 0:
                    ms_host = np.maximum(ms_host, np.asarray(ms_g))
                if len(sel):
                    snap_parts.append(snap_g if tiled
                                      else snap_g[:R, : len(sel)])
                    tile_sels.append(sel)
                    col_order.extend(sel.tolist())
        max_score = ms_host[:R].astype(np.int32)
        if n_cand == 0:
            if tiled:
                return (max_score, jnp.zeros((self.Rpad, 0), jnp.uint16),
                        np.empty(0, np.int64))
            if snap_device:
                return max_score, jnp.zeros((R, 0), jnp.uint16)
            return max_score, np.zeros((0, R), np.uint16)
        snap_dev = (snap_parts[0] if len(snap_parts) == 1
                    else jnp.concatenate(snap_parts, axis=1))
        if tiled:
            col_map = np.empty(n_cand, dtype=np.int64)
            woff = 0
            for sel in tile_sels:
                col_map[sel] = woff + np.arange(len(sel))
                woff += W
            return max_score, snap_dev, col_map
        # assemble [R, n_cand] in ORIGINAL candidate order
        inv = np.empty(len(col_order), dtype=np.int64)
        inv[np.asarray(col_order)] = np.arange(len(col_order))
        snap_dev = snap_dev[:, jnp.asarray(inv)]
        if snap_device:
            return max_score, snap_dev
        return max_score, np.asarray(snap_dev).T.copy()

    def _make_assign_fn(self):
        B = self.READ_CHUNK
        n_rows, C = self.n_rows, self.NODE_CHUNK

        C32 = C // 32
        pack32 = np.arange(32, dtype=np.uint32)  # numpy: see _make_score_all_fn

        @jax.jit
        def run(carries, ev_keys, ev_cols, ev_dels, fwd_all, rev_all,
                eff_all, thr_all, keep_all, iota_all):
            pack = np.arange(8, dtype=np.int32)

            def chunk(_, xs):
                state, ev_key, ev_col, ev_delta, keep_c, iota_c = xs
                flat = jnp.zeros(n_rows * C, jnp.int32).at[
                    ev_key * C + ev_col.astype(jnp.int32)].add(
                ev_delta.astype(jnp.int32), mode="drop")
                M = flat.reshape(n_rows, C).at[:, 0].add(state)
                P = jnp.cumsum(M, axis=1) > 0
                Pp = jnp.sum(P.reshape(n_rows, C32, 32).astype(jnp.uint32)
                             << pack32[None, None, :], axis=2)

                def blk(_, xs2):
                    fwd_key, rev_key, eff_b, thr_b = xs2
                    gf = Pp[fwd_key]
                    gr = Pp[rev_key]
                    fwd = jnp.sum((gf[:, :, :, None] >> pack32) & 1, axis=1,
                                  dtype=jnp.int32).reshape(-1, C)
                    rev = jnp.sum((gr[:, :, :, None] >> pack32) & 1, axis=1,
                                  dtype=jnp.int32).reshape(-1, C)
                    sc = jnp.maximum(fwd, rev)
                    live = eff_b[:, None] > 0
                    is_max_all = (sc == eff_b[:, None]) & live
                    is_max = is_max_all & keep_c[None, :]
                    near = (sc >= (eff_b - thr_b)[:, None]) & live
                    lca_min = jnp.min(jnp.where(is_max_all, iota_c, 1 << 30),
                                      axis=1)
                    lca_max = jnp.max(jnp.where(is_max_all, iota_c, -1),
                                      axis=1)
                    bits_max = jnp.sum(is_max.reshape(B, C // 8, 8)
                                       << pack[None, None, :],
                                       axis=2).astype(jnp.uint8)
                    bits_near = jnp.sum(near.reshape(B, C // 8, 8)
                                        << pack[None, None, :],
                                        axis=2).astype(jnp.uint8)
                    return None, (bits_max, bits_near,
                                  jnp.sum(is_max, axis=1), lca_min, lca_max)

                _, outs = jax.lax.scan(blk, None,
                                       (fwd_all, rev_all, eff_all, thr_all))
                return None, outs

            _, outs = jax.lax.scan(
                chunk, None,
                (carries, ev_keys, ev_cols, ev_dels, keep_all, iota_all))
            return outs

        return run

    def assignment_pass(self, keep: np.ndarray, eff: np.ndarray,
                        amb_thr: int = 0, amb_ratio: float = 0.0):
        """Full-matrix assignment support (the python assignReadsBatch DFS in
        closed form): per read with eff>0, the kept nodes scoring == eff
        (max-parsimony placements) and those >= eff - threshold (near-max,
        for taxonomy ambiguity).  Returns (assigned_by_node, near_iter, epp,
        (lca_lo, lca_hi)) — see meta/assign.py."""
        R = len(self.reads)
        B = self.READ_CHUNK
        C = self.NODE_CHUNK
        if self._assign_fn is None:
            self._assign_fn = self._make_assign_fn()

        eff_pad = np.zeros(self.Rpad, dtype=np.int32)
        eff_pad[:R] = eff
        thr_pad = np.maximum(amb_thr, (eff_pad * amb_ratio).astype(np.int32))
        eff_dev = jnp.asarray(eff_pad.reshape(self.n_blocks, B))
        thr_dev = jnp.asarray(thr_pad.reshape(self.n_blocks, B))

        K = self.n_chunks
        kpad = self._carries_dev.shape[0]
        keep_all = np.zeros((kpad, C), dtype=bool)
        iota_all = np.full((kpad, C), 1 << 30, dtype=np.int32)
        for ci in range(K):
            lo = self._chunk_lo[ci]
            valid_c = min(C, self.n_nodes - lo)
            if valid_c <= 0:
                continue
            keep_all[ci, :valid_c] = keep[lo : lo + valid_c]
            iota_all[ci, :valid_c] = lo + np.arange(valid_c)
        keep_dev = jnp.asarray(keep_all)
        iota_dev = jnp.asarray(iota_all)

        assigned_by_node: dict = {}
        near_sets: dict = {}
        epp = np.zeros(R, dtype=np.int64)
        lca_lo = np.full(R, 1 << 30, dtype=np.int64)
        lca_hi = np.full(R, -1, dtype=np.int64)
        G = self.group
        for g0 in range(0, K, G):
            bm, bn, cnt, lmin, lmax = self._assign_fn(
                self._carries_dev[g0 : g0 + G], self._ev_key_dev[g0 : g0 + G],
                self._ev_col_dev[g0 : g0 + G], self._ev_del_dev[g0 : g0 + G],
                self._occ_fwd_dev, self._occ_rev_dev,
                eff_dev, thr_dev, keep_dev[g0 : g0 + G],
                iota_dev[g0 : g0 + G])
            bm_h_all = np.asarray(bm)
            bn_h_all = np.asarray(bn)
            cnt = np.asarray(cnt)
            lmin = np.asarray(lmin)
            lmax = np.asarray(lmax)
            for ci in range(g0, min(g0 + G, K)):
                lo = self._chunk_lo[ci]
                valid_c = min(C, self.n_nodes - lo)
                if valid_c <= 0:
                    continue
                gi = ci - g0
                epp += cnt[gi].reshape(self.Rpad)[:R]
                lca_lo = np.minimum(lca_lo, lmin[gi].reshape(self.Rpad)[:R])
                lca_hi = np.maximum(lca_hi, lmax[gi].reshape(self.Rpad)[:R])
                bm_h = np.unpackbits(
                    bm_h_all[gi].reshape(self.Rpad, C // 8)[:R],
                    axis=1, bitorder="little")[:, :valid_c]
                rr, nn = np.nonzero(bm_h)
                for r, node in zip(rr.tolist(), nn.tolist()):
                    assigned_by_node.setdefault(lo + node, []).append(r)
                bn_h = np.unpackbits(
                    bn_h_all[gi].reshape(self.Rpad, C // 8)[:R],
                    axis=1, bitorder="little")[:, :valid_c]
                rr, nn = np.nonzero(bn_h)
                for r, node in zip(rr.tolist(), nn.tolist()):
                    near_sets.setdefault(r, []).append(lo + node)
        near_iter = [(r, np.array(sorted(ns), dtype=np.int64))
                     for r, ns in sorted(near_sets.items())]
        lca_lo[lca_lo == (1 << 30)] = -1
        return assigned_by_node, near_iter, epp, (lca_lo, lca_hi)
