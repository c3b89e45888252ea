"""The single definition site for the five placement metrics' row-delta math.

The reference maintains its metrics as per-row deltas streamed over each
node's SoA range (src/placement.cpp:242-345 computeChildMetrics; the metric
formulas live in the NodeMetrics getters, src/placement.hpp:108-155).  This
module is the one traced/vectorized body consumed by every scoring path:

 - place/engine.py       (numpy float64 — the byte-exact parity oracle)
 - place/engine_tpu.py   (jitted f32 device program)
 - place/query_tpu.py    (fused on-device sketch+score program)
 - parallel/mesh.py      (rows sharded over a device mesh, psum combine)

All four call ``row_metric_deltas`` with their own array namespace (``numpy``
or ``jax.numpy``); dtype follows the inputs, so the f64 oracle and the f32
device programs share one formula by construction.  ``finalize_scores`` is the
shared accumulator->score division, and ``euler_prefix`` the shared
ancestor-accumulation (the device replacement for the reference's
level-synchronous BFS, src/placement.cpp:701-918).

ACCUMULATOR ORDER (axis 1 of everything downstream):
  0 genome-magnitude^2   1 logRaw numerator   2 logCosine numerator
  3 weightedContainment numerator             4 logContainment numerator
  5 presence (containment numerator)
"""

from __future__ import annotations

METRICS = ("log_raw", "log_cosine", "containment", "weighted_containment",
           "log_containment")

N_ACC = 6  # accumulator columns (see module docstring)


def row_metric_deltas(xp, lrc, P, C, found):
    """Per-row metric deltas (placement.cpp:242-345).

    xp     numpy or jax.numpy — selects host-f64 vs traced-f32 execution
    lrc    float[T] log1p(read count) of the row's hash, 0 where not found
    P, C   float[T] parent/child seed counts of the row
    found  bool[T]  row hash present in the (filtered) read seed table

    Returns the 6 delta arrays in accumulator order.  Divisions guard with
    ``maximum(x, 1)`` instead of errstate so the same expression traces under
    jit; for P >= 1 the quotient is bit-identical to the unguarded division.
    """
    one = lrc.dtype.type(1.0) if hasattr(lrc.dtype, "type") else 1.0
    log_child = xp.where(C > 0, xp.log1p(C), 0.0)
    log_parent = xp.where(P > 0, xp.log1p(P), 0.0)
    mag_delta = log_child * log_child - log_parent * log_parent

    active = ((C - P) != 0) & found
    became_present = ((P == 0) & (C != 0)).astype(lrc.dtype)
    became_absent = ((C == 0) & (P != 0)).astype(lrc.dtype)
    presence_delta = xp.where(active, became_present - became_absent, 0.0)

    old_contrib = xp.where(P > 0, lrc / xp.maximum(P, one), 0.0)
    new_contrib = xp.where(C > 0, lrc / xp.maximum(C, one), 0.0)
    old_wc = xp.where(P > 0, 1.0 / xp.maximum(P, one), 0.0)
    new_wc = xp.where(C > 0, 1.0 / xp.maximum(C, one), 0.0)
    lograw_delta = xp.where(active, new_contrib - old_contrib, 0.0)
    logcos_delta = xp.where(active, lrc * (log_child - log_parent), 0.0)
    wc_delta = xp.where(active, new_wc - old_wc, 0.0)
    logcont_delta = presence_delta * lrc
    return (mag_delta, lograw_delta, logcos_delta, wc_delta, logcont_delta,
            presence_delta)


def wc_denominator(xp, lrc_root, C_root, found_root):
    """Weighted-containment denominator over the ROOT node's rows in stored
    order (src/placement.cpp:1861-1876).  The numpy path sums via cumsum so
    the f64 addition order is sequential, matching the reference's
    accumulation loop (np.sum is pairwise and can differ in the last bit)."""
    import numpy as _np

    one = lrc_root.dtype.type(1.0) if hasattr(lrc_root.dtype, "type") else 1.0
    inv = xp.where((C_root > 0) & found_root,
                   1.0 / xp.maximum(C_root, one), 0.0)
    if xp is _np:
        return _np.cumsum(inv)[-1] if len(inv) else 0.0
    return xp.sum(inv)


def row_node_sums(lrc, P, C, found, row_node, n_nodes):
    """Traced: stack the deltas and segment-sum them per node.  Used by every
    device path; the mesh path psums the result across row shards.  P/C may
    arrive as narrow integers (the index uploads counts as i16 to halve the
    transfer) — cast to the compute dtype here."""
    import jax
    import jax.numpy as jnp

    P = P.astype(lrc.dtype)
    C = C.astype(lrc.dtype)
    deltas = jnp.stack(row_metric_deltas(jnp, lrc, P, C, found), axis=1)
    # rows are CSR-grouped by node, so the segment ids are sorted — the
    # hint lets XLA lower a sorted scatter.  A prefix-difference formulation
    # avoids the scatter, but its f32 error over the multi-million-row
    # global cumsum reaches ~10 absolute on the accumulators (vs 1e-3 for
    # per-segment summation), so it was rejected.  On a GPU the scatter's
    # atomics add in an order that can change between runs; the per-query
    # guard in place/query_tpu.py measures the resulting f32 error.
    return jax.ops.segment_sum(deltas, row_node, num_segments=n_nodes,
                               indices_are_sorted=True)


class BlockSegments:
    """Static per-index structure for the blocked per-node reduction.

    row_node is FIXED per DeviceIndex, so every segment boundary is known on
    the host.  That turns the per-node sum into: one block-local cumsum
    (native XLA op — unlike the 2.4M-row sorted scatter it is HBM-speed and
    compiles in seconds), gathers at STATIC positions, a tiny segmented scan
    over the B block totals for segments spanning block boundaries, and one
    M-row scatter (M = #non-empty nodes, ~60x smaller than the row count).

    f32 error semantics: per-segment, bounded by the BLOCK-local cumsum
    magnitude (<= L rows) — measured ~25x tighter than the sorted scatter's
    own accumulation error at bench shapes, and far from the rejected
    global-cumsum prefix-difference (see row_node_sums note).
    """

    __slots__ = ("L", "B", "pad", "lastp", "base", "has_base", "spanning",
                 "seg_node", "eb_blk", "q_flat", "has_bnd", "n_rows")

    def __init__(self, **kw):
        for k, v in kw.items():
            setattr(self, k, v)


def make_block_segments(row_node, n_nodes, L=1024):
    """Host: sorted row_node i32[T] -> BlockSegments (device-resident consts).

    Pad rows (to a block multiple) join the final segment; their metric
    deltas are zero-padded in row_node_sums_blocked so the absorption is
    inert — the same scheme the mesh pad uses (engine_tpu.py:104-108).
    """
    import numpy as np
    import jax.numpy as jnp

    T = len(row_node)
    B = max(-(-T // L), 1)
    pad = B * L - T
    rn_pad = np.concatenate([row_node,
                             np.full(pad, row_node[-1] if T else 0, np.int32)])
    lastp = np.nonzero(np.diff(rn_pad, append=np.int32(n_nodes)))[0]
    seg_node = rn_pad[lastp]
    eb_blk = lastp // L
    prev_end = np.concatenate(([-1], lastp[:-1]))
    has_base = (prev_end >= 0) & (prev_end // L == eb_blk)
    firstp = prev_end + 1
    spanning = (firstp // L) < eb_blk
    q = np.full(B, -1, np.int64)
    np.maximum.at(q, eb_blk, lastp % L)
    has_bnd = q >= 0
    q_flat = np.arange(B) * L + np.maximum(q, 0)
    return BlockSegments(
        L=L, B=B, pad=pad, n_rows=T,
        lastp=jnp.asarray(lastp.astype(np.int32)),
        base=jnp.asarray(np.where(has_base, prev_end, 0).astype(np.int32)),
        has_base=jnp.asarray(has_base),
        spanning=jnp.asarray(spanning),
        seg_node=jnp.asarray(seg_node.astype(np.int32)),
        eb_blk=jnp.asarray(eb_blk.astype(np.int32)),
        q_flat=jnp.asarray(q_flat.astype(np.int32)),
        has_bnd=jnp.asarray(has_bnd),
    )


def row_node_sums_blocked(lrc, P, C, found, blk: BlockSegments, n_nodes):
    """Traced: the blocked-cumsum twin of row_node_sums (same deltas, same
    per-segment f32 error class, no row-count-sized scatter).  Numerically it
    is NOT bit-identical to the scatter — both are f32 approximations of the
    f64 oracle and place_exact's guards budget either one; measured error vs
    f64 is ~25x SMALLER than the scatter's at bench shapes."""
    import jax
    import jax.numpy as jnp

    P = P.astype(lrc.dtype)
    C = C.astype(lrc.dtype)
    deltas = jnp.stack(row_metric_deltas(jnp, lrc, P, C, found), axis=1)
    K = deltas.shape[1]
    dp = jnp.pad(deltas, ((0, blk.pad), (0, 0)))
    cum = jnp.cumsum(dp.reshape(blk.B, blk.L, K), axis=1).reshape(-1, K)
    head = cum[blk.lastp] - jnp.where(blk.has_base[:, None], cum[blk.base],
                                      0.0)
    blk_tot = cum[blk.L - 1 :: blk.L]
    tail = blk_tot - jnp.where(blk.has_bnd[:, None], cum[blk.q_flat], 0.0)

    # inclusive segmented scan over block tails: run[b] = tail[b] + (boundary
    # in b ? 0 : run[b-1]); the carry INTO block b is then run[b-1]
    def comb(x, y):
        vx, fx = x
        vy, fy = y
        return jnp.where(fy[:, None], vy, vx + vy), fx | fy

    run, _ = jax.lax.associative_scan(comb, (tail, blk.has_bnd))
    carry = jnp.concatenate([jnp.zeros((1, K), deltas.dtype), run[:-1]])
    out_c = head + jnp.where(blk.spanning[:, None], carry[blk.eb_blk], 0.0)
    return jnp.zeros((n_nodes, K), deltas.dtype).at[blk.seg_node].set(
        out_c, unique_indices=True)


class CscIndex:
    """Static per-index CSC structure: index rows grouped by unique hash id.

    The full row stream has T ~ millions of rows, but a single query's read
    seed table only FINDS a few thousand distinct hashes — and every
    query-dependent metric delta is zero on rows whose hash is not found
    (row_metric_deltas: ``active`` and ``presence_delta`` both carry the
    ``found`` factor).  Grouping rows by hash id lets the device expand and
    score ONLY the found rows (typically 100-1000x fewer than T), replacing
    the reference's full-SoA stream (src/placement.cpp:242-345) with work
    proportional to the query's hit set.  The one query-independent
    accumulator (column 0, the genome-magnitude^2 deltas) is precomputed per
    node in f64 on the host (``mag_static``).
    """

    __slots__ = ("off", "P", "C", "node", "mag_static", "mag_prefix",
                 "off_np", "n_rows")

    def __init__(self, **kw):
        self.mag_prefix = None
        for k, v in kw.items():
            setattr(self, k, v)


def make_csc_index(row_id, P, C, row_node, n_unique, n_nodes,
                   parent_index=None):
    """Host: build the CscIndex from the CSR-by-node row tensors.

    ``off`` has n_unique + 2 entries so a sentinel uid of ``n_unique`` (used
    to pad query tables) dereferences to an empty range.  With
    ``parent_index`` (DFS preorder) the ancestor-accumulated magnitude
    prefix is precomputed in f64 (it is query-independent)."""
    import numpy as np
    import jax.numpy as jnp

    order = np.argsort(row_id, kind="stable")
    counts = np.bincount(row_id, minlength=n_unique + 1)
    off = np.zeros(n_unique + 2, np.int32)
    np.cumsum(counts, out=off[1 : n_unique + 2])
    lp = np.log1p(P.astype(np.float64))
    lc = np.log1p(C.astype(np.float64))
    mag = np.zeros(n_nodes, np.float64)
    np.add.at(mag, row_node, lc * lc - lp * lp)
    mag_prefix = None
    if parent_index is not None:
        mp = mag.copy()
        par = np.asarray(parent_index, dtype=np.int64)
        for i in range(1, n_nodes):
            mp[i] += mp[par[i]]
        mag_prefix = jnp.asarray(mp.astype(np.float32))
    return CscIndex(
        off=jnp.asarray(off),
        P=jnp.asarray(P[order].astype(np.int16)),
        C=jnp.asarray(C[order].astype(np.int16)),
        node=jnp.asarray(row_node[order].astype(np.int32)),
        mag_static=jnp.asarray(mag.astype(np.float32)),
        mag_prefix=mag_prefix,
        off_np=off,
        n_rows=len(row_id),
    )


def query_found_rows(csc: CscIndex, uids):
    """Host: number of index rows the query's found uid set touches (decides
    the RCAP bucket / dense fallback before any device dispatch)."""
    import numpy as np

    if len(uids) == 0:
        return 0
    u = np.asarray(uids, dtype=np.int64)
    return int(np.sum(csc.off_np[u + 1].astype(np.int64)
                      - csc.off_np[u].astype(np.int64)))


def expand_query(q_uids, q_logc, csc: CscIndex, rcap):
    """Traced: expand the compact sorted found-uid table into per-row
    (rowpos, lrc, valid) over the query's found index rows.

    Expansion is scatter+cummax segment assignment (no searchsorted): each
    non-empty query segment stamps its id at its start slot, a running max
    assigns every expanded position to its segment, and the row position is
    the segment's CSC offset plus the position's rank within the segment.
    All expanded row positions are ascending (sorted gather)."""
    import jax
    import jax.numpy as jnp

    fcap = q_uids.shape[0]
    qo = csc.off[q_uids]
    ql = csc.off[q_uids + 1] - qo
    starts = jnp.cumsum(ql) - ql
    F = starts[-1] + ql[-1]
    sid = jnp.arange(fcap, dtype=jnp.int32)
    mark = jnp.zeros(rcap, jnp.int32).at[
        jnp.where(ql > 0, starts, rcap)].max(sid + 1, mode="drop")
    seg = jax.lax.cummax(mark) - 1
    pos = jnp.arange(rcap, dtype=jnp.int32)
    valid = (pos < F) & (seg >= 0)
    segc = jnp.maximum(seg, 0)
    rowpos = jnp.where(valid, qo[segc] + (pos - starts[segc]), 0)
    lrc = jnp.where(valid, q_logc[segc], 0.0)
    return rowpos, lrc, valid


def sparse_prefix_acc(q_uids, q_logc, csc: CscIndex, euler_in, euler_out,
                      n_nodes, rcap):
    """Traced: euler-PREFIXED accumulator [N,6] from the sparse found rows
    only — the production single-device scoring body.

    Unlike row_node_sums_sparse + euler_prefix, the expanded rows' deltas
    scatter DIRECTLY into Euler-tour slots (+ at the row's node subtree
    entry, - past its exit): two rcap-sized scatters instead of two
    N-row slot scatters, which dominate the small-query step.  The
    query-independent magnitude column uses the per-index precomputed
    prefix (csc.mag_prefix)."""
    import jax.numpy as jnp

    rowpos, lrc, valid = expand_query(q_uids, q_logc, csc, rcap)
    P = csc.P[rowpos].astype(lrc.dtype)
    C = csc.C[rowpos].astype(lrc.dtype)
    node = csc.node[rowpos]
    deltas = row_metric_deltas(jnp, lrc, P, C, valid)
    d5 = jnp.stack(deltas[1:], axis=1)  # invalid rows carry all-zero deltas
    dump = 2 * n_nodes + 1
    slot_in = jnp.where(valid, euler_in[node], dump)
    slot_out = jnp.where(valid, euler_out[node] + 1, dump)
    slots = jnp.zeros((2 * n_nodes + 2, 5), lrc.dtype)
    slots = slots.at[slot_in].add(d5, mode="drop")
    slots = slots.at[slot_out].add(-d5, mode="drop")
    pref = jnp.cumsum(slots, axis=0)
    acc5 = pref[euler_in]  # [N,5] sorted gather (euler_in ascending)
    return jnp.concatenate([csc.mag_prefix[:, None], acc5], axis=1)


def row_node_sums_sparse(q_uids, q_logc, csc: CscIndex, n_nodes, rcap):
    """Traced: per-node accumulator [N,6] touching only the query's found
    rows.

    q_uids  i32[FCAP]  sorted found uid ids, padded with the sentinel
                       n_unique (whose CSC range is empty)
    q_logc  f32[FCAP]  log1p counts, 0 on padding
    rcap    static     expanded-row capacity; caller guarantees the true
                       found-row count F <= rcap (query_found_rows)

    Expansion via expand_query; column 0 is the precomputed static magnitude
    accumulator.
    """
    import jax.numpy as jnp

    rowpos, lrc, valid = expand_query(q_uids, q_logc, csc, rcap)
    P = csc.P[rowpos].astype(lrc.dtype)
    C = csc.C[rowpos].astype(lrc.dtype)
    node = jnp.where(valid, csc.node[rowpos], 0)
    deltas = row_metric_deltas(jnp, lrc, P, C, valid)
    d5 = jnp.stack(deltas[1:], axis=1)  # invalid rows carry all-zero deltas
    acc5 = jnp.zeros((n_nodes, 5), lrc.dtype).at[node].add(d5)
    return jnp.concatenate([csc.mag_static[:, None], acc5], axis=1)


def row_weight_coefs(xp, P, C):
    """Per-row query-independent metric weight coefficients.  Every
    query-dependent delta in row_metric_deltas factors as
    ``w(P, C) * lrc`` or ``w(P, C) * found`` — computing the w's once lets
    a batched scorer share the transcendentals across queries.

    Returns (w_raw, w_cos, w_pres): lograw/wc weight, logcos weight,
    presence weight (logcont = presence * lrc)."""
    one = P.dtype.type(1.0) if hasattr(P.dtype, "type") else 1.0
    log_child = xp.where(C > 0, xp.log1p(C), 0.0)
    log_parent = xp.where(P > 0, xp.log1p(P), 0.0)
    changed = (C - P) != 0
    c_coef = xp.where(C > 0, 1.0 / xp.maximum(C, one), 0.0)
    p_coef = xp.where(P > 0, 1.0 / xp.maximum(P, one), 0.0)
    w_raw = xp.where(changed, c_coef - p_coef, 0.0)
    w_cos = xp.where(changed, log_child - log_parent, 0.0)
    became_present = ((P == 0) & (C != 0)).astype(w_raw.dtype)
    became_absent = ((C == 0) & (P != 0)).astype(w_raw.dtype)
    w_pres = xp.where(changed, became_present - became_absent, 0.0)
    return w_raw, w_cos, w_pres


def batched_prefix_acc(tab, row_id, P, C, blk: BlockSegments, euler_in,
                       euler_out, n_nodes, mag_prefix):
    """Traced: euler-prefixed accumulator [N, B, 6] for B queries in ONE
    row-stream pass.

    tab [NU, B]: per-query dense uid->log1p(count) tables (0 = not found).
    The row gather's cost is per ROW (payload up to ~8 f32 rides free on
    this chip), so B queries share one gather, one set of per-row weight
    coefficients, one blocked per-node reduction and one Euler prefix —
    per-query cost drops ~B-fold vs the single-query program.  Same f32
    error class as row_node_sums_blocked (per-segment block-local sums)."""
    import jax
    import jax.numpy as jnp

    T = row_id.shape[0]
    B = tab.shape[1]
    Pf = P.astype(jnp.float32)
    Cf = C.astype(jnp.float32)
    w_raw, w_cos, w_pres = row_weight_coefs(jnp, Pf, Cf)
    lrc = tab[row_id]  # [T, B]
    ff = (lrc > 0).astype(jnp.float32)
    d = jnp.stack([
        w_raw[:, None] * lrc,        # lograw numerator
        w_cos[:, None] * lrc,        # logcos numerator
        w_raw[:, None] * ff,         # weightedContainment numerator
        w_pres[:, None] * lrc,       # logcont numerator
        w_pres[:, None] * ff,        # presence (containment numerator)
    ], axis=2).reshape(T, 5 * B)
    K = 5 * B
    dp = jnp.pad(d, ((0, blk.pad), (0, 0)))
    cum = jnp.cumsum(dp.reshape(blk.B, blk.L, K), axis=1).reshape(-1, K)
    head = cum[blk.lastp] - jnp.where(blk.has_base[:, None], cum[blk.base],
                                      0.0)
    blk_tot = cum[blk.L - 1 :: blk.L]
    tail = blk_tot - jnp.where(blk.has_bnd[:, None], cum[blk.q_flat], 0.0)

    def comb(x, y):
        vx, fx = x
        vy, fy = y
        return jnp.where(fy[:, None], vy, vx + vy), fx | fy

    run, _ = jax.lax.associative_scan(comb, (tail, blk.has_bnd))
    carry = jnp.concatenate([jnp.zeros((1, K), jnp.float32), run[:-1]])
    out_c = head + jnp.where(blk.spanning[:, None], carry[blk.eb_blk], 0.0)
    ns = jnp.zeros((n_nodes, K), jnp.float32).at[blk.seg_node].set(
        out_c, unique_indices=True)
    slots = jnp.zeros((2 * n_nodes + 1, K), jnp.float32)
    slots = slots.at[euler_in].add(ns)
    slots = slots.at[euler_out + 1].add(-ns)
    pref = jnp.cumsum(slots, axis=0)
    acc5 = pref[euler_in].reshape(n_nodes, B, 5)
    mag = jnp.broadcast_to(mag_prefix[:, None, None], (n_nodes, B, 1))
    return jnp.concatenate([mag, acc5], axis=2)


def euler_prefix(node_sums, euler_in, euler_out, n_nodes):
    """Traced: ancestor accumulation down the DFS as an Euler-tour signed
    prefix sum (+delta at subtree entry, -delta past exit, one cumsum over
    2N+1 slots) — the parallel-scan replacement for the reference's BFS."""
    import jax.numpy as jnp

    slots = jnp.zeros((2 * n_nodes + 1, node_sums.shape[1]),
                      dtype=node_sums.dtype)
    slots = slots.at[euler_in].add(node_sums)
    slots = slots.at[euler_out + 1].add(-node_sums)
    pref = jnp.cumsum(slots, axis=0)
    return pref[euler_in]


def finalize_scores_batch(xp, acc, log_mag, read_unique, logcont_den,
                          wc_den):
    """Batched finalize: acc [N, B, 6] + per-query stats [B] -> [N, B, 5]
    in METRICS order.  Same guard structure as finalize_scores."""
    gmsq, lograw, logcos, wc_num, logcont, presence = (
        acc[..., i] for i in range(N_ACC))
    lm = log_mag[None, :]
    ru = read_unique[None, :]
    ld = logcont_den[None, :]
    wd = wc_den[None, :]
    z = xp.zeros_like(lograw)
    ok_mag = lm > 0
    s0 = xp.where(ok_mag, lograw / xp.where(ok_mag, lm, 1.0), z)
    gm = xp.sqrt(xp.maximum(gmsq, 0.0))
    den = lm * gm
    s1 = xp.clip(xp.where(den > 0, logcos / xp.where(den > 0, den, 1.0), z),
                 0.0, 1.0)
    s2 = xp.where(ru > 0, presence / xp.where(ru > 0, ru, 1), z)
    s3 = xp.where(wd > 0, wc_num / xp.where(wd > 0, wd, 1.0), z)
    s4 = xp.where(ld > 0, logcont / xp.where(ld > 0, ld, 1.0), z)
    return xp.stack([s0, s1, s2, s3, s4], axis=2)


def finalize_scores(xp, acc, log_mag, read_unique, logcont_den, wc_den):
    """Accumulator [N,6] -> scores [N,5] in METRICS order (the NodeMetrics
    getters, src/placement.hpp:120-149).  Division guards via where-on-both-
    sides so the same body runs as numpy f64 (scalar stats) and traced f32
    (0-d array stats)."""
    gmsq, lograw, logcos, wc_num, logcont, presence = (
        acc[:, i] for i in range(N_ACC))
    z = xp.zeros_like(lograw)
    ok_mag = log_mag > 0
    s0 = xp.where(ok_mag, lograw / xp.where(ok_mag, log_mag, 1.0), z)
    gm = xp.sqrt(xp.maximum(gmsq, 0.0))
    den = log_mag * gm
    s1 = xp.clip(xp.where(den > 0, logcos / xp.where(den > 0, den, 1.0), z),
                 0.0, 1.0)
    s2 = xp.where(read_unique > 0,
                  presence / xp.where(read_unique > 0, read_unique, 1), z)
    s3 = xp.where(wc_den > 0, wc_num / xp.where(wc_den > 0, wc_den, 1.0), z)
    s4 = xp.where(logcont_den > 0,
                  logcont / xp.where(logcont_den > 0, logcont_den, 1.0), z)
    return xp.stack([s0, s1, s2, s3, s4], axis=1)
