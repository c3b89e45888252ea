"""Batched shifted-band dual-affine DP for long reads as one XLA program.

The long-read extension stage (map-ont / map-hifi; reference equivalent:
src/mm_align.c:48-118 routing into 3rdparty/minimap2/ksw2_extz2_sse.c):

 - band coordinates: DP row i covers ref positions [dlo+i, dhi+i]; storage
   and compute are lq x band (W) instead of lq x ref_len, so ONT-length
   reads stay small.  Each row gathers its reference window from the one
   reference array on the device;
 - dual affine gap tiers (minimap2 -O q,q2 -E e,e2): two insertion lanes
   carried across rows by a ``lax.scan`` plus two in-row running maxima for
   the deletion tiers (the gap-reopened-from-gap-never-wins identity, one
   running max per tier);
 - the program emits a per-cell DIRECTION byte (H source + per-lane gap
   extension flags) and per-row (max, argmax); the host replays the ksw2
   z-drop rule over the row stats to pick the stop cell and walks the
   direction bytes for the CIGAR: O(path) host work instead of the O(lq*W)
   DP.  The result equals align/longread.py::banded_dp_shifted exactly.

Direction byte: bits 0-2 = H source in the host traceback's priority order
(0 stop/zero, 1 diag, 2 E, 3 E2, 4 F, 5 F2); bit 3/4 = E/E2 run continues
left; bit 5/6 = F/F2 run continues up.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

NEG = -(1 << 28)
# compiled shapes: LQ rounds up to a multiple of ROW_STEP, W to a multiple of
# COL_STEP, the batch to a power of two up to MAX_BATCH reads
ROW_STEP = 512
COL_STEP = 128
MAX_BATCH = 32
# reads whose direction matrix would exceed this many cells run the host DP
MAX_ITEM_CELLS = 32 << 20


def _shift_left(x, fill):
    return jnp.concatenate(
        [x[:, 1:], jnp.full((x.shape[0], 1), fill, x.dtype)], axis=1)


def _shift_right(x, fill):
    return jnp.concatenate(
        [jnp.full((x.shape[0], 1), fill, x.dtype), x[:, :-1]], axis=1)


@functools.partial(jax.jit,
                   static_argnames=("W", "A", "B", "GO", "GE", "GO2", "GE2"))
def _long_scan(q8, ref8, dlo, worig, lr, W, A, B, GO, GE, GO2, GE2):
    """q8 [Bt, LQ] codes, ref8 [LR] codes, dlo/worig [Bt] i32, lr scalar.
    Returns dirs [LQ, Bt, W] i8 and row stats (max, argmax) [LQ, Bt]."""
    with jax.named_scope("long_dp"):
        Bt, LQ = q8.shape
        idx = jnp.arange(W, dtype=jnp.int32)[None, :]
        ref = ref8.astype(jnp.int32)
        nref = ref.shape[0]
        dlo = dlo[:, None]
        in_w = idx < worig[:, None]

        def row(carry, xs):
            h_prev, f_prev, f2_prev = carry
            i, qc = xs
            qc = qc.astype(jnp.int32)[:, None]
            j = idx + dlo + (i + 1)  # 1-based ref column of each band cell
            # columns past the caller's band (W is padded) stay out of band:
            # the host DP's band is exactly worig wide
            inb = (j >= 1) & (j <= lr) & in_w
            rj = jnp.where((j >= 1) & (j <= nref),
                           ref[jnp.clip(j - 1, 0, nref - 1)], 4)
            sub = jnp.where((rj == qc) & (qc < 4), A, -B)

            diag = h_prev + sub
            up = _shift_left(h_prev, NEG)
            f_row = jnp.maximum(up - GO, _shift_left(f_prev, NEG) - GE)
            f2_row = jnp.maximum(up - GO2, _shift_left(f2_prev, NEG) - GE2)
            base = jnp.maximum(jnp.maximum(diag, jnp.maximum(f_row, f2_row)),
                               0)
            base = jnp.where(inb, base, NEG)
            pm = jax.lax.cummax(base + idx * GE, axis=1)
            e_row = jnp.where(idx >= 1,
                              _shift_right(pm, NEG) - GO - (idx - 1) * GE, NEG)
            pm2 = jax.lax.cummax(base + idx * GE2, axis=1)
            e2_row = jnp.where(idx >= 1,
                               _shift_right(pm2, NEG) - GO2 - (idx - 1) * GE2,
                               NEG)
            h_row = jnp.maximum(base, jnp.maximum(e_row, e2_row))
            h_row = jnp.where(inb, h_row, 0)

            src = jnp.where(
                h_row == 0, 0,
                jnp.where(h_row == diag, 1,
                          jnp.where(h_row == e_row, 2,
                                    jnp.where(h_row == e2_row, 3,
                                              jnp.where(h_row == f_row, 4,
                                                        jnp.where(
                                                            h_row == f2_row,
                                                            5, 1))))))
            e_ext = (idx > 1) & (e_row == _shift_right(e_row, NEG) - GE)
            e2_ext = (idx > 1) & (e2_row == _shift_right(e2_row, NEG) - GE2)
            f_ext = ((idx + 1 < worig[:, None]) & (i >= 1)
                     & (f_row == _shift_left(f_prev, NEG) - GE))
            f2_ext = ((idx + 1 < worig[:, None]) & (i >= 1)
                      & (f2_row == _shift_left(f2_prev, NEG) - GE2))
            byte = (src | (e_ext.astype(jnp.int32) << 3)
                    | (e2_ext.astype(jnp.int32) << 4)
                    | (f_ext.astype(jnp.int32) << 5)
                    | (f2_ext.astype(jnp.int32) << 6))
            stats = (jnp.max(h_row, axis=1),
                     jnp.argmax(h_row, axis=1).astype(jnp.int32))
            return (h_row, f_row, f2_row), (byte.astype(jnp.int8), stats)

        init = (jnp.zeros((Bt, W), jnp.int32),
                jnp.full((Bt, W), NEG, jnp.int32),
                jnp.full((Bt, W), NEG, jnp.int32))
        _, (dirs, (rmax, jarg)) = jax.lax.scan(
            row, init, (jnp.arange(LQ, dtype=jnp.int32), q8.T))
        return dirs, rmax, jarg


def _round_up(x, m):
    return -(-x // m) * m


def long_dp_device_batch(items: list, ref_codes: np.ndarray, pre):
    """items: [(q_codes, dlo, dhi)].  Runs the banded dual-affine DP rows on
    the device (direction bytes + row stats), then replays the z-drop rule
    and walks the traceback on the host.  Equal to banded_dp_shifted per
    item."""
    lr = len(ref_codes)
    out = [None] * len(items)
    buckets: dict = {}
    for n, (q, dlo, dhi) in enumerate(items):
        W = _round_up(dhi - dlo + 1, COL_STEP)
        LQ = _round_up(max(len(q), 1), ROW_STEP)
        if LQ * W > MAX_ITEM_CELLS:
            from .longread import banded_dp_shifted

            out[n] = banded_dp_shifted(q, ref_codes, dlo, dhi, pre)
            continue
        buckets.setdefault((LQ, W), []).append(n)
    if not buckets:
        return out
    ref_dev = jnp.asarray(np.asarray(ref_codes, np.int8))
    for (LQ, W), ids in buckets.items():
        for off in range(0, len(ids), MAX_BATCH):
            chunk = ids[off: off + MAX_BATCH]
            Bt = 1 << (len(chunk) - 1).bit_length()
            qb = np.full((Bt, LQ), 4, np.int8)
            dlos = np.zeros(Bt, np.int32)
            worig = np.zeros(Bt, np.int32)
            for s, n in enumerate(chunk):
                q, dlo, dhi = items[n]
                qb[s, : len(q)] = q
                dlos[s] = dlo
                worig[s] = dhi - dlo + 1
            dirs, rmax, jarg = _long_scan(
                jnp.asarray(qb), ref_dev, jnp.asarray(dlos),
                jnp.asarray(worig), np.int32(lr), W, pre.match, pre.mismatch,
                pre.gap_open, pre.gap_ext, pre.gap_open2, pre.gap_ext2)
            dirs = np.asarray(dirs)
            rmax = np.asarray(rmax)
            jarg = np.asarray(jarg)
            for s, n in enumerate(chunk):
                q, dlo, _ = items[n]
                out[n] = _finish_one(q, dlo, dirs[:, s], rmax[:, s],
                                     jarg[:, s], pre)
    return out


def _finish_one(q, dlo, dirs, rm, ja, pre):
    """Host back half: z-drop replay over row stats + direction-byte
    traceback (mirrors banded_dp_shifted's loop and state machine)."""
    lq = len(q)
    GE = pre.gap_ext
    best = (0, 0, 0)
    for i in range(1, lq + 1):
        row_max = int(rm[i - 1])
        cmax = int(ja[i - 1])
        if row_max > best[0]:
            best = (row_max, i, cmax)
        elif best[0] - row_max > pre.zdrop + GE * abs(cmax - best[2]):
            break
    score, bi, bc = best
    if score <= 0:
        return 0, 0, 0, 0, 0, []
    W = dirs.shape[1]
    i, c = bi, bc
    ops = []
    state = "H"
    while i > 0:
        j = c + dlo + i
        if j <= 0:
            break
        byte = int(dirs[i - 1, c])
        src = byte & 7
        if state == "H":
            if src == 0:
                break
            if src == 1:
                ops.append("M")
                i -= 1
            elif src == 2:
                state = "E"
            elif src == 3:
                state = "E2"
            elif src == 4:
                state = "F"
            else:
                state = "F2"
        elif state in ("E", "E2"):
            bit = 3 if state == "E" else 4
            ops.append("D")
            if not (byte >> bit) & 1:
                state = "H"
            c -= 1
        else:  # F / F2
            bit = 5 if state == "F" else 6
            ops.append("I")
            cont = (byte >> bit) & 1
            i -= 1
            c += 1
            if not cont:
                state = "H"
        if c < 0 or c >= W:
            break
    ops.reverse()
    cigar = []
    for op in ops:
        if cigar and cigar[-1][1] == op:
            cigar[-1] = (cigar[-1][0] + 1, op)
        else:
            cigar.append((1, op))
    qs = i
    rs = c + dlo + i
    qe = bi
    re_ = bc + dlo + bi
    return score, qs, qe, max(rs, 0), re_, cigar
