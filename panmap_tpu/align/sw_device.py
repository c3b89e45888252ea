"""Batched banded affine-gap Smith-Waterman scoring as one XLA program.

The full-window DP of the short-read aligner (the ksw2 extension analog,
src/3rdparty/minimap2/ksw2_extz2_sse.c driven by src/mm_align.c:148-199),
scored for a whole batch of (query, window) pairs at once:

 - a ``lax.scan`` over query rows carries the H and F rows and the running
   best (score, query end, window end) for every pair; each row update is a
   [B, LW] elementwise program across the pairs and window columns;
 - the left-gap state E, a sequential scan in ksw2, is a running max along
   the row (``lax.cummax``): a gap re-opened from a gap-derived cell never
   wins under affine costs, so E[j] = max_{j' < j} (base[j'] + j' e) - o -
   (j - 1) e;
 - scores and best (i, j) with query-end bonuses equal
   align/core.py::banded_affine_dp exactly (integer math, first-row and
   first-column tie order included), so the host reruns that DP for the
   CIGAR only on the windows that clear MIN_DP_MAX.

Shapes are static: Q [B, LQ] (2-bit codes, 4 = pad), R [B, LW]; the caller
draws B, LQ and LW from a small set of tiers so the set of compiled programs
stays small.  Scoring constants are the sr preset (align/core.py:31-45).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .core import END_BONUS, GAP_EXT, GAP_OPEN, MATCH, MISMATCH

NEG = -(1 << 28)


def banded_sw_scores(q_batch, r_batch, qlens):
    """q_batch [B, LQ] codes, r_batch [B, LW], qlens [B].  Dispatches the
    device program and returns its [B, 3] i32 result (score incl. end
    bonuses, query end, window end) without waiting for it."""
    return _sw_scan(jnp.asarray(np.asarray(q_batch, np.int8)),
                    jnp.asarray(np.asarray(r_batch, np.int8)),
                    jnp.asarray(np.asarray(qlens, np.int32)))


@jax.jit
def _sw_scan(q8, r8, qlens):
    with jax.named_scope("sw_score"):
        B, LQ = q8.shape
        LW = r8.shape[1]
        r = r8.astype(jnp.int32)
        gap_pen = jnp.arange(LW, dtype=jnp.int32) * GAP_EXT
        ext_off = jnp.maximum(gap_pen - GAP_EXT, 0)
        neg_col = jnp.full((B, 1), NEG, jnp.int32)

        def row(carry, xs):
            h_prev, f_prev, bs, bi, bj = carry
            i, qc = xs
            qc = qc.astype(jnp.int32)[:, None]
            sub = jnp.where((r == qc) & (qc < 4), MATCH, -MISMATCH)
            f_row = jnp.maximum(h_prev - GAP_OPEN, f_prev - GAP_EXT)
            # column 0 of the numpy DP: END_BONUS on row 0, the local floor 0
            # below it
            first = jnp.full((B, 1), jnp.where(i == 0, END_BONUS, 0),
                             jnp.int32)
            diag = jnp.concatenate([first, h_prev[:, :-1]], axis=1) + sub
            base = jnp.maximum(jnp.maximum(diag, f_row), 0)
            pm = jax.lax.cummax(base + gap_pen, axis=1)
            e_row = (jnp.concatenate([neg_col, pm[:, :-1]], axis=1)
                     - GAP_OPEN - ext_off)
            h_row = jnp.maximum(base, e_row)
            row_best = (jnp.max(h_row, axis=1)
                        + jnp.where(i == qlens - 1, END_BONUS, 0))
            jrow = jnp.argmax(h_row, axis=1).astype(jnp.int32)
            better = (i < qlens) & (row_best > bs)
            carry = (h_row, f_row, jnp.where(better, row_best, bs),
                     jnp.where(better, i + 1, bi),
                     jnp.where(better, jrow + 1, bj))
            return carry, None

        zeros = jnp.zeros(B, jnp.int32)
        init = (jnp.full((B, LW), END_BONUS, jnp.int32),
                jnp.full((B, LW), NEG, jnp.int32), zeros, zeros, zeros)
        (_, _, bs, bi, bj), _ = jax.lax.scan(
            row, init, (jnp.arange(LQ, dtype=jnp.int32), q8.T))
        return jnp.stack([bs, bi, bj], axis=1)
