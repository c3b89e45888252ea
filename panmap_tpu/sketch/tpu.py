"""Batched syncmer/k-min-mer sketching on the device (JAX).

The same algebra as sketch/cpu.py, expressed over [B, L] read batches with the
64-bit hash state carried as two uint32 lanes (x64 is off, so the (hi, lo)
pair form keeps every op in 32-bit lanes).  All control flow is static:
fixed read length L (reads are padded with code 4), fixed k/s/t, unrolled
rotate-XOR reductions, and an unrolled lexicographic sliding-window min over
the k-s+1 s-mers of each k-mer window.

Positions beyond a read's true length are masked off via the `lengths` input.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from .cpu import CHASH, CHASH_COMP

U32 = jnp.uint32

# per-2bit-code hash constants, split into (hi, lo) u32 (index 4 = N/pad -> 0)
_CODE2CHAR = np.frombuffer(b"ACGT", dtype=np.uint8)
_H64 = np.zeros(5, dtype=np.uint64)
_H64[:4] = CHASH[_CODE2CHAR]
_HC64 = np.zeros(5, dtype=np.uint64)
_HC64[:4] = CHASH_COMP[_CODE2CHAR]
# numpy (NOT device arrays): device-array closure constants are fetched back
# to the host during every jit lowering (mlir ir_constant); host constants
# embed for free
H_HI = (_H64 >> 32).astype(np.uint32)
H_LO = (_H64 & 0xFFFFFFFF).astype(np.uint32)
HC_HI = (_HC64 >> 32).astype(np.uint32)
HC_LO = (_HC64 & 0xFFFFFFFF).astype(np.uint32)


def rol_pair(hi, lo, r: int):
    r &= 63
    if r == 0:
        return hi, lo
    if r < 32:
        nhi = (hi << np.uint32(r)) | (lo >> np.uint32(32 - r))
        nlo = (lo << np.uint32(r)) | (hi >> np.uint32(32 - r))
        return nhi, nlo
    if r == 32:
        return lo, hi
    r -= 32
    nhi = (lo << np.uint32(r)) | (hi >> np.uint32(32 - r))
    nlo = (hi << np.uint32(r)) | (lo >> np.uint32(32 - r))
    return nhi, nlo


def _lex_lt(ahi, alo, bhi, blo):
    return (ahi < bhi) | ((ahi == bhi) & (alo < blo))


def _lex_min(ahi, alo, bhi, blo):
    take_a = _lex_lt(ahi, alo, bhi, blo)
    return jnp.where(take_a, ahi, bhi), jnp.where(take_a, alo, blo)


def _window_hash_pair(hc_hi, hc_lo, h_hi, h_lo, w: int, m: int):
    """(F_hi, F_lo, R_hi, R_lo) for every length-w window of a [B, L] batch."""
    Fh = jnp.zeros_like(h_hi[:, :m])
    Fl = jnp.zeros_like(h_lo[:, :m])
    Rh = jnp.zeros_like(h_hi[:, :m])
    Rl = jnp.zeros_like(h_lo[:, :m])
    for i in range(w):
        rhi, rlo = rol_pair(h_hi[:, i : i + m], h_lo[:, i : i + m], w - 1 - i)
        Fh = Fh ^ rhi
        Fl = Fl ^ rlo
        rhi, rlo = rol_pair(hc_hi[:, i : i + m], hc_lo[:, i : i + m], i)
        Rh = Rh ^ rhi
        Rl = Rl ^ rlo
    return Fh, Fl, Rh, Rl


def syncmer_scan_batch(reads, lengths, k: int, s: int, t: int, open_: bool):
    """reads: [B, L] uint8 2-bit codes (4 = N/pad); lengths: [B].

    Returns (hash_hi u32[B,M], hash_lo u32[B,M], is_sync bool[B,M]) with
    M = L-k+1; non-syncmer positions carry all-ones hashes.
    """
    B, L = reads.shape
    m = L - k + 1
    h_hi = jnp.asarray(H_HI)[reads]
    h_lo = jnp.asarray(H_LO)[reads]
    hc_hi = jnp.asarray(HC_HI)[reads]
    hc_lo = jnp.asarray(HC_LO)[reads]

    Fkh, Fkl, Rkh, Rkl = _window_hash_pair(hc_hi, hc_lo, h_hi, h_lo, k, m)
    ms = L - s + 1
    Fsh, Fsl, Rsh, Rsl = _window_hash_pair(hc_hi, hc_lo, h_hi, h_lo, s, ms)

    w = k - s + 1
    Fmh, Fml = Fsh[:, :m], Fsl[:, :m]
    Rmh, Rml = Rsh[:, :m], Rsl[:, :m]
    for j in range(1, w):
        Fmh, Fml = _lex_min(Fmh, Fml, Fsh[:, j : j + m], Fsl[:, j : j + m])
        Rmh, Rml = _lex_min(Rmh, Rml, Rsh[:, j : j + m], Rsl[:, j : j + m])

    def eq(ahi, alo, bhi, blo):
        return (ahi == bhi) & (alo == blo)

    if open_:
        fwd_sync = eq(Fsh[:, t : t + m], Fsl[:, t : t + m], Fmh, Fml)
        rev_sync = eq(Rsh[:, k - s - t : k - s - t + m],
                      Rsl[:, k - s - t : k - s - t + m], Rmh, Rml)
    else:
        fwd_sync = eq(Fsh[:, t : t + m], Fsl[:, t : t + m], Fmh, Fml) | eq(
            Fsh[:, k - s - t : k - s - t + m], Fsl[:, k - s - t : k - s - t + m],
            Fmh, Fml)
        rev_sync = eq(Rsh[:, k - s - t : k - s - t + m],
                      Rsl[:, k - s - t : k - s - t + m], Rmh, Rml) | eq(
            Rsh[:, t : t + m], Rsl[:, t : t + m], Rmh, Rml)

    # ambiguous-base windows + windows off the read end
    bad = (reads >= 4).astype(jnp.int32)
    cb = jnp.cumsum(bad, axis=1)
    amb = (cb[:, k - 1 :] - jnp.pad(cb, ((0, 0), (1, 0)))[:, : m]) > 0
    in_read = (jnp.arange(m)[None, :] + k) <= lengths[:, None]

    palin = eq(Fkh, Fkl, Rkh, Rkl)
    is_sync = (fwd_sync | rev_sync) & ~amb & ~palin & in_read

    take_rev = _lex_lt(Rkh, Rkl, Fkh, Fkl)
    hash_hi = jnp.where(take_rev, Rkh, Fkh)
    hash_lo = jnp.where(take_rev, Rkl, Fkl)
    ones = jnp.uint32(0xFFFFFFFF)
    hash_hi = jnp.where(is_sync, hash_hi, ones)
    hash_lo = jnp.where(is_sync, hash_lo, ones)
    return hash_hi, hash_lo, is_sync


def kminmer_batch(hash_hi, hash_lo, is_sync, k: int, l: int, max_seeds: int = 64):
    """Per-read k-min-mers from the dense scan output.

    Compacts each row's syncmers to the left (fixed max_seeds slots), then the
    unrolled l-window rotate-XOR combine; returns (km_hi, km_lo, valid)
    [B, max_seeds].  Palindromes and incomplete windows are invalid.
    """
    B, M = hash_hi.shape
    # left-compaction: one stable payload sort on (!is_sync, position) keys
    # instead of argsort + three take_along_axis gathers
    iota = jnp.arange(M, dtype=jnp.int32)[None, :]
    keyp = jnp.broadcast_to(jnp.where(is_sync, iota, M + iota), hash_hi.shape)
    _, gh, gl, gvalid = jax.lax.sort(
        (keyp, hash_hi, hash_lo, is_sync), dimension=1, num_keys=1)
    gh = gh[:, :max_seeds]
    gl = gl[:, :max_seeds]
    gvalid = gvalid[:, :max_seeds]
    count = jnp.sum(is_sync, axis=1)

    if l == 1:
        return gh, gl, gvalid
    c = max_seeds - l + 1
    Fh = jnp.zeros((B, c), dtype=U32)
    Fl = jnp.zeros((B, c), dtype=U32)
    Rh = jnp.zeros((B, c), dtype=U32)
    Rl = jnp.zeros((B, c), dtype=U32)
    for wdx in range(l):
        rhi, rlo = rol_pair(gh[:, wdx : wdx + c], gl[:, wdx : wdx + c],
                            (k * (l - 1 - wdx)) % 64)
        Fh, Fl = Fh ^ rhi, Fl ^ rlo
        rhi, rlo = rol_pair(gh[:, l - 1 - wdx : l - 1 - wdx + c],
                            gl[:, l - 1 - wdx : l - 1 - wdx + c],
                            (k * (l - 1 - wdx)) % 64)
        Rh, Rl = Rh ^ rhi, Rl ^ rlo
    palin = (Fh == Rh) & (Fl == Rl)
    take_rev = _lex_lt(Rh, Rl, Fh, Fl)
    kh = jnp.where(take_rev, Rh, Fh)
    kl = jnp.where(take_rev, Rl, Fl)
    valid = (jnp.arange(c)[None, :] + l) <= count[:, None]
    valid = valid & ~palin
    ones = jnp.uint32(0xFFFFFFFF)
    return (jnp.where(valid, kh, ones), jnp.where(valid, kl, ones), valid)


def pack_reads_2bit(codes: np.ndarray):
    """[B, L] u8 codes (0..3, 4=N/pad) -> ([B, L/4] u8 packed, [B, L/8] u8
    N-bitmask).  L must be a multiple of 8; cuts the host->device transfer
    ~2.7x."""
    B, L = codes.shape
    assert L % 8 == 0
    two = (codes & 3).reshape(B, L // 4, 4).astype(np.uint16)
    packed = (two[:, :, 0] | (two[:, :, 1] << 2) | (two[:, :, 2] << 4)
              | (two[:, :, 3] << 6)).astype(np.uint8)
    isn = (codes >= 4).reshape(B, L // 8, 8)
    nmask = np.zeros((B, L // 8), dtype=np.uint8)
    for b in range(8):
        nmask |= (isn[:, :, b] << b).astype(np.uint8)
    return packed, nmask


def unpack_reads_2bit(packed, nmask, L: int):
    """Device-side inverse of pack_reads_2bit -> [B, L] uint8 codes (4=N).

    Gather-free: four shifted copies stacked along a new minor axis then
    reshaped back to [B, L] (position 4*i+j comes from byte i, shift 2*j)."""
    B = packed.shape[0]
    p = packed.astype(jnp.int32)
    code = jnp.stack([p & 3, (p >> 2) & 3, (p >> 4) & 3, (p >> 6) & 3],
                     axis=2).reshape(B, L)
    m = nmask.astype(jnp.int32)
    is_n = jnp.stack([(m >> b) & 1 for b in range(8)], axis=2).reshape(B, L)
    return jnp.where(is_n == 1, 4, code).astype(jnp.uint8)


def kminmer_batch_full(hash_hi, hash_lo, is_sync, k: int, l: int,
                       max_seeds: int = 64):
    """kminmer_batch plus orientation and read coordinates:
    returns (km_hi, km_lo, valid, is_rev, qbeg, qend) — qbeg is the first
    member syncmer's base offset, qend the last member's offset + k - 1
    (the meta seedmersList layout; l must be >= 2 here)."""
    B, M = hash_hi.shape
    keyp = jnp.where(is_sync, jnp.arange(M)[None, :], M + jnp.arange(M)[None, :])
    order = jnp.argsort(keyp, axis=1)[:, :max_seeds]
    gh = jnp.take_along_axis(hash_hi, order, axis=1)
    gl = jnp.take_along_axis(hash_lo, order, axis=1)
    count = jnp.sum(is_sync, axis=1)
    pos = order.astype(jnp.int32)  # compacted syncmer base offsets

    c = max_seeds - l + 1
    Fh = jnp.zeros((B, c), dtype=U32)
    Fl = jnp.zeros((B, c), dtype=U32)
    Rh = jnp.zeros((B, c), dtype=U32)
    Rl = jnp.zeros((B, c), dtype=U32)
    for wdx in range(l):
        rhi, rlo = rol_pair(gh[:, wdx : wdx + c], gl[:, wdx : wdx + c],
                            (k * (l - 1 - wdx)) % 64)
        Fh, Fl = Fh ^ rhi, Fl ^ rlo
        rhi, rlo = rol_pair(gh[:, l - 1 - wdx : l - 1 - wdx + c],
                            gl[:, l - 1 - wdx : l - 1 - wdx + c],
                            (k * (l - 1 - wdx)) % 64)
        Rh, Rl = Rh ^ rhi, Rl ^ rlo
    palin = (Fh == Rh) & (Fl == Rl)
    take_rev = _lex_lt(Rh, Rl, Fh, Fl)
    kh = jnp.where(take_rev, Rh, Fh)
    kl = jnp.where(take_rev, Rl, Fl)
    valid = (jnp.arange(c)[None, :] + l) <= count[:, None]
    valid = valid & ~palin
    ones = jnp.uint32(0xFFFFFFFF)
    qbeg = jnp.where(valid, pos[:, :c], 0)
    qend = jnp.where(valid, pos[:, l - 1 : l - 1 + c] + (k - 1), 0)
    return (jnp.where(valid, kh, ones), jnp.where(valid, kl, ones), valid,
            valid & take_rev, qbeg, qend)


def encode_reads_batch(seqs: list, pad_to: int | None = None):
    """Host: list of read strings -> ([B, L] u8 codes, lengths i32).
    Vectorized: one joined buffer + a single gather."""
    from ..align.core import _ENC

    L = pad_to or max((len(s) for s in seqs), default=1)
    try:  # native twin (panmap_tpu/native): bit-exact, avoids the B*L gather
        from ..native import encode_reads_native

        out = encode_reads_native(seqs, L)
        if out is not None:
            return out
    except ImportError:  # pragma: no cover
        pass
    B = len(seqs)
    lens = np.fromiter((min(len(s), L) for s in seqs), dtype=np.int32, count=B)
    joined = np.frombuffer("".join(seqs).encode(), dtype=np.uint8)
    full_lens = np.fromiter((len(s) for s in seqs), dtype=np.int64, count=B)
    starts = np.concatenate(([0], np.cumsum(full_lens)[:-1]))
    pos = starts[:, None] + np.arange(L)[None, :]
    valid = np.arange(L)[None, :] < lens[:, None]
    out = np.where(valid, _ENC[joined[np.minimum(pos, len(joined) - 1)]], 4).astype(np.uint8)
    return out, lens
