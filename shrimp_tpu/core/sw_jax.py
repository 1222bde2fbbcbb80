"""Batched JAX Smith-Waterman kernels (vector filter + full DP).

XLA formulations of SHRiMP2's kernels, run as they are on every
platform (core/sw_pallas.py holds the GPU's vector-SW kernel):

- `sw_vector_batch`: score-only local affine SW over [B] (window, read)
  pairs; anti-diagonal wavefront with the read dimension vectorized and a
  `lax.scan` over diagonals. Bit-equal to common/sw-vector.c:68-377
  (including its H/E/F structure where gaps may open from gap states via H).

- `sw_full_batch`: banded 3-plane global/local DP with packed 2-bit
  backpointers, row `lax.scan` with the intra-row west-chain resolved by an
  associative max-plus scan. Bit-equal scores/backpointers to
  common/sw-full-ls.c:154-403 including the `revcmpl` tie-break flip.

- `sw_full_stats`: the same banded DP with no backpointer tensor, only
  the best cell and the diagonal-chain summary the host needs to rebuild
  single-diagonal alignments (the traceback-free "stats flow").

All compile for fixed padded shapes; the mapper buckets work by shape.
"""
from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

NEG = jnp.int32(-(2 ** 30))

# packed backpointer nibbles (see traceback.py)
NW_FROM_NW, NW_FROM_N, NW_FROM_W = 1, 2, 3
N_FROM_N, N_FROM_NW = 1, 2
W_FROM_W, W_FROM_NW = 1, 2


@functools.partial(jax.jit, static_argnames=(
    "match", "mismatch", "a_gap_open", "a_gap_ext", "b_gap_open",
    "b_gap_ext", "cs_mode"))
def sw_vector_batch(genome: jnp.ndarray, glen: jnp.ndarray,
                    read: jnp.ndarray, rlen: jnp.ndarray,
                    g_row0: jnp.ndarray = None,
                    *, match: int, mismatch: int,
                    a_gap_open: int, a_gap_ext: int,
                    b_gap_open: int, b_gap_ext: int,
                    cs_mode: bool = False) -> jnp.ndarray:
    """Local affine SW scores.

    genome: [B, G] uint8 codes, glen: [B]; read: [B, R] uint8, rlen: [B].
    Colour space (cs_mode): genome holds colour codes, and the first read
    row is scored against `g_row0` = lstocs(genome letters, initbp) — the
    scalar first-row special case of sw-vector.c:108-146.
    Returns [B] int32 scores.
    """
    B, G = genome.shape
    R = read.shape[1]
    goa = jnp.int32(-(a_gap_open) + -(a_gap_ext))   # open+extend on open
    gea = jnp.int32(-(a_gap_ext))
    gob = jnp.int32(-(b_gap_open) + -(b_gap_ext))
    geb = jnp.int32(-(b_gap_ext))
    m = jnp.int32(match)
    mm = jnp.int32(mismatch)

    read_i = read.astype(jnp.int32)                       # [B, R]
    ivec = jnp.arange(R, dtype=jnp.int32)[None, :]        # [1, R]
    rmask = ivec < rlen[:, None]                          # [B, R]
    genome_i = genome.astype(jnp.int32)
    g_row0_i = g_row0.astype(jnp.int32) if cs_mode else None

    def shift1(a, fill):
        return jnp.concatenate(
            [jnp.full((B, 1), fill, a.dtype), a[:, :-1]], axis=1)

    def step(carry, d):
        # jge0 / jlt are shift-register masks for j >= 0 and j < glen:
        # the wavefront grows/retires one row per diagonal.
        h_prev, h_prev2, e_prev, f_prev, g_diag, jge0, jlt, best = carry
        # slide the genome diagonal: g_diag[i] = genome[d - i]
        g_new = shift1(g_diag, 0)
        gchar = jnp.where(d < G, genome_i[:, jnp.minimum(d, G - 1)],
                          jnp.int32(-1))
        g_diag2 = g_new.at[:, 0].set(gchar)
        jge0 = shift1(jge0, True)
        jlt = shift1(jlt, False).at[:, 0].set(d < glen)

        e_new = jnp.maximum(h_prev - goa, e_prev - gea)
        f_new = shift1(jnp.maximum(h_prev - gob, f_prev - geb), NEG)
        s = jnp.where(g_diag2 == read_i, m, mm)
        if cs_mode:
            gchar0 = jnp.where(d < G, g_row0_i[:, jnp.minimum(d, G - 1)],
                               jnp.int32(-1))
            s0 = jnp.where(gchar0 == read_i[:, 0], m, mm)
            s = s.at[:, 0].set(s0)
        h_diag = shift1(h_prev2, 0)
        h_new = jnp.maximum(jnp.maximum(0, h_diag + s),
                            jnp.maximum(e_new, f_new))
        valid = rmask & jge0 & jlt
        h_new = jnp.where(valid, h_new, 0)
        e_new = jnp.where(jge0, e_new, NEG)
        f_new = jnp.where(valid, f_new, NEG)
        best = jnp.maximum(best, jnp.max(jnp.where(valid, h_new, 0), axis=1))
        return (h_new, h_prev, e_new, f_new, g_diag2, jge0, jlt, best), None

    zeros = jnp.zeros((B, R), jnp.int32)
    negs = jnp.full((B, R), NEG, jnp.int32)
    falses = jnp.zeros((B, R), bool)
    init = (zeros, zeros, negs, negs, jnp.full((B, R), -1, jnp.int32),
            falses, falses, jnp.zeros(B, jnp.int32))
    carry, _ = jax.lax.scan(step, init,
                            jnp.arange(R + G - 1, dtype=jnp.int32))
    return carry[7]


@functools.partial(jax.jit, static_argnames=(
    "match", "mismatch", "a_gap_open", "a_gap_ext", "b_gap_open",
    "b_gap_ext", "local_alignment"))
def sw_full_batch(genome: jnp.ndarray, glen: jnp.ndarray,
                  read: jnp.ndarray, rlen: jnp.ndarray,
                  ax: jnp.ndarray, ay: jnp.ndarray,
                  alen: jnp.ndarray, awid: jnp.ndarray,
                  revcmpl: jnp.ndarray,
                  *, match: int, mismatch: int,
                  a_gap_open: int, a_gap_ext: int,
                  b_gap_open: int, b_gap_ext: int,
                  local_alignment: bool = False,
                  ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray,
                             jnp.ndarray, jnp.ndarray]:
    """Banded 3-plane DP with backpointers (sw-full-ls.c:154-403).

    ax/ay/alen/awid: the already-widened anchor rectangle per batch element.
    revcmpl: [B] bool, flips tie-break preference (-T on reverse strand).
    Returns (score [B], max_i [B], max_j [B], start_from [B] int32 in
    reference FROM_* codes, bp [B, R, G] uint8 packed backpointers).
    """
    B, G = genome.shape
    R = read.shape[1]
    # full SW charges open and extend separately (sw-full-ls.c:304,332)
    goa = jnp.int32(-(a_gap_open))
    gea = jnp.int32(-(a_gap_ext))
    gob = jnp.int32(-(b_gap_open))
    geb = jnp.int32(-(b_gap_ext))
    m = jnp.int32(match)
    mm = jnp.int32(mismatch)
    init_nw = jnp.int32(0) if local_alignment else NEG
    init_n = jnp.int32(b_gap_open) if local_alignment else NEG
    init_w = jnp.int32(a_gap_open) if local_alignment else NEG

    genome_i = genome.astype(jnp.int32)
    read_i = read.astype(jnp.int32)
    jvec = jnp.arange(G, dtype=jnp.int32)[None, :]        # [1, G]
    rv = revcmpl[:, None]

    def band(i):
        """anchor_get_x_range (anchors.c:66-95), vectorized; [B] each."""
        x_min = jnp.where(
            i < ay, 0,
            jnp.where(i <= ay + alen - 1, ax + (i - ay), ax + alen))
        x_min = jnp.clip(x_min, 0, glen - 1)
        x_max = jnp.where(
            i < ay - (awid - 1), ax + awid - 2,
            jnp.where(i <= ay - (awid - 1) + alen - 1,
                      ax + (awid - 1) + (i - (ay - (awid - 1))), glen - 1))
        x_max = jnp.clip(x_max, 0, glen - 1)
        return x_min, x_max

    BIGB = jnp.int32(2 ** 26)  # saturating "infinite" gap-extend cost

    def mp_scan(a, b):
        """Associative max-plus affine scan combine: f(w) = max(a, w - b).
        Saturate to avoid int32 wraparound on long out-of-band runs."""
        (a1, b1), (a2, b2) = a, b
        return (jnp.maximum(a2, jnp.maximum(a1 - b2, NEG)),
                jnp.minimum(b1 + b2, BIGB))

    def row(carry, i):
        nwp, np_, wp = carry   # [B, G+1]; col 0 = j=-1 boundary
        rchar = jax.lax.dynamic_slice_in_dim(read_i, i, 1, axis=1)  # [B, 1]
        s = jnp.where(genome_i == rchar, m, mm)                     # [B, G]
        # --- NW plane: from prev row at j-1 = padded col j
        c_nw, c_n, c_w = nwp[:, :-1], np_[:, :-1], wp[:, :-1]
        # normal pref nw > n > w; revcmpl pref w > n > nw (sw-full-ls.c:265-291)
        v = jnp.where(rv, c_w, c_nw)
        f = jnp.where(rv, jnp.full_like(v, NW_FROM_W),
                      jnp.full_like(v, NW_FROM_NW))
        f = jnp.where(c_n > v, NW_FROM_N, f)
        v = jnp.maximum(v, c_n)
        last = jnp.where(rv, c_nw, c_w)
        lastf = jnp.where(rv, NW_FROM_NW, NW_FROM_W)
        f = jnp.where(last > v, lastf, f)
        v = jnp.maximum(v, last)
        nw_val = v + s
        nw_from = f
        if local_alignment:
            clamp = nw_val <= 0
            nw_val = jnp.where(clamp, 0, nw_val)
            nw_from = jnp.where(clamp, 0, nw_from)

        # --- N plane: from prev row same column
        c_open = nwp[:, 1:] - gob - geb
        c_ext = np_[:, 1:] - geb
        n_val, is_ext = _pick2_b(c_open, c_ext, rv)
        n_from = jnp.where(is_ext, N_FROM_N, N_FROM_NW)
        if local_alignment:
            clamp = n_val <= 0
            n_val = jnp.where(clamp, 0, n_val)
            n_from = jnp.where(clamp, 0, n_from)

        # --- band mask for this row (applied to nw/n before the W chain)
        x_min, x_max = band(i)
        inb = (jvec >= x_min[:, None]) & (jvec <= x_max[:, None])
        nw_val = jnp.where(inb, nw_val, init_nw)
        nw_from = jnp.where(inb, nw_from, 0)
        n_val = jnp.where(inb, n_val, init_n)
        n_from = jnp.where(inb, n_from, 0)

        # --- W plane: intra-row chain via associative max-plus scan
        # W(j) = max(NW(j-1) - goa, W(j-1) - gea); out-of-band resets to
        # init_w (constant function). Boundary W(-1) = init_w.
        nw_shift = jnp.concatenate(
            [jnp.full((B, 1), init_nw, jnp.int32), nw_val[:, :-1]], axis=1)
        a_elem = nw_shift - goa - gea
        if local_alignment:
            a_elem = jnp.maximum(a_elem, 0)
        b_elem = jnp.full_like(a_elem, gea)
        a_elem = jnp.where(inb, a_elem, init_w)
        b_elem = jnp.where(inb, b_elem, BIGB)
        # incorporate boundary: prepend the constant init_w element
        a0 = jnp.full((B, 1), init_w, jnp.int32)
        b0 = jnp.full((B, 1), BIGB, jnp.int32)
        aa = jnp.concatenate([a0, a_elem], axis=1)
        bb = jnp.concatenate([b0, b_elem], axis=1)
        acc_a, _ = jax.lax.associative_scan(mp_scan, (aa, bb), axis=1)
        w_val = acc_a[:, 1:]
        w_prev_val = acc_a[:, :-1]
        # recompute backpointers from resolved chain
        c_open_w = nw_shift - goa - gea
        c_ext_w = w_prev_val - gea
        _, is_ext_w = _pick2_b(c_open_w, c_ext_w, rv)
        w_from = jnp.where(is_ext_w, W_FROM_W, W_FROM_NW)
        if local_alignment:
            w_from = jnp.where(w_val <= 0, 0, w_from)
        w_from = jnp.where(inb, w_from, 0)

        bp = (nw_from | (n_from << 2) | (w_from << 4)).astype(jnp.uint8)

        # --- score tracking (sw-full-ls.c:359-368)
        cellmax = jnp.maximum(jnp.maximum(n_val, nw_val), w_val)
        if local_alignment:
            rowvalid = (i < rlen)[:, None] & inb
        else:
            rowvalid = (i == rlen - 1)[:, None] & inb
        cand = jnp.where(rowvalid, cellmax, NEG)

        # repack rows with boundary col = per-mode init
        pad_nw = jnp.full((B, 1), init_nw, jnp.int32)
        pad_n = jnp.full((B, 1), init_n, jnp.int32)
        pad_w = jnp.full((B, 1), init_w, jnp.int32)
        out = (jnp.concatenate([pad_nw, nw_val], axis=1),
               jnp.concatenate([pad_n, n_val], axis=1),
               jnp.concatenate([pad_w, w_val], axis=1))
        return out, (bp, cand, nw_val, n_val, w_val)

    # virtual row -1: all columns local-init (sw-full-ls.c:194-196)
    row_m1 = (jnp.zeros((B, G + 1), jnp.int32),
              jnp.full((B, G + 1), jnp.int32(b_gap_open), jnp.int32),
              jnp.full((B, G + 1), jnp.int32(a_gap_open), jnp.int32))
    _, (bp, cand, nw_all, n_all, w_all) = jax.lax.scan(
        row, row_m1, jnp.arange(R, dtype=jnp.int32))
    # bp: [R, B, G] -> [B, R, G]
    bp = jnp.transpose(bp, (1, 0, 2))
    cand = jnp.transpose(cand, (1, 0, 2)).reshape(B, R * G)
    nw_all = jnp.transpose(nw_all, (1, 0, 2))
    n_all = jnp.transpose(n_all, (1, 0, 2))
    w_all = jnp.transpose(w_all, (1, 0, 2))

    best = jnp.max(cand, axis=1)
    flat_idx = jnp.argmax(cand, axis=1)
    score = jnp.maximum(best, 0)
    has = best > 0
    max_i = jnp.where(has, flat_idx // G, 0).astype(jnp.int32)
    max_j = jnp.where(has, flat_idx % G, 0).astype(jnp.int32)

    # start plane (do_backtrace head, sw-full-ls.c:419-427):
    # nw preferred, then w strictly greater, then n strictly greater
    bidx = jnp.arange(B)
    nw_c = nw_all[bidx, max_i, max_j]
    n_c = n_all[bidx, max_i, max_j]
    w_c = w_all[bidx, max_i, max_j]
    plane = jnp.zeros(B, jnp.int32)            # 0=nw, 1=w, 2=n
    fs = nw_c
    plane = jnp.where(w_c > fs, 1, plane)
    fs = jnp.maximum(fs, w_c)
    plane = jnp.where(n_c > fs, 2, plane)
    return score, max_i, max_j, plane, bp


def _pick2_b(c_open, c_ext, rv_col):
    """Tie-pref pick with per-batch revcmpl flag rv_col ([B,1] bool):
    normal prefers open (sw-full-ls.c:303-318), revcmpl prefers extend."""
    take_ext = jnp.where(rv_col, ~(c_open > c_ext), c_ext > c_open)
    return jnp.where(take_ext, c_ext, c_open), take_ext


# reference FROM_* codes (sw-full-ls.c:36-42)
_F_NN, _F_NNW, _F_WNW, _F_WW, _F_NWN, _F_NWNW, _F_NWW = 1, 2, 3, 4, 5, 6, 7
# FROM code -> plane to follow next (0=nw, 1=w, 2=n); sw-full-ls.c:475-507
_NEXT_PLANE = jnp.array([0, 2, 0, 0, 1, 2, 0, 1], jnp.int32)
# decode tables: plane nibble -> FROM code
_NW_DEC = jnp.array([0, _F_NWNW, _F_NWN, _F_NWW], jnp.int32)
_N_DEC = jnp.array([0, _F_NN, _F_NNW, 0], jnp.int32)
_W_DEC = jnp.array([0, _F_WW, _F_WNW, 0], jnp.int32)

BACK_INS, BACK_DEL, BACK_MM = 1, 2, 3  # == sw_np BACK_* codes


def _tb_decode(bp_val, plane):
    nw = _NW_DEC[bp_val & 3]
    w = _W_DEC[(bp_val >> 4) & 3]
    n = _N_DEC[(bp_val >> 2) & 3]
    return jnp.where(plane == 0, nw, jnp.where(plane == 1, w, n))


def sw_full_and_traceback(genome, glen, read, rlen, ax, ay, alen, awid,
                          revcmpl, *, match, mismatch, a_gap_open,
                          a_gap_ext, b_gap_open, b_gap_ext,
                          local_alignment=False):
    """sw_full_batch + on-device traceback in one jitted computation,
    so the [B, R, G] backpointer tensor never leaves the device.

    Returns (packed [B, 10] int32, ops [B, ceil((R+G)/4)] uint8) as
    _traceback_pack lays them out — semantics of do_backtrace
    (sw-full-ls.c:413-516).
    """
    return _sw_full_tb_jit(genome, glen, read, rlen, ax, ay, alen, awid,
                           revcmpl, match, mismatch, a_gap_open, a_gap_ext,
                           b_gap_open, b_gap_ext, local_alignment)


@functools.partial(jax.jit, static_argnums=(9, 10, 11, 12, 13, 14, 15))
def _sw_full_tb_jit(genome, glen, read, rlen, ax, ay, alen, awid, revcmpl,
                    match, mismatch, a_gap_open, a_gap_ext, b_gap_open,
                    b_gap_ext, local_alignment):
    score, max_i, max_j, plane, bp = sw_full_batch.__wrapped__(
        genome, glen, read, rlen, ax, ay, alen, awid, revcmpl,
        match=match, mismatch=mismatch, a_gap_open=a_gap_open,
        a_gap_ext=a_gap_ext, b_gap_open=b_gap_open, b_gap_ext=b_gap_ext,
        local_alignment=local_alignment)
    return _traceback_pack(genome, read, score, max_i, max_j, plane, bp)


FILL = -(2 ** 28)     # cummax shift fill; stays clear of int32 overflow


def _shift_cols(x, k, fill):
    """x[:, j - k] with `fill` for j < k, along the last axis."""
    return jnp.concatenate(
        [jnp.full(x.shape[:-1] + (k,), fill, x.dtype), x[..., :-k]],
        axis=-1)


@functools.partial(jax.jit, static_argnames=(
    "match", "mismatch", "a_gap_open", "a_gap_ext", "b_gap_open",
    "b_gap_ext", "local_alignment"))
def sw_full_stats(genome, glen, read, rlen, ax, ay, alen, awid, revcmpl,
                  *, match: int, mismatch: int, a_gap_open: int,
                  a_gap_ext: int, b_gap_open: int, b_gap_ext: int,
                  local_alignment: bool = False):
    """Traceback-free full SW: the banded DP of sw_full_batch plus a
    diagonal-chain summary, with no backpointer tensor at all.

    A `lax.scan` over read rows with [B, G] planes. The intra-row W-gap
    chain W(j) = max(NW(j-1)-open, W(j-1)-ext) is a running max of
    (a_k + k*ext), taken by log2(G) shift-and-max doubling steps; the
    band's left boundary injects the out-of-band value init_w as one
    more candidate at j == x_min. Along each chain of consecutive
    NW_FROM_NW cells the scan carries its length (`run`), the
    from-nibble at its far end (`term`, 0 when the chain is the whole
    path) and the running count of equal characters (`deq`, with `base`
    its value where the chain starts).

    Returns [B, 8] int32: score, max_i, max_j, plane, run, term, deq,
    base. When plane == 0 and term == 0 the whole traceback is the
    single diagonal chain: nops = run, read_start = max_i - run + 1,
    genome_start = max_j - run + 1, matches = deq - base, mismatches =
    run - matches, no indels. Otherwise the caller walks the path itself
    (the host C++ banded DP). Score, position and plane equal
    sw_full_batch's wherever score > 0.
    """
    B, G = genome.shape
    R = read.shape[1]
    goa, gea = -a_gap_open, -a_gap_ext
    gob, geb = -b_gap_open, -b_gap_ext
    m, mm = int(match), int(mismatch)
    local = bool(local_alignment)
    NEGI = -(2 ** 30)
    init_nw = 0 if local else NEGI
    init_n = b_gap_open if local else NEGI
    init_w = a_gap_open if local else NEGI

    g = genome.astype(jnp.int32)
    jidx = jnp.arange(G, dtype=jnp.int32)[None, :]
    rv = (revcmpl != 0)[:, None]
    glen = glen.astype(jnp.int32)
    rlen = rlen.astype(jnp.int32)
    ax, ay = ax.astype(jnp.int32), ay.astype(jnp.int32)
    alen, awid = alen.astype(jnp.int32), awid.astype(jnp.int32)

    def pad(x, v):
        return jnp.concatenate([jnp.full((B, 1), v, jnp.int32), x], axis=1)

    def row(carry, xs):
        nwp, np_, wp, runp, termp, deqp, basep, st = carry
        i, rch = xs
        # band for this row (anchor_get_x_range, anchors.c:66-95)
        x_min = jnp.where(i < ay, 0,
                          jnp.where(i <= ay + alen - 1, ax + (i - ay),
                                    ax + alen))
        x_min = jnp.clip(x_min, 0, glen - 1)[:, None]
        x_max = jnp.where(
            i < ay - (awid - 1), ax + awid - 2,
            jnp.where(i <= ay - (awid - 1) + alen - 1,
                      ax + (awid - 1) + (i - (ay - (awid - 1))), glen - 1))
        x_max = jnp.clip(x_max, 0, glen - 1)[:, None]
        inb = (jidx >= x_min) & (jidx <= x_max)
        eqc = g == rch[:, None].astype(jnp.int32)
        s = jnp.where(eqc, m, mm)

        # NW plane: tie pref nw > n > w, flipped under revcmpl
        c_nw, c_n, c_w = nwp[:, :-1], np_[:, :-1], wp[:, :-1]
        v = jnp.where(rv, c_w, c_nw)
        f = jnp.where(rv, NW_FROM_W, NW_FROM_NW)
        f = jnp.where(c_n > v, NW_FROM_N, f)
        v = jnp.maximum(v, c_n)
        last = jnp.where(rv, c_nw, c_w)
        f = jnp.where(last > v, jnp.where(rv, NW_FROM_NW, NW_FROM_W), f)
        v = jnp.maximum(v, last)
        nw_val = v + s
        nw_from = f
        if local:
            clamp = nw_val <= 0
            nw_val = jnp.where(clamp, 0, nw_val)
            nw_from = jnp.where(clamp, 0, nw_from)

        # N plane: previous row, same column
        c_open = nwp[:, 1:] - gob - geb
        c_ext = np_[:, 1:] - geb
        take_ext = jnp.where(rv, c_ext >= c_open, c_ext > c_open)
        n_val = jnp.where(take_ext, c_ext, c_open)
        if local:
            n_val = jnp.where(n_val <= 0, 0, n_val)

        nw_val = jnp.where(inb, nw_val, init_nw)
        nw_from = jnp.where(inb, nw_from, 0)
        n_val = jnp.where(inb, n_val, init_n)

        # W plane: running max along j by shift-and-max doubling
        nw_shift = _shift_cols(nw_val, 1, init_nw)
        a_elem = nw_shift - goa - gea
        if local:
            a_elem = jnp.maximum(a_elem, 0)
        a_elem = jnp.where(jidx == x_min,
                           jnp.maximum(a_elem, init_w - gea), a_elem)
        c = jnp.where(inb, a_elem + jidx * gea, FILL)
        k = 1
        while k < G:
            c = jnp.maximum(c, _shift_cols(c, k, FILL))
            k *= 2
        w_val = jnp.where(inb, c - jidx * gea, init_w)

        # diagonal-chain bookkeeping: read the previous row at j-1
        deq = deqp[:, :-1] + eqc.astype(jnp.int32)
        chain = nw_from == NW_FROM_NW
        run = jnp.where(chain, runp[:, :-1] + 1, 0)
        term = jnp.where(chain, termp[:, :-1], nw_from)
        base = jnp.where(chain, basep[:, :-1], deq)

        # best cell (sw-full-ls.c:359-368): first row, then first column
        cellmax = jnp.maximum(jnp.maximum(n_val, nw_val), w_val)
        if local:
            rowvalid = (i < rlen)[:, None] & inb
        else:
            rowvalid = (i == rlen - 1)[:, None] & inb
        cand = jnp.where(rowvalid, cellmax, NEGI)
        jsel = jnp.argmax(cand, axis=1).astype(jnp.int32)
        rowbest = jnp.max(cand, axis=1)

        def pick(vals):
            return jnp.maximum(
                jnp.take_along_axis(vals, jsel[:, None], axis=1)[:, 0],
                NEGI)

        upd = rowbest > st[0]
        new = (rowbest, jnp.full((B,), i, jnp.int32), jsel, pick(nw_val),
               pick(n_val), pick(w_val), pick(run), pick(term), pick(deq),
               pick(base))
        st = tuple(jnp.where(upd, a, b) for a, b in zip(new, st))
        zcol = jnp.zeros((B, 1), jnp.int32)
        carry = (pad(nw_val, init_nw), pad(n_val, init_n),
                 pad(w_val, init_w),
                 *(jnp.concatenate([zcol, x], axis=1)
                   for x in (run, term, deq, base)), st)
        return carry, None

    # row -1 (sw-full-ls.c:194-196): nw = 0, n = b_gap_open,
    # w = a_gap_open in every column, the j = -1 pad column included
    zeros = jnp.zeros((B, G + 1), jnp.int32)
    negs = jnp.full((B,), NEGI, jnp.int32)
    zb = jnp.zeros((B,), jnp.int32)
    st0 = (negs, zb, zb) + (negs,) * 7
    carry0 = (zeros, zeros + b_gap_open, zeros + a_gap_open,
              zeros, zeros, zeros, zeros, st0)
    carry, _ = jax.lax.scan(
        row, carry0, (jnp.arange(R, dtype=jnp.int32), read.T))
    best, bi, bj, nw_c, n_c, w_c, run, term, deq, base = carry[-1]
    score = jnp.maximum(best, 0)
    has = best > 0
    # start plane (do_backtrace head, sw-full-ls.c:419-427): nw, then w
    # strictly greater, then n strictly greater
    plane = jnp.where(w_c > nw_c, 1, 0)
    plane = jnp.where(n_c > jnp.maximum(nw_c, w_c), 2, plane)
    return jnp.stack([score, jnp.where(has, bi, 0), jnp.where(has, bj, 0),
                      jnp.where(has, plane, 0), run, term, deq, base],
                     axis=1)


def _unpack_rtab_nib(rtab_pk):
    """[B, W] uint8 nibble-packed read codes -> [B, 2W] uint8 codes.
    Byte k holds code[2k] in the low nibble, code[2k+1] in the high."""
    lo = rtab_pk & jnp.uint8(0x0F)
    hi = rtab_pk >> 4
    B, W = rtab_pk.shape
    return jnp.stack([lo, hi], axis=2).reshape(B, 2 * W)


def _unpack_args4(args4):
    """Decode the 16-byte/window packed argument rows (the host packs
    them in fastpath._fused_dispatch: 16B instead of 40B per window).

    w0 = gstart (absolute genome offset, int32)
    w1 = ri | rc<<16 | rev<<17 | glen<<18        (ri<2^16, glen<2^14 —
         the 14-bit glen is what lets --longest-read windows, G up to
         4095, ride the packed flow on every tier incl. multi-host)
    w2 = (rx & 0xffff) | ry<<16                  (both signed int16)
    w3 = (rl & 0xffff) | rw<<16
    """
    w0, w1, w2, w3 = (args4[:, k] for k in range(4))
    ri = w1 & 0xFFFF
    rc = (w1 >> 16) & 1
    rev = (w1 >> 17) & 1
    glen = (w1 >> 18) & 0x3FFF
    rx = (w2 << 16) >> 16
    ry = w2 >> 16
    rl_ = w3 & 0xFFFF
    rw_ = (w3 >> 16) & 0xFFFF
    return w0, glen, ri, rc, rx, ry, rl_, rw_, rev


def fast_window_gather(codes_fwd, codes_rc, gstart, rc, G,
                       cat_words=None):
    """[B, G] uint8 genome windows via ONE word-granular gather over a
    concatenated (fwd, pad, rc, pad) plane plus a 4-way shift select, in
    place of two byte-granular [B, G] gathers + select. The pads repeat
    each plane's last byte, which reproduces the byte-gather's
    per-element clip for windows whose padded-G tail overruns the plane
    (those cells are glen-masked in every kernel). Returns None when G
    is not a whole number of words or the concatenated offsets would
    overflow int32 (planes over ~1 Gbp): the caller falls back."""
    n_gen = codes_fwd.shape[0]
    B = gstart.shape[0]
    PAD = 96
    pad2 = PAD + (-(2 * n_gen + PAD) % 4)
    if G % 4 or 2 * n_gen + PAD + pad2 >= 2 ** 31:
        return None
    if cat_words is not None:
        # prebuilt word plane (Mapper._dev_cat_words): built once per
        # index instead of concatenated in every launch
        words = cat_words
    else:
        cat = jnp.concatenate([
            codes_fwd,
            jnp.broadcast_to(codes_fwd[-1], (PAD,)),
            codes_rc,
            jnp.broadcast_to(codes_rc[-1], (pad2,))])
        words = jax.lax.bitcast_convert_type(
            cat.reshape(-1, 4), jnp.int32).reshape(-1)
    eff = jnp.clip(gstart, 0, n_gen - 1) \
        + jnp.where(rc != 0, n_gen + PAD, 0)
    w0 = eff >> 2
    nw = G // 4 + 1
    gw = jnp.take(words, w0[:, None]
                  + jnp.arange(nw, dtype=jnp.int32)[None, :], axis=0)
    by = jax.lax.bitcast_convert_type(
        gw[..., None], jnp.uint8).reshape(B, 4 * nw)
    sh = eff & 3
    gwin = by[:, 0:G]
    for k in (1, 2, 3):
        gwin = jnp.where((sh == k)[:, None], by[:, k:k + G], gwin)
    return gwin


def _vec_full_gather_packed(codes_fwd, codes_rc, args4, rtab_pk, G, L,
                            cat_words=None):
    """Packed-IO twin of _vec_full_gather: args4 is [B, 4] int32 per
    _unpack_args4 and rtab_pk the nibble-packed read table. rlen is the
    uniform batch read length L (pad rows simply score a 1-cell window
    whose result the host discards).

    The genome window gather runs at WORD granularity over a single
    concatenated (fwd, pad, rc, pad) plane: one int32 [B, G/4+1]
    gather plus a 4-way shift select replaces two byte-granular [B, G]
    gathers + select (fast_window_gather). The pads repeat each plane's last byte, reproducing the old
    per-element clip exactly for the <= G-byte overruns of
    windows shorter than the padded G (those cells are glen-masked in
    the kernels anyway)."""
    gstart, glen, ri, rc, rx, ry, rl_, rw_, rev = _unpack_args4(args4)
    B = args4.shape[0]
    n_gen = codes_fwd.shape[0]
    gwin = fast_window_gather(codes_fwd, codes_rc, gstart, rc, G,
                              cat_words=cat_words)
    if gwin is None:
        # concatenated-plane offsets would overflow int32 (genomes over
        # ~1 Gbp per shard): keep the byte-granular clip gather
        jidx = jnp.arange(G, dtype=jnp.int32)[None, :]
        pos = jnp.clip(gstart[:, None] + jidx, 0, n_gen - 1)
        gwin = jnp.where((rc != 0)[:, None], codes_rc[pos],
                         codes_fwd[pos])
        rtab = _unpack_rtab_nib(rtab_pk)
        rwin = rtab[jnp.clip(ri, 0, rtab.shape[0] - 1)]
        rlen = jnp.full((B,), L, jnp.int32)
        return gwin, rwin, glen, rlen, rx, ry, rl_, rw_, rev
    # read rows gather at word granularity too (rows are word-aligned:
    # R % 8 == 0 so the nibble-packed row is a whole number of int32s)
    rB, rW = rtab_pk.shape
    if rW % 4 == 0:
        rwords = jax.lax.bitcast_convert_type(
            rtab_pk.reshape(rB, rW // 4, 4), jnp.int32).reshape(rB,
                                                                rW // 4)
        rw_rows = jnp.take(rwords, jnp.clip(ri, 0, rB - 1), axis=0)
        rby = jax.lax.bitcast_convert_type(
            rw_rows[..., None], jnp.uint8).reshape(B, rW)
        rwin = _unpack_rtab_nib(rby)
    else:
        rtab = _unpack_rtab_nib(rtab_pk)
        rwin = rtab[jnp.clip(ri, 0, rB - 1)]
    rlen = jnp.full((B,), L, jnp.int32)
    return gwin, rwin, glen, rlen, rx, ry, rl_, rw_, rev


def _pack_stats3(vec, stats):
    """Pack (vec score, full-SW stats [B, 8]) into [B, 3] int32 for the
    device->host fetch (12B/row vs 18B unpacked):

    w0 = vec | score<<16       (both >= 0 and < 2^15: sw-vector.c:393)
    w1 = mi | mj<<12 | plane<<24 | (term!=0)<<26    (mi, mj < 4096)
    w2 = matches | run<<16     (matches = deq - base along the chain)

    Fields of rows with score == 0 are junk the host never reads."""
    score, mi, mj, plane, run, term = (stats[:, k] for k in range(6))
    matches = stats[:, 6] - stats[:, 7]
    v = vec if vec is not None else jnp.zeros_like(score)
    w0 = (score << 16) | (v & 0xFFFF)
    w1 = ((mi & 4095) | ((mj & 4095) << 12) | ((plane & 3) << 24)
          | (jnp.where(term != 0, 1, 0) << 26))
    w2 = (matches & 0xFFFF) | ((run & 0x7FFF) << 16)
    return jnp.stack([w0, w1, w2], axis=1).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=(
    "G", "L", "match", "mismatch", "a_gap_open", "a_gap_ext",
    "b_gap_open", "b_gap_ext", "local_alignment", "vec_kernel", "phase"))
def sw_vec_full_stats_packed(codes_fwd, codes_rc, args4, rtab_pk,
                             cat_words=None,
                             *, G: int, L: int, match, mismatch,
                             a_gap_open, a_gap_ext, b_gap_open, b_gap_ext,
                             local_alignment=False, vec_kernel: str,
                             phase="fused"):
    """Packed-IO fused filter 2 + speculative filter 3 (stats flow).

    Same math as sw_vec_full_stats_from_index, but every host<->device
    buffer is packed: args 16B/window up, read table 4-bit up, results
    12B/window down ([B, 3] int32, _pack_stats3 layout).
    phase "vec" -> (int16 vec scores,) only; "full" -> packed stats
    with the vec field zero. `vec_kernel` names the vector-SW kernel
    (backend.vec_kernel)."""
    from .sw_pallas import sw_vector
    gwin, rwin, glen, rlen, ax, ay, alen, awid, rev = \
        _vec_full_gather_packed(codes_fwd, codes_rc, args4, rtab_pk, G, L,
                                cat_words=cat_words)
    kw = dict(match=match, mismatch=mismatch, a_gap_open=a_gap_open,
              a_gap_ext=a_gap_ext, b_gap_open=b_gap_open,
              b_gap_ext=b_gap_ext)
    vec = None
    if phase != "full":
        vec = sw_vector(gwin, glen, rwin, rlen, vec_kernel=vec_kernel, **kw)
        if phase == "vec":
            return (vec.astype(jnp.int16),)
    stats = sw_full_stats.__wrapped__(
        gwin, glen, rwin, rlen, ax, ay, alen, awid, rev,
        local_alignment=local_alignment, **kw)
    return (_pack_stats3(vec, stats),)


@functools.partial(jax.jit, static_argnames=(
    "G", "L", "match", "mismatch", "a_gap_open", "a_gap_ext",
    "b_gap_open", "b_gap_ext", "local_alignment", "vec_kernel", "phase"))
def sw_vec_full_tb_packed(codes_fwd, codes_rc, args4, rtab_pk,
                          cat_words=None,
                          *, G: int, L: int, match, mismatch, a_gap_open,
                          a_gap_ext, b_gap_open, b_gap_ext,
                          local_alignment=False, vec_kernel: str,
                          phase="fused"):
    """Packed-INPUT fused filter 2 + speculative filter 3 with on-device
    traceback (the traceback flow). Outputs stay unpacked:
    (int16 vec, packed [B, 10] int32, ops [B, W] uint8)."""
    gwin, rwin, glen, rlen, ax, ay, alen, awid, rev = \
        _vec_full_gather_packed(codes_fwd, codes_rc, args4, rtab_pk, G, L,
                                cat_words=cat_words)
    return _vec_full_tb(gwin, rwin, glen, rlen, ax, ay, alen, awid, rev,
                        local_alignment, vec_kernel, phase,
                        dict(match=match, mismatch=mismatch,
                             a_gap_open=a_gap_open, a_gap_ext=a_gap_ext,
                             b_gap_open=b_gap_open, b_gap_ext=b_gap_ext))


def _vec_full_tb(gwin, rwin, glen, rlen, ax, ay, alen, awid, rev,
                 local_alignment, vec_kernel, phase, kw):
    """Shared body of the traceback-flow launches (see
    sw_vec_full_tb_from_index for `phase`)."""
    from .sw_pallas import sw_vector
    if phase != "full":
        vec = sw_vector(gwin, glen, rwin, rlen, vec_kernel=vec_kernel, **kw)
        if phase == "vec":
            return (vec.astype(jnp.int16),)
    score, max_i, max_j, plane, bp = sw_full_batch.__wrapped__(
        gwin, glen, rwin, rlen, ax, ay, alen, awid, rev != 0,
        local_alignment=local_alignment, **kw)
    packed, ops = _traceback_pack(gwin, rwin, score, max_i, max_j, plane,
                                  bp)
    if phase == "full":
        return packed, ops
    return vec.astype(jnp.int16), packed, ops


def _vec_full_gather(codes_fwd, codes_rc, args, rtab, G):
    """Shared gather for the fused filter2+3 launch. args int32 [B, 10]:
    (gstart, glen, ri, rc, rlen, ax, ay, alen, awid, rev); one packed
    host->device buffer per launch. Strand-1 rows hold the reverse_hit
    coordinates (mapping.c:254-263), so the window is gathered from the
    revcomp plane and scored against the FORWARD read row —
    SW(revcomp(r), w) == SW(r, revcomp(w)) exactly, so the read table
    needs no rc rows."""
    cols = [args[:, k] for k in range(10)]
    gstart, glen, ri, rc, rlen, ax, ay, alen, awid, rev = cols
    jidx = jnp.arange(G, dtype=jnp.int32)[None, :]
    pos = jnp.clip(gstart[:, None] + jidx, 0, codes_fwd.shape[0] - 1)
    gwin = jnp.where((rc != 0)[:, None], codes_rc[pos], codes_fwd[pos])
    rwin = rtab[jnp.clip(ri, 0, rtab.shape[0] - 1)]
    return gwin, rwin, glen, rlen, ax, ay, alen, awid, rev


@functools.partial(jax.jit, static_argnames=(
    "G", "match", "mismatch", "a_gap_open", "a_gap_ext", "b_gap_open",
    "b_gap_ext", "local_alignment", "vec_kernel", "phase"))
def sw_vec_full_stats_from_index(codes_fwd, codes_rc, args, rtab,
                                 *, G: int, match, mismatch, a_gap_open,
                                 a_gap_ext, b_gap_open, b_gap_ext,
                                 local_alignment=False, vec_kernel: str,
                                 phase="fused"):
    """Fused filter 2 + SPECULATIVE filter 3 (stats flow) in ONE device
    launch: vector SW scores and full-SW DP stats for every candidate
    window. The host runs pass1 selection afterwards and simply indexes
    the speculative rows it keeps — trading ~15% extra (cheap) DP cells
    for one host->device->host round trip per batch instead of two.
    Returns (int16 vec_scores [B], int16 stats [B, 8]).

    `phase` (static): "vec" computes only (vec_scores,), "full" only
    (stats,) — the two-phase dispatch shape used at hg-scale candidate
    density where speculation wastes most full-DP cells (see
    fastpath._fused_dispatch)."""
    from .sw_pallas import sw_vector
    gwin, rwin, glen, rlen, ax, ay, alen, awid, rev = _vec_full_gather(
        codes_fwd, codes_rc, args, rtab, G)
    kw = dict(match=match, mismatch=mismatch, a_gap_open=a_gap_open,
              a_gap_ext=a_gap_ext, b_gap_open=b_gap_open,
              b_gap_ext=b_gap_ext)
    if phase != "full":
        vec = sw_vector(gwin, glen, rwin, rlen, vec_kernel=vec_kernel, **kw)
        if phase == "vec":
            return (vec.astype(jnp.int16),)
    stats = sw_full_stats.__wrapped__(
        gwin, glen, rwin, rlen, ax, ay, alen, awid, rev,
        local_alignment=local_alignment, **kw)
    # vec scores fit int16 by the reference's own cap (sw-vector.c:393);
    # stats fields are positions/runs < R+G — halves the fetch
    if phase == "full":
        return (stats.astype(jnp.int16),)
    return vec.astype(jnp.int16), stats.astype(jnp.int16)


@functools.partial(jax.jit, static_argnames=(
    "G", "match", "mismatch", "a_gap_open", "a_gap_ext", "b_gap_open",
    "b_gap_ext", "local_alignment", "vec_kernel", "phase"))
def sw_vec_full_tb_from_index(codes_fwd, codes_rc, args, rtab,
                              *, G: int, match, mismatch, a_gap_open,
                              a_gap_ext, b_gap_open, b_gap_ext,
                              local_alignment=False, vec_kernel: str,
                              phase="fused"):
    """Fused filter 2 + speculative filter 3 with on-device traceback
    (the traceback flow). Returns
    (int16 vec_scores, packed [B, 10] int32, ops [B, W] uint8).
    `phase` as in sw_vec_full_stats_from_index: "vec" -> (vec,),
    "full" -> (packed, ops)."""
    gwin, rwin, glen, rlen, ax, ay, alen, awid, rev = _vec_full_gather(
        codes_fwd, codes_rc, args, rtab, G)
    return _vec_full_tb(gwin, rwin, glen, rlen, ax, ay, alen, awid, rev,
                        local_alignment, vec_kernel, phase,
                        dict(match=match, mismatch=mismatch,
                             a_gap_open=a_gap_open, a_gap_ext=a_gap_ext,
                             b_gap_open=b_gap_open, b_gap_ext=b_gap_ext))


def _traceback_pack(genome, read, score, max_i, max_j, plane, bp):
    """Shared on-device traceback + output packing (do_backtrace,
    sw-full-ls.c:413-516); bp is [B, R, G] of packed plane nibbles.

    The walk itself is a minimal while_loop (one flat 1D gather per
    step, early exit once every lane's pointer chain ends); positions,
    indel counts and the match/mismatch tallies are reconstructed
    vectorized from the emitted op string afterwards, which keeps the
    sequential part gather-light."""
    B, R, G = bp.shape
    L = R + G
    bp_all = bp.reshape(B * R * G).astype(jnp.int32)
    base = jnp.arange(B, dtype=jnp.int32) * (R * G)
    genome_i = genome.astype(jnp.int32)
    read_i = read.astype(jnp.int32)

    i0 = max_i.astype(jnp.int32)
    j0 = max_j.astype(jnp.int32)
    frm0 = _tb_decode(bp_all[base + jnp.clip(i0, 0, None) * G
                             + jnp.clip(j0, 0, None)], plane)

    def cond(carry):
        t, i, j, frm, ops_buf = carry
        return (t < L) & jnp.any(frm != 0)

    def body(carry):
        t, i, j, frm, ops_buf = carry
        active = frm != 0
        is_n = active & ((frm == _F_NN) | (frm == _F_NNW))
        is_w = active & ((frm == _F_WW) | (frm == _F_WNW))
        is_nw = active & (frm >= _F_NWN)
        op = jnp.where(is_n, BACK_DEL,
                       jnp.where(is_w, BACK_INS,
                                 jnp.where(is_nw, BACK_MM, 0)))
        i2 = i - (is_n | is_nw)
        j2 = j - (is_w | is_nw)
        nxt = _NEXT_PLANE[jnp.clip(frm, 0, 7)]
        inb = active & (i2 >= 0) & (j2 >= 0)
        bpv = bp_all[base + jnp.clip(i2, 0, R - 1) * G
                     + jnp.clip(j2, 0, G - 1)]
        frm2 = jnp.where(inb, _tb_decode(bpv, nxt), 0)
        ops_buf = jax.lax.dynamic_update_slice(
            ops_buf, op.astype(jnp.int8)[:, None], (0, t))
        return (t + 1, i2, j2, frm2, ops_buf)

    ops0 = jnp.zeros((B, L), jnp.int8)
    _, _, _, _, ops_rev = jax.lax.while_loop(
        cond, body, (jnp.int32(0), i0, j0, frm0, ops0))

    # ---- vectorized stats from the op string (walk order = reversed
    # alignment): positions at step t follow from exclusive cumsums
    consumes_r = (ops_rev == BACK_DEL) | (ops_rev == BACK_MM)
    consumes_g = (ops_rev == BACK_INS) | (ops_rev == BACK_MM)
    act = ops_rev != 0
    cr = jnp.cumsum(consumes_r.astype(jnp.int32), axis=1)
    cg = jnp.cumsum(consumes_g.astype(jnp.int32), axis=1)
    i_t = i0[:, None] - (cr - consumes_r)           # exclusive cumsum
    j_t = j0[:, None] - (cg - consumes_g)
    is_nw_t = ops_rev == BACK_MM
    gch = jnp.take_along_axis(genome_i, jnp.clip(j_t, 0, G - 1), axis=1)
    rch = jnp.take_along_axis(read_i, jnp.clip(i_t, 0, R - 1), axis=1)
    eq = gch == rch
    m_ = jnp.sum(is_nw_t & eq, axis=1).astype(jnp.int32)
    mm_ = jnp.sum(is_nw_t & ~eq, axis=1).astype(jnp.int32)
    dele = jnp.sum(ops_rev == BACK_DEL, axis=1).astype(jnp.int32)
    ins = jnp.sum(ops_rev == BACK_INS, axis=1).astype(jnp.int32)
    nops = jnp.sum(act, axis=1).astype(jnp.int32)
    ncr = cr[:, -1]
    ncg = cg[:, -1]
    rs = jnp.where(ncr > 0, i0 - ncr + 1, 0)
    gs = jnp.where(ncg > 0, j0 - ncg + 1, 0)
    # pack scalar outputs into one tensor and the 2-bit ops 4-per-byte:
    # every device fetch costs a host round-trip, so the host gets
    # exactly two small arrays per launch (traceback.unpack_ops reverses)
    packed = jnp.stack([score, max_i, max_j, nops, rs, gs, m_, mm_, ins,
                        dele], axis=1).astype(jnp.int32)
    L = R + G
    pad = (-L) % 4
    if pad:
        ops_rev = jnp.concatenate(
            [ops_rev, jnp.zeros((B, pad), jnp.int8)], axis=1)
    o = ops_rev.astype(jnp.uint8).reshape(B, (L + pad) // 4, 4)
    ops_packed = (o[:, :, 0] | (o[:, :, 1] << 2) | (o[:, :, 2] << 4)
                  | (o[:, :, 3] << 6)).astype(jnp.uint8)
    return packed, ops_packed
