"""Batched (cross-read) candidate generation: filter 1 on flat arrays.

Where candidates.py mirrors SHRiMP2 one read at a time, this module runs an
entire same-length read batch through kmer lookup, the region-count
prefilter, anchor collapse, and window generation as flat numpy arrays with
(read, strand) owner segments — the array-programming layout that feeds the
device kernels without per-read python overhead.

Semantics are identical to candidates.py (verified by tests) and hence to:
- read_get_mapidxs         gmapper/mapping.c:37-115
- read_get_region_counts   gmapper/mapping.c:459-542
- read_get_anchor_list     gmapper/mapping.c:861-1022
- read_get_hit_list        gmapper/mapping.c:1025-1258
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from .. import constants as C
from ..config import is_absolute
from ..index.build import GenomeIndex


@dataclass
class FlatHits:
    """Candidate windows for a read batch, owner-segment ordered.

    owner = read_index * 2 + strand; hits within an owner are sorted by
    (cn, g_off) exactly like the per-read hit lists.
    """
    owner: np.ndarray            # int64 [H]
    cn: np.ndarray               # int32 [H]
    g_off: np.ndarray            # int64 [H] contig-local window start
    w_len: np.ndarray            # int32 [H]
    score_window_gen: np.ndarray  # int64 [H]
    matches: np.ndarray          # int32 [H]
    score_max: np.ndarray        # int64 [H]
    ax: np.ndarray               # int64 [H] anchor rect relative to g_off
    ay: np.ndarray
    alen: np.ndarray
    awid: np.ndarray
    seg_start: np.ndarray        # int64 [n_reads*2 + 1] owner segment bounds

    @property
    def n(self) -> int:
        return len(self.owner)


def _ranges_to_flat(lo: np.ndarray, hi: np.ndarray):
    """Concatenate ranges [lo_i, hi_i) into one index array; also return
    the repeat counts."""
    ln = (hi - lo).astype(np.int64)
    total = int(ln.sum())
    if total == 0:
        return np.zeros(0, np.int64), ln
    starts = np.zeros(len(lo), dtype=np.int64)
    np.cumsum(ln[:-1], out=starts[1:])
    idx = np.repeat(lo - starts, ln)
    return idx + np.arange(total, dtype=np.int64), ln


def region_mark_keys(index: GenomeIndex, codes: np.ndarray, read_len: int,
                     cutoff: int, min_kmer_pos: int = 0,
                     region_bits: int = C.DEF_REGION_BITS,
                     region_overlap: int = C.DEF_REGION_OVERLAP):
    """Per-owner region marks (read_get_region_counts,
    mapping.c:459-542). Returns (keys1, keys2): sorted arrays of
    owner * n_regions + region keys touched >= 1 / >= 2 times (the
    MAP_ID / HAS_2 bits of the reference's region_map), where
    owner = read_index * 2 + strand and the region-overlap extension
    counts as an extra touch of region-1."""
    from ..index.seeds import mapidx_matrix
    N = codes.shape[0]
    n_owners = N * 2
    flat_codes = codes.reshape(n_owners, read_len)
    n_reg = (index.total_len >> region_bits) + 2
    mask = (1 << region_bits) - 1
    max_span = max(s.seed.span for s in index.seeds)
    chunks = []
    for sn, si in enumerate(index.seeds):
        span = si.seed.span
        last = read_len - span
        if last < min_kmer_pos:
            continue
        starts = np.arange(min_kmer_pos, last + 1, dtype=np.int64)
        keys = mapidx_matrix(flat_codes, starts, si.seed, index.hashed,
                             max_span)
        lo = si.offsets[keys]
        hi = si.offsets[keys + 1]
        ok = (hi - lo) <= cutoff
        idx, counts = _ranges_to_flat(lo[ok], hi[ok])
        if len(idx) == 0:
            continue
        own_k, _ = np.nonzero(ok)
        owner = np.repeat(own_k.astype(np.int64), counts)
        x = si.positions[idx].astype(np.int64)
        r = x >> region_bits
        ov = ((x & mask) < region_overlap) & (r > 0)
        chunks.append(owner * n_reg + r)
        chunks.append(owner[ov] * n_reg + (r[ov] - 1))
    if not chunks:
        z = np.zeros(0, np.int64)
        return z, z
    ids, counts = np.unique(np.concatenate(chunks), return_counts=True)
    return ids, ids[counts >= 2]


def generate_candidates(index: GenomeIndex, codes: np.ndarray,
                        read_len: int, window_len: int, cutoff: int,
                        match_mode: int, threshold: float, match_score: int,
                        b_gap_open: int, b_gap_extend: int,
                        min_kmer_pos: int = 0,
                        use_region_counts: bool = True,
                        region_bits: int = C.DEF_REGION_BITS,
                        region_overlap: int = C.DEF_REGION_OVERLAP,
                        collapse: bool = True,
                        gapless: bool = False,
                        search_strands=(True, True),
                        mp_mode: int = 0,
                        mp_mate_m1: Optional[np.ndarray] = None,
                        mp_mate_m2: Optional[np.ndarray] = None,
                        mp_drmin: Optional[np.ndarray] = None,
                        mp_drmax: Optional[np.ndarray] = None,
                        ) -> FlatHits:
    """codes: [N, 2, read_len] uint8 for N same-length reads, both strands."""
    N = codes.shape[0]
    n_owners = N * 2
    flat_codes = codes.reshape(n_owners, read_len)

    # ---- step 1+2: kmers and CSR lookups, flattened across the batch
    pos_chunks, owner_chunks, y_chunks, stream_chunks, span_chunks = \
        [], [], [], [], []
    for sn, si in enumerate(index.seeds):
        span = si.seed.span
        last = read_len - span
        if last < min_kmer_pos:
            continue
        starts = np.arange(min_kmer_pos, last + 1, dtype=np.int64)
        from ..index.seeds import mapidx_matrix
        keys = mapidx_matrix(flat_codes, starts, si.seed, index.hashed,
                             max(s.seed.span for s in index.seeds))
        lo = si.offsets[keys]          # [n_owners, K]
        hi = si.offsets[keys + 1]
        ln = hi - lo
        ok = ln <= cutoff
        if not search_strands[0]:
            ok[0::2] = False
        if not search_strands[1]:
            ok[1::2] = False
        lo_f = lo[ok]
        hi_f = hi[ok]
        idx, counts = _ranges_to_flat(lo_f, hi_f)
        if len(idx) == 0:
            continue
        own_k, y_k = np.nonzero(ok)
        pos_chunks.append(si.positions[idx].astype(np.int64))
        owner_chunks.append(np.repeat(own_k.astype(np.int64), counts))
        y_chunks.append(np.repeat(starts[y_k], counts))
        stream_chunks.append(np.repeat(
            sn * read_len + starts[y_k], counts))
        span_chunks.append(np.full(len(idx), span, np.int64))

    seg = np.zeros(n_owners + 1, np.int64)
    if not pos_chunks:
        return _empty_flat(n_owners)
    x = np.concatenate(pos_chunks)
    owner = np.concatenate(owner_chunks)
    y = np.concatenate(y_chunks)
    stream = np.concatenate(stream_chunks)
    span = np.concatenate(span_chunks)

    # ---- step 3: region prefilter (HAS_2 regions per owner)
    if use_region_counts:
        r = x >> region_bits
        mask = (1 << region_bits) - 1
        ov = ((x & mask) < region_overlap) & (r > 0)
        n_reg = (index.total_len >> region_bits) + 2
        mk = owner * n_reg + r
        mk_ov = owner[ov] * n_reg + (r[ov] - 1)
        marks = np.concatenate([mk, mk_ov])
        ids, counts = np.unique(marks, return_counts=True)
        has2 = ids[counts >= 2]
        if mp_mode == 0:
            keep = np.isin(mk, has2)
            keep |= ov & np.isin(mk - 1, has2)
        else:
            # mate-pair region filter (advance_index_in_genomemap,
            # mapping.c:695-745): per anchor region, count_main is the
            # read's own HAS_2 and count_mp the best mark of the mate's
            # opposite strand within [r+drmin, r+drmax]; modes 1/2/3
            # combine them. mp_mate_m1/m2 hold the mate marks rebased
            # to this batch's owner slots.
            drmin = mp_drmin[owner]
            drmax = mp_drmax[owner]

            def _mode_pass(rq):
                main2 = np.isin(owner * n_reg + rq, has2)
                lo_q = owner * n_reg + np.maximum(rq + drmin, 0)
                hi_q = owner * n_reg + np.minimum(rq + drmax, n_reg - 1)
                mp1 = (np.searchsorted(mp_mate_m1, lo_q)
                       < np.searchsorted(mp_mate_m1, hi_q + 1))
                mp2 = (np.searchsorted(mp_mate_m2, lo_q)
                       < np.searchsorted(mp_mate_m2, hi_q + 1))
                if mp_mode == 1:
                    return main2 & mp2
                if mp_mode == 2:
                    return main2 | mp2
                return mp1 & (main2 | mp2)     # mode 3

            keep = _mode_pass(r)
            keep |= ov & _mode_pass(r - 1)
        x, owner, y, stream, span = (x[keep], owner[keep], y[keep],
                                     stream[keep], span[keep])
        if len(x) == 0:
            return _empty_flat(n_owners)

    # ---- step 4: genome-order anchor stream + collapse
    order = np.lexsort((stream, x, owner))
    x, y, stream, span, owner = (x[order], y[order], stream[order],
                                 span[order], owner[order])
    cn = index.contig_of(x).astype(np.int64)

    if collapse:
        diag = x - y
        ckey = (x + read_len - y) % read_len
        arrival = np.arange(len(x), dtype=np.int64)
        corder = np.lexsort((arrival, ckey, owner))
        xs, ys, ss, cs, os_, dg, ar = (x[corder], y[corder], span[corder],
                                       cn[corder], owner[corder],
                                       diag[corder], arrival[corder])
        ck = ckey[corder]
        newgrp = np.ones(len(xs), bool)
        newgrp[1:] = ((os_[1:] != os_[:-1]) | (ck[1:] != ck[:-1])
                      | (dg[1:] != dg[:-1]) | (cs[1:] != cs[:-1]))
        run = np.cumsum(newgrp) - 1
        nrun = int(run[-1]) + 1
        lead = np.nonzero(newgrp)[0]
        run_x = xs[lead]
        run_y = ys[lead]
        run_cn = cs[lead]
        run_owner = os_[lead]
        run_ar = ar[lead]
        ends = np.zeros(nrun, np.int64)
        np.maximum.at(ends, run, xs + ss)
        run_len = ends - run_x
        run_w = np.bincount(run, minlength=nrun)
        back = np.argsort(run_ar, kind="stable")
        x, y, alen = run_x[back], run_y[back], run_len[back]
        aweight = run_w[back]
        cn, owner = run_cn[back], run_owner[back]
    else:
        alen = span
        aweight = np.ones(len(x), np.int64)

    # ---- step 5: window generation
    coff = index.contig_offsets[cn].astype(np.int64)
    clen = index.contig_lengths[cn].astype(np.int64)
    n = len(x)
    w_len = np.minimum(window_len, clen)
    gend = np.minimum((x - coff) + read_len - 1 - y, clen - 1)
    gstart = np.where(gend >= window_len, gend - window_len, 0)

    # match_mode 3: per-anchor mate support (heavy_mp, mapping.c:1083-1094)
    # = mate's opposite strand has a >=2-touch region within the delta
    # range of the anchor's region (with the region-overlap fallback).
    heavy = np.zeros(n, bool)
    if match_mode == 3 and mp_mode and mp_mate_m2 is not None and n:
        n_reg = (index.total_len >> region_bits) + 2
        mask = (1 << region_bits) - 1
        r = x >> region_bits
        drmin = mp_drmin[owner]
        drmax = mp_drmax[owner]

        def _mp2(rq):
            lo_q = owner * n_reg + np.maximum(rq + drmin, 0)
            hi_q = owner * n_reg + np.minimum(rq + drmax, n_reg - 1)
            return (np.searchsorted(mp_mate_m2, lo_q)
                    < np.searchsorted(mp_mate_m2, hi_q + 1))

        heavy = _mp2(r)
        ovl = ((x & mask) < region_overlap) & (r > 0)
        heavy |= ~heavy & ovl & _mp2(r - 1)

    max_score = alen * match_score
    if not gapless and match_mode in (2, 3):
        single = (aweight == 1) if match_mode == 2 else \
            ((aweight == 1) & ~heavy)
        max_score = np.where(single, -1, max_score)
    max_idx = np.arange(n, dtype=np.int64)

    if not gapless and n:
        # enumerate every (anchor i, upstream anchor j) pair inside the
        # window as flat arrays and take a segmented max; the scan order
        # tie-break (largest j wins, self beats pairs) is encoded in the
        # combined (score, j) sort key. Pair counts can explode in repeat
        # pileups, so work proceeds in bounded slices.
        BIG = np.int64(1) << 40
        xkey = owner * BIG + x
        lo = np.searchsorted(xkey, owner * BIG + coff + gstart, side="left")
        i_all = np.arange(n, dtype=np.int64)
        cnt = i_all - lo
        KOFF = np.int64(1) << 24          # score offset to keep keys >= 0
        JBITS = np.int64(1) << 28
        base_key = (max_score + KOFF) * JBITS + i_all
        MAX_PAIRS = 20_000_000
        start = 0
        while start < n:
            end = start
            tot = 0
            while end < n and tot + cnt[end] <= MAX_PAIRS:
                tot += cnt[end]
                end += 1
            if end == start:
                end = start + 1
                tot = int(cnt[start])
            if tot > 0:
                seg_cnt = cnt[start:end]
                seg_i = np.repeat(np.arange(start, end), seg_cnt)
                offs = np.zeros(end - start, np.int64)
                np.cumsum(seg_cnt[:-1], out=offs[1:])
                within = np.arange(len(seg_i), dtype=np.int64) - \
                    np.repeat(offs, seg_cnt)
                seg_j = seg_i - 1 - within          # j descending from i-1
                valid = y[seg_j] < y[seg_i]
                dx = x[seg_i] - x[seg_j]
                dy = y[seg_i] - y[seg_j]
                deletion = dx > dy
                short_len = np.where(deletion, dy, dx) + alen[seg_i]
                long_len = np.where(deletion, dx, dy) + alen[seg_i]
                gap = long_len > short_len
                tmp = short_len * match_score + np.where(
                    gap, b_gap_open + (long_len - short_len) * b_gap_extend,
                    0)
                key = np.where(valid, (tmp + KOFF) * JBITS + seg_j,
                               np.int64(-1))
                starts_r = offs
                nonempty = seg_cnt > 0
                red = np.full(end - start, -1, np.int64)
                if nonempty.any():
                    red_ne = np.maximum.reduceat(key, starts_r[nonempty])
                    red[nonempty] = red_ne
                better = red > base_key[start:end]
                sl = slice(start, end)
                max_score[sl] = np.where(better, red // JBITS - KOFF,
                                         max_score[sl])
                max_idx[sl] = np.where(better, red % JBITS, max_idx[sl])
            start = end

    cap = np.minimum(read_len, w_len) * match_score
    if gapless or match_mode == 1:
        keep = np.ones(n, bool)
    else:
        # (int) truncation mirrors mapping.c:1157's
        # `>= (int)abs_or_pct(...)` — the f64 product 400 * 0.55 is
        # 220.0000000000000028 and must still accept a score of 220
        thr = (np.full(n, -threshold)
               if is_absolute(threshold)
               else (cap * (threshold / 100.0)))
        thr = np.trunc(thr).astype(np.int64)
        keep = max_score >= thr
        if match_mode == 3:
            # heavy anchors get a window with no threshold check
            # (mapping.c:1160-1163)
            keep |= heavy

    i = np.nonzero(keep)[0]
    j = max_idx[i]
    x_len = (x[i] - x[j]) + alen[i]
    goff = np.where((window_len - x_len) // 2 < x[j] - coff[i],
                    (x[j] - coff[i]) - (window_len - x_len) // 2, 0)
    goff = np.where(goff + w_len[i] > clen[i], clen[i] - w_len[i], goff)

    rel_xi = x[i] - (coff[i] + goff)
    rel_xj = x[j] - (coff[i] + goff)
    jx, jy, jl, jw = _anchor_join2_vec(rel_xi, y[i], alen[i],
                                       rel_xj, y[j], alen[j])
    same = j == i
    jx = np.where(same, rel_xi, jx)
    jy = np.where(same, y[i], jy)
    jl = np.where(same, alen[i], jl)
    jw = np.where(same, 1, jw)
    matches = np.where(same | gapless, aweight[i], aweight[i] + aweight[j])

    # stable sort hits by (owner, cn, g_off)
    horder = np.lexsort((np.arange(len(i)), goff, cn[i], owner[i]))
    h_owner = owner[i][horder]
    seg = np.zeros(n_owners + 1, np.int64)
    np.cumsum(np.bincount(h_owner, minlength=n_owners), out=seg[1:])
    return FlatHits(
        owner=h_owner,
        cn=cn[i][horder].astype(np.int32),
        g_off=goff[horder],
        w_len=w_len[i][horder].astype(np.int32),
        score_window_gen=max_score[i][horder],
        matches=matches[horder].astype(np.int32),
        score_max=cap[i][horder],
        ax=jx[horder], ay=jy[horder],
        alen=jl[horder].astype(np.int64), awid=jw[horder].astype(np.int64),
        seg_start=seg)


def _anchor_join2_vec(ax0, ay0, al0, ax1, ay1, al1):
    """anchor_join for two width-1 anchors (anchors.c:10-54)."""
    nw0, sw0 = ax0 + ay0, ax0 - ay0
    se0 = nw0 + 2 * (al0 - 1)
    nw1, sw1 = ax1 + ay1, ax1 - ay1
    se1 = nw1 + 2 * (al1 - 1)
    nw = np.minimum(nw0, nw1)
    sw = np.minimum(sw0, sw1)
    ne = np.maximum(sw0, sw1)      # widths are 1: ne border == sw border
    se = np.maximum(se0, se1)
    nw = nw - ((nw + sw) % 2 != 0)
    jx = (nw + sw) // 2
    jy = nw - jx
    ne = ne + ((ne - sw) % 2 != 0)
    jw = (ne - sw) // 2 + 1
    se = se + ((se - nw) % 2 != 0)
    jl = (se - nw) // 2 + 1
    return jx, jy, jl, jw


def _empty_flat(n_owners: int) -> FlatHits:
    z64 = np.zeros(0, np.int64)
    z32 = np.zeros(0, np.int32)
    return FlatHits(z64, z32, z64, z32, z64, z32, z64, z64, z64, z64, z64,
                    np.zeros(n_owners + 1, np.int64))
