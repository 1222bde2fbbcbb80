"""Flat-array fast path for letter-space unpaired mapping to SAM.

The generic pipeline in mapper.py materializes a Hit object per
surviving candidate; this module keeps the whole post-filter1 flow in
flat numpy arrays plus two native calls (native/hostpipe.cpp):

    filter1 (native)  ->  vector SW (device)  ->  pass1_select (native)
    -> full SW + traceback (device, batched)  ->  finalize_render
    (native: threshold/dedup/sort/MQV/SAM text)

Selections, scores, MQVs and SAM bytes are identical to the generic
path (and to gmapper -E); tests/test_fastpath.py asserts both.
Falls back (returns None) whenever the configuration needs a feature
only the generic path implements.
"""
from __future__ import annotations

import ctypes
import time as _time
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from . import constants as C
from .config import MapperConfig, abs_or_pct
from .io.fasta import SeqRecord
from .mapper import FULL_BATCH, _round_up

# windows/read at or above which the unpaired dispatch switches from
# the fused speculative launch to two-phase (vec, then full SW on the
# pass1 survivors); override with SHRIMP_TPU_LS_TWO_PHASE=0/1/auto
LS_TWO_PHASE_WPR = 8

# SAM seq cleaning LUTs (io/sam.py _CLEAN_TBL / _COMP_TBL as byte maps)
_CLEAN_LUT = np.arange(256, dtype=np.uint8)
for _c in range(128):
    _u = chr(_c).upper()
    if _u in "RYSWKMBDHV":
        _CLEAN_LUT[_c] = ord("N")
    elif len(_u) == 1 and ord(_u) < 256:
        _CLEAN_LUT[_c] = ord(_u)
_COMP_LUT = np.arange(256, dtype=np.uint8)
for _a, _b in (("A", "T"), ("T", "A"), ("C", "G"), ("G", "C")):
    _COMP_LUT[ord(_a)] = ord(_b)


def fastpath_supported(cfg: MapperConfig) -> bool:
    """Gate: the C renderer covers the default LS unpaired SAM flow
    plus the renderer-level flags (--all-contigs, --sam-unaligned,
    --read-group, --sam-r2, --extra-sam-fields — output-side only, so
    they must not evict the device fast path)."""
    return (cfg.mode == C.MODE_LETTER_SPACE
            and cfg.pair_mode == C.PAIR_NONE
            and len(cfg.unpaired_options()) == 1
            and not cfg.gapless
            and cfg.global_alignment
            and cfg.compute_mapping_qualities
            and not cfg.shrimp_format
            and cfg.search_forward and cfg.search_reverse)


class _P1Params(ctypes.Structure):
    _fields_ = [("n", ctypes.c_int64), ("n_owners", ctypes.c_int64),
                ("read_len", ctypes.c_int32),
                ("window_len", ctypes.c_int32),
                ("overlap", ctypes.c_int32), ("threshold", ctypes.c_double),
                ("min_matches", ctypes.c_int32),
                ("num_outputs", ctypes.c_int32),
                ("normalize", ctypes.c_int32),
                ("contig_lengths", ctypes.c_void_p)]


class _P1In(ctypes.Structure):
    _fields_ = [(f, ctypes.c_void_p) for f in
                ("owner", "cn", "g_off", "w_len", "matches", "score_max",
                 "ax", "ay", "alen", "awid", "scores", "swg")]


class _P1Out(ctypes.Structure):
    _fields_ = [("cap", ctypes.c_int64)] + \
        [(f, ctypes.c_void_p) for f in
         ("ri", "gen_st", "cn", "g_off", "w_len", "score_max", "ax", "ay",
          "alen", "awid", "score_vector", "seg", "src",
          "matches", "swg")]


class _FRParams(ctypes.Structure):
    _fields_ = [("n_jobs", ctypes.c_int64), ("n_reads", ctypes.c_int64),
                ("read_len", ctypes.c_int32), ("ops_words", ctypes.c_int32),
                ("sw_full_threshold", ctypes.c_double),
                ("num_outputs", ctypes.c_int32), ("strata", ctypes.c_int32),
                ("max_alignments", ctypes.c_int32),
                ("single_best", ctypes.c_int32),
                ("compute_mqv", ctypes.c_int32),
                ("alpha", ctypes.c_double), ("beta", ctypes.c_double),
                ("contig_lengths", ctypes.c_void_p),
                ("contig_name_off", ctypes.c_void_p),
                ("contig_names", ctypes.c_void_p),
                ("name_off", ctypes.c_void_p), ("names", ctypes.c_void_p),
                ("seq_fwd", ctypes.c_void_p), ("seq_rc", ctypes.c_void_p),
                ("qual_fwd", ctypes.c_void_p),
                ("qual_rc", ctypes.c_void_p),
                ("surv_post", ctypes.c_void_p),
                ("ext_z1", ctypes.c_void_p),
                # renderer-level flags (hostpipe.cpp tail)
                ("rg", ctypes.c_void_p), ("rg_len", ctypes.c_int32),
                ("all_contigs", ctypes.c_int32),
                ("sam_unaligned", ctypes.c_int32),
                ("qual_raw", ctypes.c_void_p),
                ("una_lo", ctypes.c_int64),
                ("una_hi", ctypes.c_int64),
                ("extra_sam", ctypes.c_int32),
                ("genome", ctypes.c_void_p),
                ("genome_rc", ctypes.c_void_p),
                ("contig_offsets", ctypes.c_void_p)]


class _FRJobs(ctypes.Structure):
    _fields_ = [(f, ctypes.c_void_p) for f in
                ("ri", "cn", "gen_st", "g_off", "score_max", "packed",
                 "ops_pk", "f_matches", "swg", "svec")]


class _FSWParams(ctypes.Structure):
    _fields_ = [("n_jobs", ctypes.c_int64), ("G", ctypes.c_int32),
                ("R", ctypes.c_int32), ("ops_words", ctypes.c_int32),
                ("match", ctypes.c_int32), ("mismatch", ctypes.c_int32),
                ("a_gap_open", ctypes.c_int32),
                ("a_gap_ext", ctypes.c_int32),
                ("b_gap_open", ctypes.c_int32),
                ("b_gap_ext", ctypes.c_int32), ("local", ctypes.c_int32)]


class _FSWJobs(ctypes.Structure):
    _fields_ = [(f, ctypes.c_void_p) for f in
                ("gwin", "glen", "read", "rlen", "ax", "ay", "alen",
                 "awid", "rev")]


def _vp(a: np.ndarray) -> ctypes.c_void_p:
    return ctypes.c_void_p(a.ctypes.data)


def _i32(x: np.ndarray) -> np.ndarray:
    """int64 -> int32 with C wraparound semantics (packed bit fields)."""
    return (x & 0xFFFFFFFF).astype(np.uint32).view(np.int32)


def _pack_args4(bucket: int, k: int, starts, glen, ri, rc, rx, ry,
                rl, rw, rev) -> np.ndarray:
    """Host side of sw_jax._unpack_args4: 16B/window packed argument
    rows; pad rows score a 1-cell window the host discards."""
    a = np.zeros((bucket, 4), np.int32)
    a[:k, 0] = starts.astype(np.int64).astype(np.int32)
    a[:k, 1] = _i32(ri.astype(np.int64)
                    | (rc.astype(np.int64) << 16)
                    | (rev.astype(np.int64) << 17)
                    | (glen.astype(np.int64) << 18))
    a[:k, 2] = _i32((rx.astype(np.int64) & 0xFFFF)
                    | (ry.astype(np.int64) << 16))
    a[:k, 3] = _i32((rl.astype(np.int64) & 0xFFFF)
                    | (rw.astype(np.int64) << 16))
    a[k:, 1] = 1 << 18              # pad: glen = 1
    a[k:, 3] = (1 << 16) | 1        # pad: rl = rw = 1
    return a


def _pack_rtab(read_tab: np.ndarray) -> np.ndarray:
    """4-bit nibble pack of the read table (sw_jax._unpack_rtab_nib):
    halves the per-batch upload. Codes are 4-bit (constants.CHAR_TO_INT
    <= 15); the 254 col/row fill packs to junk nibbles that rlen/bucket
    masking keeps out of every real score."""
    lo = read_tab[:, 0::2] & 15
    hi = read_tab[:, 1::2] & 15
    return np.ascontiguousarray(lo | (hi << 4))


def _unpack_stats3(pk: np.ndarray):
    """Host side of sw_jax._pack_stats3: [n, 3] int32 -> (vec int64 [n],
    stats int32 [n, 7]: score, mi, mj, plane, run, term, matches)."""
    w0 = pk[:, 0]
    w1 = pk[:, 1]
    w2 = pk[:, 2]
    vec = (w0 & 0xFFFF).astype(np.int64)
    st = np.empty((pk.shape[0], 7), np.int32)
    st[:, 0] = w0 >> 16
    st[:, 1] = w1 & 4095
    st[:, 2] = (w1 >> 12) & 4095
    st[:, 3] = (w1 >> 24) & 3
    st[:, 4] = (w2 >> 16) & 0x7FFF
    st[:, 5] = (w1 >> 26) & 1
    st[:, 6] = (w2 & 0xFFFF).astype(np.int16)   # sign-extend matches
    return vec, st


def _normalize_win(m, fh, L: int, rcf: np.ndarray):
    """Window geometry normalization shared by the single-device fused
    dispatch and the mesh (shard_map) dispatch: apply the reverse_hit
    strand transform (mapping.c:254-263) to every strand-1 window and
    assemble the flat geometry dict used by both the device launch and
    the host reconstruction stage."""
    cfg = m.config
    idx = m.index
    aw = cfg.anchor_width
    coff = idx.contig_offsets[fh.cn].astype(np.int64)
    clen = idx.contig_lengths[fh.cn].astype(np.int64)
    wl64 = fh.w_len.astype(np.int64)
    g_off_t = np.where(rcf, clen - fh.g_off - wl64, fh.g_off)
    ax_t = np.where(rcf, -fh.ax + (wl64 - 1) - (fh.alen - 1)
                    - (fh.awid - 1), fh.ax)
    ay_t = np.where(rcf, -fh.ay + (L - 1) - (fh.alen - 1)
                    + (fh.awid - 1), fh.ay)
    win = dict(
        starts=coff + g_off_t,
        g_off_t=g_off_t,
        rcmask=rcf,
        glen=fh.w_len.astype(np.int32),
        ri=(fh.owner >> 1).astype(np.int32),
        rx=(ax_t - aw // 2).astype(np.int32),
        ry=(ay_t + aw // 2).astype(np.int32),
        rl_=fh.alen.astype(np.int32),
        rw_=(fh.awid + aw).astype(np.int32),
        rev=rcf & cfg.rev_tiebreak)
    G = _round_up(max(int(fh.w_len.max()), 16), 32)
    return win, G


def _fused_dispatch(m, fh, read_tab: np.ndarray, L: int, R: int,
                    rcf: np.ndarray, n_reads=None):
    """Fused filter2 + speculative filter3 device launches over every
    candidate window.  `rcf` marks windows needing the reverse_hit
    normalization (st != input_strand, mapping.c:254-263) — for unpaired
    reads this is simply strand 1; paired legs may be pre-flipped by the
    pair mode (gmapper.c:175-186).  Returns (futures, win, G,
    stats_flow); `win` carries the normalized window geometry reused by
    the host reconstruction stage."""
    import os as _os

    import jax

    from . import backend
    from .core.sw_jax import (sw_vec_full_stats_from_index,
                              sw_vec_full_stats_packed,
                              sw_vec_full_tb_from_index,
                              sw_vec_full_tb_packed)
    from .mapper import FULL_BATCH, FULL_BUCKETS
    cfg = m.config
    idx = m.index
    sc = cfg.scores
    codes_dev = m._dev_codes()
    codes_rc_dev = m._dev_codes_rc()
    n = fh.n
    win, G = _normalize_win(m, fh, L, rcf)
    stats_flow = backend.stats_flow()
    # Packed IO (16B/window args up, 4-bit reads up, 12B/window stats
    # down) whenever the bit-field ranges hold.
    packed_io = (G <= 4095 and R <= 4095
                 and int(fh.w_len.max()) < (1 << 14)
                 and read_tab.shape[0] <= (1 << 16)
                 and idx.total_len < (1 << 31))
    kw = dict(G=G, match=sc.match, mismatch=sc.mismatch,
              a_gap_open=sc.a_gap_open, a_gap_ext=sc.a_gap_extend,
              b_gap_open=sc.b_gap_open, b_gap_ext=sc.b_gap_extend,
              local_alignment=False, vec_kernel=backend.vec_kernel())
    if packed_io:
        kw["L"] = L
    if stats_flow:
        fn = sw_vec_full_stats_packed if packed_io \
            else sw_vec_full_stats_from_index
    else:
        fn = sw_vec_full_tb_packed if packed_io \
            else sw_vec_full_tb_from_index
    with m._device_ctx():
        rtab_dev = jax.device_put(
            _pack_rtab(read_tab) if packed_io else read_tab, m.device)
    # prebuilt concatenated word plane for the fast on-device window
    # gather (None outside the packed flow or for >1 Gbp planes)
    cat_dev = m._dev_cat_words() if packed_io else None
    # Two-phase at high candidate density (see the colour-space twin in
    # fastpath_cs._fused_dispatch_cs): vec-only first, full SW from
    # stage_finish on the pass1+pass2-gate survivors only. LS full-SW
    # costs roughly the vec cells again, so this halves device work at
    # hg-scale density; per-row kernel math is chunk-independent, so
    # output stays byte-identical.
    tp_env = _os.environ.get("SHRIMP_TPU_LS_TWO_PHASE", "auto")
    two_phase = (n_reads is not None and tp_env != "0"
                 and (tp_env == "1"
                      or n >= LS_TWO_PHASE_WPR * max(n_reads, 1)))
    if two_phase:
        kw["phase"] = "vec"
    # the traceback flow materializes a [B, R, G] backpointer tensor;
    # long-read shapes (R*G in the millions) must shrink the window
    # batch so the flat tensor stays far below int32 indexing / HBM
    # limits (e.g. R=1200, G=1736 at the default 2048-window bucket is
    # a 4.3e9-element tensor)
    eff_batch = FULL_BATCH
    if two_phase:
        # vec-only phase: rows are cheap, so at hg-scale density the
        # WHOLE batch's windows go up in ONE launch (pow2-bucketed)
        # instead of dozens of 32k-row launches (2207 windows/read x
        # 1024 reads = 69 launches/batch at 32k). The 4M-row cap bounds
        # the launch's transient device memory; it was sized for a
        # 16 GB device and is kept until it is measured on the card.
        eff_batch = int(_os.environ.get("SHRIMP_TPU_LS_VEC_BATCH",
                                        str(1 << 22)))
    if not stats_flow:
        eff_batch = max(8, min(FULL_BATCH, (1 << 28) // max(R * G, 1)))
    futures = []
    off = 0
    while off < n:
        k = min(n - off, eff_batch)
        if k > FULL_BUCKETS[-1]:
            # above the shared bucket table: 1.25/1.5/2x pow2 steps
            # bound the distinct compiled shapes while keeping the
            # padded-row tail under ~25%
            p2 = 1 << int(np.ceil(np.log2(k)))
            bucket = next(b for b in
                          (5 * (p2 // 8), 3 * (p2 // 4), p2) if b >= k)
        elif eff_batch >= FULL_BUCKETS[0]:
            bucket = FULL_BUCKETS[int(np.searchsorted(FULL_BUCKETS, k))]
        else:
            # long-read shrink active: small pow2 bucket
            bucket = 1 << int(np.ceil(np.log2(max(k, 8))))
        sl = slice(off, off + k)
        if packed_io:
            args = _pack_args4(
                bucket, k, win["starts"][sl], win["glen"][sl],
                win["ri"][sl], win["rcmask"][sl], win["rx"][sl],
                win["ry"][sl], win["rl_"][sl], win["rw_"][sl],
                win["rev"][sl])
        else:
            args = np.zeros((bucket, 10), np.int32)
            args[:k, 0] = win["starts"][sl]
            args[:k, 1] = win["glen"][sl]
            args[:k, 2] = win["ri"][sl]
            args[:k, 3] = win["rcmask"][sl]
            args[:k, 4] = L
            args[:k, 5] = win["rx"][sl]
            args[:k, 6] = win["ry"][sl]
            args[:k, 7] = win["rl_"][sl]
            args[:k, 8] = win["rw_"][sl]
            args[:k, 9] = win["rev"][sl]
            args[k:, 1] = 1          # pad rows: 1-cell windows
            args[k:, 4] = 1
            args[k:, 7] = 1
            args[k:, 8] = 1
        with m._device_ctx():
            args = jax.device_put(args, m.device)
            if packed_io:
                res = fn(codes_dev, codes_rc_dev, args, rtab_dev,
                         cat_dev, **kw)
            else:
                res = fn(codes_dev, codes_rc_dev, args, rtab_dev, **kw)
        futures.append((off, k, res))
        off += k
    win["packed_io"] = packed_io
    if two_phase:
        win["two_phase"] = dict(fn=fn, kw=kw, L=L, R=R,
                                codes_dev=codes_dev,
                                codes_rc_dev=codes_rc_dev,
                                rtab_dev=rtab_dev,
                                cat_dev=cat_dev if packed_io else None,
                                packed_io=packed_io)
    m.stats.vec_invocs += n
    cells = int(fh.w_len.astype(np.int64).sum()) * L
    m.stats.vec_cells += cells
    if not two_phase:
        m.stats.full_invocs += n
        m.stats.full_cells += cells
    return futures, win, G, stats_flow


def _tp_run_full(m, tp, win, G, rows, stats_flow, fh, L):
    """Two-phase phase B: dispatch the full-SW launch for the selected
    window rows only and fetch the results. Returns stats_sel [k, 7]
    (stats flow) or (packed_sel, ops_sel). Shared by the unpaired
    pass1-survivor flow (FastLS.stage_finish) and the paired
    select-then-full flow (FastPaired.stage_finish)."""
    import jax
    from .mapper import FULL_BATCH, FULL_BUCKETS
    t2 = _time.perf_counter()
    n_jobs = len(rows)
    L2, R2 = tp["L"], tp["R"]
    kw2 = dict(tp["kw"], phase="full")
    # same long-read shrink as _fused_dispatch: without stats flow,
    # phase B materializes a [bucket, R, G] backpointer tensor that
    # must stay under int32/HBM limits
    # one launch for the typical pass1-survivor count (~30/read)
    eff_batch2 = FULL_BUCKETS[-1]
    if not stats_flow:
        eff_batch2 = max(8, min(FULL_BATCH,
                                (1 << 28) // max(R2 * G, 1)))
    futures2 = []
    off = 0
    while off < n_jobs:
        k = min(n_jobs - off, eff_batch2)
        if eff_batch2 >= FULL_BUCKETS[0]:
            bucket = FULL_BUCKETS[int(np.searchsorted(FULL_BUCKETS, k))]
        else:
            bucket = 1 << int(np.ceil(np.log2(max(k, 8))))
        rws = rows[off:off + k]
        if win.get("packed_io"):
            args = _pack_args4(
                bucket, k, win["starts"][rws], win["glen"][rws],
                win["ri"][rws], win["rcmask"][rws],
                win["rx"][rws], win["ry"][rws], win["rl_"][rws],
                win["rw_"][rws], win["rev"][rws])
        else:
            args = np.zeros((bucket, 10), np.int32)
            args[:k, 0] = win["starts"][rws]
            args[:k, 1] = win["glen"][rws]
            args[:k, 2] = win["ri"][rws]
            args[:k, 3] = win["rcmask"][rws]
            args[:k, 4] = L2
            args[:k, 5] = win["rx"][rws]
            args[:k, 6] = win["ry"][rws]
            args[:k, 7] = win["rl_"][rws]
            args[:k, 8] = win["rw_"][rws]
            args[:k, 9] = win["rev"][rws]
            args[k:, 1] = 1
            args[k:, 4] = 1
            args[k:, 7] = 1
            args[k:, 8] = 1
        with m._device_ctx():
            args = jax.device_put(args, m.device)
            if tp.get("packed_io"):
                res = tp["fn"](tp["codes_dev"], tp["codes_rc_dev"],
                               args, tp["rtab_dev"], tp["cat_dev"],
                               **kw2)
            else:
                res = tp["fn"](tp["codes_dev"], tp["codes_rc_dev"],
                               args, tp["rtab_dev"], **kw2)
        futures2.append((off, k, res))
        off += k
    fetched2 = jax.device_get([r for _, _, r in futures2])
    m.stats.full_invocs += n_jobs
    m.stats.full_cells += int(
        fh.w_len[rows].astype(np.int64).sum()) * L
    m.stats.add_stage("device full (2ph)", _time.perf_counter() - t2)
    if stats_flow and win.get("packed_io"):
        stats_sel = np.empty((n_jobs, 7), np.int32)
        for (off, k, _), (pk3,) in zip(futures2, fetched2):
            stats_sel[off:off + k] = _unpack_stats3(pk3[:k])[1]
        return stats_sel
    if stats_flow:
        stats_sel = np.empty((n_jobs, 7), np.int32)
        for (off, k, _), (st,) in zip(futures2, fetched2):
            s32 = st[:k].astype(np.int32)
            stats_sel[off:off + k, :6] = s32[:, :6]
            stats_sel[off:off + k, 6] = s32[:, 6] - s32[:, 7]
        return stats_sel
    W_all = fetched2[0][1].shape[1]
    packed_sel = np.empty((n_jobs, 10), np.int32)
    ops_sel = np.empty((n_jobs, W_all), np.uint8)
    for (off, k, _), (pk, opk) in zip(futures2, fetched2):
        packed_sel[off:off + k] = pk[:k]
        ops_sel[off:off + k] = opk[:k]
    return packed_sel, ops_sel


class FastLS:
    """Per-Mapper fast-path state (padded genome, contig name blobs)."""

    def __init__(self, mapper) -> None:
        from .native import get_lib
        self.lib = get_lib()
        self.m = mapper
        # overridable fused-launch dispatcher (the mesh pipeline swaps in
        # its shard_map dispatch; signature of _fused_dispatch)
        self.dispatch_fn = _fused_dispatch
        # optional survivor-posterior output buffer: when set (and the
        # native lib supports it), finalize_render writes each emitted
        # alignment's posterior at its job index — the per-shard z1
        # partials of the cross-shard MQV recombination
        self.surv_post: Optional[np.ndarray] = None
        # filter1 internal fan-out; multi-lane streams set 1 (the lanes
        # already keep every core busy, inner threads just contend)
        self.f1_threads: Optional[int] = None
        # sharded-index MQV recombination hook: called with
        # (posteriors[n_jobs], job_ri, job_rows, n_reads) after the
        # selection pass; must return the cross-shard-merged z1 [n_reads]
        # that the render pass then consumes (parallel/meshmap.py)
        self.z1_merge_hook = None
        self._last_z1_merged: Optional[np.ndarray] = None
        # read-axis data parallelism (parallel/dist.py read_sharding):
        # when set to (lo, hi), finalize + render run ONLY for reads in
        # [lo, hi) of the batch. With slice_select additionally set,
        # pass1 selection, the vec gate and alignment expansion are
        # sliced too (full-depth read sharding; the owner-host
        # expansion then uses the request/response exchange so remote
        # shards' windows still expand on their owning host)
        self.read_slice = None
        self.slice_select = False
        self.last_slice_jobs = 0
        idx = mapper.index
        blob = b""
        offs = [0]
        for nm in idx.contig_names:
            blob += nm.encode()
            offs.append(len(blob))
        self.contig_names_blob = np.frombuffer(blob, np.uint8).copy() \
            if blob else np.zeros(1, np.uint8)
        self.contig_name_off = np.array(offs, np.int32)
        self.contig_lengths32 = np.ascontiguousarray(idx.contig_lengths,
                                                     np.uint32)
        self.contig_offsets32 = np.ascontiguousarray(idx.contig_offsets,
                                                     np.uint32)

    def _filter1(self, codes2: np.ndarray, L: int, wlen: int):
        """Candidate window generation over the mapper's index;
        overridable — parallel/meshmap.ShardedIndexMapper swaps in a
        per-shard-sub-index run with an order-preserving merge."""
        m = self.m
        cfg = m.config
        opts = m._unpaired_opts[0]
        from .native.filter1_py import generate_candidates_native
        return generate_candidates_native(
            m.index, codes2, L, wlen, m.cutoff, opts.hit_list.match_mode,
            opts.hit_list.threshold, cfg.scores.match,
            cfg.scores.b_gap_open, cfg.scores.b_gap_extend,
            min_kmer_pos=0,
            use_region_counts=opts.anchor_list.use_region_counts,
            region_bits=cfg.region_bits,
            region_overlap=cfg.region_overlap,
            collapse=opts.anchor_list.collapse, gapless=False,
            search_strands=(True, True), threads=self.f1_threads)

    # ---------------------------------------------------------- stage A
    def stage_prepare(self, records: Sequence[SeqRecord],
                      batch_cap: Optional[int] = None):
        """Encode batch + filter1 + async vector-SW dispatch. Returns
        None when the batch shape is unsupported (caller falls back).
        `batch_cap` pads the device read table to a fixed row count so
        jit shapes stay constant across batches."""
        m = self.m
        cfg = m.config
        t0 = _time.perf_counter()
        if not records:
            return None
        if cfg.trim_front or cfg.trim_end or cfg.trim_illumina:
            return None  # raw-string trims: generic prepare_read path
        if cfg.custom_unpaired_options or cfg.custom_paired_options:
            return None  # multi-round option sets: handle_read loop path
        has_qual = any(r.qual is not None for r in records)
        L = len(records[0].seq)
        if L == 0 or L > cfg.longest_read_len:
            return None
        try:
            buf = "".join(r.seq for r in records).encode("ascii")
        except UnicodeEncodeError:
            return None
        B = len(records)
        if len(buf) != B * L:
            return None
        raw = np.frombuffer(buf, np.uint8).reshape(B, L)
        qual_fwd = qual_rc = qual_raw = None
        if has_qual:
            try:
                qbuf = "".join(r.qual for r in records).encode("ascii")
            except (UnicodeEncodeError, TypeError):
                return None
            if len(qbuf) != B * L:
                return None   # mixed/missing quals: generic path
            qarr = np.frombuffer(qbuf, np.uint8).reshape(B, L)
            qv = qarr.astype(np.int32) - cfg.qual_delta
            if not cfg.ignore_qvs and not cfg.no_qv_check:
                # PHRED offset sanity check (gmapper.c:464-473)
                bad = (qv < -10) | (qv > 50)
                if bad.any():
                    q0 = int(qv[bad][0])
                    raise ValueError(
                        "The qv-offset might be set incorrectly! "
                        "Currently qvs are interpreted as PHRED+"
                        f"{cfg.qual_delta} and a qv of {q0} was "
                        "observed.")
            if not cfg.ignore_qvs and cfg.min_avg_qv >= 0:
                # average-qv read drop (gmapper.c:455-462; C int division)
                s = qv.sum(axis=1, dtype=np.int64)
                avg = np.where(s < 0, -((-s) // L), s // L)
                keep = avg >= cfg.min_avg_qv
                if not keep.all():
                    records = [r for r, k in zip(records, keep) if k]
                    if not records:
                        return dict(B=0)
                    raw = np.ascontiguousarray(raw[keep])
                    qarr = np.ascontiguousarray(qarr[keep])
                    B = len(records)
            qual_raw = np.ascontiguousarray(qarr)  # unrescaled (for
            # the sam-unaligned records, output.c:419-421)
            if cfg.qual_delta != 33:
                # rescale to PHRED+33 (output.c:562-568)
                qarr = (qarr.astype(np.int32) - cfg.qual_delta + 33
                        ).astype(np.uint8)
            qual_fwd = np.ascontiguousarray(qarr)
            qual_rc = np.ascontiguousarray(qarr[:, ::-1])
        codes16 = C.CHAR_TO_INT[raw]
        if (codes16 < 0).any():
            return None
        codes = codes16.astype(np.uint8)
        rc = C.COMPLEMENT[codes[:, ::-1]]
        # SAM SEQ blobs
        seq_fwd = np.ascontiguousarray(_CLEAN_LUT[raw])
        seq_rc = np.ascontiguousarray(_COMP_LUT[seq_fwd[:, ::-1]])
        nm_blob = b""
        offs = np.empty(B + 1, np.int64)
        offs[0] = 0
        parts = []
        for i, r in enumerate(records):
            parts.append(r.name.encode())
            offs[i + 1] = offs[i] + len(parts[-1])
        nm_blob = np.frombuffer(b"".join(parts), np.uint8).copy() \
            if parts else np.zeros(1, np.uint8)
        wlen = int(abs_or_pct(cfg.window_len, L))
        m.stats.add_stage("read prep", _time.perf_counter() - t0)
        t1 = _time.perf_counter()
        # interleave strand rows for filter1's owner convention
        codes2 = np.empty((B, 2, L), np.uint8)
        codes2[:, 0] = codes
        codes2[:, 1] = rc
        fh = self._filter1(codes2, L, wlen)
        if fh is None:
            return None
        m.stats.add_stage("filter1", _time.perf_counter() - t1)
        t2 = _time.perf_counter()
        # Fused filter2 + SPECULATIVE filter3: full-SW DP runs on EVERY
        # candidate window in the same launch as the vector SW, so each
        # batch pays ONE host->device->host round trip, at the cost of
        # DP cells on windows pass1 later drops. The shared per-batch
        # read table holds forward rows only: strand-1 windows carry
        # reverse_hit coordinates (mapping.c:254-263) and gather from
        # the revcomp genome plane (score-identical strand algebra, see
        # sw_jax._vec_full_gather).
        idx = m.index
        Bcap = max(batch_cap or B, B)
        R = _round_up(L, 8)
        read_tab = np.full((Bcap, R), 254, np.uint8)
        read_tab[:B, :L] = codes
        win = None
        futures = []
        G = 16
        stats_flow = False
        if fh.n:
            futures, win, G, stats_flow = self.dispatch_fn(
                m, fh, read_tab, L, R, (fh.owner & 1) == 1, n_reads=B)
        m.stats.add_stage("device dispatch", _time.perf_counter() - t2)
        return dict(B=B, L=L, wlen=wlen, fh=fh, win=win, futures=futures,
                    G=G, R=R, stats_flow=stats_flow,
                    codes=codes, names=nm_blob, name_off=offs,
                    seq_fwd=seq_fwd, seq_rc=seq_rc,
                    qual_fwd=qual_fwd, qual_rc=qual_rc,
                    qual_raw=qual_raw,
                    Bcap=Bcap, read_tab=read_tab,
                    t_dispatch=_time.perf_counter() - t2)

    def _unaligned_block(self, ctx, nhits) -> bytes:
        """--sam-unaligned records for the reads in `ctx` with no
        emitted alignments, for the early-return paths where the native
        renderer never runs (same bytes hostpipe emits,
        output.c:417-474)."""
        cfg = self.m.config
        if not cfg.sam_unaligned:
            return b""
        B = ctx["B"]
        lo, hi = (self.read_slice if self.read_slice is not None
                  else (0, B))
        seq_fwd = ctx["seq_fwd"]
        qual_raw = ctx.get("qual_raw")
        rg = (f"\tRG:Z:{cfg.read_group_name}".encode()
              if cfg.read_group_name else b"")
        parts = []
        name_off = ctx["name_off"]
        names = ctx["names"].tobytes()
        for r in range(lo, hi):
            if nhits[r]:
                continue
            q = (qual_raw[r].tobytes() if qual_raw is not None
                 else b"*")
            parts.append(names[name_off[r]:name_off[r + 1]]
                         + b"\t4\t*\t0\t0\t*\t*\t0\t0\t"
                         + seq_fwd[r].tobytes() + b"\t" + q + rg
                         + b"\n")
        return b"".join(parts)

    def _stats_to_packed(self, stats, ctx2):
        """Expand the [n, 7] int32 stats rows (score, max_i, max_j,
        plane, run, term, matches — normalized from either the packed
        [n, 3] device fetch via _unpack_stats3 or the legacy [n, 8]
        sw_jax.sw_full_stats rows) into the finalize_render job format.
        Rows whose best path is a single diagonal chain (plane == 0,
        term == 0) are reconstructed closed form, vectorized; the rare
        indel / cross-plane paths are re-run by the native banded DP
        (hostpipe.cpp sw_full_tb_host). Output is bit-identical to the
        on-device traceback flow."""
        m = self.m
        sc = m.config.scores
        n_jobs = ctx2["n_jobs"]
        jobs = ctx2["jobs"]
        R, G = ctx2["R"], ctx2["G"]
        L = ctx2["ctx"]["L"]
        W = (R + G + 3) // 4
        packed = np.zeros((n_jobs, 10), np.int32)
        ops_pk = np.zeros((n_jobs, W), np.uint8)
        score, mi, mj, plane, run, term, matches = (
            stats[:, k] for k in range(7))
        packed[:, 0] = score
        packed[:, 1] = mi
        packed[:, 2] = mj
        pos = score > 0
        closed = pos & (plane == 0) & (term == 0)
        packed[closed, 3] = run[closed]
        packed[closed, 4] = (mi - run + 1)[closed]
        packed[closed, 5] = (mj - run + 1)[closed]
        packed[closed, 6] = matches[closed]
        packed[closed, 7] = (run - matches)[closed]
        rows = np.nonzero(closed)[0]
        if rows.size:
            # walk-order op string: `run` diagonal ops (0b11), 4/byte
            fb = run[rows] // 4
            rem = run[rows] % 4
            sub = np.zeros((rows.size, W), np.uint8)
            sub[np.arange(W, dtype=np.int32)[None, :] < fb[:, None]] = 255
            ii = np.nonzero(rem > 0)[0]
            sub[ii, fb[ii]] = ((1 << (2 * rem[ii])) - 1).astype(np.uint8)
            ops_pk[rows] = sub
        need = np.nonzero(pos & ~closed)[0]
        m.stats.full_host_tb += int(need.size)
        if need.size:
            idx = m.index
            k2 = need.size
            starts = ctx2["starts"][need]
            rc = ctx2["rcmask"][need]
            gpos = np.clip(starts[:, None]
                           + np.arange(G, dtype=np.int64)[None, :],
                           0, idx.total_len - 1)
            gwin = np.ascontiguousarray(
                np.where(rc[:, None], idx.codes_rc[gpos],
                         idx.codes[gpos]).astype(np.uint8))
            read = np.ascontiguousarray(
                ctx2["read_tab"][jobs["ri"][need]])
            glen = np.ascontiguousarray(
                jobs["w_len"][need].astype(np.int32))
            rlen = np.full(k2, L, np.int32)
            ax = np.ascontiguousarray(ctx2["rx"][need])
            ay = np.ascontiguousarray(ctx2["ry"][need])
            alen = np.ascontiguousarray(ctx2["rl_"][need])
            awid = np.ascontiguousarray(ctx2["rw_"][need])
            rev = np.ascontiguousarray(ctx2["rev"][need].astype(np.uint8))
            pk2 = np.zeros((k2, 10), np.int32)
            op2 = np.zeros((k2, W), np.uint8)
            p = _FSWParams(k2, G, R, W, sc.match, sc.mismatch,
                           sc.a_gap_open, sc.a_gap_extend, sc.b_gap_open,
                           sc.b_gap_extend, 0)
            jb = _FSWJobs(_vp(gwin), _vp(glen), _vp(read), _vp(rlen),
                          _vp(ax), _vp(ay), _vp(alen), _vp(awid),
                          _vp(rev))
            rv = self.lib.sw_full_tb_host(ctypes.byref(p),
                                          ctypes.byref(jb), _vp(pk2),
                                          _vp(op2))
            assert rv == 0, rv
            packed[need] = pk2
            ops_pk[need] = op2
        return packed, ops_pk, W

    # ---------------------------------------------------------- stage B
    def stage_finish(self, ctx) -> Tuple[bytes, np.ndarray]:
        """Fetch the fused (vec, full) device results, run the native
        pass1 selection on the vector scores, keep the selected rows'
        speculative full-SW results, then native finalize/render."""
        m = self.m
        cfg = m.config
        B = ctx["B"]
        if B == 0:     # whole batch dropped by the avg-qv gate
            return b"", np.zeros(0, np.int32)
        fh = ctx["fh"]
        L, wlen = ctx["L"], ctx["wlen"]
        nhits = np.zeros(B, np.int32)
        if fh.n == 0:
            m.stats.reads += B
            return self._unaligned_block(ctx, nhits), nhits
        import jax
        n = int(fh.n)
        tp = (ctx["win"] or {}).get("two_phase")
        t0 = _time.perf_counter()
        fetch = (ctx["win"] or {}).get("fetch")
        fetched = fetch(ctx["futures"]) if fetch else \
            jax.device_get([res for _, _, res in ctx["futures"]])
        scores = np.empty(n, np.int64)
        stats_flow = ctx["stats_flow"]
        stats_all = packed_all = ops_all = None
        packed_io = (ctx["win"] or {}).get("packed_io", False)
        if tp is not None:
            for (off, k, _), (vec,) in zip(ctx["futures"], fetched):
                scores[off:off + k] = vec[:k]
        elif stats_flow and packed_io:
            stats_all = np.empty((n, 7), np.int32)
            for (off, k, _), (pk3,) in zip(ctx["futures"], fetched):
                v, st = _unpack_stats3(pk3[:k])
                scores[off:off + k] = v
                stats_all[off:off + k] = st
        elif stats_flow:
            stats_all = np.empty((n, 7), np.int32)
            for (off, k, _), (vec, st) in zip(ctx["futures"], fetched):
                scores[off:off + k] = vec[:k]
                s32 = st[:k].astype(np.int32)
                stats_all[off:off + k, :6] = s32[:, :6]
                stats_all[off:off + k, 6] = s32[:, 6] - s32[:, 7]
        else:
            W_all = fetched[0][2].shape[1]
            packed_all = np.empty((n, 10), np.int32)
            ops_all = np.empty((n, W_all), np.uint8)
            for (off, k, _), (vec, pk, opk) in zip(ctx["futures"],
                                                   fetched):
                scores[off:off + k] = vec[:k]
                packed_all[off:off + k] = pk[:k]
                ops_all[off:off + k] = opk[:k]
        dev_secs = _time.perf_counter() - t0 + ctx["t_dispatch"]
        m.stats.vec_secs += dev_secs
        m.stats.full_secs += dev_secs

        # ---- native pass1 selection over vector scores
        t0 = _time.perf_counter()
        sel_base = 0
        sel_sl = slice(0, n)
        if self.read_slice is not None and self.slice_select:
            # read-axis data parallelism, full-depth: pass1 selection,
            # the vec gate, alignment expansion AND finalize/render all
            # run only on this rank's read slice. Window rows are
            # owner-major, so the slice's rows are one contiguous span
            # of the candidate arrays (seg_start bounds). Selection is
            # per-read top-k, so per-read results are unchanged; the
            # windows of each sliced read still span every index shard
            # (the cross-host allgather ran before this), so MQV
            # denominators stay complete without a collective.
            lo_s, hi_s = self.read_slice
            sel_base = int(fh.seg_start[min(2 * lo_s, 2 * B)])
            r1_s = int(fh.seg_start[min(2 * hi_s, 2 * B)])
            sel_sl = slice(sel_base, r1_s)
            n = r1_s - sel_base
            if n == 0:
                m.stats.reads += B
                return self._unaligned_block(ctx, nhits), nhits
        opts = m._unpaired_opts[0].pass1
        cap = max(n, 1)
        sel = {k: np.empty(cap, dt) for k, dt in
               (("ri", np.int32), ("gen_st", np.int8), ("cn", np.int32),
                ("g_off", np.int64), ("w_len", np.int32),
                ("score_max", np.int64), ("ax", np.int64),
                ("ay", np.int64), ("alen", np.int64), ("awid", np.int64),
                ("score_vector", np.int64), ("src", np.int64),
                ("matches", np.int32), ("swg", np.int64))}
        seg = np.zeros(B + 1, np.int64)
        p1 = _P1Params(
            n, 2 * B, L, wlen,
            int(abs_or_pct(opts.window_overlap, wlen)),
            float(opts.threshold), opts.min_matches, opts.num_outputs,
            1, self.contig_lengths32.ctypes.data)
        arrs = dict(owner=np.ascontiguousarray(fh.owner[sel_sl], np.int64),
                    cn=np.ascontiguousarray(fh.cn[sel_sl], np.int32),
                    g_off=np.ascontiguousarray(fh.g_off[sel_sl], np.int64),
                    w_len=np.ascontiguousarray(fh.w_len[sel_sl], np.int32),
                    matches=np.ascontiguousarray(fh.matches[sel_sl],
                                                 np.int32),
                    score_max=np.ascontiguousarray(fh.score_max[sel_sl],
                                                   np.int64),
                    ax=np.ascontiguousarray(fh.ax[sel_sl], np.int64),
                    ay=np.ascontiguousarray(fh.ay[sel_sl], np.int64),
                    alen=np.ascontiguousarray(fh.alen[sel_sl], np.int64),
                    awid=np.ascontiguousarray(fh.awid[sel_sl], np.int64),
                    scores=scores[sel_sl],
                    swg=np.ascontiguousarray(fh.score_window_gen[sel_sl],
                                             np.int64))
        p1in = _P1In(**{k: _vp(v) for k, v in arrs.items()})
        p1out = _P1Out(cap, *[_vp(sel[k]) for k in
                              ("ri", "gen_st", "cn", "g_off", "w_len",
                               "score_max", "ax", "ay", "alen",
                               "awid", "score_vector")],
                       _vp(seg), _vp(sel["src"]),
                       _vp(sel["matches"]), _vp(sel["swg"]))
        n_sel = int(self.lib.pass1_select(ctypes.byref(p1),
                                          ctypes.byref(p1in),
                                          ctypes.byref(p1out)))
        assert n_sel >= 0

        # pass2 vector-score gate (read_pass2 threshold pre-check)
        thr = cfg.sw_full_threshold
        if n_sel:
            smax = sel["score_max"][:n_sel]
            if thr < 0:
                thresh = np.full(n_sel, int(-thr), np.int64)
            else:
                thresh = (smax * (thr / 100.0)).astype(np.int64)
            jsel = np.nonzero(sel["score_vector"][:n_sel] >= thresh)[0]
        else:
            jsel = np.zeros(0, np.int64)
        n_jobs = len(jsel)
        m.stats.add_stage("pass1 select", _time.perf_counter() - t0)
        if n_jobs == 0:
            m.stats.reads += B
            return self._unaligned_block(ctx, nhits), nhits
        jobs = {k: np.ascontiguousarray(sel[k][:n_sel][jsel]) for k in
                ("ri", "gen_st", "cn", "g_off", "w_len", "score_max",
                 "ax", "ay", "alen", "awid", "matches", "swg",
                 "score_vector")}
        rows = sel["src"][:n_sel][jsel] + sel_base
        if tp is not None:
            # two-phase phase B: full SW only on the pass1 + vec-gate
            # survivors
            out2 = _tp_run_full(m, tp, ctx["win"], ctx["G"], rows,
                                stats_flow, fh, L)
            if stats_flow:
                stats_sel = out2
            else:
                packed_sel, ops_sel = out2
        t0 = _time.perf_counter()
        if stats_flow:
            win = ctx["win"]
            ctx2 = dict(n_jobs=n_jobs, jobs=jobs, R=ctx["R"], G=ctx["G"],
                        ctx=ctx, read_tab=ctx["read_tab"], rows=rows,
                        rank_local_jobs=(self.read_slice is not None
                                         and self.slice_select),
                        starts=win["starts"][rows],
                        rcmask=win["rcmask"][rows],
                        rx=win["rx"][rows], ry=win["ry"][rows],
                        rl_=win["rl_"][rows], rw_=win["rw_"][rows],
                        rev=win["rev"][rows])
            packed, ops_pk, W = self._stats_to_packed(
                stats_sel if tp is not None else stats_all[rows], ctx2)
        elif tp is not None:
            W = ops_sel.shape[1]
            packed = packed_sel
            ops_pk = ops_sel
        else:
            W = ops_all.shape[1]
            packed = np.ascontiguousarray(packed_all[rows])
            ops_pk = np.ascontiguousarray(ops_all[rows])
        if self.read_slice is not None and self.slice_select:
            # slice-at-selection mode: every job already belongs to this
            # rank's read slice — just count them for the scaling test
            assert self.z1_merge_hook is None, \
                "read_slice and z1_merge_hook are mutually exclusive"
            self.last_slice_jobs += n_jobs
        elif self.read_slice is not None:
            # read-axis data parallelism (legacy shallow mode): this
            # rank finalizes + renders only its read slice. Selection
            # and the owner-host expansion above ran over the FULL
            # batch (replicated), so each sliced read's job set spans
            # every shard and its MQV denominator is complete without a
            # collective (splitreads recast,
            # /root/reference/README:236-276).
            assert self.z1_merge_hook is None, \
                "read_slice and z1_merge_hook are mutually exclusive"
            lo, hi = self.read_slice
            smask = (jobs["ri"] >= lo) & (jobs["ri"] < hi)
            jobs = {k: np.ascontiguousarray(v[smask])
                    for k, v in jobs.items()}
            rows = rows[smask]
            packed = np.ascontiguousarray(packed[smask])
            ops_pk = np.ascontiguousarray(ops_pk[smask])
            n_jobs = int(smask.sum())
            self.last_slice_jobs += n_jobs
            if n_jobs == 0:
                m.stats.reads += B
                return self._unaligned_block(ctx, nhits), nhits
        t1 = _time.perf_counter()
        cal = m.cal
        fr = _FRParams(
            n_jobs, B, L, W, float(cfg.sw_full_threshold),
            cfg.num_outputs, int(cfg.strata), cfg.max_alignments,
            int(cfg.single_best_mapping),
            int(cfg.compute_mapping_qualities), cal.alpha, cal.beta,
            self.contig_lengths32.ctypes.data,
            self.contig_name_off.ctypes.data,
            self.contig_names_blob.ctypes.data,
            ctx["name_off"].ctypes.data, ctx["names"].ctypes.data,
            ctx["seq_fwd"].ctypes.data, ctx["seq_rc"].ctypes.data,
            ctx["qual_fwd"].ctypes.data
            if ctx.get("qual_fwd") is not None else None,
            ctx["qual_rc"].ctypes.data
            if ctx.get("qual_rc") is not None else None,
            None)
        # renderer-level flags (kept out of the gate: the native
        # renderer implements them at full speed, output.c:227-774)
        rg_bytes = None
        if cfg.read_group_name:
            rg_bytes = f"\tRG:Z:{cfg.read_group_name}".encode()
            fr.rg = ctypes.cast(ctypes.c_char_p(rg_bytes),
                                ctypes.c_void_p)
            fr.rg_len = len(rg_bytes)
        fr.all_contigs = int(cfg.all_contigs)
        fr.sam_unaligned = int(cfg.sam_unaligned)
        fr.extra_sam = int(cfg.extra_sam_fields)
        if cfg.extra_sam_fields:
            idx0 = m.index
            if getattr(idx0, "codes", None) is None:
                # multi-host tier: remote shards' genome bytes are
                # unreachable, ZE cannot be built — generic path only
                raise RuntimeError(
                    "--extra-sam-fields is not supported on the "
                    "multi-host tier (remote genome bytes)")
            fr.genome = idx0.codes.ctypes.data
            fr.genome_rc = idx0.codes_rc.ctypes.data
            fr.contig_offsets = self.contig_offsets32.ctypes.data
        if cfg.sam_unaligned:
            if ctx.get("qual_raw") is not None:
                fr.qual_raw = ctx["qual_raw"].ctypes.data
            lo_u, hi_u = (self.read_slice if self.read_slice is not None
                          else (0, B))
            fr.una_lo = lo_u
            fr.una_hi = hi_u
        if self.surv_post is not None:
            # caller-owned survivor-posterior output (per-shard z1
            # partials for the cross-shard MQV recombination); job t maps
            # to original candidate window self.last_rows[t] and read
            # self.last_ri[t]
            sp = np.zeros(n_jobs, np.float64)
            self.surv_post = sp
            self.last_rows = rows
            self.last_ri = jobs["ri"]
            fr.surv_post = sp.ctypes.data
        frj = _FRJobs(_vp(jobs["ri"]), _vp(jobs["cn"]),
                      _vp(jobs["gen_st"]), _vp(jobs["g_off"]),
                      _vp(jobs["score_max"]), _vp(packed), _vp(ops_pk),
                      _vp(jobs["matches"]), _vp(jobs["swg"]),
                      _vp(jobs["score_vector"]))
        if self.z1_merge_hook is not None:
            # sharded-index MQV recombination (MAPPING_QUALITIES Part
            # 1c): first finalize pass collects every MQV-contributing
            # alignment's posterior (the per-shard z1 partials), the
            # hook merges them across shards with the device collective,
            # and the render pass below consumes the merged z1
            sp = np.zeros(n_jobs, np.float64)
            fr.surv_post = sp.ctypes.data
            cap0 = n_jobs * (2 * L + 224) + 4096
            while True:
                scratch = np.empty(cap0, np.uint8)
                nb0 = self.lib.finalize_render(ctypes.byref(fr),
                                               ctypes.byref(frj),
                                               _vp(scratch), cap0,
                                               _vp(nhits))
                if nb0 >= 0:
                    break
                cap0 *= 4      # render overflow (long names): grow
            fr.surv_post = None
            z1m = np.ascontiguousarray(
                self.z1_merge_hook(sp, jobs["ri"], rows, B), np.float64)
            assert z1m.shape == (B,)
            self._last_z1_merged = z1m
            fr.ext_z1 = z1m.ctypes.data
        cap = n_jobs * (2 * L + 224) + 4096
        while True:
            buf = np.empty(cap, np.uint8)
            nb = self.lib.finalize_render(ctypes.byref(fr),
                                          ctypes.byref(frj),
                                          _vp(buf), cap, _vp(nhits))
            if nb >= 0:
                break
            if nb == -2:
                raise RuntimeError("fastpath finalize unsupported config")
            cap *= 4
        m.stats.reads += B
        m.stats.reads_mapped += int((nhits > 0).sum())
        m.stats.alignments += int(nhits.sum())
        m.stats.add_stage("finalize + render", _time.perf_counter() - t1)
        return buf[:nb].tobytes(), nhits




def auto_batch_size(mapper) -> int:
    """Density-aware default batch size: big genomes carry thousands of
    candidate windows per read, so smaller batches give the lane
    pipeline enough depth to overlap host filter 1 with the device
    step (a 50k-read run at 8192 is only 6 pipeline steps); small
    genomes amortize per-batch overheads with big batches. Proxy for
    density: total genome length (windows/read scales with posting-list
    length)."""
    import os as _o
    env = _o.environ.get("SHRIMP_TPU_BATCH_SIZE")
    if env:
        return int(env)
    return 2048 if mapper.index.total_len >= (1 << 28) else 8192


def map_unpaired_sam_stream(mapper, records: Sequence[SeqRecord],
                            batch_size: Optional[int] = None,
                            lanes: Optional[int] = None
                            ) -> Optional[Iterator[bytes]]:
    """Pipelined LS unpaired mapping straight to SAM bytes; None when the
    config or batch shape needs the generic path.

    `lanes` > 1 runs that many whole-batch pipelines on worker threads
    with output re-ordered to input order — the launch_scan_threads
    architecture (gmapper.c:287-645: per-thread chunks + ordered output
    heap). Device round-trip latency and the GIL-releasing native stages
    overlap across lanes; results are byte-identical to lanes=1."""
    if not fastpath_supported(mapper.config):
        return None
    if batch_size is None:
        batch_size = auto_batch_size(mapper)
    fast = FastLS(mapper)
    if fast.lib is None:
        return None
    # probe the first batch for shape support before committing
    first = fast.stage_prepare(records[:batch_size], batch_cap=batch_size)
    if first is None and len(records):
        return None

    def slow_tail(off: int):
        """Generic-path fallback for a batch the flat encoder rejects
        (mixed lengths / non-ACGT): identical output, slower."""
        from .io.sam import render_unpaired
        batch = list(records[off:off + batch_size])
        fq = any(r.qual is not None for r in batch)
        lines = []
        for re_, hits in mapper.map_unpaired(batch):
            for h in hits:
                lines.append(render_unpaired(re_, h, mapper.index,
                                             mapper.config, fastq=fq))
        return ("\n".join(lines) + "\n").encode() if lines else b""

    if lanes is None:
        import os as _os
        # lanes overlap the device round trip and the GIL-releasing
        # native stages; 16 is a default still to be measured on the
        # card
        lanes = int(_os.environ.get("SHRIMP_TPU_PIPELINE_LANES", "16"))
    if lanes > 1 and len(records) > batch_size:
        # lanes keep every host core busy, so filter1's inner fan-out
        # defaults to 1; SHRIMP_TPU_F1_THREADS overrides for tuning
        import os as _os1
        fast.f1_threads = int(_os1.environ.get("SHRIMP_TPU_F1_THREADS",
                                               "1"))
        # lazy init of the device genome planes happens once, up front,
        # so worker threads never race the device_put
        mapper._dev_codes()
        mapper._dev_codes_rc()

        def work(off: int, pre) -> bytes:
            a = pre if pre is not None else fast.stage_prepare(
                records[off:off + batch_size], batch_cap=batch_size)
            if a is None:
                return slow_tail(off)
            return fast.stage_finish(a)[0]

        def gen_mt():
            from concurrent.futures import ThreadPoolExecutor
            offs = list(range(0, len(records), batch_size))
            with ThreadPoolExecutor(lanes) as ex:
                futs = {}
                ahead = lanes + 2
                sub = 0
                for i in range(len(offs)):
                    while sub < len(offs) and sub - i < ahead:
                        futs[sub] = ex.submit(work, offs[sub],
                                              first if sub == 0 else None)
                        sub += 1
                    yield futs.pop(i).result()
        return gen_mt()

    def gen():
        pend = first
        off = batch_size
        while True:
            a = None
            if off < len(records):
                a = fast.stage_prepare(records[off:off + batch_size],
                                       batch_cap=batch_size)
                if a is None:
                    # drain in input order, then the slow batch, resume
                    if pend is not None:
                        yield fast.stage_finish(pend)[0]
                        pend = None
                    yield slow_tail(off)
                    off += batch_size
                    continue
                off += batch_size
            if pend is not None:
                yield fast.stage_finish(pend)[0]
            pend = a
            if pend is None and off >= len(records):
                break
    return gen()


# ===================================================================
# Paired-end fast path
# ===================================================================

class _PPParams(ctypes.Structure):
    _fields_ = [("n_pairs", ctypes.c_int64), ("n_windows", ctypes.c_int64),
                ("read_len", ctypes.c_int32),
                ("window_len", ctypes.c_int32),
                ("ops_words", ctypes.c_int32),
                ("d_min", ctypes.c_int64 * 2),
                ("d_max", ctypes.c_int64 * 2),
                ("p1_min_matches", ctypes.c_int32),
                ("p1_overlap", ctypes.c_int32),
                ("p1_threshold", ctypes.c_double),
                ("pair1_num_outputs", ctypes.c_int32),
                ("pair1_threshold", ctypes.c_double),
                ("foot_threshold", ctypes.c_double),
                ("pair2_threshold", ctypes.c_double),
                ("pair2_num_outputs", ctypes.c_int32),
                ("strata", ctypes.c_int32),
                ("max_alignments", ctypes.c_int32),
                ("hp_enabled", ctypes.c_int32),
                ("hp_min_matches", ctypes.c_int32),
                ("hp_overlap", ctypes.c_int32),
                ("hp_threshold", ctypes.c_double),
                ("hp_num_tmp", ctypes.c_int32),
                ("hp_full_threshold", ctypes.c_double),
                ("hp_num_outputs", ctypes.c_int32),
                ("compute_mqv", ctypes.c_int32),
                ("alpha", ctypes.c_double), ("beta", ctypes.c_double),
                ("match_score", ctypes.c_int32),
                ("mismatch_score", ctypes.c_int32),
                ("total_genome_size", ctypes.c_double),
                ("ins_mean", ctypes.c_double),
                ("ins_stddev", ctypes.c_double),
                ("mode_sign_st0", ctypes.c_int32),
                ("contig_lengths", ctypes.c_void_p),
                ("contig_name_off", ctypes.c_void_p),
                ("contig_names", ctypes.c_void_p),
                ("name_off", ctypes.c_void_p), ("names", ctypes.c_void_p),
                ("seq_fwd", ctypes.c_void_p), ("seq_rc", ctypes.c_void_p),
                ("qual_fwd", ctypes.c_void_p),
                ("qual_rc", ctypes.c_void_p),
                ("qual_raw", ctypes.c_void_p),
                # colour-space mode extras (cs=0 for LS)
                ("cs", ctypes.c_int32),
                ("pr_random_den", ctypes.c_int32),
                ("pr_xover", ctypes.c_double), ("pr_snp", ctypes.c_double),
                ("pr_del_open", ctypes.c_double),
                ("pr_del_extend", ctypes.c_double),
                ("pr_ins_open", ctypes.c_double),
                ("pr_ins_extend", ctypes.c_double),
                ("cs_fastq", ctypes.c_int32),
                ("cs_use_read_qvs", ctypes.c_int32),
                ("cs_qual_delta", ctypes.c_int32),
                ("cs_use_sanger", ctypes.c_int32),
                ("cs_genome_fwd", ctypes.c_void_p),
                ("cs_genome_rc", ctypes.c_void_p),
                ("cs_colours", ctypes.c_void_p),
                ("cs_qr_tab", ctypes.c_void_p),
                ("cs_initbp", ctypes.c_void_p),
                ("cs_readseq", ctypes.c_void_p),
                ("cs_read_seq_len", ctypes.c_int32),
                ("cs_quals", ctypes.c_void_p),
                ("cs_cq", ctypes.c_void_p),
                ("cs_cq_len", ctypes.c_int32),
                # sharded-index MQV recombination (two-pass; see
                # pairedpipe.cpp PPParams tail)
                ("win_shard", ctypes.c_void_p),
                ("n_shards", ctypes.c_int32),
                ("part_out", ctypes.c_void_p),
                ("ext_in", ctypes.c_void_p),
                # select-then-full two-phase (pairedpipe.cpp tail)
                ("full_valid", ctypes.c_void_p),
                ("rescue_flag", ctypes.c_void_p),
                ("select_only", ctypes.c_int32),
                ("sel_out", ctypes.c_void_p),
                # renderer-level flags
                ("rg", ctypes.c_void_p), ("rg_len", ctypes.c_int32),
                ("all_contigs", ctypes.c_int32),
                ("sam_unaligned", ctypes.c_int32),
                ("sam_r2", ctypes.c_int32),
                ("seq_raw", ctypes.c_void_p),
                ("una_lo", ctypes.c_int64),
                ("una_hi", ctypes.c_int64),
                ("rescue_cap", ctypes.c_int64)]


class _PPWin(ctypes.Structure):
    _fields_ = [(f, ctypes.c_void_p) for f in
                ("seg", "cn", "g_off", "g_off_norm", "gen_st", "w_len",
                 "matches", "score_max", "vec", "packed", "ops_pk",
                 "cs_packed", "cs_steps", "start_abs")]


def fastpath_paired_supported(cfg: MapperConfig) -> bool:
    """Gate: the native paired renderer covers the default LS paired SAM
    flow (single option set, MQV on, no single-best) plus the
    renderer-level flags (--all-contigs without single-best is Z-field
    suppression only, paired.py:623; --sam-unaligned / --sam-r2 /
    --read-group are output-side)."""
    if cfg.pair_mode == C.PAIR_NONE:
        return False
    if cfg.mode != C.MODE_LETTER_SPACE:
        return False
    if cfg.custom_paired_options or cfg.custom_unpaired_options:
        return False
    popts = cfg.paired_options()
    if len(popts) != 1:
        return False
    ro = popts[0].read[0]
    if (ro.anchor_list.use_mp_region_counts
            and not ro.anchor_list.use_region_counts):
        return False
    if cfg.gapless or not cfg.global_alignment:
        return False
    if not cfg.compute_mapping_qualities:
        return False
    if cfg.single_best_mapping:
        return False
    if cfg.extra_sam_fields or cfg.shrimp_format:
        return False
    if not (cfg.search_forward and cfg.search_reverse):
        return False
    return True


class FastPaired:
    """Flat-array paired-end pipeline: filter1 + fused device launch
    shared with the unpaired path, then ONE native call
    (pairedpipe.cpp paired_finalize_render) for pair-up, paired
    pass1/pass2, half-paired fallback, paired MQV and SAM text."""

    def __init__(self, mapper) -> None:
        self.fls = FastLS(mapper)
        self.lib = self.fls.lib
        self.m = mapper
        # sharded-index paired MQV recombination hook: called with the
        # per-(pair, shard) partial stats [n_pairs, D, 9]; must return
        # the merged [n_pairs, 7] rows the render pass consumes
        # (parallel/meshmap.ShardedIndexMapper wires the collectives)
        self.zpair_merge_hook = None
        self.zpair_win_shard = None
        self.zpair_n_shards = 0
        self._last_zpair_merged: Optional[np.ndarray] = None
        # read-axis data parallelism: when set to (plo, phi), the native
        # paired brain runs ONLY for pairs in [plo, phi) of the batch
        # (their window rows are a contiguous owner-major span; other
        # pairs get empty segments). With slice_select additionally
        # set, the alignment expansion is sliced to the pair span too
        # (full-depth read sharding; remote shards' windows expand via
        # the request/response exchange in _stats_to_packed).
        self.read_slice = None
        self.slice_select = False
        self.last_slice_jobs = 0

    def _set_render_flags(self, p, ctx, n_pairs):
        """Renderer-level flag fields on the native params (RG suffix,
        all-contigs, sam-unaligned range, sam-r2). Returns the RG bytes
        to keep alive through the native call."""
        cfg = self.m.config
        rg_bytes = None
        if cfg.read_group_name:
            rg_bytes = f"\tRG:Z:{cfg.read_group_name}".encode()
            p.rg = ctypes.cast(ctypes.c_char_p(rg_bytes),
                               ctypes.c_void_p)
            p.rg_len = len(rg_bytes)
        p.all_contigs = int(cfg.all_contigs)
        p.sam_unaligned = int(cfg.sam_unaligned)
        p.sam_r2 = int(cfg.sam_r2)
        if ctx.get("raw") is not None:
            p.seq_raw = ctx["raw"].ctypes.data
        lo, hi = (self.read_slice if self.read_slice is not None
                  else (0, n_pairs))
        p.una_lo = lo
        p.una_hi = hi
        return rg_bytes

    def _paired_unaligned_block(self, ctx) -> bytes:
        """--sam-unaligned records for every (in-slice) pair of a batch
        with no candidate windows (same bytes pairedpipe emits)."""
        cfg = self.m.config
        if not cfg.sam_unaligned:
            return b""
        from .io.sam import _pair_qname
        name_off = ctx["name_off"]
        names = ctx["names"].tobytes()
        raw = ctx["raw"]
        qual_raw = ctx.get("qual_raw")
        rg = (f"\tRG:Z:{cfg.read_group_name}".encode()
              if cfg.read_group_name else b"")
        n_pairs = ctx["B"] // 2
        lo, hi = (self.read_slice if self.read_slice is not None
                  else (0, n_pairs))
        parts = []
        for pi in range(lo, hi):
            nms = [names[name_off[2 * pi + k]:
                         name_off[2 * pi + k + 1]].decode()
                   for k in (0, 1)]
            q = _pair_qname(nms[0], nms[1]).encode()
            for nip in (0, 1):
                ri = 2 * pi + nip
                flags = 0x1 | 0x4 | 0x8 | (0x40 if nip == 0 else 0x80)
                ql = (qual_raw[ri].tobytes() if qual_raw is not None
                      else b"*")
                line = (q + f"\t{flags}\t*\t0\t0\t*\t*\t0\t0\t".encode()
                        + ctx["seq_fwd"][ri].tobytes() + b"\t" + ql)
                if cfg.sam_r2:
                    line += b"\tR2:Z:" + raw[2 * pi + 1 - nip].tobytes()
                parts.append(line + rg + b"\n")
        return b"".join(parts)

    def _filter1_paired(self, codes2, L: int, wlen: int, ro, mp_kw):
        """Paired candidate generation (mp region filter included);
        overridable — parallel/meshmap.ShardedIndexMapper swaps in the
        per-shard-sub-index run with an order-preserving merge."""
        m = self.m
        cfg = m.config
        from .native.filter1_py import generate_candidates_native
        return generate_candidates_native(
            m.index, codes2, L, wlen, m.cutoff, ro.hit_list.match_mode,
            ro.hit_list.threshold, cfg.scores.match,
            cfg.scores.b_gap_open, cfg.scores.b_gap_extend,
            min_kmer_pos=0,
            use_region_counts=ro.anchor_list.use_region_counts,
            region_bits=cfg.region_bits,
            region_overlap=cfg.region_overlap,
            collapse=ro.anchor_list.collapse, gapless=False,
            search_strands=(True, True), threads=self.fls.f1_threads,
            **mp_kw)

    # ---------------------------------------------------------- stage A
    def stage_prepare(self, records: Sequence[SeqRecord],
                      batch_cap: Optional[int] = None):
        """Encode interleaved mate pairs + filter1 + fused dispatch.
        Returns None when the batch shape needs the generic path."""
        m = self.m
        cfg = m.config
        t0 = _time.perf_counter()
        if not records or len(records) % 2:
            return None
        if cfg.trim_front or cfg.trim_end or cfg.trim_illumina:
            return None
        qual_raw = None
        has_qual = any(r.qual is not None for r in records)
        L = len(records[0].seq)
        if L == 0 or L > cfg.longest_read_len:
            return None
        try:
            buf = "".join(r.seq for r in records).encode("ascii")
        except UnicodeEncodeError:
            return None
        B = len(records)
        if len(buf) != B * L:
            return None
        raw = np.frombuffer(buf, np.uint8).reshape(B, L)
        qual_fwd = qual_rc = None
        if has_qual:
            try:
                qbuf = "".join(r.qual for r in records).encode("ascii")
            except (UnicodeEncodeError, TypeError):
                return None
            if len(qbuf) != B * L:
                return None
            qarr = np.frombuffer(qbuf, np.uint8).reshape(B, L)
            qv = qarr.astype(np.int32) - cfg.qual_delta
            if not cfg.ignore_qvs and not cfg.no_qv_check:
                bad = (qv < -10) | (qv > 50)
                if bad.any():
                    q0 = int(qv[bad][0])
                    raise ValueError(
                        "The qv-offset might be set incorrectly! "
                        "Currently qvs are interpreted as PHRED+"
                        f"{cfg.qual_delta} and a qv of {q0} was "
                        "observed.")
            if not cfg.ignore_qvs and cfg.min_avg_qv >= 0:
                s = qv.sum(axis=1, dtype=np.int64)
                avg = np.where(s < 0, -((-s) // L), s // L)
                if (avg < cfg.min_avg_qv).any():
                    return None   # pair drops: generic path handles
            qual_raw = np.ascontiguousarray(qarr)
            if cfg.qual_delta != 33:
                qarr = (qarr.astype(np.int32) - cfg.qual_delta + 33
                        ).astype(np.uint8)
            qual_fwd = np.ascontiguousarray(qarr)
            qual_rc = np.ascontiguousarray(qarr[:, ::-1])
        codes16 = C.CHAR_TO_INT[raw]
        if (codes16 < 0).any():
            return None
        codes = codes16.astype(np.uint8)
        rc = C.COMPLEMENT[codes[:, ::-1]]
        seq_fwd = np.ascontiguousarray(_CLEAN_LUT[raw])
        seq_rc = np.ascontiguousarray(_COMP_LUT[seq_fwd[:, ::-1]])
        offs = np.empty(B + 1, np.int64)
        offs[0] = 0
        parts = []
        for i, r in enumerate(records):
            parts.append(r.name.encode())
            offs[i + 1] = offs[i] + len(parts[-1])
        nm_blob = np.frombuffer(b"".join(parts), np.uint8).copy() \
            if parts else np.zeros(1, np.uint8)
        wlen = int(abs_or_pct(cfg.window_len, L))
        # per-leg strand flips (read_reverse, gmapper.c:175-186)
        flip1, flip2 = C.PAIR_REVERSE[cfg.pair_mode]
        input_strand = np.zeros(B, np.int8)
        input_strand[0::2] = int(flip1)
        input_strand[1::2] = int(flip2)
        codes2 = np.empty((B, 2, L), np.uint8)
        flipm = input_strand == 1
        codes2[~flipm, 0] = codes[~flipm]
        codes2[~flipm, 1] = rc[~flipm]
        codes2[flipm, 0] = rc[flipm]
        codes2[flipm, 1] = codes[flipm]
        m.stats.add_stage("read prep", _time.perf_counter() - t0)
        t1 = _time.perf_counter()
        ro = m._paired_opts[0].read[0]
        mp_kw = {}
        if ro.anchor_list.use_mp_region_counts:
            # mate-pair region filter deltas (readpair_compute_mp_ranges,
            # mapping.c:2317-2442); all pairs share them at equal lengths
            from types import SimpleNamespace
            re1 = SimpleNamespace(window_len=wlen, read_len=L)
            re2 = SimpleNamespace(window_len=wlen, read_len=L)
            m._compute_mp_ranges(re1, re2, m._paired_opts[0].pairing)
            drmin = np.empty(2 * B, np.int64)
            drmax = np.empty(2 * B, np.int64)
            for st in (0, 1):
                drmin[st::4] = re1.delta_region_min[st]
                drmax[st::4] = re1.delta_region_max[st]
                drmin[2 + st::4] = re2.delta_region_min[st]
                drmax[2 + st::4] = re2.delta_region_max[st]
            mp_kw = dict(mp_mode=ro.anchor_list.use_mp_region_counts,
                         mp_drmin=drmin, mp_drmax=drmax)
        fh = self._filter1_paired(codes2, L, wlen, ro, mp_kw)
        if fh is None:
            return None
        m.stats.add_stage("filter1", _time.perf_counter() - t1)
        t2 = _time.perf_counter()
        R = _round_up(L, 8)
        Bcap = max(batch_cap or B, B)
        read_tab = np.full((Bcap, R), 254, np.uint8)
        read_tab[:B, :L] = codes        # raw forward rows for all legs
        win = None
        futures = []
        G = 16
        stats_flow = False
        if fh.n:
            rcf = (fh.owner & 1).astype(np.int8) != \
                input_strand[(fh.owner >> 1).astype(np.int64)]
            # n_reads enables the density-gated two-phase dispatch
            # (vec-only now; full SW later on the rows the native
            # SELECT pass picks — the reference's lazy full-SW). Only
            # the plain single-host path takes it: the sharded tiers
            # override dispatch_fn and keep the fused launch.
            tp_ok = (self.fls.dispatch_fn is _fused_dispatch
                     and self.zpair_merge_hook is None
                     and self.read_slice is None)
            futures, win, G, stats_flow = self.fls.dispatch_fn(
                m, fh, read_tab, L, R, rcf,
                **(dict(n_reads=B) if tp_ok else {}))
        m.stats.add_stage("device dispatch", _time.perf_counter() - t2)
        return dict(B=B, L=L, wlen=wlen, fh=fh, win=win, futures=futures,
                    G=G, R=R, stats_flow=stats_flow, codes=codes,
                    names=nm_blob, name_off=offs, seq_fwd=seq_fwd,
                    seq_rc=seq_rc, Bcap=Bcap, read_tab=read_tab,
                    input_strand=input_strand,
                    qual_fwd=qual_fwd, qual_rc=qual_rc,
                    qual_raw=qual_raw, raw=np.ascontiguousarray(raw),
                    t_dispatch=_time.perf_counter() - t2)

    # ---------------------------------------------------------- stage B
    def stage_finish(self, ctx) -> Tuple[bytes, np.ndarray, np.ndarray]:
        """Fetch device results, expand alignments for every window, and
        run the whole paired brain in one native call."""
        m = self.m
        cfg = m.config
        fls = self.fls
        fh = ctx["fh"]
        B, L = ctx["B"], ctx["L"]
        n_pairs = B // 2
        pair_nhits = np.zeros(n_pairs, np.int32)
        read_nhits = np.zeros(B, np.int32)
        m.stats.reads += B
        if fh.n == 0:
            return (self._paired_unaligned_block(ctx), pair_nhits,
                    read_nhits)
        import jax
        n = int(fh.n)
        tp = (ctx["win"] or {}).get("two_phase")
        t0 = _time.perf_counter()
        fetch = (ctx["win"] or {}).get("fetch")
        fetched = fetch(ctx["futures"]) if fetch else \
            jax.device_get([res for _, _, res in ctx["futures"]])
        scores = np.empty(n, np.int64)
        if tp is not None:
            for (off, k, _), (vec,) in zip(ctx["futures"], fetched):
                scores[off:off + k] = vec[:k]
        elif ctx["stats_flow"] and ctx["win"].get("packed_io"):
            stats_all = np.empty((n, 7), np.int32)
            for (off, k, _), (pk3,) in zip(ctx["futures"], fetched):
                v, st = _unpack_stats3(pk3[:k])
                scores[off:off + k] = v
                stats_all[off:off + k] = st
        elif ctx["stats_flow"]:
            stats_all = np.empty((n, 7), np.int32)
            for (off, k, _), (vec, st) in zip(ctx["futures"], fetched):
                scores[off:off + k] = vec[:k]
                s32 = st[:k].astype(np.int32)
                stats_all[off:off + k, :6] = s32[:, :6]
                stats_all[off:off + k, 6] = s32[:, 6] - s32[:, 7]
        else:
            W_all = fetched[0][2].shape[1]
            packed = np.empty((n, 10), np.int32)
            ops_pk = np.empty((n, W_all), np.uint8)
            for (off, k, _), (vec, pk, opk) in zip(ctx["futures"],
                                                   fetched):
                scores[off:off + k] = vec[:k]
                packed[off:off + k] = pk[:k]
                ops_pk[off:off + k] = opk[:k]
        dev_secs = _time.perf_counter() - t0 + ctx["t_dispatch"]
        m.stats.vec_secs += dev_secs
        m.stats.full_secs += dev_secs

        owner = np.ascontiguousarray(fh.owner, np.int64)
        seg = np.ascontiguousarray(
            np.searchsorted(owner, np.arange(2 * B + 1)), np.int64)
        rsl = slice(0, n)
        sliced_expand = False
        if self.read_slice is not None:
            assert self.zpair_merge_hook is None, \
                "read_slice and zpair_merge_hook are mutually exclusive"
            plo, phi = self.read_slice
            # pair pi owns legs 2pi..2pi+1 -> owners 4pi..4pi+3, whose
            # window rows are the contiguous span below (owner-major)
            r0 = int(seg[min(4 * plo, 2 * B)])
            r1 = int(seg[min(4 * phi, 2 * B)])
            rsl = slice(r0, r1)
            seg = np.ascontiguousarray(
                np.clip(seg, r0, r1) - r0, np.int64)
            n = r1 - r0
            self.last_slice_jobs += n
            sliced_expand = self.slice_select
            if n == 0:
                return (self._paired_unaligned_block(ctx), pair_nhits,
                        read_nhits)

        t0 = _time.perf_counter()
        win = ctx["win"]
        ex = rsl if sliced_expand else slice(0, None)
        if tp is not None:
            # select-then-full: alignment expansion happens later, only
            # for the rows the native SELECT pass picks
            assert self.read_slice is None \
                and self.zpair_merge_hook is None
            W = (ctx["R"] + ctx["G"] + 3) // 4
            packed = ops_pk = None
        elif ctx["stats_flow"]:
            # with sliced_expand, expansion (incl. the owner-host
            # exchange in the dist tier) runs only on this rank's pair
            # span — _stats_to_packed's request/response exchange keeps
            # remote shards' windows expanding on their owning host
            ctx2 = dict(n_jobs=n if sliced_expand else int(fh.n),
                        jobs=dict(ri=win["ri"][ex],
                                  w_len=np.ascontiguousarray(
                                      fh.w_len[ex], np.int32)),
                        R=ctx["R"], G=ctx["G"], ctx=dict(L=L),
                        read_tab=ctx["read_tab"],
                        starts=win["starts"][ex], rcmask=win["rcmask"][ex],
                        rx=win["rx"][ex], ry=win["ry"][ex],
                        rl_=win["rl_"][ex],
                        rw_=win["rw_"][ex], rev=win["rev"][ex])
            if sliced_expand:
                ctx2["rows"] = np.arange(rsl.start, rsl.stop,
                                         dtype=np.int64)
                ctx2["rank_local_jobs"] = True
            packed, ops_pk, W = fls._stats_to_packed(
                stats_all[ex], ctx2)
        else:
            W = ops_pk.shape[1]
        m.stats.add_stage("alignment expand", _time.perf_counter() - t0)

        # ---- one native call: pair-up .. SAM text
        t0 = _time.perf_counter()
        popts = m._paired_opts[0]
        ro = popts.read[0]
        pairing = popts.pairing
        hp = cfg.half_paired_unpaired_options(0)[0]
        from types import SimpleNamespace
        re1 = SimpleNamespace(window_len=ctx["wlen"], read_len=L)
        re2 = SimpleNamespace(window_len=ctx["wlen"], read_len=L)
        m._compute_mp_ranges(re1, re2, pairing)
        cal = m.cal
        sc = cfg.scores
        arrs = dict(
            seg=seg,
            cn=np.ascontiguousarray(fh.cn[rsl], np.int32),
            g_off=np.ascontiguousarray(fh.g_off[rsl], np.int64),
            g_off_norm=np.ascontiguousarray(win["g_off_t"][rsl],
                                            np.int64),
            gen_st=np.ascontiguousarray(win["rcmask"][rsl], np.int8),
            w_len=np.ascontiguousarray(fh.w_len[rsl], np.int32),
            matches=np.ascontiguousarray(fh.matches[rsl], np.int32),
            score_max=np.ascontiguousarray(fh.score_max[rsl], np.int64),
            vec=np.ascontiguousarray(scores[rsl], np.int64))
        if tp is None:
            psl = slice(0, None) if sliced_expand else rsl
            arrs["packed"] = np.ascontiguousarray(packed[psl], np.int32)
            arrs["ops_pk"] = np.ascontiguousarray(ops_pk[psl], np.uint8)
        p = _PPParams(
            n_pairs, n, L, ctx["wlen"], W,
            (ctypes.c_int64 * 2)(int(re1.delta_g_off_min[0]),
                                 int(re1.delta_g_off_min[1])),
            (ctypes.c_int64 * 2)(int(re1.delta_g_off_max[0]),
                                 int(re1.delta_g_off_max[1])),
            ro.pass1.min_matches,
            int(abs_or_pct(ro.pass1.window_overlap, ctx["wlen"])),
            float(ro.pass1.threshold),
            pairing.pass1_num_outputs, float(pairing.pass1_threshold),
            float(ro.pass2.threshold),
            float(pairing.pass2_threshold), pairing.pass2_num_outputs,
            int(pairing.strata), cfg.max_alignments,
            int(cfg.half_paired), hp.pass1.min_matches,
            int(abs_or_pct(hp.pass1.window_overlap, ctx["wlen"])),
            float(hp.pass1.threshold), hp.pass1.num_outputs,
            float(hp.pass2.threshold), hp.pass2.num_outputs,
            int(cfg.compute_mapping_qualities), cal.alpha, cal.beta,
            sc.match, sc.mismatch,
            float(m.total_genome_size),
            float(cfg.insert_size_mean), float(cfg.insert_size_stddev),
            int(cfg.pair_mode in (C.PAIR_OPP_IN, C.PAIR_COL_FW)),
            fls.contig_lengths32.ctypes.data,
            fls.contig_name_off.ctypes.data,
            fls.contig_names_blob.ctypes.data,
            ctx["name_off"].ctypes.data, ctx["names"].ctypes.data,
            ctx["seq_fwd"].ctypes.data, ctx["seq_rc"].ctypes.data,
            ctx["qual_fwd"].ctypes.data
            if ctx.get("qual_fwd") is not None else None,
            ctx["qual_rc"].ctypes.data
            if ctx.get("qual_rc") is not None else None,
            ctx["qual_raw"].ctypes.data
            if ctx.get("qual_raw") is not None else None,
            0, sc.match - sc.mismatch,
            0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
            0, 0, 0, 0, None, None, None, None, None, None, 0,
            None, None, 0)
        rg_keep = self._set_render_flags(p, ctx, n_pairs)
        wstruct = _PPWin(**{k: _vp(v) for k, v in arrs.items()})
        if tp is not None:
            # ---- select pass: from the vector scores alone, the
            # native brain picks every row that can need full-SW
            # results (paired heap feet + the hp heap superset)
            t2 = _time.perf_counter()
            hp_tmp = hp.pass1.num_outputs
            cap_sel = int(n_pairs) * 2 * (
                pairing.pass1_num_outputs + hp_tmp
                + pairing.pass2_num_outputs) + 8
            sel_out = np.zeros(cap_sel, np.int32)
            p.select_only = 1
            p.sel_out = sel_out.ctypes.data
            dummy = np.zeros(8, np.uint8)
            nsel = int(self.lib.paired_finalize_render(
                ctypes.byref(p), ctypes.byref(wstruct),
                dummy.ctypes.data_as(ctypes.c_char_p), 0,
                _vp(pair_nhits), _vp(read_nhits)))
            assert 0 <= nsel <= cap_sel
            p.select_only = 0
            p.sel_out = None
            m.stats.add_stage("paired select (2ph)",
                              _time.perf_counter() - t2)

            keep_alive = {}

            def add_full(rows_f):
                """Full SW + alignment expansion for rows_f, merged
                into the accumulated full-size arrays the render
                consumes (incremental: rescue rounds add rows)."""
                nonlocal W
                if keep_alive:
                    rows_f = rows_f[keep_alive["fv"][rows_f] == 0]
                if len(rows_f) == 0:
                    return
                out2 = _tp_run_full(m, tp, win, ctx["G"], rows_f,
                                    ctx["stats_flow"], fh, L)
                t3 = _time.perf_counter()
                if ctx["stats_flow"]:
                    ctx2 = dict(
                        n_jobs=len(rows_f),
                        jobs=dict(ri=win["ri"][rows_f],
                                  w_len=np.ascontiguousarray(
                                      fh.w_len[rows_f], np.int32)),
                        R=ctx["R"], G=ctx["G"], ctx=dict(L=L),
                        read_tab=ctx["read_tab"], rows=rows_f,
                        starts=win["starts"][rows_f],
                        rcmask=win["rcmask"][rows_f],
                        rx=win["rx"][rows_f], ry=win["ry"][rows_f],
                        rl_=win["rl_"][rows_f], rw_=win["rw_"][rows_f],
                        rev=win["rev"][rows_f])
                    pk_s, ops_s, W2 = fls._stats_to_packed(out2, ctx2)
                else:
                    pk_s, ops_s = out2
                    W2 = ops_s.shape[1]
                if not keep_alive:
                    W = W2
                    p.ops_words = W
                    keep_alive.update(
                        pk=np.zeros((n, 10), np.int32),
                        ops=np.zeros((n, W), np.uint8),
                        fv=np.zeros(n, np.uint8))
                    wstruct.packed = _vp(keep_alive["pk"])
                    wstruct.ops_pk = _vp(keep_alive["ops"])
                    p.full_valid = keep_alive["fv"].ctypes.data
                assert W2 == W
                keep_alive["pk"][rows_f] = pk_s
                keep_alive["ops"][rows_f] = ops_s
                keep_alive["fv"][rows_f] = 1
                m.stats.add_stage("alignment expand",
                                  _time.perf_counter() - t3)

            add_full(np.unique(sel_out[:nsel]).astype(np.int64))
            rescue = np.zeros(1, np.int32)
            p.rescue_flag = rescue.ctypes.data
            p.sel_out = sel_out.ctypes.data
            p.rescue_cap = cap_sel
        if self.zpair_merge_hook is not None:
            # sharded-index paired MQV recombination: collect pass
            # writes per-(pair, shard) partials, the hook merges them
            # with the device collectives (psum/pmin/argmax), and the
            # render pass consumes the merged values
            D = self.zpair_n_shards
            ws = np.ascontiguousarray(self.zpair_win_shard, np.int32)
            part = np.zeros((n_pairs, D, 9), np.float64)
            p.win_shard = ws.ctypes.data
            p.n_shards = D
            p.part_out = part.ctypes.data
            cap0 = max(1 << 20, n_pairs * 4 * (L + 320))
            while True:
                scratch = np.empty(cap0, np.uint8)
                rv0 = int(self.lib.paired_finalize_render(
                    ctypes.byref(p), ctypes.byref(wstruct),
                    scratch.ctypes.data_as(ctypes.c_char_p), cap0,
                    _vp(pair_nhits), _vp(read_nhits)))
                if rv0 >= 0:
                    break
                cap0 *= 4      # render overflow (long names): grow
                pair_nhits[:] = 0
                read_nhits[:] = 0
                part[:] = 0.0
            ext = np.ascontiguousarray(self.zpair_merge_hook(part),
                                       np.float64)
            assert ext.shape == (n_pairs, 7)
            self._last_zpair_merged = ext
            p.part_out = None
            p.ext_in = ext.ctypes.data
            pair_nhits[:] = 0
            read_nhits[:] = 0
        cap = max(1 << 20, n_pairs * 4 * (L + 320))
        while True:
            out = np.empty(cap, np.uint8)
            rv = int(self.lib.paired_finalize_render(
                ctypes.byref(p), ctypes.byref(wstruct),
                out.ctypes.data_as(ctypes.c_char_p), cap,
                _vp(pair_nhits), _vp(read_nhits)))
            if rv >= 0:
                break
            cap *= 4
        if tp is not None:
            # incremental rescue: the select superset can miss hp rows
            # when saved-anchor suppression diverges (common at hg
            # density); fetch full SW for exactly the recorded missing
            # rows and re-render, iterating (each round strictly grows
            # the valid set), with an all-rows final net
            rounds = 0
            while rescue[0] and rounds < 4:
                missing = np.unique(
                    sel_out[:min(int(rescue[0]), cap_sel)]
                ).astype(np.int64)
                self.last_rescue_rows = getattr(
                    self, "last_rescue_rows", 0) + len(missing)
                add_full(missing)
                rescue[0] = 0
                pair_nhits[:] = 0
                read_nhits[:] = 0
                while True:
                    out = np.empty(cap, np.uint8)
                    rv = int(self.lib.paired_finalize_render(
                        ctypes.byref(p), ctypes.byref(wstruct),
                        out.ctypes.data_as(ctypes.c_char_p), cap,
                        _vp(pair_nhits), _vp(read_nhits)))
                    if rv >= 0:
                        break
                    cap *= 4
                rounds += 1
            if rescue[0]:
                import sys as _sys
                print("fastpath: paired two-phase full-rows rescue",
                      file=_sys.stderr)
                add_full(np.arange(n, dtype=np.int64))
                p.full_valid = None
                pair_nhits[:] = 0
                read_nhits[:] = 0
                while True:
                    out = np.empty(cap, np.uint8)
                    rv = int(self.lib.paired_finalize_render(
                        ctypes.byref(p), ctypes.byref(wstruct),
                        out.ctypes.data_as(ctypes.c_char_p), cap,
                        _vp(pair_nhits), _vp(read_nhits)))
                    if rv >= 0:
                        break
                    cap *= 4
        m.stats.add_stage("paired select + render",
                          _time.perf_counter() - t0)
        m.stats.reads_mapped += int((pair_nhits > 0).sum()) * 2
        m.stats.alignments += 2 * int(pair_nhits.sum()) \
            + int(read_nhits.sum())
        return bytes(out[:rv]), pair_nhits, read_nhits


def map_paired_sam_stream(mapper, records: Sequence[SeqRecord],
                          batch_size: Optional[int] = None,
                          lanes: Optional[int] = None
                          ) -> Optional[Iterator[bytes]]:
    """Pipelined LS paired mapping straight to SAM bytes; None when the
    config needs the generic path.  records are interleaved mate pairs;
    output order == input order (multi-lane like the unpaired stream)."""
    if not fastpath_paired_supported(mapper.config):
        return None
    if batch_size is None:
        batch_size = auto_batch_size(mapper)
    fast = FastPaired(mapper)
    if fast.lib is None:
        return None
    if batch_size % 2:
        batch_size += 1
    first = fast.stage_prepare(records[:batch_size],
                               batch_cap=batch_size)
    if first is None and records:
        return None

    from .io import sam as _sam

    def slow_tail(off: int) -> bytes:
        batch = records[off:off + batch_size]
        fq = any(r.qual is not None for r in batch)
        lines = []
        for pe in mapper.map_paired(batch):
            p_out, u_out = mapper.select_output(pe)
            lines.extend(_sam.render_pair_entry(
                pe, mapper.index, mapper.config, p_out, u_out, fastq=fq))
        return ("\n".join(lines) + "\n").encode() if lines else b""

    if lanes is None:
        import os as _os
        lanes = int(_os.environ.get("SHRIMP_TPU_PIPELINE_LANES", "16"))
    if lanes > 1:
        import os as _os2
        fast.fls.f1_threads = int(_os2.environ.get(
            "SHRIMP_TPU_F1_THREADS", "1"))

    def work(off: int, pre) -> bytes:
        a = pre if pre is not None else fast.stage_prepare(
            records[off:off + batch_size], batch_cap=batch_size)
        if a is None:
            return slow_tail(off)
        return fast.stage_finish(a)[0]

    def gen_mt():
        from concurrent.futures import ThreadPoolExecutor
        offs = list(range(0, len(records), batch_size))
        with ThreadPoolExecutor(max(lanes, 1)) as ex:
            futs = {}
            ahead = max(lanes, 1) + 2
            sub = 0
            for i in range(len(offs)):
                while sub < len(offs) and sub - i < ahead:
                    futs[sub] = ex.submit(work, offs[sub],
                                          first if sub == 0 else None)
                    sub += 1
                yield futs.pop(i).result()
    if records:
        mapper._dev_codes()
        mapper._dev_codes_rc()
    return gen_mt()
