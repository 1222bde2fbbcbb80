"""Flat-array fast path for colour-space unpaired mapping to SAM.

The colour-space analogue of fastpath.py: the whole post-filter1 flow
stays in flat arrays plus native calls —

    filter1 (native) -> fused CS vector SW + speculative 4-layer full
    SW with on-device traceback (one launch per chunk, device-resident
    genome planes) -> pass1_select (native, hostpipe.cpp) ->
    cs_finalize_render (native, cspipe.cpp: post-SW forward-backward,
    threshold/dedup/sort, MQV, SAM text).

Output is byte-identical to the generic path (mapper._pass2_cs +
io/sam.py), which is golden-tested against gmapper-cs.  Falls back
(returns None) whenever the configuration or batch shape needs a
feature only the generic path implements (quality values, trims,
custom option sets, mixed read lengths).
"""
from __future__ import annotations

import ctypes
import time as _time
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from . import constants as C
from .config import MapperConfig, abs_or_pct
from .fastpath import FastLS, _vp
from .io.fasta import SeqRecord
from .mapper import _round_up

CS_FUSED_BATCH = 2048
# At hg-scale candidate density (hundreds of windows/read) a batch has
# millions of windows; fixed 2048-row chunks mean thousands of device
# launches per batch and the Python dispatch loop + per-launch overhead
# become the wall. Chunk size adapts to the window count, bucketed so
# only a few kernel shapes ever compile.
# bucket ladder reaches one-launch-per-batch at hg-scale density
# (8192-read batches carry ~10M windows; dozens of 32k launches per
# batch made the per-launch device round trip the wall) — ~1.5x
# spacing bounds both the padded-row tail and the number of distinct
# compiled shapes. The 2M-row cap bounds a launch's transient device
# memory; it was sized for a 16 GB device and is kept until it is
# measured on the card.
CS_CHUNK_BUCKETS = (2048, 8192, 32768, 131072, 262144, 393216, 524288,
                    786432, 1048576, 1572864, 2097152)


def _cs_chunk(n: int) -> int:
    """Pick the chunk bucket minimizing launches*overhead + pad rows
    (overhead ~1024 rows' worth of dispatch+latency per launch). A
    too-big bucket pays up to bucket-1 padded rows of the 4-5x-vec
    full DP (halved E. coli CS when 44k windows ran as 2x32768); a
    too-small one pays thousands of launches at hg density."""
    import os as _o
    env = _o.environ.get("SHRIMP_TPU_CS_FUSED_BATCH")
    if env:
        return int(env)
    best, best_cost = CS_CHUNK_BUCKETS[0], None
    for b in CS_CHUNK_BUCKETS:
        launches = -(-n // b) if n else 1
        cost = launches * 1024 + (launches * b - n)
        if best_cost is None or cost < best_cost:
            best, best_cost = b, cost
    return best


# windows/read at or above which the unpaired dispatch switches from the
# fused speculative launch to two-phase (vec, then full on survivors);
# override with SHRIMP_TPU_CS_TWO_PHASE=0/1/auto
CS_TWO_PHASE_WPR = 8


def fastpath_cs_supported(cfg: MapperConfig) -> bool:
    """Gate: the native CS renderer covers the default CS unpaired SAM
    flow (single option set, global alignment, MQV on) plus the
    renderer-level flags (--all-contigs, --sam-unaligned, --read-group,
    --sam-r2 — output-side only, they must not evict the device fast
    path)."""
    return (cfg.mode == C.MODE_COLOUR_SPACE
            and cfg.pair_mode == C.PAIR_NONE
            and len(cfg.unpaired_options()) == 1
            and not cfg.gapless
            and cfg.global_alignment
            and cfg.compute_mapping_qualities
            and not cfg.extra_sam_fields
            and not cfg.shrimp_format
            and not cfg.bfast
            and cfg.search_forward and cfg.search_reverse)


class _CSFRParams(ctypes.Structure):
    _fields_ = [("n_jobs", ctypes.c_int64), ("n_reads", ctypes.c_int64),
                ("read_len", ctypes.c_int32),
                ("steps_words", ctypes.c_int32),
                ("read_seq_len", ctypes.c_int32),
                ("sw_full_threshold", ctypes.c_double),
                ("num_outputs", ctypes.c_int32),
                ("strata", ctypes.c_int32),
                ("max_alignments", ctypes.c_int32),
                ("single_best", ctypes.c_int32),
                ("compute_mqv", ctypes.c_int32),
                ("alpha", ctypes.c_double), ("beta", ctypes.c_double),
                ("pr_xover", ctypes.c_double), ("pr_snp", ctypes.c_double),
                ("pr_del_open", ctypes.c_double),
                ("pr_del_extend", ctypes.c_double),
                ("pr_ins_open", ctypes.c_double),
                ("pr_ins_extend", ctypes.c_double),
                ("genome_len", ctypes.c_int64),
                ("genome_fwd", ctypes.c_void_p),
                ("genome_rc", ctypes.c_void_p),
                ("contig_lengths", ctypes.c_void_p),
                ("contig_name_off", ctypes.c_void_p),
                ("contig_names", ctypes.c_void_p),
                ("name_off", ctypes.c_void_p), ("names", ctypes.c_void_p),
                ("colours", ctypes.c_void_p), ("qr_tab", ctypes.c_void_p),
                ("initbp", ctypes.c_void_p), ("readseq", ctypes.c_void_p),
                ("fastq", ctypes.c_int32), ("use_read_qvs", ctypes.c_int32),
                ("qual_delta", ctypes.c_int32),
                ("use_sanger_qvs", ctypes.c_int32),
                ("quals", ctypes.c_void_p), ("cq", ctypes.c_void_p),
                ("cq_len", ctypes.c_int32),
                # renderer-level flags (cspipe.cpp tail)
                ("rg", ctypes.c_void_p), ("rg_len", ctypes.c_int32),
                ("all_contigs", ctypes.c_int32),
                ("sam_unaligned", ctypes.c_int32)]


class _CSFRJobs(ctypes.Structure):
    _fields_ = [(f, ctypes.c_void_p) for f in
                ("ri", "cn", "gen_st", "g_off", "start_abs", "score_max",
                 "packed", "steps_rev")]


def _pr_err_from_qv_py(qv: int) -> float:
    """util.h:284-293 (scalar libm math, exact vs the reference)."""
    import math
    if qv <= 0:
        return .99999999
    if qv >= 250:
        return 1e-25
    return math.pow(10.0, -qv / 10.0)


def _revcomp_cs_batch(codes: np.ndarray, initbp: np.ndarray) -> np.ndarray:
    """Vectorized encode.revcomp_cs (util.c:580-616) over [B, R] rows."""
    B, R = codes.shape
    cur = initbp.astype(np.int64).copy()
    for jc in range(R):
        c = codes[:, jc].astype(np.int64)
        even = cur % 2 == 0
        nxt = np.where(even, (4 + cur + c) % 4, (4 + cur - c) % 4)
        cur = np.where((cur != C.BASE_N) & (c <= 3), nxt, C.BASE_N)
    out = np.empty_like(codes)
    out[:, 1:] = codes[:, :0:-1]
    comp_init = C.COMPLEMENT[initbp]
    first = np.where(cur <= 3,
                     C.COLOUR_MAT[np.clip(cur, 0, 15), comp_init],
                     C.BASE_N)
    out[:, 0] = first
    return out


class FastCS:
    """Per-Mapper colour-space fast-path state."""

    def __init__(self, mapper) -> None:
        self.fls = FastLS(mapper)
        self.lib = self.fls.lib
        self.m = mapper

    def _filter1_cs(self, codes2, R: int, wlen: int, opts):
        """CS candidate generation (colour-space k-mers start at colour
        1, min_kmer_pos=1); overridable — the index-sharded mapper
        swaps in per-shard sub-index runs."""
        m = self.m
        cfg = m.config
        from .native.filter1_py import generate_candidates_native
        return generate_candidates_native(
            m.index, codes2, R, wlen, m.cutoff, opts.hit_list.match_mode,
            opts.hit_list.threshold, cfg.scores.match,
            cfg.scores.b_gap_open, cfg.scores.b_gap_extend,
            min_kmer_pos=1,
            use_region_counts=opts.anchor_list.use_region_counts,
            region_bits=cfg.region_bits,
            region_overlap=cfg.region_overlap,
            collapse=opts.anchor_list.collapse, gapless=False,
            search_strands=(True, True), threads=self.fls.f1_threads)

    # ---------------------------------------------------------- stage A
    def stage_prepare(self, records: Sequence[SeqRecord],
                      batch_cap: Optional[int] = None):
        """Encode CS batch + filter1 + fused async device dispatch.
        Returns None when the batch shape is unsupported."""
        m = self.m
        cfg = m.config
        t0 = _time.perf_counter()
        if not records:
            return None
        if cfg.trim_front or cfg.trim_end:
            return None
        if cfg.custom_unpaired_options or cfg.custom_paired_options:
            return None
        has_qual = any(r.qual is not None for r in records)
        Lseq = len(records[0].seq)
        R = Lseq - 1
        if R <= 0 or R > cfg.longest_read_len:
            return None
        try:
            buf = "".join(r.seq for r in records).encode("ascii")
        except UnicodeEncodeError:
            return None
        B = len(records)
        if len(buf) != B * Lseq:
            return None
        raw = np.frombuffer(buf, np.uint8).reshape(B, Lseq)
        quals = cq = None
        if has_qual:
            try:
                qbuf = "".join(r.qual for r in records).encode("ascii")
            except (UnicodeEncodeError, TypeError):
                return None
            # SOLiD fastq carries one qv per colour (R) or one per seq
            # char incl. the primer (R+1); scoring always reads the
            # first R (qual_vector_offset == 0, gmapper.h:79)
            if len(qbuf) == B * R:
                Lq = R
            elif len(qbuf) == B * Lseq:
                Lq = Lseq
            else:
                return None
            cq = np.frombuffer(qbuf, np.uint8).reshape(B, Lq)
            qv_full = cq.astype(np.int32) - cfg.qual_delta
            if not cfg.ignore_qvs and not cfg.no_qv_check:
                bad = (qv_full < -10) | (qv_full > 50)
                if bad.any():
                    q0 = int(qv_full[bad][0])
                    raise ValueError(
                        "The qv-offset might be set incorrectly! "
                        "Currently qvs are interpreted as PHRED+"
                        f"{cfg.qual_delta} and a qv of {q0} was "
                        "observed.")
            if not cfg.ignore_qvs and cfg.min_avg_qv >= 0:
                # avg-qv read drop (gmapper.c:455-462; C int division;
                # the sum spans the whole qual string, the divisor is
                # the colour count)
                s = qv_full.sum(axis=1, dtype=np.int64)
                avg = np.where(s < 0, -((-s) // R), s // R)
                keep = avg >= cfg.min_avg_qv
                if not keep.all():
                    records = [r for r, k in zip(records, keep) if k]
                    if not records:
                        return dict(B=0)
                    raw = np.ascontiguousarray(raw[keep])
                    cq = np.ascontiguousarray(cq[keep])
                    B = len(records)
            cq = np.ascontiguousarray(cq)
            quals = np.ascontiguousarray(cq[:, :R])
        init16 = C.CHAR_TO_INT[raw[:, 0]]
        if ((init16 < 0) | (init16 > 3)).any():
            return None
        codes16 = C.CHAR_TO_INT[raw[:, 1:]]
        if (codes16 < 0).any():
            return None
        initbp = init16.astype(np.int64)
        codes0 = codes16.astype(np.uint8)
        codes1 = _revcomp_cs_batch(codes0, initbp)
        # per-position crossover scores from qvs (gmapper.c:532-543);
        # a 256-entry LUT over raw qual chars built with libm math so
        # the DP integers match the reference exactly
        xover_tab = None
        if quals is not None and not cfg.ignore_qvs:
            import math as _math
            cal = m.cal
            lut = np.empty(256, np.int32)
            for ch in range(256):
                pe = _pr_err_from_qv_py(ch - cfg.qual_delta)
                v = int(cal.alpha * _math.log2(pe / 3.0))
                v = min(v, -1)
                v = max(v, 2 * cfg.scores.crossover)
                lut[ch] = v
            xover_tab = lut[quals]
        nm_parts = [r.name.encode() for r in records]
        offs = np.zeros(B + 1, np.int64)
        np.cumsum([len(x) for x in nm_parts], out=offs[1:])
        nm_blob = (np.frombuffer(b"".join(nm_parts), np.uint8).copy()
                   if nm_parts else np.zeros(1, np.uint8))
        wlen = int(abs_or_pct(cfg.window_len, R))
        m.stats.add_stage("read prep", _time.perf_counter() - t0)

        t1 = _time.perf_counter()
        opts = m._unpaired_opts[0]
        codes2 = np.empty((B, 2, R), np.uint8)
        codes2[:, 0] = codes0
        codes2[:, 1] = codes1
        fh = self._filter1_cs(codes2, R, wlen, opts)
        if fh is None:
            return None
        m.stats.add_stage("filter1", _time.perf_counter() - t1)

        t2 = _time.perf_counter()
        idx = m.index
        Bcap = max(batch_cap or B, B)
        from .core.sw_cs_batch import cs_layers_batch
        qr_tab = cs_layers_batch(codes0, initbp)      # [B, 4, R]
        win = None
        futures = []
        G = 32
        if fh.n:
            futures, win, G = self._fused_dispatch_cs(
                fh, codes0, qr_tab, initbp, R, Bcap, xover_tab,
                n_reads=B)
        m.stats.add_stage("device dispatch", _time.perf_counter() - t2)
        return dict(B=B, R=R, wlen=wlen, fh=fh, win=win, futures=futures,
                    G=G, codes0=codes0, qr_tab=qr_tab,
                    initbp=initbp.astype(np.int32), raw=raw, quals=quals,
                    cq=cq,
                    names=nm_blob, name_off=offs, Bcap=Bcap,
                    t_dispatch=_time.perf_counter() - t2)

    def _cs_args(self, fh, R, rcf, thresh_override, initbp):
        """Normalized CS window geometry + packed launch args
        (reverse_hit, mapping.c:254-263); shared by the single-device
        dispatch below and the mesh dispatch
        (parallel/meshmap._MeshFastCS). Returns (args_all [n,12] int32,
        win dict, G)."""
        m = self.m
        cfg = m.config
        idx = m.index
        aw = cfg.anchor_width
        n = fh.n
        coff = idx.contig_offsets[fh.cn].astype(np.int64)
        clen = idx.contig_lengths[fh.cn].astype(np.int64)
        wl64 = fh.w_len.astype(np.int64)
        if rcf is None:
            rcf = (fh.owner & 1) == 1  # unpaired CS: input_strand == 0
        g_off_t = np.where(rcf, clen - fh.g_off - wl64, fh.g_off)
        ax_t = np.where(rcf, -fh.ax + (wl64 - 1) - (fh.alen - 1)
                        - (fh.awid - 1), fh.ax)
        ay_t = np.where(rcf, -fh.ay + (R - 1) - (fh.alen - 1)
                        + (fh.awid - 1), fh.ay)
        thr = cfg.sw_full_threshold
        smax = fh.score_max.astype(np.int64)
        if thresh_override is not None:
            thresh = np.full(n, thresh_override, np.int64)
        elif thr < 0:
            thresh = np.full(n, int(-thr), np.int64)
        else:
            thresh = (smax.astype(np.float64) * (thr / 100.0)
                      ).astype(np.int64)
        win = dict(starts=coff + g_off_t, g_off_t=g_off_t, rcmask=rcf)
        G = _round_up(max(int(fh.w_len.max()), 16), 32)
        owner_ri = (fh.owner >> 1).astype(np.int64)

        args_all = np.zeros((n, 12), np.int32)
        args_all[:, 0] = win["starts"]
        args_all[:, 1] = fh.w_len
        args_all[:, 2] = owner_ri.astype(np.int32)
        args_all[:, 3] = rcf
        args_all[:, 4] = R
        args_all[:, 5] = ax_t - aw // 2
        args_all[:, 6] = ay_t + aw // 2
        args_all[:, 7] = fh.alen
        args_all[:, 8] = np.asarray(fh.awid) + aw
        args_all[:, 9] = rcf & cfg.rev_tiebreak
        args_all[:, 10] = thresh
        args_all[:, 11] = initbp[owner_ri]
        return args_all, win, G

    def _fused_dispatch_cs(self, fh, codes0, qr_tab, initbp, R, Bcap,
                           xover_tab=None, rcf=None, thresh_override=None,
                           n_reads=None):
        """Normalize window geometry (reverse_hit, mapping.c:254-263) and
        launch fused CS vec+full chunks against the device planes.

        `rcf` marks windows needing reverse_hit normalization (default:
        strand-1 windows; paired legs may be pre-flipped).
        `thresh_override` replaces the per-window full-SW zero-out
        threshold (the paired flow passes 1 so the raw DP score returns
        and context thresholds apply natively)."""
        import os as _os

        import jax

        from . import backend
        from .core.sw_cs_jax import sw_vec_cs_full_from_index
        m = self.m
        cfg = m.config
        sc = cfg.scores
        planes = m._dev_cs_planes()   # cs, cs_rc, ls, ls_rc (padded)
        n = fh.n
        args_all, win, G = self._cs_args(fh, R, rcf, thresh_override,
                                         initbp)

        CB = _cs_chunk(int(n))
        kw = dict(G=G, xover=sc.crossover, match=sc.match,
                  mismatch=sc.mismatch, a_gap_open=sc.a_gap_open,
                  a_gap_ext=sc.a_gap_extend, b_gap_open=sc.b_gap_open,
                  b_gap_ext=sc.b_gap_extend,
                  local_alignment=not cfg.global_alignment,
                  indel_taboo_len=cfg.indel_taboo_len,
                  vec_kernel=backend.vec_kernel())
        # Two-phase dispatch at high candidate density: speculative
        # full-SW on every window costs ~4-5x the vec cells, worth it
        # only when most windows survive pass1 (E.coli-scale: ~15%
        # overhead, README perf notes). At hg-scale density (~21
        # windows/read, ~2.5% pass1 survivors) it wastes ~97% of the
        # full-DP cells, so run vec-only first and full-SW on the
        # pass1 survivors from stage_finish. Both shapes produce
        # bit-identical alignments (per-row kernel math is independent
        # of chunk composition).
        tp_env = _os.environ.get("SHRIMP_TPU_CS_TWO_PHASE", "auto")
        two_phase = (n_reads is not None and tp_env != "0"
                     and (tp_env == "1"
                          or n >= CS_TWO_PHASE_WPR * max(n_reads, 1)))
        futures = []
        with m._device_ctx():
            rows = _round_up(max(Bcap, 1), 1024)
            rtab_pad = np.full((rows, R), C.BASE_N, np.uint8)
            rtab_pad[:codes0.shape[0]] = codes0
            qr_pad = np.full((rows, 4, R), C.BASE_N, np.uint8)
            qr_pad[:qr_tab.shape[0]] = qr_tab
            xov_pad = np.full((rows, R), sc.crossover, np.int32)
            if xover_tab is not None:
                xov_pad[:xover_tab.shape[0]] = xover_tab
            rtab_dev = jax.device_put(rtab_pad, m.device)
            qr_dev = jax.device_put(qr_pad, m.device)
            xov_dev = jax.device_put(xov_pad, m.device)
            phase_kw = dict(kw, phase="vec") if two_phase else kw
            for off in range(0, n, CB):
                end = min(off + CB, n)
                k = end - off
                chunk = np.zeros((CB, 12), np.int32)
                chunk[:k] = args_all[off:end]
                chunk[k:, 1] = 1   # pad rows: 1-cell windows
                chunk[k:, 4] = 1
                chunk[k:, 7] = 1
                chunk[k:, 8] = 1
                chunk[k:, 10] = 1  # threshold 1 zeroes pad scores
                chunk = jax.device_put(chunk, m.device)
                res = sw_vec_cs_full_from_index(
                    *planes, chunk, rtab_dev, qr_dev, xov_dev,
                    *(m._dev_cs_cat_words() or (None, None)),
                    **phase_kw)
                futures.append((off, k, res))
        if two_phase:
            win["two_phase"] = dict(args_all=args_all, kw=kw,
                                    rtab_dev=rtab_dev, qr_dev=qr_dev,
                                    xov_dev=xov_dev)
        cells = int(fh.w_len.astype(np.int64).sum()) * R
        m.stats.vec_invocs += n
        m.stats.vec_cells += cells
        if not two_phase:
            m.stats.full_invocs += n
            m.stats.full_cells += cells * 4
        return futures, win, G

    def _unaligned_block_cs(self, ctx, nhits) -> bytes:
        """--sam-unaligned CS records for reads with no alignments, for
        the early-return paths (same bytes cspipe emits)."""
        cfg = self.m.config
        if not cfg.sam_unaligned:
            return b""
        rg = (f"\tRG:Z:{cfg.read_group_name}".encode()
              if cfg.read_group_name else b"")
        name_off = ctx["name_off"]
        names = ctx["names"].tobytes()
        raw = ctx["raw"]
        cq = ctx.get("cq")
        fastq = ctx.get("quals") is not None
        parts = []
        for r in range(ctx["B"]):
            if nhits[r]:
                continue
            cqs = (cq[r].tobytes() if fastq and cq is not None
                   else b"*")
            parts.append(names[name_off[r]:name_off[r + 1]]
                         + b"\t4\t*\t0\t0\t*\t*\t0\t0\t*\t*\tCQ:Z:"
                         + cqs + b"\tCS:Z:" + raw[r].tobytes() + rg
                         + b"\n")
        return b"".join(parts)

    def _cs_run_full_rows(self, tp, rows, fh, R):
        """Two-phase phase B: the fused CS full launch for the given
        window rows only. Returns (packed_sel [k,12] int16, steps_sel
        [k,W] int8, W). Shared by the unpaired pass1-survivor flow and
        the paired select-then-full flow."""
        t2 = _time.perf_counter()
        import jax as _jax

        from .core.sw_cs_jax import sw_vec_cs_full_from_index
        m = self.m
        n_sel = len(rows)
        planes = m._dev_cs_planes()
        args_sel = tp["args_all"][rows]
        full_kw = dict(tp["kw"], phase="full")
        CB = _cs_chunk(int(n_sel))
        futures2 = []
        with m._device_ctx():
            for off in range(0, n_sel, CB):
                end = min(off + CB, n_sel)
                k = end - off
                chunk = np.zeros((CB, 12), np.int32)
                chunk[:k] = args_sel[off:end]
                chunk[k:, 1] = 1
                chunk[k:, 4] = 1
                chunk[k:, 7] = 1
                chunk[k:, 8] = 1
                chunk[k:, 10] = 1
                chunk = _jax.device_put(chunk, m.device)
                res = sw_vec_cs_full_from_index(
                    *planes, chunk, tp["rtab_dev"], tp["qr_dev"],
                    tp["xov_dev"],
                    *(m._dev_cs_cat_words() or (None, None)),
                    **full_kw)
                futures2.append((off, k, res))
        fetched2 = _jax.device_get([res for _, _, res in futures2])
        W = fetched2[0][1].shape[1] if futures2 else 1
        packed_sel = np.empty((n_sel, 12), np.int16)
        steps_sel = np.empty((n_sel, W), np.int8)
        for (off, k, _), (pk, st) in zip(futures2, fetched2):
            packed_sel[off:off + k] = pk[:k]
            steps_sel[off:off + k] = st[:k]
        m.stats.full_invocs += n_sel
        m.stats.full_cells += int(
            fh.w_len[rows].astype(np.int64).sum()) * R * 4
        m.stats.add_stage("device full (2ph)",
                          _time.perf_counter() - t2)
        return packed_sel, steps_sel, W

    def _cs_genome_view(self, rows, ctx):
        """Letter-plane view the native post-SW eval reads
        (`eval_hit`'s genome[gbase + jj] accesses, confined to each
        job's normalized window). Default: the whole-genome planes with
        absolute offsets. Overridable — the multi-host mapper swaps in a
        per-job window arena assembled by an owner-host exchange so no
        host ever addresses a remote shard's plane. Returns
        (genome_fwd, genome_rc, start_abs[rows], genome_len)."""
        idx = self.m.index
        return (idx.codes, idx.codes_rc,
                np.ascontiguousarray(ctx["win"]["starts"][rows]),
                int(idx.total_len))

    # ---------------------------------------------------------- stage B
    def stage_finish(self, ctx) -> Tuple[bytes, np.ndarray]:
        """Fetch fused device results, native pass1 selection, then one
        native call for post-SW + finalize + SAM text."""
        import jax

        from .fastpath import _P1In, _P1Out, _P1Params
        m = self.m
        cfg = m.config
        fls = self.fls
        B = ctx["B"]
        if B == 0:     # whole batch dropped by the avg-qv gate
            return b"", np.zeros(0, np.int32)
        fh = ctx["fh"]
        R, wlen = ctx["R"], ctx["wlen"]
        nhits = np.zeros(B, np.int32)
        m.stats.reads += B
        if fh.n == 0:
            return self._unaligned_block_cs(ctx, nhits), nhits
        n = int(fh.n)
        tp = (ctx["win"] or {}).get("two_phase")
        t0 = _time.perf_counter()
        fetched = jax.device_get([res for _, _, res in ctx["futures"]])
        scores = np.empty(n, np.int64)
        packed_all = steps_all = None
        if tp is None:
            W = fetched[0][2].shape[1]
            packed_all = np.empty((n, 12), np.int16)
            steps_all = np.empty((n, W), np.int8)
            for (off, k, _), (vec, pk, st) in zip(ctx["futures"],
                                                  fetched):
                scores[off:off + k] = vec[:k]
                packed_all[off:off + k] = pk[:k]
                steps_all[off:off + k] = st[:k]
        else:
            for (off, k, _), (vec,) in zip(ctx["futures"], fetched):
                scores[off:off + k] = vec[:k]
        dev_secs = _time.perf_counter() - t0 + ctx["t_dispatch"]
        m.stats.vec_secs += dev_secs
        m.stats.full_secs += dev_secs

        # ---- native pass1 selection on the vector scores
        t0 = _time.perf_counter()
        opts = m._unpaired_opts[0].pass1
        cap = max(n, 1)
        sel = {k: np.empty(cap, dt) for k, dt in
               (("ri", np.int32), ("gen_st", np.int8), ("cn", np.int32),
                ("g_off", np.int64), ("w_len", np.int32),
                ("score_max", np.int64), ("ax", np.int64),
                ("ay", np.int64), ("alen", np.int64), ("awid", np.int64),
                ("score_vector", np.int64), ("src", np.int64))}
        seg = np.zeros(B + 1, np.int64)
        p1 = _P1Params(
            n, 2 * B, R, wlen,
            int(abs_or_pct(opts.window_overlap, wlen)),
            float(opts.threshold), opts.min_matches, opts.num_outputs,
            1, fls.contig_lengths32.ctypes.data)
        arrs = dict(owner=np.ascontiguousarray(fh.owner, np.int64),
                    cn=np.ascontiguousarray(fh.cn, np.int32),
                    g_off=np.ascontiguousarray(fh.g_off, np.int64),
                    w_len=np.ascontiguousarray(fh.w_len, np.int32),
                    matches=np.ascontiguousarray(fh.matches, np.int32),
                    score_max=np.ascontiguousarray(fh.score_max, np.int64),
                    ax=np.ascontiguousarray(fh.ax, np.int64),
                    ay=np.ascontiguousarray(fh.ay, np.int64),
                    alen=np.ascontiguousarray(fh.alen, np.int64),
                    awid=np.ascontiguousarray(fh.awid, np.int64),
                    scores=scores)
        p1in = _P1In(**{k: _vp(v) for k, v in arrs.items()})
        p1out = _P1Out(cap, *[_vp(sel[k]) for k in
                              ("ri", "gen_st", "cn", "g_off", "w_len",
                               "score_max", "ax", "ay", "alen",
                               "awid", "score_vector")],
                       _vp(seg), _vp(sel["src"]))
        n_sel = int(self.lib.pass1_select(ctypes.byref(p1),
                                          ctypes.byref(p1in),
                                          ctypes.byref(p1out)))
        assert n_sel >= 0
        m.stats.add_stage("pass1 select", _time.perf_counter() - t0)
        if n_sel == 0:
            return self._unaligned_block_cs(ctx, nhits), nhits

        # CS pass2 runs the full SW on every selected hit (no vector
        # gate, hit_run_full_sw mapping.c:375-379): keep all rows
        rows = sel["src"][:n_sel]
        if tp is None:
            packed_sel = np.ascontiguousarray(packed_all[rows])
            steps_sel = np.ascontiguousarray(steps_all[rows])
        else:
            # two-phase: full SW only on the pass1 survivors
            packed_sel, steps_sel, W = self._cs_run_full_rows(
                tp, rows, fh, R)
        t1 = _time.perf_counter()
        idx = m.index
        cal = m.cal
        g_fwd, g_rc, start_abs_sel, g_len = self._cs_genome_view(rows,
                                                                 ctx)
        job_arrs = dict(
            ri=np.ascontiguousarray(sel["ri"][:n_sel]),
            cn=np.ascontiguousarray(sel["cn"][:n_sel]),
            gen_st=np.ascontiguousarray(sel["gen_st"][:n_sel]),
            g_off=np.ascontiguousarray(sel["g_off"][:n_sel]),
            start_abs=start_abs_sel,
            score_max=np.ascontiguousarray(sel["score_max"][:n_sel]),
            packed=packed_sel,
            steps_rev=steps_sel)
        raw = ctx["raw"]
        fr = _CSFRParams(
            n_sel, B, R, W, raw.shape[1],
            float(cfg.sw_full_threshold), cfg.num_outputs,
            int(cfg.strata), cfg.max_alignments,
            int(cfg.single_best_mapping),
            int(cfg.compute_mapping_qualities),
            cal.alpha, cal.beta, cal.pr_xover, cal.pr_mismatch,
            cal.pr_del_open, cal.pr_del_extend, cal.pr_ins_open,
            cal.pr_ins_extend,
            g_len,
            g_fwd.ctypes.data, g_rc.ctypes.data,
            fls.contig_lengths32.ctypes.data,
            fls.contig_name_off.ctypes.data,
            fls.contig_names_blob.ctypes.data,
            ctx["name_off"].ctypes.data, ctx["names"].ctypes.data,
            ctx["codes0"].ctypes.data, ctx["qr_tab"].ctypes.data,
            ctx["initbp"].ctypes.data, raw.ctypes.data,
            int(ctx.get("quals") is not None),
            int(ctx.get("quals") is not None and not cfg.ignore_qvs),
            cfg.qual_delta, 1,
            ctx["quals"].ctypes.data
            if ctx.get("quals") is not None else None,
            ctx["cq"].ctypes.data
            if ctx.get("cq") is not None else None,
            ctx["cq"].shape[1] if ctx.get("cq") is not None else 0)
        # renderer-level flags (kept out of the gate)
        rg_bytes = None
        if cfg.read_group_name:
            rg_bytes = f"\tRG:Z:{cfg.read_group_name}".encode()
            fr.rg = ctypes.cast(ctypes.c_char_p(rg_bytes),
                                ctypes.c_void_p)
            fr.rg_len = len(rg_bytes)
        fr.all_contigs = int(cfg.all_contigs)
        fr.sam_unaligned = int(cfg.sam_unaligned)
        frj = _CSFRJobs(**{k: _vp(v) for k, v in job_arrs.items()})
        cap_b = n_sel * (3 * R + 256) + 4096
        while True:
            buf = np.empty(cap_b, np.uint8)
            nb = self.lib.cs_finalize_render(
                ctypes.byref(fr), ctypes.byref(frj), _vp(buf),
                ctypes.c_int64(cap_b), _vp(nhits))
            if nb >= 0:
                break
            if nb == -2:
                raise RuntimeError("cs fastpath unsupported config")
            cap_b *= 4
        m.stats.reads_mapped += int((nhits > 0).sum())
        m.stats.alignments += int(nhits.sum())
        m.stats.add_stage("cs finalize + render",
                          _time.perf_counter() - t1)
        return buf[:nb].tobytes(), nhits


def map_unpaired_cs_sam_stream(mapper, records: Sequence[SeqRecord],
                               batch_size: Optional[int] = None,
                               lanes: Optional[int] = None
                               ) -> Optional[Iterator[bytes]]:
    """Pipelined CS unpaired mapping straight to SAM bytes; None when
    the config or batch shape needs the generic path.  Multi-lane like
    fastpath.map_unpaired_sam_stream."""
    if not fastpath_cs_supported(mapper.config):
        return None
    if batch_size is None:
        from .fastpath import auto_batch_size
        batch_size = auto_batch_size(mapper)
    fast = FastCS(mapper)
    if fast.lib is None:
        return None
    first = fast.stage_prepare(records[:batch_size], batch_cap=batch_size)
    if first is None and len(records):
        return None

    def slow_tail(off: int) -> bytes:
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
        lanes = int(_os.environ.get("SHRIMP_TPU_PIPELINE_LANES", "16"))
    if lanes > 1:
        fast.fls.f1_threads = int(_os.environ.get(
            "SHRIMP_TPU_F1_THREADS", "1"))
    if records:
        mapper._dev_cs_planes()

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
    return gen_mt()


# ===================================================================
# Colour-space paired-end fast path
# ===================================================================

def fastpath_cs_paired_supported(cfg: MapperConfig) -> bool:
    """Gate: the native paired renderer's CS mode covers the default CS
    paired SAM flow."""
    if cfg.pair_mode == C.PAIR_NONE or cfg.mode != C.MODE_COLOUR_SPACE:
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
    if cfg.bfast:
        return False
    if not (cfg.search_forward and cfg.search_reverse):
        return False
    return True


class FastPairedCS(FastCS):
    """Colour-space paired pipeline: CS encode + fused CS device launch
    (shared with FastCS), then ONE native call (pairedpipe.cpp in CS
    mode) for pair-up, paired pass1/pass2 with post-SW foot rescoring,
    half-paired fallback, paired MQV and CS SAM text."""

    def __init__(self, mapper) -> None:
        super().__init__(mapper)
        # sharded-index paired MQV recombination (same protocol as
        # fastpath.FastPaired): the hook gets per-(pair, shard)
        # partials [n_pairs, D, 9] and returns the merged [n_pairs, 7]
        self.zpair_merge_hook = None
        self.zpair_win_shard = None
        self.zpair_n_shards = 0
        self._last_zpair_merged: Optional[np.ndarray] = None

    def _cs_paired_unaligned_block(self, ctx) -> bytes:
        """--sam-unaligned records for every pair of a CS batch with no
        candidate windows (same bytes pairedpipe emits in CS mode)."""
        cfg = self.m.config
        if not cfg.sam_unaligned:
            return b""
        from .io.sam import _pair_qname
        name_off = ctx["name_off"]
        names = ctx["names"].tobytes()
        raw = ctx["raw"]
        cq = ctx.get("cq")
        fastq = ctx.get("quals") is not None
        rg = (f"\tRG:Z:{cfg.read_group_name}".encode()
              if cfg.read_group_name else b"")
        parts = []
        for pi in range(ctx["B"] // 2):
            nms = [names[name_off[2 * pi + k]:
                         name_off[2 * pi + k + 1]].decode()
                   for k in (0, 1)]
            q = _pair_qname(nms[0], nms[1]).encode()
            for nip in (0, 1):
                ri = 2 * pi + nip
                flags = 0x1 | 0x4 | 0x8 | (0x40 if nip == 0 else 0x80)
                cqs = (cq[ri].tobytes() if fastq and cq is not None
                       else b"*")
                line = (q + f"\t{flags}\t*\t0\t0\t*\t*\t0\t0\t*\t*"
                        .encode() + b"\tCQ:Z:" + cqs + b"\tCS:Z:"
                        + raw[ri].tobytes())
                if cfg.sam_r2:
                    line += (b"\tX2:Z:"
                             + raw[2 * pi + 1 - nip].tobytes())
                parts.append(line + rg + b"\n")
        return b"".join(parts)

    def _cs_genome_view_paired(self, ctx):
        """Letter-plane view for the paired native render's post-SW
        eval, over ALL windows (the paired brain may eval any plausible
        window during pair rescoring). Overridable — the multi-host
        mapper swaps in the owner-host window arena. Returns
        (genome_fwd, genome_rc, start_abs)."""
        idx = self.m.index
        return (idx.codes, idx.codes_rc,
                np.ascontiguousarray(ctx["win"]["starts"], np.int64))

    def _filter1_cs_paired(self, codes2, R: int, wlen: int, ro, mp_kw):
        """Paired CS candidate generation (colour k-mers start at colour
        1, mate-pair region filter included); overridable — the
        index-sharded mapper swaps in per-shard sub-index runs."""
        m = self.m
        cfg = m.config
        from .native.filter1_py import generate_candidates_native
        return generate_candidates_native(
            m.index, codes2, R, wlen, m.cutoff, ro.hit_list.match_mode,
            ro.hit_list.threshold, cfg.scores.match,
            cfg.scores.b_gap_open, cfg.scores.b_gap_extend,
            min_kmer_pos=1,
            use_region_counts=ro.anchor_list.use_region_counts,
            region_bits=cfg.region_bits,
            region_overlap=cfg.region_overlap,
            collapse=ro.anchor_list.collapse, gapless=False,
            search_strands=(True, True), threads=self.fls.f1_threads,
            **mp_kw)

    # ---------------------------------------------------------- stage A
    def stage_prepare(self, records: Sequence[SeqRecord],
                      batch_cap: Optional[int] = None):
        m = self.m
        cfg = m.config
        t0 = _time.perf_counter()
        if not records or len(records) % 2:
            return None
        if cfg.trim_front or cfg.trim_end:
            return None
        if cfg.custom_unpaired_options or cfg.custom_paired_options:
            return None
        has_qual = any(r.qual is not None for r in records)
        Lseq = len(records[0].seq)
        R = Lseq - 1
        if R <= 0 or R > cfg.longest_read_len:
            return None
        try:
            buf = "".join(r.seq for r in records).encode("ascii")
        except UnicodeEncodeError:
            return None
        B = len(records)
        if len(buf) != B * Lseq:
            return None
        raw = np.frombuffer(buf, np.uint8).reshape(B, Lseq)
        quals = cq = None
        if has_qual:
            try:
                qbuf = "".join(r.qual for r in records).encode("ascii")
            except (UnicodeEncodeError, TypeError):
                return None
            if len(qbuf) == B * R:
                Lq = R
            elif len(qbuf) == B * Lseq:
                Lq = Lseq
            else:
                return None
            cq = np.frombuffer(qbuf, np.uint8).reshape(B, Lq)
            qv_full = cq.astype(np.int32) - cfg.qual_delta
            if not cfg.ignore_qvs and not cfg.no_qv_check:
                bad = (qv_full < -10) | (qv_full > 50)
                if bad.any():
                    q0 = int(qv_full[bad][0])
                    raise ValueError(
                        "The qv-offset might be set incorrectly! "
                        "Currently qvs are interpreted as PHRED+"
                        f"{cfg.qual_delta} and a qv of {q0} was "
                        "observed.")
            if not cfg.ignore_qvs and cfg.min_avg_qv >= 0:
                s = qv_full.sum(axis=1, dtype=np.int64)
                avg = np.where(s < 0, -((-s) // R), s // R)
                if (avg < cfg.min_avg_qv).any():
                    return None   # pair drops: generic path handles
            cq = np.ascontiguousarray(cq)
            quals = np.ascontiguousarray(cq[:, :R])
        init16 = C.CHAR_TO_INT[raw[:, 0]]
        if ((init16 < 0) | (init16 > 3)).any():
            return None
        codes16 = C.CHAR_TO_INT[raw[:, 1:]]
        if (codes16 < 0).any():
            return None
        initbp = init16.astype(np.int64)
        codes0 = codes16.astype(np.uint8)
        codes1 = _revcomp_cs_batch(codes0, initbp)
        xover_tab = None
        if quals is not None and not cfg.ignore_qvs:
            import math as _math
            cal = m.cal
            lut = np.empty(256, np.int32)
            for ch in range(256):
                pe = _pr_err_from_qv_py(ch - cfg.qual_delta)
                v = int(cal.alpha * _math.log2(pe / 3.0))
                v = min(v, -1)
                v = max(v, 2 * cfg.scores.crossover)
                lut[ch] = v
            xover_tab = lut[quals]
        nm_parts = [r.name.encode() for r in records]
        offs = np.zeros(B + 1, np.int64)
        np.cumsum([len(x) for x in nm_parts], out=offs[1:])
        nm_blob = (np.frombuffer(b"".join(nm_parts), np.uint8).copy()
                   if nm_parts else np.zeros(1, np.uint8))
        wlen = int(abs_or_pct(cfg.window_len, R))
        # per-leg strand flips (read_reverse, gmapper.c:175-186); a
        # flipped leg's strand-0 row is the revcomp colours
        flip1, flip2 = C.PAIR_REVERSE[cfg.pair_mode]
        input_strand = np.zeros(B, np.int8)
        input_strand[0::2] = int(flip1)
        input_strand[1::2] = int(flip2)
        codes2 = np.empty((B, 2, R), np.uint8)
        flipm = input_strand == 1
        codes2[~flipm, 0] = codes0[~flipm]
        codes2[~flipm, 1] = codes1[~flipm]
        codes2[flipm, 0] = codes1[flipm]
        codes2[flipm, 1] = codes0[flipm]
        m.stats.add_stage("read prep", _time.perf_counter() - t0)

        t1 = _time.perf_counter()
        ro = m._paired_opts[0].read[0]
        mp_kw = {}
        if ro.anchor_list.use_mp_region_counts:
            from types import SimpleNamespace
            re1 = SimpleNamespace(window_len=wlen, read_len=R)
            re2 = SimpleNamespace(window_len=wlen, read_len=R)
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
        fh = self._filter1_cs_paired(codes2, R, wlen, ro, mp_kw)
        if fh is None:
            return None
        m.stats.add_stage("filter1", _time.perf_counter() - t1)

        t2 = _time.perf_counter()
        Bcap = max(batch_cap or B, B)
        from .core.sw_cs_batch import cs_layers_batch
        qr_tab = cs_layers_batch(codes0, initbp)
        win = None
        futures = []
        G = 32
        if fh.n:
            # feet run full SW in two contexts (paired 0.5x, half-paired
            # 1x): dispatch with thresh=1 so the raw DP score comes back
            # and the native code applies the context threshold
            rcf = (fh.owner & 1).astype(np.int8) != \
                input_strand[(fh.owner >> 1).astype(np.int64)]
            # n_reads enables the density-gated two-phase dispatch
            # (vec now, full SW later on the native SELECT pass's
            # rows); the mesh overrides ignore it and stay fused
            futures, win, G = self._fused_dispatch_cs(
                fh, codes0, qr_tab, initbp, R, Bcap, xover_tab,
                rcf=np.asarray(rcf, bool), thresh_override=1,
                n_reads=B)
        m.stats.add_stage("device dispatch", _time.perf_counter() - t2)
        return dict(B=B, R=R, wlen=wlen, fh=fh, win=win, futures=futures,
                    G=G, codes0=codes0, qr_tab=qr_tab,
                    initbp=initbp.astype(np.int32), raw=raw, quals=quals,
                    cq=cq, names=nm_blob, name_off=offs, Bcap=Bcap,
                    input_strand=input_strand,
                    t_dispatch=_time.perf_counter() - t2)

    # ---------------------------------------------------------- stage B
    def stage_finish(self, ctx):
        """Fetch fused device results and run the whole CS paired brain
        in one native call."""
        import jax

        from .fastpath import _PPParams, _PPWin
        m = self.m
        cfg = m.config
        fls = self.fls
        B = ctx["B"]
        if B == 0:
            return b"", np.zeros(0, np.int32), np.zeros(0, np.int32)
        fh = ctx["fh"]
        R, wlen = ctx["R"], ctx["wlen"]
        n_pairs = B // 2
        pair_nhits = np.zeros(n_pairs, np.int32)
        read_nhits = np.zeros(B, np.int32)
        m.stats.reads += B
        if fh.n == 0:
            return (self._cs_paired_unaligned_block(ctx), pair_nhits,
                    read_nhits)
        n = int(fh.n)
        tp = (ctx["win"] or {}).get("two_phase")
        t0 = _time.perf_counter()
        fetched = jax.device_get([res for _, _, res in ctx["futures"]])
        scores = np.empty(n, np.int64)
        if tp is not None:
            # select-then-full: only the vector scores exist so far
            assert self.zpair_merge_hook is None
            for (off, k, _), (vec,) in zip(ctx["futures"], fetched):
                scores[off:off + k] = vec[:k]
            packed_all = steps_all = None
            W = 1
        else:
            W = fetched[0][2].shape[1]
            packed_all = np.empty((n, 12), np.int16)
            steps_all = np.empty((n, W), np.int8)
            for (off, k, _), (vec, pk, st) in zip(ctx["futures"],
                                                  fetched):
                scores[off:off + k] = vec[:k]
                packed_all[off:off + k] = pk[:k]
                steps_all[off:off + k] = st[:k]
        dev_secs = _time.perf_counter() - t0 + ctx["t_dispatch"]
        m.stats.vec_secs += dev_secs
        m.stats.full_secs += dev_secs

        t0 = _time.perf_counter()
        win = ctx["win"]
        popts = m._paired_opts[0]
        ro = popts.read[0]
        pairing = popts.pairing
        hp = cfg.half_paired_unpaired_options(0)[0]
        from types import SimpleNamespace
        re1 = SimpleNamespace(window_len=wlen, read_len=R)
        re2 = SimpleNamespace(window_len=wlen, read_len=R)
        m._compute_mp_ranges(re1, re2, pairing)
        cal = m.cal
        sc = cfg.scores
        owner = np.ascontiguousarray(fh.owner, np.int64)
        seg = np.ascontiguousarray(
            np.searchsorted(owner, np.arange(2 * B + 1)), np.int64)
        g_fwd, g_rc, start_abs_all = self._cs_genome_view_paired(ctx)
        arrs = dict(
            seg=seg,
            cn=np.ascontiguousarray(fh.cn, np.int32),
            g_off=np.ascontiguousarray(fh.g_off, np.int64),
            g_off_norm=np.ascontiguousarray(win["g_off_t"], np.int64),
            gen_st=np.ascontiguousarray(win["rcmask"], np.int8),
            w_len=np.ascontiguousarray(fh.w_len, np.int32),
            matches=np.ascontiguousarray(fh.matches, np.int32),
            score_max=np.ascontiguousarray(fh.score_max, np.int64),
            vec=np.ascontiguousarray(scores, np.int64),
            start_abs=start_abs_all)
        if tp is None:
            arrs["cs_packed"] = np.ascontiguousarray(packed_all)
            arrs["cs_steps"] = np.ascontiguousarray(steps_all)
        idx = m.index
        import ctypes
        raw = ctx["raw"]
        quals = ctx.get("quals")
        cq = ctx.get("cq")
        p = _PPParams(
            n_pairs, n, R, wlen, W,
            (ctypes.c_int64 * 2)(int(re1.delta_g_off_min[0]),
                                 int(re1.delta_g_off_min[1])),
            (ctypes.c_int64 * 2)(int(re1.delta_g_off_max[0]),
                                 int(re1.delta_g_off_max[1])),
            ro.pass1.min_matches,
            int(abs_or_pct(ro.pass1.window_overlap, wlen)),
            float(ro.pass1.threshold),
            pairing.pass1_num_outputs, float(pairing.pass1_threshold),
            float(ro.pass2.threshold),
            float(pairing.pass2_threshold), pairing.pass2_num_outputs,
            int(pairing.strata), cfg.max_alignments,
            int(cfg.half_paired), hp.pass1.min_matches,
            int(abs_or_pct(hp.pass1.window_overlap, wlen)),
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
            None, None, None, None, None,
            1, abs(sc.crossover),
            cal.pr_xover, cal.pr_mismatch,
            cal.pr_del_open, cal.pr_del_extend, cal.pr_ins_open,
            cal.pr_ins_extend,
            int(quals is not None),
            int(quals is not None and not cfg.ignore_qvs),
            cfg.qual_delta, 1,
            g_fwd.ctypes.data, g_rc.ctypes.data,
            ctx["codes0"].ctypes.data, ctx["qr_tab"].ctypes.data,
            ctx["initbp"].ctypes.data, raw.ctypes.data, raw.shape[1],
            quals.ctypes.data if quals is not None else None,
            cq.ctypes.data if cq is not None else None,
            cq.shape[1] if cq is not None else 0)
        # renderer-level flags (RG suffix, all-contigs, sam-unaligned,
        # X2 mate seq)
        rg_keep = None
        if cfg.read_group_name:
            rg_keep = f"\tRG:Z:{cfg.read_group_name}".encode()
            p.rg = ctypes.cast(ctypes.c_char_p(rg_keep),
                               ctypes.c_void_p)
            p.rg_len = len(rg_keep)
        p.all_contigs = int(cfg.all_contigs)
        p.sam_unaligned = int(cfg.sam_unaligned)
        p.sam_r2 = int(cfg.sam_r2)
        p.una_lo = 0
        p.una_hi = n_pairs
        wstruct = _PPWin(
            **{k: _vp(v) for k, v in arrs.items()},
            packed=None, ops_pk=None)
        if tp is not None:
            # ---- select pass (vector scores only), then CS full SW
            # for just the selected rows (paired heap feet + hp heap
            # superset — pairedpipe.cpp select_only)
            t2 = _time.perf_counter()
            cap_sel = int(n_pairs) * 2 * (
                pairing.pass1_num_outputs + hp.pass1.num_outputs
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
            m.stats.add_stage("cs paired select (2ph)",
                              _time.perf_counter() - t2)

            keep_alive = {}

            def add_full(rows_f):
                """Incremental full-SW accumulation (rescue rounds add
                rows to the same arrays)."""
                nonlocal W
                if keep_alive:
                    rows_f = rows_f[keep_alive["fv"][rows_f] == 0]
                if len(rows_f) == 0:
                    return
                pk_s, st_s, W2 = self._cs_run_full_rows(tp, rows_f, fh,
                                                        R)
                if not keep_alive:
                    W = W2
                    p.ops_words = W
                    keep_alive.update(
                        pk=np.zeros((n, 12), np.int16),
                        st=np.zeros((n, W), np.int8),
                        fv=np.zeros(n, np.uint8))
                    wstruct.cs_packed = _vp(keep_alive["pk"])
                    wstruct.cs_steps = _vp(keep_alive["st"])
                    p.full_valid = keep_alive["fv"].ctypes.data
                assert W2 == W
                keep_alive["pk"][rows_f] = pk_s
                keep_alive["st"][rows_f] = st_s
                keep_alive["fv"][rows_f] = 1

            add_full(np.unique(sel_out[:nsel]).astype(np.int64))
            rescue = np.zeros(1, np.int32)
            p.rescue_flag = rescue.ctypes.data
            p.sel_out = sel_out.ctypes.data
            p.rescue_cap = cap_sel
        if self.zpair_merge_hook is not None:
            # sharded-index CS paired MQV recombination: identical
            # two-pass protocol to fastpath.FastPaired.stage_finish —
            # collect per-(pair, shard) partials, merge with the device
            # collectives, re-render with the merged values
            D = self.zpair_n_shards
            ws = np.ascontiguousarray(self.zpair_win_shard, np.int32)
            part = np.zeros((n_pairs, D, 9), np.float64)
            p.win_shard = ws.ctypes.data
            p.n_shards = D
            p.part_out = part.ctypes.data
            cap0 = max(1 << 20, n_pairs * 6 * (3 * R + 320))
            while True:
                scratch = np.empty(cap0, np.uint8)
                rv0 = int(self.lib.paired_finalize_render(
                    ctypes.byref(p), ctypes.byref(wstruct),
                    scratch.ctypes.data_as(ctypes.c_char_p), cap0,
                    _vp(pair_nhits), _vp(read_nhits)))
                if rv0 >= 0:
                    break
                cap0 *= 4
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
        cap = max(1 << 20, n_pairs * 6 * (3 * R + 320))
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
            # incremental rescue (see fastpath.FastPaired): fetch full
            # SW for exactly the recorded missing rows and re-render
            rounds = 0
            while rescue[0] and rounds < 4:
                missing = np.unique(
                    sel_out[:min(int(rescue[0]), cap_sel)]
                ).astype(np.int64)
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
                print("fastpath_cs: paired two-phase full-rows rescue",
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
        m.stats.add_stage("cs paired select + render",
                          _time.perf_counter() - t0)
        m.stats.reads_mapped += int((pair_nhits > 0).sum()) * 2
        m.stats.alignments += 2 * int(pair_nhits.sum()) \
            + int(read_nhits.sum())
        return bytes(out[:rv]), pair_nhits, read_nhits


def map_paired_cs_sam_stream(mapper, records: Sequence[SeqRecord],
                             batch_size: Optional[int] = None,
                             lanes: Optional[int] = None
                             ) -> Optional[Iterator[bytes]]:
    """Pipelined CS paired mapping straight to SAM bytes; None when the
    config needs the generic path."""
    if not fastpath_cs_paired_supported(mapper.config):
        return None
    if batch_size is None:
        from .fastpath import auto_batch_size
        batch_size = auto_batch_size(mapper)
    fast = FastPairedCS(mapper)
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
        fast.fls.f1_threads = int(_os.environ.get(
            "SHRIMP_TPU_F1_THREADS", "1"))
    if records:
        mapper._dev_cs_planes()

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
    return gen_mt()
