"""Multi-host distribution: jax.distributed + per-host sub-indexes.

The reference scales past one machine by running gmapper per genome
chunk on different machines and recombining SAM + mapping qualities
offline with mergesam (/root/reference/SPLITTING_AND_MERGING:1-160,
README:281-303, mergesam/sam_reader.c:417-520). Here that workflow is
an on-line jax program over a multi-process mesh:

- `jax.distributed.initialize` joins N processes (hosts); the global
  mesh spans every process's local devices, one genome shard per
  device. DCN carries the cross-host collectives, ICI the intra-host
  ones — both expressed with the same `shard_map` program.
- Each process builds/loads ONLY the sub-indexes of its local shards
  (`DistIndex` holds just the global contig table — a few KB — plus the
  local CSR sub-indexes; no process ever materializes the whole-genome
  postings, the RAM wall that forces sharding at hg18 scale,
  /root/reference/README:128-150).
- Each process reads the same read stream (the reference maps the full
  read set against every chunk, README:236-276) and runs filter 1
  against its local sub-indexes only.
- Candidate-window descriptors are allgathered across processes (the
  on-line analogue of mergesam reading every per-chunk SAM), merged
  into the global (owner, contig, offset) order, and the fused
  vector+full-SW launch runs as ONE shard_map program over the global
  mesh: every device scans only its own genome slice; the jitted body
  all_gathers the per-window stats so each host sees every shard's
  results (the DCN data movement).
- Selection (pass 1/2, dedup, strata) is computed identically on every
  host from the replicated stats; alignments whose indel-path traceback
  needs genome bytes are expanded by the shard's OWNING host and
  exchanged (no host touches a remote shard's genome).
- The MQV denominator z1 rides a psum over the global mesh and the
  merged value feeds the rendered MQV (ext_z1 — MAPPING_QUALITIES Part
  1c recombination as a collective).

Output is byte-identical to the single-process whole-index run, under
the same two caveats as ShardedIndexMapper (local list cutoffs,
region-boundary straddle) — the caveats the reference's own split-db
workflow carries.

Spawning (CPU validation, tests/test_dist.py): per process set
JAX_PLATFORMS=cpu, jax.config jax_num_cpu_devices=<chips/host> and
jax_cpu_collectives_implementation=gloo, then
`init_distributed("localhost:<port>", P, pid)`.
"""
from __future__ import annotations

import ctypes
import time
from typing import List, Optional, Sequence

import numpy as np

from ..config import MapperConfig
from ..fastpath import (_FSWJobs, _FSWParams, _normalize_win, _pack_args4,
                        _pack_rtab, _vp, FastPaired,
                        fastpath_paired_supported, fastpath_supported)
from ..io.fasta import SeqRecord
from ..mapper import Mapper, _round_up
from .meshmap import (SHARD_AXIS, CompositeIndex, _ShardedFastLS,
                      halo_for, zpair_collective_body)

# re-exported for callers that pre-split contigs
from .meshmap import split_contig_bins  # noqa: F401


def init_distributed(coordinator: str, num_processes: int,
                     process_id: int,
                     local_device_count: Optional[int] = None):
    """jax.distributed.initialize wrapper. On CPU validation meshes set
    `local_device_count` to the per-host device count; on GPU hosts
    leave it None (the plugin reports the local cards)."""
    import jax
    if local_device_count is not None:
        jax.config.update("jax_num_cpu_devices", int(local_device_count))
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)


def global_mesh():
    """Mesh over every process's devices, ordered (process, local id) so
    shard ownership is contiguous per host."""
    import jax
    from jax.sharding import Mesh
    devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    return Mesh(np.array(devs), (SHARD_AXIS,))


def _allgather_bytes(b: bytes) -> List[bytes]:
    """Gather one byte string from every process, in process order (the
    on-line analogue of mergesam concatenating per-machine SAM chunks in
    read order)."""
    parts = _allgather_rows(np.frombuffer(b, np.uint8).copy())
    return [p.tobytes() for p in parts]


def _slice_for(pid: int, P: int, n: int):
    """Rank pid's contiguous slice of n items (splitreads recast:
    utils/splitreads.py gives machine i every P-th chunk; contiguous
    slices keep the assembled stream in read order with one concat)."""
    per = -(-n // P)
    lo = min(pid * per, n)
    return lo, min(lo + per, n)


def _allgather_rows(arr: np.ndarray) -> List[np.ndarray]:
    """Gather one 1-D/2-D array from every process; returns the list in
    process order (ragged first dims allowed)."""
    import jax
    from jax.experimental import multihost_utils as mhu
    with jax.enable_x64(True):      # keep int64/f64 dtypes exact
        n = np.zeros(1, np.int64)
        n[0] = arr.shape[0]
        counts = np.asarray(mhu.process_allgather(n)).reshape(-1)
        mx = int(counts.max())
        pad_shape = (max(mx, 1),) + arr.shape[1:]
        padded = np.zeros(pad_shape, arr.dtype)
        padded[:arr.shape[0]] = arr
        gathered = np.asarray(mhu.process_allgather(padded))
    return [gathered[p, :int(counts[p])] for p in range(len(counts))]


class DistIndex(CompositeIndex):
    """CompositeIndex for the multi-host case: the global contig table
    comes from per-shard metadata (every host has the split manifest),
    but genome planes and CSR sub-indexes exist only for LOCAL shards.
    `codes`/`codes_rc` are deliberately absent — remote genome bytes
    are never addressable from this host."""

    def __init__(self, shard_meta: Sequence[dict], local_subs: Sequence,
                 local_shard0: int):
        # shard_meta: per shard {names: [...], lengths: np.ndarray}
        assert local_subs, "each process owns at least one shard"
        self.subs = list(local_subs)            # LOCAL only
        self.local_shard0 = local_shard0
        ref = local_subs[0]
        self.mode = ref.mode
        self.hashed = ref.hashed
        self.is_rna = ref.is_rna
        self.contig_names = []
        offs, lens = [], []
        base = 0
        D = len(shard_meta)
        self.cn_base = np.zeros(D + 1, np.int64)
        self.pos_base = np.zeros(D + 1, np.int64)
        for d, mt in enumerate(shard_meta):
            self.contig_names += list(mt["names"])
            ln = np.asarray(mt["lengths"], np.uint32)
            off = np.zeros(len(ln), np.int64)
            if len(ln) > 1:
                off[1:] = np.cumsum(ln[:-1])
            offs.append(off + base)
            lens.append(ln)
            self.cn_base[d + 1] = self.cn_base[d] + len(ln)
            self.pos_base[d + 1] = self.pos_base[d] + int(ln.sum())
            base += int(ln.sum())
        self.contig_offsets = np.concatenate(offs).astype(np.uint32)
        self.contig_lengths = np.concatenate(lens)
        self.codes = None
        self.codes_rc = None
        self.cs_codes = None
        self.cs_codes_rc = None
        self._total = base
        self._max_weight = max(si.seed.weight for si in ref.seeds)
        self._max_span = max(si.seed.span for si in ref.seeds)

    @property
    def total_len(self) -> int:
        return self._total


def _dist_filter1(m, dm, codes2, L: int, wlen: int, opts, mp_kw,
                  min_kmer_pos: int, threads: int):
    """Shared multi-host filter 1: run candidate generation against the
    LOCAL CSR sub-indexes only, allgather the per-window descriptors
    across processes, and merge into the global (owner, shard) order —
    the on-line analogue of mergesam reading every per-chunk SAM.
    Returns (FlatHits, win_shard[n]); min_kmer_pos=1 selects the
    colour-space k-mer geometry."""
    from ..core.batch_pipeline import FlatHits, _empty_flat
    from ..native.filter1_py import generate_candidates_native
    cfg = m.config
    comp: DistIndex = m.index
    loc_owner, loc_shard = [], []
    loc_fields = {k: [] for k in
                  ("g_off", "w_len", "score_window_gen", "matches",
                   "score_max", "ax", "ay", "alen", "awid")}
    loc_cn = []
    for i, sub in enumerate(comp.subs):
        d = comp.local_shard0 + i
        fh = generate_candidates_native(
            sub, codes2, L, wlen, m.cutoff,
            opts.hit_list.match_mode, opts.hit_list.threshold,
            cfg.scores.match, cfg.scores.b_gap_open,
            cfg.scores.b_gap_extend, min_kmer_pos=min_kmer_pos,
            use_region_counts=opts.anchor_list.use_region_counts,
            region_bits=cfg.region_bits,
            region_overlap=cfg.region_overlap,
            collapse=opts.anchor_list.collapse, gapless=False,
            search_strands=(True, True), threads=threads,
            **mp_kw)
        if fh is None:
            raise ValueError("batch shape outside fast-path support")
        loc_owner.append(fh.owner)
        loc_shard.append(np.full(fh.n, d, np.int64))
        loc_cn.append(fh.cn.astype(np.int64) + comp.cn_base[d])
        for k in loc_fields:
            loc_fields[k].append(getattr(fh, k))
    # pack the descriptor matrix for the cross-host allgather
    n_loc = int(sum(len(o) for o in loc_owner))
    # per-rank f1 work counter: windows generated from LOCAL shards
    # (the shard axis is what splits filter-1 work across hosts)
    dm.last_f1_local_windows = getattr(dm, "last_f1_local_windows",
                                       0) + n_loc
    desc = np.empty((n_loc, 12), np.int64)
    if n_loc:
        desc[:, 0] = np.concatenate(loc_owner)
        desc[:, 1] = np.concatenate(loc_shard)
        desc[:, 2] = np.concatenate(loc_cn)
        for ci, k in enumerate(("g_off", "w_len", "score_window_gen",
                                "matches", "score_max", "ax", "ay",
                                "alen", "awid")):
            desc[:, 3 + ci] = np.concatenate(loc_fields[k])
    parts = _allgather_rows(desc)
    allw = np.concatenate(parts, axis=0)
    n_owners = codes2.shape[0] * 2
    if allw.shape[0] == 0:
        return _empty_flat(n_owners), np.zeros(0, np.int64)
    D = dm.D
    order = np.argsort(allw[:, 0] * D + allw[:, 1], kind="stable")
    allw = allw[order]
    owner_s = allw[:, 0]
    seg = np.searchsorted(owner_s, np.arange(n_owners + 1))
    win_shard = allw[:, 1].copy()
    g = lambda c, dt: np.ascontiguousarray(allw[:, c].astype(dt))
    fh = FlatHits(owner=owner_s.copy(), cn=g(2, np.int32),
                  g_off=g(3, np.int64), w_len=g(4, np.int32),
                  score_window_gen=g(5, np.int64),
                  matches=g(6, np.int32),
                  score_max=g(7, np.int64), ax=g(8, np.int64),
                  ay=g(9, np.int64), alen=g(10, np.int64),
                  awid=g(11, np.int64),
                  seg_start=seg.astype(np.int64))
    return fh, win_shard


def _window_arena(comp: "DistIndex", shard, starts, w_len, gen_st,
                  G: int):
    """Owner-host assembly of the letter-plane window bytes the CS
    post-SW eval reads: each host extracts [start, start+w_len) from its
    LOCAL shards' fwd/rc plane (gen_st selects the plane), the rows are
    allgathered, and every host ends with the full [n, G] arena — no
    host ever addresses a remote shard's genome. Returns
    (arena [n, G] uint8, start_abs_rewritten [n] = row*G)."""
    n = len(starts)
    lo = comp.local_shard0
    hi = lo + len(comp.subs)
    sh = np.asarray(shard, np.int64)
    mine = np.nonzero((sh >= lo) & (sh < hi))[0]
    rows = np.zeros((mine.size, G), np.uint8)
    for i, t in enumerate(mine):
        sub = comp.subs[int(sh[t]) - lo]
        ls = int(starts[t] - comp.pos_base[sh[t]])
        src = sub.codes_rc if gen_st[t] else sub.codes
        k = max(0, min(int(w_len[t]), sub.total_len - ls, G))
        if k:
            rows[i, :k] = src[ls:ls + k]
    ids = np.asarray(mine, np.int64).reshape(-1, 1)
    arena = np.zeros((n, G), np.uint8)
    for p_ids, p_rows in zip(_allgather_rows(ids),
                             _allgather_rows(rows)):
        if p_ids.shape[0]:
            arena[p_ids[:, 0]] = p_rows
    return arena, np.arange(n, dtype=np.int64) * G


class _DistFastLS(_ShardedFastLS):
    """_ShardedFastLS across processes: local filter 1, allgathered
    window merge, global-mesh device step, owner-host traceback
    exchange, psum'd z1."""

    def _filter1(self, codes2, L: int, wlen: int):
        return self._filter1_dist(codes2, L, wlen,
                                  self.m._unpaired_opts[0], {})

    def _filter1_dist(self, codes2, L: int, wlen: int, opts, mp_kw):
        fh, self._win_shard = _dist_filter1(
            self.m, self.mm, codes2, L, wlen, opts, mp_kw,
            min_kmer_pos=0, threads=self.f1_threads)
        return fh

    def _stats_to_packed(self, stats, ctx2):
        """Closed-form rows expand locally (genome-free); indel /
        cross-plane rows are re-run by the banded native DP on the host
        that OWNS the window's shard, then exchanged — no host reads a
        remote shard's genome bytes."""
        m = self.m
        sc = m.config.scores
        dm = self.mm
        comp: DistIndex = m.index
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
            fb = run[rows] // 4
            rem = run[rows] % 4
            sub = np.zeros((rows.size, W), np.uint8)
            sub[np.arange(W, dtype=np.int32)[None, :] < fb[:, None]] = 255
            ii = np.nonzero(rem > 0)[0]
            sub[ii, fb[ii]] = ((1 << (2 * rem[ii])) - 1).astype(np.uint8)
            ops_pk[rows] = sub
        need = np.nonzero(pos & ~closed)[0]
        m.stats.full_host_tb += int(need.size)
        # owner-host exchange: this host expands `mine`, others theirs
        # (the paired path passes every window, no `rows` subselection)
        rows_sel = ctx2.get("rows")
        job_shard_all = (self._win_shard[rows_sel]
                         if rows_sel is not None else self._win_shard)
        job_shard = job_shard_all[need] if need.size \
            else np.zeros(0, np.int64)
        lo = comp.local_shard0
        hi = lo + len(comp.subs)
        mine = need[(job_shard >= lo) & (job_shard < hi)]

        def expand_local(sh, starts, rc, ri, glen32, ax, ay, alen, awid,
                         rev):
            """Banded native DP on windows of LOCALLY-owned shards:
            gather the genome bytes from this host's sub-indexes and
            run sw_full_tb_host. All args are per-row arrays."""
            k2 = len(sh)
            pk2 = np.zeros((k2, 10), np.int32)
            op2 = np.zeros((k2, W), np.uint8)
            if k2 == 0:
                return pk2, op2
            local_start = starts - comp.pos_base[sh]
            gpos = np.clip(local_start[:, None]
                           + np.arange(G, dtype=np.int64)[None, :],
                           0, None)
            gwin = np.empty((k2, G), np.uint8)
            for i in range(k2):
                sub = comp.subs[int(sh[i]) - lo]
                gp = np.clip(gpos[i], 0, sub.total_len - 1)
                src = sub.codes_rc if rc[i] else sub.codes
                gwin[i] = src[gp]
            read = np.ascontiguousarray(ctx2["read_tab"][ri])
            glen = np.ascontiguousarray(glen32.astype(np.int32))
            rlen = np.full(k2, L, np.int32)
            p = _FSWParams(k2, G, R, W, sc.match, sc.mismatch,
                           sc.a_gap_open, sc.a_gap_extend,
                           sc.b_gap_open, sc.b_gap_extend, 0)
            jb = _FSWJobs(_vp(np.ascontiguousarray(gwin)), _vp(glen),
                          _vp(read),
                          _vp(rlen),
                          _vp(np.ascontiguousarray(ax, np.int32)),
                          _vp(np.ascontiguousarray(ay, np.int32)),
                          _vp(np.ascontiguousarray(alen, np.int32)),
                          _vp(np.ascontiguousarray(awid, np.int32)),
                          _vp(np.ascontiguousarray(rev, np.uint8)))
            rv = self.lib.sw_full_tb_host(ctypes.byref(p),
                                          ctypes.byref(jb), _vp(pk2),
                                          _vp(op2))
            assert rv == 0, rv
            return pk2, op2

        pk2, op2 = expand_local(
            job_shard_all[mine], ctx2["starts"][mine],
            ctx2["rcmask"][mine], jobs["ri"][mine], jobs["w_len"][mine],
            ctx2["rx"][mine], ctx2["ry"][mine], ctx2["rl_"][mine],
            ctx2["rw_"][mine], ctx2["rev"][mine].astype(np.uint8))

        if not ctx2.get("rank_local_jobs"):
            # identical job lists on every rank: broadcast local
            # expansions by job index, each rank applies every part
            res_rows = np.zeros((len(mine), 1 + 10 + W), np.int64)
            if mine.size:
                res_rows[:, 0] = mine
                res_rows[:, 1:11] = pk2
                res_rows[:, 11:] = op2
            for part in _allgather_rows(res_rows):
                if part.shape[0] == 0:
                    continue
                jr = part[:, 0].astype(np.int64)
                packed[jr] = part[:, 1:11].astype(np.int32)
                ops_pk[jr] = part[:, 11:].astype(np.uint8)
            return packed, ops_pk, W

        # read-sharded (slice_select) mode: each rank's job list covers
        # only its read slice, so job indices are NOT shared — remote
        # shards' windows are shipped as explicit REQUESTS (the window
        # descriptor + origin tag), expanded by the owning host, and
        # returned tagged so only the origin applies them. Reads are
        # replicated on every host, so requests carry `ri`, not bytes.
        if mine.size:
            packed[mine] = pk2
            ops_pk[mine] = op2
        remote = need[(job_shard < lo) | (job_shard >= hi)]
        req = np.zeros((len(remote), 12), np.int64)
        if remote.size:
            req[:, 0] = self.mm.pid
            req[:, 1] = remote
            req[:, 2] = jobs["ri"][remote]
            req[:, 3] = ctx2["starts"][remote]
            req[:, 4] = job_shard_all[remote]
            req[:, 5] = ctx2["rcmask"][remote]
            req[:, 6] = jobs["w_len"][remote]
            req[:, 7] = ctx2["rx"][remote]
            req[:, 8] = ctx2["ry"][remote]
            req[:, 9] = ctx2["rl_"][remote]
            req[:, 10] = ctx2["rw_"][remote]
            req[:, 11] = ctx2["rev"][remote]
        req_all = [p for p in _allgather_rows(req) if p.shape[0]]
        req_all = (np.concatenate(req_all, axis=0) if req_all
                   else np.zeros((0, 12), np.int64))
        fme = ((req_all[:, 4] >= lo) & (req_all[:, 4] < hi)) \
            if req_all.shape[0] else np.zeros(0, bool)
        fr = req_all[fme]
        pk3, op3 = expand_local(
            fr[:, 4], fr[:, 3], fr[:, 5].astype(bool),
            fr[:, 2].astype(np.int64), fr[:, 6], fr[:, 7], fr[:, 8],
            fr[:, 9], fr[:, 10], fr[:, 11].astype(np.uint8))
        resp = np.zeros((fr.shape[0], 2 + 10 + W), np.int64)
        if fr.shape[0]:
            resp[:, 0] = fr[:, 0]
            resp[:, 1] = fr[:, 1]
            resp[:, 2:12] = pk3
            resp[:, 12:] = op3
        for part in _allgather_rows(resp):
            if part.shape[0] == 0:
                continue
            sel_own = part[part[:, 0] == self.mm.pid]
            if sel_own.shape[0] == 0:
                continue
            jr = sel_own[:, 1].astype(np.int64)
            packed[jr] = sel_own[:, 2:12].astype(np.int32)
            ops_pk[jr] = sel_own[:, 12:].astype(np.uint8)
        return packed, ops_pk, W


class _DistFastPaired(FastPaired):
    """FastPaired across processes: per-shard filter 1 (incl. the
    mate-pair region filter) on LOCAL sub-indexes, allgathered window
    merge, global-mesh fused launch, owner-host traceback exchange —
    all inherited through the _DistFastLS it carries. The paired class
    statistics ride the zpair collective over the global mesh
    (DistMapper._zpair_hook)."""

    def __init__(self, mapper, dm) -> None:
        super().__init__(mapper)
        self.fls = _DistFastLS(mapper, dm)
        self.lib = self.fls.lib

    def _filter1_paired(self, codes2, L: int, wlen: int, ro, mp_kw):
        return self.fls._filter1_dist(codes2, L, wlen, ro, mp_kw)


class _DistCSMixin:
    """Shared multi-host colour-space machinery for the CS unpaired
    (FastCS) and CS paired (FastPairedCS) pipelines: local-shard CS
    filter 1 with the cross-host descriptor allgather, the fused CS
    launch as ONE shard_map program over the GLOBAL mesh (each device
    scans its own colour/letter planes; results replicated by the
    in-program all_gather), and the owner-host window arena for the
    native post-SW eval — the on-line recast of the reference's
    "gmapper-cs per chunk + mergesam" cluster workflow
    (SPLITTING_AND_MERGING:1-160, sam_reader.c:417-520)."""

    def _fused_dispatch_cs(self, fh, codes0, qr_tab, initbp, R, Bcap,
                           xover_tab=None, rcf=None,
                           thresh_override=None, n_reads=None):
        import jax
        from jax.experimental import multihost_utils as mhu
        from jax.sharding import PartitionSpec as P
        from .. import constants as C
        m = self.m
        sc = m.config.scores
        cfg = m.config
        dm = self.mm
        comp: DistIndex = m.index
        n = int(fh.n)
        args_all, win, G = self._cs_args(fh, R, rcf, thresh_override,
                                         initbp)
        if G > dm.halo:
            raise ValueError(f"window {G} exceeds shard halo {dm.halo}")
        if G > 1023 or R > 1023:
            raise ValueError(
                f"window/read shape (G={G}, R={R}) outside the "
                "packed-IO envelope; multi-host long-read CS mapping "
                "is not supported — use MeshMapper or split reads")
        shard = self._win_shard
        local_all = win["starts"] - comp.pos_base[shard]
        order = np.argsort(shard, kind="stable")
        counts = np.bincount(shard, minlength=dm.D)
        Wcap = max(2048, 1 << int(np.ceil(np.log2(max(
            int(counts.max()), 1)))))
        d_local = dm.D // dm.P
        args_loc = np.zeros((d_local, Wcap, 12), np.int32)
        for c in (1, 4, 7, 8, 10):   # pad rows: 1-cell windows
            args_loc[:, :, c] = 1
        off = 0
        for d in range(dm.D):
            k = int(counts[d])
            sl = order[off:off + k]
            i = d - comp.local_shard0
            if 0 <= i < d_local:
                args_loc[i, :k] = args_all[sl]
                args_loc[i, :k, 0] = local_all[sl]
            off += k
        rows = _round_up(max(Bcap, 1), 1024)
        kw_key = (
            ("xover", sc.crossover), ("match", sc.match),
            ("mismatch", sc.mismatch),
            ("a_gap_open", sc.a_gap_open),
            ("a_gap_ext", sc.a_gap_extend),
            ("b_gap_open", sc.b_gap_open),
            ("b_gap_ext", sc.b_gap_extend),
            ("local_alignment", not cfg.global_alignment),
            ("indel_taboo_len", cfg.indel_taboo_len))
        step = dm._get_cs_step(G, R, Wcap, rows, kw_key)
        rtab_pad = np.full((rows, R), C.BASE_N, np.uint8)
        rtab_pad[:codes0.shape[0]] = codes0
        qr_pad = np.full((rows, 4, R), C.BASE_N, np.uint8)
        qr_pad[:qr_tab.shape[0]] = qr_tab
        xov_pad = np.full((rows, R), sc.crossover, np.int32)
        if xover_tab is not None:
            xov_pad[:xover_tab.shape[0]] = xover_tab

        def repl(a):
            return mhu.host_local_array_to_global_array(a, dm.mesh, P())
        args_dev = mhu.host_local_array_to_global_array(
            args_loc, dm.mesh, P(SHARD_AXIS))
        vec_sh, pk_sh, st_sh = step(
            dm._cs_planes_sh[0], dm._cs_planes_sh[1],
            dm._cs_planes_sh[2], dm._cs_planes_sh[3],
            args_dev, repl(rtab_pad), repl(qr_pad), repl(xov_pad))
        # ragged cross-host merge: trim each LOCAL shard's rows to its
        # true count, exchange only valid rows (process order == shard
        # order), scatter back to the global window order — the same
        # no-padding protocol as the LS stats merge
        import time as _t
        t1 = _t.time()
        loc = {}
        for name, arr in (("vec", vec_sh), ("pk", pk_sh),
                          ("st", st_sh)):
            parts_loc = []
            for s in arr.addressable_shards:
                d = int(s.index[0].start or 0)
                parts_loc.append(
                    (d, np.asarray(s.data)[0, :int(counts[d])]))
            parts_loc.sort(key=lambda x: x[0])
            cat = (np.concatenate([pp for _, pp in parts_loc])
                   if parts_loc else None)
            gathered = _allgather_rows(np.ascontiguousarray(cat))
            allrows = np.concatenate(gathered, axis=0)
            dm.merge_bytes += int(allrows.nbytes)
            full = np.zeros((n,) + allrows.shape[1:], allrows.dtype)
            full[order] = allrows
            loc[name] = full
        dm.merge_secs += _t.time() - t1
        res = (loc["vec"], loc["pk"], loc["st"])
        cells = int(fh.w_len.astype(np.int64).sum()) * R
        m.stats.vec_invocs += n
        m.stats.vec_cells += cells
        m.stats.full_invocs += n
        m.stats.full_cells += cells * 4
        return [(0, n, res)], win, G

    def _cs_genome_view(self, rows, ctx):
        """Unpaired: arena over the pass-1-selected jobs only."""
        fh = ctx["fh"]
        shard = self._win_shard[rows]
        arena, sabs = _window_arena(
            self.m.index, shard, ctx["win"]["starts"][rows],
            fh.w_len[rows], np.asarray(ctx["win"]["rcmask"])[rows],
            ctx["G"])
        self._arena_keep = arena    # keep alive through the native call
        return arena, arena, sabs, int(arena.size)

    def _cs_genome_view_paired(self, ctx):
        """Paired: arena over ALL windows (the paired brain may eval
        any plausible window during pair rescoring)."""
        fh = ctx["fh"]
        arena, sabs = _window_arena(
            self.m.index, self._win_shard, ctx["win"]["starts"],
            fh.w_len, np.asarray(ctx["win"]["rcmask"]), ctx["G"])
        self._arena_keep = arena
        return arena, arena, sabs


def _DistFastCS(mapper, dm):
    """Multi-host CS unpaired pipeline (factory: lazy FastCS import).
    MQV note: the window set is allgathered before selection, so each
    read's z1 denominator (Part 1c) is already the complete cross-shard
    sum when cs_finalize_render computes it locally — no separate
    collective is needed for byte-identity."""
    from ..fastpath_cs import FastCS

    class _Impl(_DistCSMixin, FastCS):
        def __init__(self, mapper, dm) -> None:
            super().__init__(mapper)
            self.mm = dm
            self._win_shard = None

        def _filter1_cs(self, codes2, R: int, wlen: int, opts):
            fh, self._win_shard = _dist_filter1(
                self.m, self.mm, codes2, R, wlen, opts, {},
                min_kmer_pos=1, threads=self.fls.f1_threads)
            return fh

    return _Impl(mapper, dm)


def _DistFastPairedCS(mapper, dm):
    """Multi-host CS paired pipeline (factory: lazy import). The paired
    class statistics ride the zpair collective over the global mesh
    (DistMapper._zpair_hook), consumed by the native render's ext_in
    path — MAPPING_QUALITIES Part 2c as a DCN collective."""
    from ..fastpath_cs import FastPairedCS

    class _Impl(_DistCSMixin, FastPairedCS):
        def __init__(self, mapper, dm) -> None:
            super().__init__(mapper)
            self.mm = dm
            self._win_shard = None

        def _filter1_cs_paired(self, codes2, R: int, wlen: int, ro,
                               mp_kw):
            fh, self._win_shard = _dist_filter1(
                self.m, self.mm, codes2, R, wlen, ro, mp_kw,
                min_kmer_pos=1, threads=self.fls.f1_threads)
            return fh

    return _Impl(mapper, dm)


class DistMapper:
    """Multi-host mapping session (one instance per process). See the
    module docstring for the wire plan."""

    def __init__(self, shard_meta: Sequence[dict], local_subs: Sequence,
                 config: Optional[MapperConfig] = None, mesh=None,
                 halo: Optional[int] = None):
        import jax
        from jax.experimental import multihost_utils as mhu
        from jax.sharding import NamedSharding, PartitionSpec as P
        self.mesh = mesh if mesh is not None else global_mesh()
        self.D = int(self.mesh.devices.size)
        self.P = jax.process_count()
        self.pid = jax.process_index()
        assert self.D == len(shard_meta), \
            "one shard per global device"
        d_local = self.D // self.P
        assert len(local_subs) == d_local
        self.local_shard0 = self.pid * d_local
        cfg = config or MapperConfig()
        self.halo = halo if halo is not None else halo_for(cfg)
        comp = DistIndex(shard_meta, local_subs, self.local_shard0)
        self.comp = comp
        if cfg.pair_mode and cfg.pair_mode != "none":
            from ..paired import PairedMapper
            self.m = PairedMapper(comp, cfg)
        else:
            self.m = Mapper(comp, cfg)
        S = _round_up(
            int(max(np.asarray(m["lengths"], np.int64).sum()
                    for m in shard_meta)) + self.halo, 256)
        self.S = S
        rows = np.full((d_local, S), 254, np.uint8)
        rows_rc = np.full((d_local, S), 254, np.uint8)
        for i, s in enumerate(local_subs):
            rows[i, :s.total_len] = s.codes
            rows_rc[i, :s.total_len] = s.codes_rc
        self._fwd_sh = mhu.host_local_array_to_global_array(
            rows, self.mesh, P(SHARD_AXIS))
        self._rc_sh = mhu.host_local_array_to_global_array(
            rows_rc, self.mesh, P(SHARD_AXIS))
        # colour-space planes (cs, cs_rc, ls, ls_rc), one LOCAL shard
        # per device row, assembled into the global sharded arrays
        self._cs_planes_sh = None
        if local_subs[0].cs_codes is not None:
            planes = []
            for field in ("cs_codes", "cs_codes_rc", "codes",
                          "codes_rc"):
                rp = np.full((d_local, S), 254, np.uint8)
                for i, s in enumerate(local_subs):
                    rp[i, :s.total_len] = getattr(s, field)
                planes.append(mhu.host_local_array_to_global_array(
                    rp, self.mesh, P(SHARD_AXIS)))
            self._cs_planes_sh = tuple(planes)
        self._step_cache = {}
        import threading
        self._lock = threading.Lock()
        self.last_z1_merged: Optional[np.ndarray] = None
        self.last_zpair_merged: Optional[np.ndarray] = None
        self.last_slice_jobs = 0       # read_sharding: jobs this rank
        self.last_f1_local_windows = 0  # f1 windows from LOCAL shards
        self.last_render_wall = 0.0    # read_sharding: render seconds
        self.merge_bytes = 0           # cross-host stats-merge bytes
        self.merge_secs = 0.0          # host time in the ragged merge

    # ------------------------------------------------------ device step
    def _get_step(self, G, L, Wcap, kw_key):
        key = (G, L, Wcap, kw_key)
        with self._lock:
            fn = self._step_cache.get(key)
        if fn is not None:
            return fn
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P
        from .. import backend
        from ..core.sw_jax import sw_vec_full_stats_packed
        kw = dict(kw_key)
        vec_kernel = backend.vec_kernel()

        def body(fwd, rc, args, rtab_pk):
            pk3, = sw_vec_full_stats_packed.__wrapped__(
                fwd[0], rc[0], args[0], rtab_pk, G=G, L=L,
                local_alignment=False, vec_kernel=vec_kernel,
                phase="fused", **kw)
            # per-shard output: each host fetches only its LOCAL
            # shards' rows and the cross-host merge is a RAGGED host
            # exchange of the valid rows (no O(D * max-per-shard)
            # padding crosses hosts)
            return pk3[None]

        fn = jax.jit(
            jax.shard_map(body, mesh=self.mesh,
                          in_specs=(P(SHARD_AXIS), P(SHARD_AXIS),
                                    P(SHARD_AXIS), P()),
                          out_specs=P(SHARD_AXIS), check_vma=False),
            out_shardings=NamedSharding(
                self.mesh, jax.sharding.PartitionSpec(SHARD_AXIS)))
        with self._lock:
            self._step_cache[key] = fn
        return fn

    def _get_cs_step(self, G, R, Wcap, rows, kw_key):
        """CS device step over the GLOBAL mesh with PER-SHARD outputs:
        each host fetches only its local shards' (vec, packed, steps)
        rows, and the cross-host merge is the same ragged host exchange
        the LS path uses (no O(D*Wcap) padded all_gather over DCN)."""
        key = ("csd", G, R, Wcap, rows, kw_key)
        with self._lock:
            fn = self._step_cache.get(key)
        if fn is not None:
            return fn
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P
        from .. import backend
        from ..core.sw_cs_jax import sw_vec_cs_full_from_index
        kw = dict(kw_key)
        kw.update(vec_kernel=backend.vec_kernel(), phase="fused", G=G)

        def body(p0, p1, p2, p3, args, rtab, qr, xov):
            vec, pk, st = sw_vec_cs_full_from_index.__wrapped__(
                p0[0], p1[0], p2[0], p3[0], args[0], rtab, qr, xov,
                **kw)
            return vec[None], pk[None], st[None]

        fn = jax.jit(
            jax.shard_map(body, mesh=self.mesh,
                          in_specs=(P(SHARD_AXIS), P(SHARD_AXIS),
                                    P(SHARD_AXIS), P(SHARD_AXIS),
                                    P(SHARD_AXIS), P(), P(), P()),
                          out_specs=(P(SHARD_AXIS),) * 3,
                          check_vma=False),
            out_shardings=(NamedSharding(
                self.mesh, jax.sharding.PartitionSpec(SHARD_AXIS)),) * 3)
        with self._lock:
            self._step_cache[key] = fn
        return fn

    def _dispatch(self, m, fh, read_tab: np.ndarray, L: int, R: int,
                  rcf: np.ndarray, n_reads=None):
        import jax
        from jax.experimental import multihost_utils as mhu
        from jax.sharding import PartitionSpec as P
        sc = m.config.scores
        n = int(fh.n)
        win, G = _normalize_win(m, fh, L, rcf)
        if G > self.halo:
            raise ValueError(f"window {G} exceeds halo {self.halo}")
        if G > 4095 or R > 4095 or int(fh.w_len.max()) >= (1 << 14):
            # remote shards' genome bytes are unreachable from this
            # host, so there is no single-device fallback here; fail
            # loudly and synchronously on every rank
            raise ValueError(
                f"window/read shape (G={G}, R={R}) outside the "
                "packed-IO envelope; multi-host long-read mapping is "
                "not supported — use MeshMapper or split reads")
        shard = self._fast._win_shard
        starts = win["starts"] - self.comp.pos_base[shard]
        order = np.argsort(shard, kind="stable")
        counts = np.bincount(shard, minlength=self.D)
        Wcap = max(2048, 1 << int(np.ceil(np.log2(max(
            int(counts.max()), 1)))))
        d_local = self.D // self.P
        args_loc = np.empty((d_local, Wcap, 4), np.int32)
        off = 0
        for d in range(self.D):
            k = int(counts[d])
            i = d - self.local_shard0
            if 0 <= i < d_local:
                sl = order[off:off + k]
                args_loc[i] = _pack_args4(
                    Wcap, k, starts[sl], win["glen"][sl], win["ri"][sl],
                    win["rcmask"][sl], win["rx"][sl], win["ry"][sl],
                    win["rl_"][sl], win["rw_"][sl], win["rev"][sl])
            off += k
        kw_key = (("match", sc.match), ("mismatch", sc.mismatch),
                  ("a_gap_open", sc.a_gap_open),
                  ("a_gap_ext", sc.a_gap_extend),
                  ("b_gap_open", sc.b_gap_open),
                  ("b_gap_ext", sc.b_gap_extend))
        step = self._get_step(G, L, Wcap, kw_key)
        args_dev = mhu.host_local_array_to_global_array(
            args_loc, self.mesh, P(SHARD_AXIS))
        rtab_dev = mhu.host_local_array_to_global_array(
            _pack_rtab(read_tab), self.mesh, P())
        pk3_sh = step(self._fwd_sh, self._rc_sh, args_dev, rtab_dev)
        win["packed_io"] = True
        win["shard"] = shard

        def fetch(futures):
            """Ragged cross-host stats merge: trim each LOCAL shard's
            [Wcap, 3] rows to its true count, exchange only the valid
            rows (process order == shard order: shards are contiguous
            per host), and scatter back to the global window order.
            Per-batch exchanged bytes + merge seconds are recorded in
            merge_bytes / merge_secs."""
            t1 = time.time()
            parts_loc = []
            for s in pk3_sh.addressable_shards:
                d = int(s.index[0].start or 0)
                parts_loc.append(
                    (d, np.asarray(s.data)[0, :int(counts[d])]))
            parts_loc.sort(key=lambda x: x[0])
            loc = (np.concatenate([p for _, p in parts_loc])
                   if parts_loc else np.zeros((0, 3), np.int32))
            gathered = _allgather_rows(np.ascontiguousarray(loc))
            allrows = np.concatenate(gathered, axis=0)
            self.merge_bytes += int(allrows.nbytes)
            flat = np.empty((n, 3), np.int32)
            flat[order] = allrows
            self.merge_secs += time.time() - t1
            return [(flat,)]
        win["fetch"] = fetch
        m.stats.vec_invocs += n
        cells = int(fh.w_len.astype(np.int64).sum()) * L
        m.stats.vec_cells += cells
        m.stats.full_invocs += n
        m.stats.full_cells += cells
        return [(0, n, None)], win, G, True

    def _z1_hook(self, fast):
        import jax
        from jax.experimental import multihost_utils as mhu
        from jax.sharding import NamedSharding, PartitionSpec as P

        def hook(posteriors, job_ri, job_rows, B):
            """Cross-host MQV denominator (Part 1c): this host
            contributes ONLY its own shards' z1 partial rows; the psum
            over the global mesh assembles the true denominator, and
            its output is what the render divides by."""
            d_local = self.D // self.P
            zloc = np.zeros((d_local, B), np.float64)
            sh = fast._win_shard[job_rows]
            loc = (sh >= self.local_shard0) \
                & (sh < self.local_shard0 + d_local)
            np.add.at(zloc,
                      (sh[loc] - self.local_shard0,
                       job_ri[loc].astype(np.int64)), posteriors[loc])
            with jax.enable_x64(True):
                zg = mhu.host_local_array_to_global_array(
                    zloc, self.mesh, P(SHARD_AXIS))
                out = jax.jit(
                    jax.shard_map(
                        lambda z: jax.lax.psum(z[0], SHARD_AXIS),
                        mesh=self.mesh, in_specs=(P(SHARD_AXIS),),
                        out_specs=P(None), check_vma=False),
                    out_shardings=NamedSharding(self.mesh, P()))(zg)
                merged = np.asarray(jax.device_get(out))
            self.last_z1_merged = merged
            return merged
        return hook

    # ------------------------------------------------------- public API
    def map_unpaired_sam(self, records: Sequence[SeqRecord],
                         batch_size: int = 8192,
                         read_sharding: bool = False) -> bytes:
        """Every process returns the identical SAM bytes; emit rank 0's.

        With `read_sharding`, the host-side finalize + render runs only
        for this rank's 1/P read slice of each batch (selection and the
        owner-host expansion still cover the full batch, so each sliced
        read's job set spans every shard and its MQV denominator is
        complete without a collective). The per-rank slice bytes are
        exchanged and concatenated in rank order, so the returned
        stream is still the full, identical SAM on every rank — but
        the dominant host work (selection maths aside) is 1/P per rank,
        which is what makes reads/s scale with hosts (the reference's
        cluster recipe shards reads the same way,
        /root/reference/README:236-276, utils/splitreads.py)."""
        from .. import constants as C
        if self.m.config.mode == C.MODE_COLOUR_SPACE:
            return self._map_unpaired_cs(records, batch_size)
        if not fastpath_supported(self.m.config):
            raise ValueError("config outside the fast-path envelope")
        fast = _DistFastLS(self.m, self)
        self._fast = fast
        fast.dispatch_fn = self._dispatch
        if self.m.config.compute_mapping_qualities and not read_sharding:
            fast.z1_merge_hook = self._z1_hook(fast)
        out: List[bytes] = []
        t0 = time.time()
        self.last_render_wall = 0.0
        for off in range(0, len(records), batch_size):
            batch = records[off:off + batch_size]
            ctx = fast.stage_prepare(batch, batch_cap=batch_size)
            if ctx is None:
                raise ValueError("batch shape outside fast-path support")
            if read_sharding:
                fast.read_slice = _slice_for(self.pid, self.P,
                                             len(batch))
                fast.slice_select = True
                t1 = time.time()
                mine = fast.stage_finish(ctx)[0]
                self.last_render_wall += time.time() - t1
                out.append(b"".join(_allgather_bytes(mine)))
            else:
                out.append(fast.stage_finish(ctx)[0])
        self.last_slice_jobs = fast.last_slice_jobs
        self.last_wall = time.time() - t0
        return b"".join(out)

    def _map_unpaired_cs(self, records: Sequence[SeqRecord],
                         batch_size: int) -> bytes:
        """Multi-host colour-space unpaired mapping: per-LOCAL-shard CS filter 1, cross-host descriptor
        allgather, fused CS launch over the global mesh, owner-host
        window arena for the native post-SW eval — the flagship 36bp-CS
        workload on the flagship distribution tier, byte-identical on
        every rank to the single-process CS fast path. (z1 needs no
        collective here: the allgathered window set makes each read's
        local Part 1c sum already complete.)"""
        from ..fastpath_cs import fastpath_cs_supported
        if not fastpath_cs_supported(self.m.config) \
                or self._cs_planes_sh is None:
            raise ValueError("config outside the CS fast-path envelope")
        fast = _DistFastCS(self.m, self)
        self._fast = fast
        out: List[bytes] = []
        t0 = time.time()
        for off in range(0, len(records), batch_size):
            ctx = fast.stage_prepare(records[off:off + batch_size],
                                     batch_cap=batch_size)
            if ctx is None:
                raise ValueError("batch shape outside fast-path support")
            out.append(fast.stage_finish(ctx)[0])
        self.last_wall = time.time() - t0
        return b"".join(out)

    def _map_paired_cs(self, records: Sequence[SeqRecord],
                       batch_size: int) -> bytes:
        """Multi-host colour-space paired mapping: same dist CS wiring
        plus the zpair collective over the global mesh feeding the
        native paired render (ext_in, pairedpipe.cpp in CS mode) —
        gmapper-cs paired per chunk + mergesam recombination as one
        on-line program (SPLITTING_AND_MERGING, sam_reader.c:417-520)."""
        from ..fastpath_cs import fastpath_cs_paired_supported
        if not fastpath_cs_paired_supported(self.m.config) \
                or self._cs_planes_sh is None:
            raise ValueError("config outside the CS paired fast-path"
                             " envelope")
        if batch_size % 2:
            batch_size += 1
        fp = _DistFastPairedCS(self.m, self)
        self._fast = fp
        if self.m.config.compute_mapping_qualities:
            fp.zpair_n_shards = self.D
            fp.zpair_merge_hook = self._zpair_hook()
        out: List[bytes] = []
        t0 = time.time()
        for off in range(0, len(records), batch_size):
            ctx = fp.stage_prepare(records[off:off + batch_size],
                                   batch_cap=batch_size)
            if ctx is None:
                raise ValueError("batch shape outside fast-path support")
            fp.zpair_win_shard = fp._win_shard
            out.append(fp.stage_finish(ctx)[0])
        self.last_wall = time.time() - t0
        return b"".join(out)

    def _zpair_hook(self):
        import jax
        from jax.experimental import multihost_utils as mhu
        from jax.sharding import NamedSharding, PartitionSpec as P

        def hook(part):
            """Cross-host paired Z recombination (Part 2c): every host
            computed the per-(pair, shard) partials from the replicated
            stats; each contributes its LOCAL shards' rows and the
            global-mesh collective (psum/pmin/argmax) assembles the
            merged class statistics the render consumes."""
            d_local = self.D // self.P
            loc = np.ascontiguousarray(
                part.transpose(1, 0, 2)[self.local_shard0:
                                        self.local_shard0 + d_local])
            with jax.enable_x64(True):
                zg = mhu.host_local_array_to_global_array(
                    loc, self.mesh, P(SHARD_AXIS))
                out = jax.jit(
                    jax.shard_map(
                        lambda z: zpair_collective_body(z[0]),
                        mesh=self.mesh, in_specs=(P(SHARD_AXIS),),
                        out_specs=P(None), check_vma=False),
                    out_shardings=NamedSharding(self.mesh, P()))(zg)
                merged = np.asarray(jax.device_get(out))
            self.last_zpair_merged = merged
            return merged
        return hook

    def map_paired_sam(self, records: Sequence[SeqRecord],
                       batch_size: int = 8192,
                       read_sharding: bool = False) -> bytes:
        """Paired mapping across hosts: local-shard filter 1 + mp
        region filter, allgathered windows, one global-mesh fused
        launch, and the paired MQV class statistics merged by the
        zpair collective over DCN — byte-identical on every rank to the
        single-process whole-index paired run.

        With `read_sharding`, the native paired brain (pair-up, paired
        pass1/pass2, MQV, render) runs only for this rank's 1/P pair
        slice; each sliced pair's windows span every shard so the class
        statistics are complete without the zpair collective. Slice
        bytes are exchanged and concatenated in rank order."""
        from .. import constants as C
        if self.m.config.mode == C.MODE_COLOUR_SPACE:
            return self._map_paired_cs(records, batch_size)
        if not fastpath_paired_supported(self.m.config):
            raise ValueError("config outside the paired fast-path"
                             " envelope")
        if batch_size % 2:
            batch_size += 1
        fp = _DistFastPaired(self.m, self)
        self._fast = fp.fls
        fp.fls.dispatch_fn = self._dispatch
        if self.m.config.compute_mapping_qualities and not read_sharding:
            fp.zpair_n_shards = self.D
            fp.zpair_merge_hook = self._zpair_hook()
        out: List[bytes] = []
        t0 = time.time()
        self.last_render_wall = 0.0
        for off in range(0, len(records), batch_size):
            batch = records[off:off + batch_size]
            ctx = fp.stage_prepare(batch, batch_cap=batch_size)
            if ctx is None:
                raise ValueError("batch shape outside fast-path support")
            if read_sharding:
                fp.read_slice = _slice_for(self.pid, self.P,
                                           len(batch) // 2)
                fp.slice_select = True
                t1 = time.time()
                mine = fp.stage_finish(ctx)[0]
                self.last_render_wall += time.time() - t1
                out.append(b"".join(_allgather_bytes(mine)))
            else:
                fp.zpair_win_shard = fp.fls._win_shard
                out.append(fp.stage_finish(ctx)[0])
        self.last_slice_jobs = fp.last_slice_jobs
        self.last_wall = time.time() - t0
        return b"".join(out)
