"""On-line sharded mapping: the product pipeline over a device mesh.

SHRiMP2 scales out by splitting the genome into RAM-sized chunks,
mapping each chunk in its own process, and recombining SAM + mapping
qualities offline with mergesam (SPLITTING_AND_MERGING:1-160,
mergesam/sam_reader.c:417-520). Here the genome becomes a
`jax.sharding.Mesh` axis: the packed genome planes are range-sharded
(with an overlap halo) across the devices, every batch's candidate
windows are routed to the device that owns their genome range, and ONE
`shard_map` launch per batch runs the real fused filter-2 + filter-3
kernels (core/sw_jax.sw_vec_full_stats_packed) on every shard
concurrently — the same launch the single-device fast path uses. The
host then merges the per-shard results back into the original window
order and runs the identical native selection/finalize, so the SAM
stream is byte-identical to the unsharded run by construction.

Cross-shard Z statistics ride the same collectives mergesam's algebra
prescribes (not_in_dist/MAPPING_QUALITIES Parts 1c/2c): z1 (the
posterior-sum MQV denominator, output.c:777-793) is a `psum` over the
shard axis (`zmerge_psum`); the paired class statistics merge with
`zpair_merge` (psum for the additive z1/z2/z3/insert terms, pmin for
the pair prior — "the min becomes a max" in neg-log space — and an
argmax-of-best-posterior selection for the z4 leg priors). In the
index-sharded modes these collectives are load-bearing: their outputs
are the denominators the rendered MQVs divide by (ext_z1 / ext_in
paths in native/hostpipe.cpp and native/pairedpipe.cpp).
"""
from __future__ import annotations

import functools
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..config import MapperConfig
from ..fastpath import (FastLS, FastPaired, _normalize_win, _pack_args4,
                        _pack_rtab, fastpath_paired_supported,
                        fastpath_supported)
from ..io.fasta import SeqRecord
from ..mapper import Mapper, _round_up

SHARD_AXIS = "index_shard"


def make_mesh(devices=None):
    import jax
    from jax.sharding import Mesh
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.array(devices), (SHARD_AXIS,))


def zmerge_psum(mesh, zrows: np.ndarray) -> np.ndarray:
    """Cross-shard additive Z recombination as an on-device collective:
    zrows [D, ...] holds each shard's partial statistic rows (z1 / z3 /
    insert-size denominator — the literal sums of MAPPING_QUALITIES
    Parts 1c/2c, sam_reader.c:456-509); returns the psum-merged rows.
    """
    import jax
    from jax.sharding import PartitionSpec as P

    with jax.enable_x64(True):   # Z stats are f64 end to end
        out = jax.jit(jax.shard_map(
            lambda z: jax.lax.psum(z[0], SHARD_AXIS)[None], mesh=mesh,
            in_specs=(P(SHARD_AXIS),), out_specs=P(SHARD_AXIS),
            check_vma=False))(zrows)
        return np.asarray(out)[0]


def zpair_merge(mesh, zrows: np.ndarray) -> np.ndarray:
    """Cross-shard paired Z recombination (MAPPING_QUALITIES Part 2c,
    pairedpipe.cpp PPParams tail): zrows [D, n_pairs, 9] holds each
    shard's partial rows [z1a, z1b, ins_denom, z3, best_post_a, z4a,
    best_post_b, z4b, pr2_min]. Additive columns psum; pr2 pmins ("the
    min becomes a max" in neg-log space); the z4 class priors merge by
    argmax of best posterior (first shard wins ties — the whole-run
    first-max rule, output.c:796). Returns merged [n_pairs, 7]:
    [z1a, z1b, ins_denom, z3, z4a, z4b, pr2_pre]."""
    import jax
    from jax.sharding import PartitionSpec as P

    with jax.enable_x64(True):
        res = jax.jit(jax.shard_map(
            lambda z: zpair_collective_body(z[0])[None], mesh=mesh,
            in_specs=(P(SHARD_AXIS),),
            out_specs=P(SHARD_AXIS), check_vma=False))(zrows)
        return np.asarray(res)[0]


def zpair_collective_body(loc):
    """shard_map body for the paired Z recombination: `loc` [n, 9] is
    this shard's partial rows; returns the collective-merged [n, 7]
    (identical on every shard). Shared by the single-host
    ShardedIndexMapper and the multi-host DistMapper."""
    import jax
    import jax.numpy as jnp
    add = jax.lax.psum(loc[:, :4], SHARD_AXIS)
    pr2 = jax.lax.pmin(loc[:, 8], SHARD_AXIS)
    ba = jax.lax.all_gather(loc[:, 4], SHARD_AXIS)   # [D, n]
    za = jax.lax.all_gather(loc[:, 5], SHARD_AXIS)
    bb = jax.lax.all_gather(loc[:, 6], SHARD_AXIS)
    zb = jax.lax.all_gather(loc[:, 7], SHARD_AXIS)
    ia = jnp.argmax(ba, axis=0)
    ib = jnp.argmax(bb, axis=0)
    z4a = jnp.where(jnp.max(ba, axis=0) < 0.0, 1.0,
                    jnp.take_along_axis(za, ia[None], 0)[0])
    z4b = jnp.where(jnp.max(bb, axis=0) < 0.0, 1.0,
                    jnp.take_along_axis(zb, ib[None], 0)[0])
    return jnp.concatenate([add, z4a[:, None], z4b[:, None],
                            pr2[:, None]], axis=1)


def halo_for(cfg: MapperConfig, read_len: Optional[int] = None) -> int:
    """Shard halo derived from the config's maximum window length
    (a fixed 2048 halo would reject long-read runs).
    Windows gather up to the next power of two of the window length, so
    the halo must cover that."""
    from ..config import abs_or_pct
    L = read_len if read_len is not None else cfg.longest_read_len
    wl = int(abs_or_pct(cfg.window_len, L)) + 8
    h = 2048
    while h < wl:
        h *= 2
    return h


def split_contig_bins(contigs: Sequence[tuple], D: int) -> List[List]:
    """Contiguous greedy split of [(name, codes)] into D bins balanced
    by length (split-db bin packing, utils/split-db.py recast): bin d
    gets a consecutive contig range, so global contig numbering is the
    concatenation of the bins'."""
    total = sum(len(c) for _, c in contigs)
    per = -(-total // D)
    bins: List[List] = [[] for _ in range(D)]
    d = 0
    acc = 0
    for item in contigs:
        if acc >= per and d < D - 1 and bins[d]:
            d += 1
            acc = 0
        bins[d].append(item)
        acc += len(item[1])
    return bins


class CompositeIndex:
    """Duck-typed GenomeIndex over per-shard sub-indexes.

    Exposes the small global structures the host pipeline needs (contig
    table, concatenated genome planes) while the CSR inverted indexes —
    the dominant RAM cost, README:128-150's L*K*4-byte postings — stay
    per-shard, each destined for its own device/host. `seeds` is
    deliberately ABSENT: any code path that would touch a whole-genome
    CSR fails loudly instead of silently re-materializing it.
    """

    def __init__(self, subs: Sequence):
        assert subs, "need at least one sub-index"
        self.subs = list(subs)
        self.mode = subs[0].mode
        self.hashed = subs[0].hashed
        self.is_rna = subs[0].is_rna
        self.contig_names: List[str] = []
        offs = []
        lens = []
        base = 0
        for s in subs:
            self.contig_names += list(s.contig_names)
            offs.append(s.contig_offsets.astype(np.int64) + base)
            lens.append(s.contig_lengths)
            base += int(s.total_len)
        self.contig_offsets = np.concatenate(offs).astype(np.uint32)
        self.contig_lengths = np.concatenate(lens)
        self.codes = np.concatenate([s.codes for s in subs])
        self.codes_rc = np.concatenate([s.codes_rc for s in subs])
        self.cs_codes = None
        self.cs_codes_rc = None
        if subs[0].cs_codes is not None:
            self.cs_codes = np.concatenate([s.cs_codes for s in subs])
            self.cs_codes_rc = np.concatenate(
                [s.cs_codes_rc for s in subs])
        # shard routing tables
        self.cn_base = np.zeros(len(subs) + 1, np.int64)
        self.pos_base = np.zeros(len(subs) + 1, np.int64)
        for d, s in enumerate(subs):
            self.cn_base[d + 1] = self.cn_base[d] + s.n_contigs
            self.pos_base[d + 1] = self.pos_base[d] + s.total_len
        self._max_weight = max(si.seed.weight
                               for si in subs[0].seeds)
        self._max_span = max(si.seed.span for si in subs[0].seeds)

    @property
    def total_len(self) -> int:
        return int(self.codes.shape[0])

    @property
    def n_contigs(self) -> int:
        return len(self.contig_names)

    @property
    def max_seed_span(self) -> int:
        return self._max_span

    def contig_of(self, pos):
        return np.searchsorted(self.contig_offsets, pos,
                               side="right") - 1

    def auto_list_cutoff(self) -> int:
        """Whole-genome auto cutoff (gmapper.c:2830-2834): uses the
        GLOBAL length, so the cutoff VALUE matches the unsharded run;
        per-key decisions use each shard's local list lengths (the same
        per-chunk behavior as the reference's split-db workflow)."""
        from .. import constants as C
        max_w = C.HASH_TABLE_POWER if self.hashed else self._max_weight
        return max(1000, int((100 * self.total_len) // (4 ** max_w)))


def merge_shard_flathits(parts, cn_base, n_owners: int):
    """Order-preserving merge of per-shard FlatHits: per owner,
    shard-major = ascending global contig number, within a shard the
    filter's own (cn, g_off) insertion order — exactly the whole-index
    window order. Returns (merged FlatHits, global shard id per row)."""
    from ..core.batch_pipeline import FlatHits, _empty_flat
    tot = sum(p.n for p, _ in parts)
    if tot == 0:
        return _empty_flat(n_owners), np.zeros(0, np.int64)
    owner = np.concatenate([p.owner for p, _ in parts])
    shard = np.concatenate([np.full(p.n, d, np.int64)
                            for p, d in parts])
    D = int(max(d for _, d in parts)) + 1
    order = np.argsort(owner * D + shard, kind="stable")
    owner_s = owner[order]

    def cat(field):
        return np.concatenate(
            [getattr(p, field) for p, _ in parts])[order]

    cn = np.concatenate(
        [p.cn.astype(np.int64) + cn_base[d]
         for p, d in parts])[order].astype(np.int32)
    seg = np.searchsorted(owner_s, np.arange(n_owners + 1))
    fh = FlatHits(owner=owner_s, cn=cn, g_off=cat("g_off"),
                  w_len=cat("w_len"),
                  score_window_gen=cat("score_window_gen"),
                  matches=cat("matches"),
                  score_max=cat("score_max"), ax=cat("ax"),
                  ay=cat("ay"), alen=cat("alen"),
                  awid=cat("awid"), seg_start=seg.astype(np.int64))
    return fh, shard[order]


class _ShardedFastLS(FastLS):
    """FastLS whose filter 1 runs per shard against that shard's own
    CSR sub-index, merged back into global (owner, cn, g_off) order."""

    def __init__(self, mapper, owner_mesh) -> None:
        super().__init__(mapper)
        self.mm = owner_mesh

    def _filter1(self, codes2, L: int, wlen: int):
        from ..native.filter1_py import generate_candidates_native
        m = self.m
        cfg = m.config
        opts = m._unpaired_opts[0]
        comp: CompositeIndex = m.index
        parts = []
        for d, sub in enumerate(comp.subs):
            fh = generate_candidates_native(
                sub, codes2, L, wlen, m.cutoff,
                opts.hit_list.match_mode, opts.hit_list.threshold,
                cfg.scores.match, cfg.scores.b_gap_open,
                cfg.scores.b_gap_extend, min_kmer_pos=0,
                use_region_counts=opts.anchor_list.use_region_counts,
                region_bits=cfg.region_bits,
                region_overlap=cfg.region_overlap,
                collapse=opts.anchor_list.collapse, gapless=False,
                search_strands=(True, True), threads=self.f1_threads)
            if fh is None:
                return None
            parts.append((fh, d))
        fh, self._win_shard = merge_shard_flathits(
            parts, comp.cn_base, codes2.shape[0] * 2)
        return fh


class _ShardedFastPaired(FastPaired):
    """FastPaired whose filter 1 (incl. the mate-pair region filter)
    runs per shard against that shard's own CSR sub-index. Pairs are
    insert-size-local, so every pairing decision is intra-shard and the
    merged window set reproduces the whole-index paired run exactly
    (same caveats as the unpaired mode)."""

    def __init__(self, mapper, owner_mesh) -> None:
        super().__init__(mapper)
        self.mm = owner_mesh
        self.fls = _ShardedFastLS(mapper, owner_mesh)
        self.lib = self.fls.lib

    def _filter1_paired(self, codes2, L: int, wlen: int, ro, mp_kw):
        from ..native.filter1_py import generate_candidates_native
        m = self.m
        cfg = m.config
        comp: CompositeIndex = m.index
        parts = []
        for d, sub in enumerate(comp.subs):
            fh = generate_candidates_native(
                sub, codes2, L, wlen, m.cutoff,
                ro.hit_list.match_mode, ro.hit_list.threshold,
                cfg.scores.match, cfg.scores.b_gap_open,
                cfg.scores.b_gap_extend, min_kmer_pos=0,
                use_region_counts=ro.anchor_list.use_region_counts,
                region_bits=cfg.region_bits,
                region_overlap=cfg.region_overlap,
                collapse=ro.anchor_list.collapse, gapless=False,
                search_strands=(True, True),
                threads=self.fls.f1_threads, **mp_kw)
            if fh is None:
                return None
            parts.append((fh, d))
        fh, self.fls._win_shard = merge_shard_flathits(
            parts, comp.cn_base, codes2.shape[0] * 2)
        return fh


class ShardedIndexMapper:
    """Fully index-sharded mapping: every device owns ONE genome shard —
    its packed genome planes in HBM *and* its CSR sub-index on the host
    side of that shard — and filter 1 runs per shard against only that
    shard's sub-index. No data structure anywhere holds the whole-genome
    CSR (the RAM cost that forces the reference to shard at all,
    README:128-150: 48GB hg18 postings). MQV denominators are
    recombined ACROSS shards with the on-device `zmerge_psum` collective
    and the merged value feeds the rendered MQV (ext_z1 path in
    native/hostpipe.cpp) — the mergesam Z algebra
    (not_in_dist/MAPPING_QUALITIES Part 1c, sam_reader.c:417-520) as a
    jax collective instead of an offline file merge.

    Output matches the whole-index run byte for byte, with the same two
    caveats the reference's own split-db workflow has: (a) per-key list
    cutoffs apply to each shard's local list lengths, so a key whose
    global list exceeds the cutoff may survive in a shard
    (README:1280-1305); (b) the 2^region_bits region prefilter loses
    cross-contig mark bleed at shard boundaries when a contig boundary
    straddles a region. Both vanish when cutoffs don't trip and contigs
    are region-aligned; the equivalence tests assert byte-identity under
    those conditions.
    """

    def __init__(self, sub_indexes: Sequence, config=None, mesh=None,
                 halo: Optional[int] = None):
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P
        self.mesh = mesh if mesh is not None else make_mesh()
        self.D = int(self.mesh.devices.size)
        assert len(sub_indexes) == self.D, \
            f"need {self.D} sub-indexes for a {self.D}-device mesh"
        cfg = config or MapperConfig()
        self.halo = halo if halo is not None else halo_for(cfg)
        comp = CompositeIndex(sub_indexes)
        self.comp = comp
        if cfg.pair_mode and cfg.pair_mode != "none":
            from ..paired import PairedMapper
            self.m = PairedMapper(comp, cfg)
        else:
            self.m = Mapper(comp, cfg)
        # per-shard genome planes, padded to a common row length; no
        # cross-shard halo is needed: shards own whole contigs and
        # windows never cross a contig boundary
        S = _round_up(max(int(s.total_len) for s in sub_indexes)
                      + self.halo, 256)
        self.S = S
        rows = np.full((self.D, S), 254, np.uint8)
        rows_rc = np.full((self.D, S), 254, np.uint8)
        for d, s in enumerate(sub_indexes):
            rows[d, :s.total_len] = s.codes
            rows_rc[d, :s.total_len] = s.codes_rc
        shd = NamedSharding(self.mesh, P(SHARD_AXIS))
        self._fwd_sh = jax.device_put(rows, shd)
        self._rc_sh = jax.device_put(rows_rc, shd)
        self._repl = NamedSharding(self.mesh, P())
        # per-shard colour/letter planes for CS mapping: each device row
        # holds ITS sub-index's planes (not a range slice of the whole)
        self._cs_planes_sh = None
        if sub_indexes[0].cs_codes is not None:
            planes = []
            for field in ("cs_codes", "cs_codes_rc", "codes",
                          "codes_rc"):
                rp = np.full((self.D, S), 254, np.uint8)
                for d, s in enumerate(sub_indexes):
                    rp[d, :s.total_len] = getattr(s, field)
                planes.append(jax.device_put(rp, shd))
            self._cs_planes_sh = tuple(planes)
        self._step_cache = {}
        self._lock = threading.Lock()
        self.last_z1_merged: Optional[np.ndarray] = None
        self.last_zpair_merged: Optional[np.ndarray] = None

    # shared device-step machinery (identical program shape; resolved at
    # call time — MeshMapper is defined below)
    def _get_step(self, *a):
        return MeshMapper._get_step(self, *a)

    def _get_cs_step(self, *a):
        return MeshMapper._get_cs_step(self, *a)

    def _fetch(self, *a):
        return MeshMapper._fetch(self, *a)

    def _dispatch(self, m, fh, read_tab: np.ndarray, L: int, R: int,
                  rcf: np.ndarray, n_reads=None):
        """fastpath._fused_dispatch drop-in: each window already belongs
        to the shard whose sub-index generated it; run the fused
        vec+full launch as ONE shard_map program, each shard scanning
        its own genome rows."""
        import jax
        sc = m.config.scores
        n = int(fh.n)
        win, G = _normalize_win(m, fh, L, rcf)
        if G > self.halo:
            raise ValueError(
                f"window {G} exceeds shard halo {self.halo}; construct "
                f"with halo=halo_for(cfg, read_len)")
        if G > 1023 or R > 1023 or int(fh.w_len.max()) >= 4096:
            # outside the packed-IO envelope (long reads): run this
            # batch's launch on a single device — identical output,
            # no mesh parallelism for the batch
            from ..fastpath import _fused_dispatch
            return _fused_dispatch(m, fh, read_tab, L, R, rcf,
                                   n_reads=n_reads)
        shard = self._fast._win_shard
        starts = win["starts"] - self.comp.pos_base[shard]
        order = np.argsort(shard, kind="stable")
        counts = np.bincount(shard, minlength=self.D)
        Wcap = max(2048, 1 << int(np.ceil(np.log2(max(
            int(counts.max()), 1)))))
        args = np.empty((self.D, Wcap, 4), np.int32)
        off = 0
        for d in range(self.D):
            k = int(counts[d])
            sl = order[off:off + k]
            args[d] = _pack_args4(
                Wcap, k, starts[sl], win["glen"][sl], win["ri"][sl],
                win["rcmask"][sl], win["rx"][sl], win["ry"][sl],
                win["rl_"][sl], win["rw_"][sl], win["rev"][sl])
            off += k
        kw_key = (("match", sc.match), ("mismatch", sc.mismatch),
                  ("a_gap_open", sc.a_gap_open),
                  ("a_gap_ext", sc.a_gap_extend),
                  ("b_gap_open", sc.b_gap_open),
                  ("b_gap_ext", sc.b_gap_extend))
        step = self._get_step(G, L, Wcap, read_tab.shape[0],
                              read_tab.shape[1] // 2, kw_key)
        args_dev = jax.device_put(args, jax.sharding.NamedSharding(
            self.mesh, jax.sharding.PartitionSpec(SHARD_AXIS)))
        rtab_dev = jax.device_put(_pack_rtab(read_tab), self._repl)
        pk3_sh = step(self._fwd_sh, self._rc_sh, args_dev, rtab_dev)
        win["packed_io"] = True
        win["shard"] = shard
        win["fetch"] = functools.partial(
            self._fetch, pk3_sh, order, counts, n)
        m.stats.vec_invocs += n
        cells = int(fh.w_len.astype(np.int64).sum()) * L
        m.stats.vec_cells += cells
        m.stats.full_invocs += n
        m.stats.full_cells += cells
        return [(0, n, None)], win, G, True

    def _z1_hook(self, fast):
        def hook(posteriors, job_ri, job_rows, B):
            """Cross-shard MQV denominator: per-shard z1 partials from
            this shard's MQV-contributing alignments, psum-merged on
            device (MAPPING_QUALITIES Part 1c: z1 is a literal sum of
            per-shard terms). The merged value is what the render pass
            divides by — the collective is load-bearing."""
            zp = np.zeros((self.D, B), np.float64)
            sh = fast._win_shard[job_rows]
            np.add.at(zp, (sh, job_ri.astype(np.int64)), posteriors)
            merged = zmerge_psum(self.mesh, zp)
            self.last_z1_merged = merged
            return merged
        return hook

    def map_unpaired_sam(self, records: Sequence[SeqRecord],
                         batch_size: int = 8192) -> bytes:
        """Unpaired mapping to SAM bytes; the MQV of every emitted
        alignment is computed from the device-collective-merged z1."""
        from .. import constants as C
        if self.m.config.mode == C.MODE_COLOUR_SPACE:
            return self._map_unpaired_cs(records, batch_size)
        if not fastpath_supported(self.m.config):
            raise ValueError("config outside the fast-path envelope")
        fast = _ShardedFastLS(self.m, self)
        self._fast = fast
        fast.dispatch_fn = self._dispatch
        if self.m.config.compute_mapping_qualities:
            fast.z1_merge_hook = self._z1_hook(fast)
        out: List[bytes] = []
        for off in range(0, len(records), batch_size):
            ctx = fast.stage_prepare(records[off:off + batch_size],
                                     batch_cap=batch_size)
            if ctx is None:
                raise ValueError("batch shape outside fast-path support")
            out.append(fast.stage_finish(ctx)[0])
        return b"".join(out)

    def _map_unpaired_cs(self, records: Sequence[SeqRecord],
                         batch_size: int) -> bytes:
        """Index-sharded colour-space mapping: per-shard CS filter 1
        against each shard's own sub-index, fused CS launch as the
        shard_map program over per-shard planes — byte-identical to the
        whole-index CS fast path (same split-db caveats as LS)."""
        from ..fastpath_cs import fastpath_cs_supported
        if not fastpath_cs_supported(self.m.config) \
                or self._cs_planes_sh is None:
            raise ValueError("config outside the CS fast-path envelope")
        fast = _MeshFastCS(self.m, self, sharded_index=True)
        out: List[bytes] = []
        for off in range(0, len(records), batch_size):
            ctx = fast.stage_prepare(records[off:off + batch_size],
                                     batch_cap=batch_size)
            if ctx is None:
                raise ValueError("batch shape outside fast-path support")
            out.append(fast.stage_finish(ctx)[0])
        return b"".join(out)

    def map_paired_sam(self, records: Sequence[SeqRecord],
                       batch_size: int = 8192) -> bytes:
        """Paired mapping with per-shard sub-indexes: filter 1 + the
        mate-pair region filter run per shard, the fused launch runs as
        the shard_map program, and the native paired brain consumes the
        merged windows — byte-identical to the whole-index paired run
        (pairs never span shards: insert-size windows are intra-contig,
        mapping.c:405-456). Colour space routes to the CS paired fast
        path (fastpath_cs.FastPairedCS) with the same per-shard filter 1
        and zpair collectives."""
        from .. import constants as C
        if self.m.config.mode == C.MODE_COLOUR_SPACE:
            return self._map_paired_cs(records, batch_size,
                                       sharded_index=True)
        if not fastpath_paired_supported(self.m.config):
            raise ValueError("config outside the paired fast-path"
                             " envelope")
        if batch_size % 2:
            batch_size += 1
        fp = _ShardedFastPaired(self.m, self)
        self._fast = fp.fls
        fp.fls.dispatch_fn = self._dispatch
        if self.m.config.compute_mapping_qualities:
            fp.zpair_n_shards = self.D

            def hook(part):
                merged = zpair_merge(
                    self.mesh,
                    np.ascontiguousarray(part.transpose(1, 0, 2)))
                self.last_zpair_merged = merged
                return merged
            fp.zpair_merge_hook = hook
        out: List[bytes] = []
        for off in range(0, len(records), batch_size):
            ctx = fp.stage_prepare(records[off:off + batch_size],
                                   batch_cap=batch_size)
            if ctx is None:
                raise ValueError("batch shape outside fast-path support")
            fp.zpair_win_shard = fp.fls._win_shard
            out.append(fp.stage_finish(ctx)[0])
        return b"".join(out)

    def _map_paired_cs(self, records: Sequence[SeqRecord],
                       batch_size: int, sharded_index: bool) -> bytes:
        """Colour-space paired mapping over the mesh: per-shard CS
        filter 1 (mate-pair region filter included), the fused CS
        launch as the shard_map program over per-shard planes, and the
        paired MQV class statistics merged by the zpair collective —
        byte-identical to the single-device CS paired fast path
        (fastpath_cs.FastPairedCS, matching gmapper-cs paired:
        mapping.c:2502, sw-full-cs.c:1146-1236)."""
        from ..fastpath_cs import fastpath_cs_paired_supported
        if not fastpath_cs_paired_supported(self.m.config) \
                or self._cs_planes_sh is None:
            raise ValueError("config outside the CS paired fast-path"
                             " envelope")
        if batch_size % 2:
            batch_size += 1
        fp = _MeshFastCS(self.m, self, sharded_index=sharded_index,
                         paired=True)
        if sharded_index and self.m.config.compute_mapping_qualities:
            fp.zpair_n_shards = self.D

            def hook(part):
                merged = zpair_merge(
                    self.mesh,
                    np.ascontiguousarray(part.transpose(1, 0, 2)))
                self.last_zpair_merged = merged
                return merged
            fp.zpair_merge_hook = hook
        out: List[bytes] = []
        for off in range(0, len(records), batch_size):
            ctx = fp.stage_prepare(records[off:off + batch_size],
                                   batch_cap=batch_size)
            if ctx is None:
                raise ValueError("batch shape outside fast-path support")
            if sharded_index and fp.zpair_merge_hook is not None:
                fp.zpair_win_shard = fp._win_shard
            out.append(fp.stage_finish(ctx)[0])
        return b"".join(out)


def _MeshFastCS(mapper, mm, sharded_index: bool = False,
                paired: bool = False):
    """FastCS/FastPairedCS whose fused colour-space launch runs as ONE
    shard_map program over the mesh's range-sharded colour+letter genome
    planes. Each shard scans only its own genome slice; the per-shard
    results are all_gathered and un-permuted back to the original window
    order INSIDE the jitted program, so stage_finish consumes them
    unchanged and the SAM bytes match the single-device fast path.
    With `sharded_index`, filter 1 also runs per shard against that
    shard's own CSR sub-index (ShardedIndexMapper: no whole-genome CSR
    anywhere) and windows route to the shard whose sub-index produced
    them. With `paired`, the base is the CS paired pipeline
    (fastpath_cs.FastPairedCS — pair-up + paired MQV in the native
    renderer; the device launch override is shared, sw-full-cs.c:
    1146-1236 semantics). (Factory function: lazily imported bases.)"""
    from ..fastpath_cs import FastCS, FastPairedCS
    base = FastPairedCS if paired else FastCS

    class _Impl(base):
        def __init__(self, mapper, mm) -> None:
            super().__init__(mapper)
            self.mm = mm
            self._win_shard = None

        def _filter1_cs(self, codes2, R: int, wlen: int, opts):
            if not sharded_index:
                return super()._filter1_cs(codes2, R, wlen, opts)
            from ..native.filter1_py import generate_candidates_native
            m = self.m
            cfg = m.config
            comp: CompositeIndex = m.index
            parts = []
            for d, sub in enumerate(comp.subs):
                fh = generate_candidates_native(
                    sub, codes2, R, wlen, m.cutoff,
                    opts.hit_list.match_mode, opts.hit_list.threshold,
                    cfg.scores.match, cfg.scores.b_gap_open,
                    cfg.scores.b_gap_extend, min_kmer_pos=1,
                    use_region_counts=opts.anchor_list.use_region_counts,
                    region_bits=cfg.region_bits,
                    region_overlap=cfg.region_overlap,
                    collapse=opts.anchor_list.collapse, gapless=False,
                    search_strands=(True, True),
                    threads=self.fls.f1_threads)
                if fh is None:
                    return None
                parts.append((fh, d))
            fh, self._win_shard = merge_shard_flathits(
                parts, comp.cn_base, codes2.shape[0] * 2)
            return fh

        def _filter1_cs_paired(self, codes2, R: int, wlen: int, ro,
                               mp_kw):
            if not sharded_index:
                return super()._filter1_cs_paired(codes2, R, wlen, ro,
                                                  mp_kw)
            from ..native.filter1_py import generate_candidates_native
            m = self.m
            cfg = m.config
            comp: CompositeIndex = m.index
            parts = []
            for d, sub in enumerate(comp.subs):
                fh = generate_candidates_native(
                    sub, codes2, R, wlen, m.cutoff,
                    ro.hit_list.match_mode, ro.hit_list.threshold,
                    cfg.scores.match, cfg.scores.b_gap_open,
                    cfg.scores.b_gap_extend, min_kmer_pos=1,
                    use_region_counts=ro.anchor_list.use_region_counts,
                    region_bits=cfg.region_bits,
                    region_overlap=cfg.region_overlap,
                    collapse=ro.anchor_list.collapse, gapless=False,
                    search_strands=(True, True),
                    threads=self.fls.f1_threads, **mp_kw)
                if fh is None:
                    return None
                parts.append((fh, d))
            fh, self._win_shard = merge_shard_flathits(
                parts, comp.cn_base, codes2.shape[0] * 2)
            return fh

        def _fused_dispatch_cs(self, fh, codes0, qr_tab, initbp, R,
                           Bcap, xover_tab=None, rcf=None,
                           thresh_override=None, n_reads=None):
            import jax
            m = self.m
            cfg = m.config
            sc = cfg.scores
            mm = self.mm
            n = int(fh.n)
            args_all, win, G = self._cs_args(fh, R, rcf,
                                             thresh_override, initbp)
            if G > mm.halo:
                raise ValueError(
                    f"window {G} exceeds shard halo {mm.halo}")
            starts = win["starts"]
            if sharded_index:
                comp: CompositeIndex = m.index
                shard = self._win_shard
                local_all = starts - comp.pos_base[shard]
            else:
                shard = np.clip(starts // mm.S, 0,
                                mm.D - 1).astype(np.int64)
                local_all = starts - shard * mm.S
            order = np.argsort(shard, kind="stable")
            counts = np.bincount(shard, minlength=mm.D)
            Wcap = max(2048, 1 << int(np.ceil(np.log2(max(
                int(counts.max()), 1)))))
            args = np.zeros((mm.D, Wcap, 12), np.int32)
            # pad rows: 1-cell windows, threshold 1 zeroes scores
            args[:, :, 1] = 1
            args[:, :, 4] = 1
            args[:, :, 7] = 1
            args[:, :, 8] = 1
            args[:, :, 10] = 1
            slot = np.zeros(n, np.int64)
            off = 0
            for d in range(mm.D):
                k = int(counts[d])
                sl = order[off:off + k]
                args[d, :k] = args_all[sl]
                args[d, :k, 0] = local_all[sl]  # shard-local starts
                slot[sl] = d * Wcap + np.arange(k)
                off += k
            n_cap = max(2048, 1 << int(np.ceil(np.log2(max(n, 1)))))
            inv = np.zeros(n_cap, np.int64)
            inv[:n] = slot
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
            step = mm._get_cs_step(G, R, Wcap, n_cap, rows, kw_key)
            shd = jax.sharding.NamedSharding(
                mm.mesh, jax.sharding.PartitionSpec(SHARD_AXIS))
            repl = mm._repl
            from .. import constants as C
            rtab_pad = np.full((rows, R), C.BASE_N, np.uint8)
            rtab_pad[:codes0.shape[0]] = codes0
            qr_pad = np.full((rows, 4, R), C.BASE_N, np.uint8)
            qr_pad[:qr_tab.shape[0]] = qr_tab
            xov_pad = np.full((rows, R), sc.crossover, np.int32)
            if xover_tab is not None:
                xov_pad[:xover_tab.shape[0]] = xover_tab
            args_dev = jax.device_put(args, shd)
            res = step(mm._cs_planes_sh[0], mm._cs_planes_sh[1],
                       mm._cs_planes_sh[2], mm._cs_planes_sh[3],
                       args_dev, jax.device_put(inv, repl),
                       jax.device_put(rtab_pad, repl),
                       jax.device_put(qr_pad, repl),
                       jax.device_put(xov_pad, repl))
            cells = int(fh.w_len.astype(np.int64).sum()) * R
            m.stats.vec_invocs += n
            m.stats.vec_cells += cells
            m.stats.full_invocs += n
            m.stats.full_cells += cells * 4
            return [(0, n, res)], win, G

    return _Impl(mapper, mm)


class MeshMapper:
    """Maps read batches against a genome range-sharded over a device
    mesh; SAM output is byte-identical to the unsharded fast path.

    The index stays host-resident once (single-host multi-chip model:
    host RAM holds the CSR index, device HBM holds only the 1/D genome
    slice + halo per chip); candidate generation (filter 1) runs on the
    host exactly as unsharded, so candidate sets — and therefore output
    bytes — match the whole-genome run exactly. Multi-host distribution
    (per-host sub-index + mergesam-collective recombination) lives in
    parallel/dist.py.
    """

    def __init__(self, index, config: Optional[MapperConfig] = None,
                 mesh=None, halo: Optional[int] = None):
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P
        self.mesh = mesh if mesh is not None else make_mesh()
        self.D = int(self.mesh.devices.size)
        cfg = config or MapperConfig()
        # halo sized to the config's maximum window length (long-read
        # configs get a bigger overlap instead of a raise)
        self.halo = halo if halo is not None else halo_for(cfg)
        if cfg.pair_mode and cfg.pair_mode != "none":
            from ..paired import PairedMapper
            self.m = PairedMapper(index, cfg)
        else:
            self.m = Mapper(index, cfg)
        # range-sharded genome planes with halo: device d holds
        # [d*S, d*S + S + halo) of both the forward and the revcomp
        # plane (windows never span more than halo beyond their start)
        pad = Mapper._pad_plane(index.codes)
        pad_rc = Mapper._pad_plane(index.codes_rc)
        P_len = len(pad)
        S = _round_up(-(-P_len // self.D), 256)
        self.S = S
        halo = self.halo
        rows = np.full((self.D, S + halo), 254, np.uint8)
        rows_rc = np.full((self.D, S + halo), 254, np.uint8)
        for d in range(self.D):
            src = pad[d * S: d * S + S + halo]
            rows[d, :len(src)] = src
            src = pad_rc[d * S: d * S + S + halo]
            rows_rc[d, :len(src)] = src
        shd = NamedSharding(self.mesh, P(SHARD_AXIS))
        self._fwd_sh = jax.device_put(rows, shd)
        self._rc_sh = jax.device_put(rows_rc, shd)
        self._repl = NamedSharding(self.mesh, P())
        # colour-space planes (cs, cs_rc, ls, ls_rc), range-sharded the
        # same way, for the CS mesh dispatch
        self._cs_planes_sh = None
        if getattr(index, "cs_codes", None) is not None:
            planes = []
            for src in (index.cs_codes, index.cs_codes_rc,
                        index.codes, index.codes_rc):
                padp = Mapper._pad_plane(src)
                rp = np.full((self.D, S + halo), 254, np.uint8)
                for d in range(self.D):
                    seg = padp[d * S: d * S + S + halo]
                    rp[d, :len(seg)] = seg
                planes.append(jax.device_put(rp, shd))
            self._cs_planes_sh = tuple(planes)
        self._step_cache = {}
        self._lock = threading.Lock()
        self.last_zpart: Optional[np.ndarray] = None  # [D, B] z1 partials

    # ------------------------------------------------------ device step
    def _get_step(self, G, L, Wcap, Bcap, Rpk, kw_key):
        key = (G, L, Wcap, Bcap, Rpk, kw_key)
        with self._lock:
            fn = self._step_cache.get(key)
        if fn is not None:
            return fn
        import jax
        import jax.numpy as jnp
        from jax.sharding import PartitionSpec as P
        from .. import backend
        from ..core.sw_jax import sw_vec_full_stats_packed
        kw = dict(kw_key)
        vec_kernel = backend.vec_kernel()

        def body(fwd, rc, args, rtab_pk):
            pk3, = sw_vec_full_stats_packed.__wrapped__(
                fwd[0], rc[0], args[0], rtab_pk, G=G, L=L,
                local_alignment=False, vec_kernel=vec_kernel,
                phase="fused", **kw)
            return pk3[None]

        fn = jax.jit(jax.shard_map(
            body, mesh=self.mesh,
            in_specs=(P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS), P()),
            out_specs=P(SHARD_AXIS), check_vma=False))
        with self._lock:
            self._step_cache[key] = fn
        return fn

    # ---------------------------------------------------- CS device step
    def _get_cs_step(self, G, R, Wcap, n_cap, rows, kw_key):
        key = ("cs", G, R, Wcap, n_cap, rows, kw_key)
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
        D = self.D

        def body(p0, p1, p2, p3, args, inv, rtab, qr, xov):
            vec, pk, st = sw_vec_cs_full_from_index.__wrapped__(
                p0[0], p1[0], p2[0], p3[0], args[0], rtab, qr, xov,
                **kw)
            # gather every shard's rows and restore the original window
            # order (inv maps original index -> shard-major slot); the
            # replicated result feeds FastCS.stage_finish unchanged
            vec_all = jax.lax.all_gather(vec, SHARD_AXIS)
            pk_all = jax.lax.all_gather(pk, SHARD_AXIS)
            st_all = jax.lax.all_gather(st, SHARD_AXIS)
            vec_f = vec_all.reshape(D * Wcap)[inv]
            pk_f = pk_all.reshape(D * Wcap, pk.shape[-1])[inv]
            st_f = st_all.reshape(D * Wcap, st.shape[-1])[inv]
            return vec_f, pk_f, st_f

        fn = jax.jit(
            jax.shard_map(body, mesh=self.mesh,
                          in_specs=(P(SHARD_AXIS), P(SHARD_AXIS),
                                    P(SHARD_AXIS), P(SHARD_AXIS),
                                    P(SHARD_AXIS), P(), P(), P(), P()),
                          out_specs=(P(None), P(None), P(None)),
                          check_vma=False),
            out_shardings=(NamedSharding(self.mesh, P()),) * 3)
        with self._lock:
            self._step_cache[key] = fn
        return fn

    # --------------------------------------------------------- dispatch
    def _dispatch(self, m, fh, read_tab: np.ndarray, L: int, R: int,
                  rcf: np.ndarray, n_reads=None):
        """Drop-in for fastpath._fused_dispatch: routes every candidate
        window to the device owning its genome range and runs the fused
        vec+full launch as ONE shard_map program over the mesh."""
        import jax
        cfg = m.config
        sc = cfg.scores
        n = int(fh.n)
        win, G = _normalize_win(m, fh, L, rcf)
        if G > self.halo:
            raise ValueError(f"window {G} exceeds shard halo {self.halo}")
        if G > 1023 or R > 1023 or int(fh.w_len.max()) >= 4096:
            # outside the packed-IO envelope (long reads): single-device
            # launch for this batch, identical output
            from ..fastpath import _fused_dispatch
            return _fused_dispatch(m, fh, read_tab, L, R, rcf,
                                   n_reads=n_reads)
        starts = win["starts"]
        shard = np.clip(starts // self.S, 0, self.D - 1).astype(np.int64)
        order = np.argsort(shard, kind="stable")
        counts = np.bincount(shard, minlength=self.D)
        Wcap = max(2048, 1 << int(np.ceil(np.log2(max(
            int(counts.max()), 1)))))
        args = np.empty((self.D, Wcap, 4), np.int32)
        off = 0
        for d in range(self.D):
            k = int(counts[d])
            sl = order[off:off + k]
            local = starts[sl] - d * self.S
            args[d] = _pack_args4(
                Wcap, k, local, win["glen"][sl], win["ri"][sl],
                win["rcmask"][sl], win["rx"][sl], win["ry"][sl],
                win["rl_"][sl], win["rw_"][sl], win["rev"][sl])
            off += k
        kw_key = (("match", sc.match), ("mismatch", sc.mismatch),
                  ("a_gap_open", sc.a_gap_open),
                  ("a_gap_ext", sc.a_gap_extend),
                  ("b_gap_open", sc.b_gap_open),
                  ("b_gap_ext", sc.b_gap_extend))
        step = self._get_step(G, L, Wcap, read_tab.shape[0],
                              read_tab.shape[1] // 2, kw_key)
        args_dev = jax.device_put(args, jax.sharding.NamedSharding(
            self.mesh, jax.sharding.PartitionSpec(SHARD_AXIS)))
        rtab_dev = jax.device_put(_pack_rtab(read_tab), self._repl)
        pk3_sh = step(self._fwd_sh, self._rc_sh, args_dev, rtab_dev)
        win["packed_io"] = True
        win["shard"] = shard
        win["fetch"] = functools.partial(
            self._fetch, pk3_sh, order, counts, n)
        m.stats.vec_invocs += n
        cells = int(fh.w_len.astype(np.int64).sum()) * L
        m.stats.vec_cells += cells
        m.stats.full_invocs += n
        m.stats.full_cells += cells
        return [(0, n, None)], win, G, True

    def _fetch(self, pk3_sh, order, counts, n, futures):
        """Gather the sharded [D, Wcap, 3] stats and restore the
        original (unsharded) window order."""
        import jax
        pk3 = np.asarray(jax.device_get(pk3_sh))
        flat = np.empty((n, 3), np.int32)
        off = 0
        for d in range(len(counts)):
            k = int(counts[d])
            flat[order[off:off + k]] = pk3[d, :k]
            off += k
        return [(flat,)]

    # ------------------------------------------------------- public API
    def map_unpaired_sam(self, records: Sequence[SeqRecord],
                         batch_size: int = 8192,
                         collect_z: bool = False) -> bytes:
        """Unpaired mapping to SAM bytes, byte-identical to the
        unsharded fast path. With collect_z, also accumulates the
        per-shard z1 partials ([D, n_reads] in self.last_zpart) that the
        zmerge_psum collective recombines (verified in tests).

        Configs or batch shapes outside the fused fast path fall back to
        the generic (unsharded) mapper with a warning instead of
        raising, so exotic-flag runs still complete."""
        from .. import constants as C
        if self.m.config.mode == C.MODE_COLOUR_SPACE:
            return self._map_unpaired_cs(records, batch_size)
        if not fastpath_supported(self.m.config):
            return self._generic_fallback(records)
        fast = FastLS(self.m)
        fast.dispatch_fn = self._dispatch
        out: List[bytes] = []
        zparts = []
        for off in range(0, len(records), batch_size):
            batch = records[off:off + batch_size]
            if collect_z:
                fast.surv_post = np.zeros(0, np.float64)  # request
            ctx = fast.stage_prepare(batch, batch_cap=batch_size)
            if ctx is None:
                out.append(self._generic_fallback(batch))
                if collect_z:
                    zparts.append(np.zeros((self.D, len(batch))))
                    fast.surv_post = None
                continue
            sam, _ = fast.stage_finish(ctx)
            out.append(sam)
            if collect_z:
                zp = np.zeros((self.D, len(batch)), np.float64)
                if ctx["fh"].n and fast.surv_post is not None \
                        and len(fast.surv_post):
                    sh = ctx["win"]["shard"][fast.last_rows]
                    np.add.at(zp, (sh, fast.last_ri.astype(np.int64)),
                              fast.surv_post)
                zparts.append(zp)
                fast.surv_post = None
        if collect_z:
            self.last_zpart = (np.concatenate(zparts, axis=1) if zparts
                               else np.zeros((self.D, 0)))
        return b"".join(out)

    def _map_unpaired_cs(self, records: Sequence[SeqRecord],
                         batch_size: int) -> bytes:
        """Colour-space unpaired mapping over the mesh: the fused CS
        vector + 4-layer-full launch runs as ONE shard_map program over
        the range-sharded colour/letter planes; byte-identical to the
        single-device CS fast path."""
        from ..fastpath_cs import fastpath_cs_supported
        if (not fastpath_cs_supported(self.m.config)
                or self._cs_planes_sh is None):
            return self._generic_fallback(records)
        fast = _MeshFastCS(self.m, self)
        out: List[bytes] = []
        for off in range(0, len(records), batch_size):
            batch = records[off:off + batch_size]
            ctx = fast.stage_prepare(batch, batch_cap=batch_size)
            if ctx is None:
                out.append(self._generic_fallback(batch))
                continue
            out.append(fast.stage_finish(ctx)[0])
        return b"".join(out)

    def _generic_fallback(self, records: Sequence[SeqRecord]) -> bytes:
        """Generic-mapper fallback for configs/batches outside the
        fused fast path (single-device execution, identical output)."""
        import sys
        print("meshmap: config/batch outside the fused fast path; "
              "falling back to the generic mapper for this run",
              file=sys.stderr)
        from ..io.sam import render_pair_entry, render_unpaired
        cfg = self.m.config
        lines: List[str] = []
        if cfg.pair_mode and cfg.pair_mode != "none":
            fq = any(r.qual is not None for r in records)
            for pe in self.m.map_paired(list(records)):
                p_out, u_out = self.m.select_output(pe)
                lines += render_pair_entry(pe, self.m.index, cfg, p_out,
                                           u_out, fastq=fq)
        else:
            fq = any(r.qual is not None for r in records)
            for re_, hits in self.m.map_unpaired(list(records)):
                for h in hits:
                    lines.append(render_unpaired(
                        re_, h, self.m.index, cfg, fastq=fq))
                if not hits and cfg.sam_unaligned:
                    lines.append(render_unpaired(
                        re_, None, self.m.index, cfg, fastq=fq))
        return ("\n".join(lines) + "\n").encode() if lines else b""

    def map_paired_sam(self, records: Sequence[SeqRecord],
                       batch_size: int = 8192) -> bytes:
        """Paired mapping to SAM bytes, byte-identical to the unsharded
        paired fast path: same whole-index filter 1 + pair-up, the fused
        SW launch runs as the shard_map program over the mesh. Colour
        space routes to the CS paired fast path over the range-sharded
        planes. Falls back to the generic mapper outside the fast-path
        envelope."""
        from .. import constants as C
        if self.m.config.mode == C.MODE_COLOUR_SPACE:
            from ..fastpath_cs import fastpath_cs_paired_supported
            if (not fastpath_cs_paired_supported(self.m.config)
                    or self._cs_planes_sh is None):
                return self._generic_fallback(records)
            return ShardedIndexMapper._map_paired_cs(
                self, records, batch_size, sharded_index=False)
        if not fastpath_paired_supported(self.m.config):
            return self._generic_fallback(records)
        if batch_size % 2:
            batch_size += 1
        fp = FastPaired(self.m)
        fp.fls.dispatch_fn = self._dispatch
        out: List[bytes] = []
        for off in range(0, len(records), batch_size):
            ctx = fp.stage_prepare(records[off:off + batch_size],
                                   batch_cap=batch_size)
            if ctx is None:
                out.append(self._generic_fallback(
                    records[off:off + batch_size]))
                continue
            out.append(fp.stage_finish(ctx)[0])
        return b"".join(out)
