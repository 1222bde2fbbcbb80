"""ShardedIndexMapper: filter 1 runs per shard against that shard's own
CSR sub-index (no structure anywhere holds the whole-genome CSR), and
the MQV denominator is recombined across shards with the on-device
zmerge_psum collective whose output feeds the rendered MQV (ext_z1,
native/hostpipe.cpp) — the mergesam Z algebra
(not_in_dist/MAPPING_QUALITIES Part 1c, sam_reader.c:417-520) as a jax
collective. Output must equal the whole-index run byte for byte.

Contigs here are multiples of 2^region_bits so the region prefilter has
no cross-contig straddle (the same boundary caveat the reference's
split-db workflow documents, README:158-166).
"""
import numpy as np
import pytest

pytestmark = pytest.mark.slow

import jax

from shrimp_tpu.config import MapperConfig
from shrimp_tpu.core import encode
from shrimp_tpu.index.build import build_index
from shrimp_tpu.index.seeds import default_seeds
from shrimp_tpu.io.fasta import SeqRecord
from shrimp_tpu.mapper import Mapper
from shrimp_tpu.fastpath import map_unpaired_sam_stream
from shrimp_tpu.parallel.meshmap import (CompositeIndex,
                                         ShardedIndexMapper, halo_for,
                                         make_mesh, split_contig_bins)

COMP = {"A": "T", "C": "G", "G": "C", "T": "A"}
CLEN = 16 * 2048          # region-aligned contig length


def _mk_genome(rng, n_contigs=6, clen=CLEN):
    contigs, gs = [], []
    for c in range(n_contigs):
        g = "".join(rng.choice(list("ACGT"), clen))
        gs.append(g)
        contigs.append((f"chr{c}", encode.encode_ls(g)))
    return contigs, gs


def _mk_reads(rng, gs, n, L=36, mut=3):
    reads = []
    for k in range(n):
        src = gs[k % len(gs)]
        p = int(rng.integers(0, len(src) - L))
        r = list(src[p:p + L])
        for _ in range(int(rng.integers(0, mut))):
            r[int(rng.integers(0, L))] = "ACGT"[int(rng.integers(0, 4))]
        r = "".join(r)
        if k % 3 == 0:
            r = "".join(COMP[c] for c in reversed(r))
        reads.append(SeqRecord(f"sr{k}", r))
    return reads


def _subs_for(contigs, D):
    bins = split_contig_bins(contigs, D)
    return [build_index(b, default_seeds()) for b in bins]


def test_sharded_index_byte_identical_and_z1_collective():
    rng = np.random.default_rng(211)
    contigs, gs = _mk_genome(rng)
    reads = _mk_reads(rng, gs, 240)
    cfg = MapperConfig()
    # reference: the whole-index fast path (built only for the oracle)
    idx = build_index(contigs, default_seeds())
    want = b"".join(map_unpaired_sam_stream(Mapper(idx, cfg), reads,
                                            batch_size=96, lanes=1))
    D = 4
    mesh = make_mesh(jax.devices()[:D])
    sim = ShardedIndexMapper(_subs_for(contigs, D), cfg, mesh=mesh)
    got = sim.map_unpaired_sam(reads, batch_size=96)
    assert got == want
    # the collective genuinely ran and produced the denominators the
    # render used (load-bearing, not demonstrative)
    assert sim.last_z1_merged is not None
    assert float(np.max(sim.last_z1_merged)) > 0.0
    # no single structure holds the whole-genome CSR
    assert not hasattr(sim.comp, "seeds")
    whole = sum(int(si.positions.nbytes) for si in idx.seeds)
    per_shard = [sum(int(si.positions.nbytes) for si in s.seeds)
                 for s in sim.comp.subs]
    assert max(per_shard) < whole


def test_sharded_index_uneven_mesh_sizes():
    rng = np.random.default_rng(212)
    contigs, gs = _mk_genome(rng, n_contigs=5)
    reads = _mk_reads(rng, gs, 100)
    cfg = MapperConfig()
    idx = build_index(contigs, default_seeds())
    want = b"".join(map_unpaired_sam_stream(Mapper(idx, cfg), reads,
                                            batch_size=100, lanes=1))
    for D in (2, 3, 5, 8):
        mesh = make_mesh(jax.devices()[:D])
        sim = ShardedIndexMapper(_subs_for(contigs, D), cfg, mesh=mesh)
        assert sim.map_unpaired_sam(reads, batch_size=100) == want, D


def test_sharded_index_paired_byte_identical_and_zpair():
    """Paired mode with per-shard sub-indexes: the paired class
    statistics (z1/z2/z3/insert denominator, z4 leg priors, pair prior)
    merge across shards with the zpair_merge collectives and the merged
    rows are what the native render consumes (ext_in path,
    pairedpipe.cpp) — asserted byte-identical to the whole-index paired
    run."""
    rng = np.random.default_rng(215)
    contigs, gs = _mk_genome(rng, n_contigs=4)
    cfg = MapperConfig(pair_mode="opp-in", min_insert_size=60,
                       max_insert_size=240)
    reads = []
    for k in range(120):
        src = gs[k % len(gs)]
        isz = int(rng.integers(90, 200))
        p = int(rng.integers(0, len(src) - isz - 1))
        r1 = src[p:p + 36]
        r2 = "".join(COMP[c] for c in reversed(src[p + isz - 36:p + isz]))
        if k % 11 == 0:   # discordant mate: unpaired fallback exercises
            q = int(rng.integers(0, len(src) - 36))
            r2 = src[q:q + 36]
        reads.append(SeqRecord(f"sp{k}/1", r1))
        reads.append(SeqRecord(f"sp{k}/2", r2))
    from shrimp_tpu.fastpath import map_paired_sam_stream
    from shrimp_tpu.paired import PairedMapper
    idx = build_index(contigs, default_seeds())
    want = b"".join(map_paired_sam_stream(PairedMapper(idx, cfg), reads,
                                          batch_size=80, lanes=1))
    for D in (2, 4):
        bins = split_contig_bins(contigs, D)
        subs = [build_index(b, default_seeds()) for b in bins]
        sim = ShardedIndexMapper(subs, cfg,
                                 mesh=make_mesh(jax.devices()[:D]))
        got = sim.map_paired_sam(reads, batch_size=80)
        assert got == want, D
        # the collective's merged rows were produced and consumed
        assert sim.last_zpair_merged is not None
        assert float(np.max(sim.last_zpair_merged[:, 3])) > 0.0  # z3


def test_sharded_index_rejects_unsupported_config():
    """Outside the fused envelope there is no generic fallback by
    design: the generic mapper would need the whole-genome CSR, which
    this mode exists to never materialize — it must fail loudly."""
    rng = np.random.default_rng(213)
    contigs, _ = _mk_genome(rng, n_contigs=2)
    cfg = MapperConfig(compute_mapping_qualities=False)
    sim = ShardedIndexMapper(_subs_for(contigs, 2), cfg,
                             mesh=make_mesh(jax.devices()[:2]))
    with pytest.raises(ValueError, match="fast-path"):
        sim.map_unpaired_sam([SeqRecord("x", "ACGT" * 9)])


def test_halo_for_scales_with_window():
    assert halo_for(MapperConfig(), read_len=36) == 2048
    # long-read config: window 140% of 10k reads -> halo grows
    assert halo_for(MapperConfig(longest_read_len=10000)) >= 14000


def test_composite_index_contig_table():
    rng = np.random.default_rng(214)
    contigs, _ = _mk_genome(rng, n_contigs=5, clen=4096)
    subs = _subs_for(contigs, 3)
    comp = CompositeIndex(subs)
    idx = build_index(contigs, default_seeds())
    assert comp.contig_names == idx.contig_names
    assert np.array_equal(comp.contig_offsets, idx.contig_offsets)
    assert np.array_equal(comp.codes, idx.codes)
    assert np.array_equal(comp.codes_rc, idx.codes_rc)
    assert comp.auto_list_cutoff() == idx.auto_list_cutoff()


def test_sharded_index_colour_space_byte_identical():
    """Index-sharded CS: per-shard CS filter 1 on each shard's own
    sub-index, fused CS launch over per-shard colour/letter planes —
    byte-identical to the whole-index CS fast path."""
    import shrimp_tpu.constants as C
    from shrimp_tpu.fastpath_cs import map_unpaired_cs_sam_stream
    rng = np.random.default_rng(31)
    contigs, gs = _mk_genome(rng, n_contigs=4)
    l2n = {c: i for i, c in enumerate("ACGT")}

    def tocs(s):
        return "T" + str(l2n["T"] ^ l2n[s[0]]) + "".join(
            str(l2n[s[i]] ^ l2n[s[i + 1]]) for i in range(len(s) - 1))

    reads = []
    for k in range(150):
        src = gs[k % len(gs)]
        p = int(rng.integers(0, len(src) - 36))
        s = list(src[p:p + 36])
        for _ in range(int(rng.integers(0, 2))):
            s[int(rng.integers(0, 36))] = "ACGT"[int(rng.integers(0, 4))]
        s = "".join(s)
        if k % 3 == 0:
            s = "".join(COMP[c] for c in reversed(s))
        reads.append(SeqRecord(f"sc{k}", tocs(s)))
    cfg = MapperConfig(mode=C.MODE_COLOUR_SPACE)
    idx = build_index(contigs, default_seeds(mode="cs"), mode="cs")
    want = b"".join(map_unpaired_cs_sam_stream(
        Mapper(idx, cfg), reads, batch_size=100, lanes=1))
    assert want.count(b"\n") >= 140
    for D in (2, 4):
        bins = split_contig_bins(contigs, D)
        subs = [build_index(b, default_seeds(mode="cs"), mode="cs")
                for b in bins]
        sim = ShardedIndexMapper(subs, cfg,
                                 mesh=make_mesh(jax.devices()[:D]))
        assert sim.map_unpaired_sam(reads, batch_size=100) == want, D


def test_sharded_index_colour_space_paired_and_zpair():
    """Index-sharded CS paired: per-shard CS
    filter 1 (mate-pair region filter included), fused CS launch over
    per-shard planes, and the paired class statistics merged by the
    zpair collective whose output the native render consumes (ext_in,
    pairedpipe.cpp in CS mode) — byte-identical to the whole-index CS
    paired fast path."""
    import shrimp_tpu.constants as C
    from shrimp_tpu.fastpath_cs import map_paired_cs_sam_stream
    from shrimp_tpu.paired import PairedMapper
    from .test_meshmap import mk_cs_pairs
    rng = np.random.default_rng(557)
    contigs, gs = _mk_genome(rng, n_contigs=4)
    recs = mk_cs_pairs(rng, gs, 80)
    cfg = MapperConfig(mode=C.MODE_COLOUR_SPACE, pair_mode="opp-in")
    idx = build_index(contigs, default_seeds(mode="cs"), mode="cs")
    gen = map_paired_cs_sam_stream(PairedMapper(idx, cfg), recs,
                                   batch_size=80, lanes=1)
    assert gen is not None
    want = b"".join(gen)
    assert want.count(b"\n") >= 80
    for D in (2, 4):
        bins = split_contig_bins(contigs, D)
        subs = [build_index(b, default_seeds(mode="cs"), mode="cs")
                for b in bins]
        sim = ShardedIndexMapper(subs, cfg,
                                 mesh=make_mesh(jax.devices()[:D]))
        got = sim.map_paired_sam(recs, batch_size=80)
        assert got == want, D
        assert sim.last_zpair_merged is not None
        assert float(np.max(sim.last_zpair_merged[:, 3])) > 0.0
