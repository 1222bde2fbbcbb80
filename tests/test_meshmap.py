"""MeshMapper (shard_map product pipeline) must reproduce the unsharded
run byte-for-byte, and the cross-shard Z collectives must match the
host-exact recombination (sharded-vs-unsharded equivalence is the
reference's own correctness criterion for its split/merge workflow,
mergesam/sam_reader.c:417-520, MAPPING_QUALITIES Parts 1c/2c)."""
import numpy as np
import pytest

import jax

from shrimp_tpu.config import MapperConfig
from shrimp_tpu.core import encode
from shrimp_tpu.index.build import build_index
from shrimp_tpu.index.seeds import default_seeds
from shrimp_tpu.io.fasta import SeqRecord
from shrimp_tpu.mapper import Mapper
from shrimp_tpu.fastpath import (map_paired_sam_stream,
                                 map_unpaired_sam_stream)
from shrimp_tpu.parallel.meshmap import MeshMapper, make_mesh, zmerge_psum

COMP = {"A": "T", "C": "G", "G": "C", "T": "A"}


def _mk_genome(rng, n_contigs=3, clen=30_000):
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
        reads.append(SeqRecord(f"mr{k}", r))
    return reads


def test_meshmap_unpaired_byte_identical():
    rng = np.random.default_rng(101)
    contigs, gs = _mk_genome(rng)
    idx = build_index(contigs, default_seeds())
    reads = _mk_reads(rng, gs, 240)
    cfg = MapperConfig()
    m = Mapper(idx, cfg)
    want = b"".join(map_unpaired_sam_stream(m, reads, batch_size=96,
                                            lanes=1))
    mesh = make_mesh(jax.devices()[:8])
    mm = MeshMapper(idx, cfg, mesh=mesh)
    got = mm.map_unpaired_sam(reads, batch_size=96, collect_z=True)
    assert got == want

    # the z1 psum collective must equal the host-exact per-read
    # posterior sums (output.c:777-793 summed across shards, Part 1c)
    zp = mm.last_zpart
    merged = zmerge_psum(mesh, zp)
    host = zp.sum(axis=0)
    assert np.allclose(merged, host, rtol=1e-12, atol=0.0)
    assert float(host.max()) > 0.0          # something actually mapped


def test_meshmap_paired_byte_identical():
    rng = np.random.default_rng(102)
    contigs, gs = _mk_genome(rng)
    idx = build_index(contigs, default_seeds())
    cfg = MapperConfig(pair_mode="opp-in", min_insert_size=60,
                       max_insert_size=240)
    # interleaved opp-in pairs straddling contig positions
    reads = []
    for k in range(120):
        src = gs[k % len(gs)]
        isz = int(rng.integers(90, 200))
        p = int(rng.integers(0, len(src) - isz - 1))
        r1 = src[p:p + 36]
        r2 = src[p + isz - 36:p + isz]
        r2 = "".join(COMP[c] for c in reversed(r2))
        reads.append(SeqRecord(f"p{k}/1", r1))
        reads.append(SeqRecord(f"p{k}/2", r2))
    from shrimp_tpu.paired import PairedMapper
    m = PairedMapper(idx, cfg)
    want = b"".join(map_paired_sam_stream(m, reads, batch_size=80,
                                          lanes=1))
    mm = MeshMapper(idx, cfg, mesh=make_mesh(jax.devices()[:8]))
    got = mm.map_paired_sam(reads, batch_size=80)
    assert got == want


def test_meshmap_uneven_mesh_sizes():
    """Byte identity must hold for any shard count, including ones that
    leave some devices nearly empty."""
    rng = np.random.default_rng(103)
    contigs, gs = _mk_genome(rng, n_contigs=1, clen=12_000)
    idx = build_index(contigs, default_seeds())
    reads = _mk_reads(rng, gs, 64)
    cfg = MapperConfig()
    m = Mapper(idx, cfg)
    want = b"".join(map_unpaired_sam_stream(m, reads, batch_size=64,
                                            lanes=1))
    for nd in (2, 3, 5):
        mm = MeshMapper(idx, cfg, mesh=make_mesh(jax.devices()[:nd]))
        assert mm.map_unpaired_sam(reads, batch_size=64) == want, nd



def test_meshmap_long_reads():
    """Long-read configs map multi-chip: the halo derives from the
    window length (halo_for), and windows past the packed-IO envelope
    (G > 1023) fall back to a single-device launch per batch with
    identical output."""
    rng = np.random.default_rng(977)
    contigs, gs = _mk_genome(rng, n_contigs=1, clen=40_000)
    idx = build_index(contigs, default_seeds())
    RL = 1200
    reads = []
    for k in range(12):
        p = int(rng.integers(0, len(gs[0]) - RL))
        r = list(gs[0][p:p + RL])
        for _ in range(int(rng.integers(0, 6))):
            r[int(rng.integers(0, RL))] = "ACGT"[int(rng.integers(0, 4))]
        r = "".join(r)
        if k % 3 == 0:
            r = "".join(COMP[c] for c in reversed(r))
        reads.append(SeqRecord(f"lr{k}", r))
    cfg = MapperConfig(longest_read_len=2000)
    m = Mapper(idx, cfg)
    want = b"".join(map_unpaired_sam_stream(m, reads, batch_size=12,
                                            lanes=1))
    assert want.count(b"\n") >= 10     # the long reads actually map
    mm = MeshMapper(idx, cfg, mesh=make_mesh(jax.devices()[:4]))
    assert mm.halo >= 2048             # halo grew from the window length
    got = mm.map_unpaired_sam(reads, batch_size=12)
    assert got == want


def test_meshmap_colour_space():
    """Colour-space unpaired mapping over the mesh: the fused CS
    vector + 4-layer-full launch runs as one shard_map program over the
    range-sharded colour/letter planes, byte-identical to the
    single-device CS fast path."""
    import shrimp_tpu.constants as C
    from shrimp_tpu.fastpath_cs import map_unpaired_cs_sam_stream
    rng = np.random.default_rng(555)
    contigs, gs = _mk_genome(rng, n_contigs=2, clen=20_000)
    idx = build_index(contigs, default_seeds(mode="cs"), mode="cs")
    l2n = {c: i for i, c in enumerate("ACGT")}

    def tocs(s):
        return "T" + str(l2n["T"] ^ l2n[s[0]]) + "".join(
            str(l2n[s[i]] ^ l2n[s[i + 1]]) for i in range(len(s) - 1))

    reads = []
    for k in range(96):
        src = gs[k % 2]
        p = int(rng.integers(0, len(src) - 36))
        s = list(src[p:p + 36])
        for _ in range(int(rng.integers(0, 2))):
            s[int(rng.integers(0, 36))] = "ACGT"[int(rng.integers(0, 4))]
        s = "".join(s)
        if k % 3 == 0:
            s = "".join(COMP[c] for c in reversed(s))
        reads.append(SeqRecord(f"cs{k}", tocs(s)))
    cfg = MapperConfig(mode=C.MODE_COLOUR_SPACE)
    m = Mapper(idx, cfg)
    want = b"".join(map_unpaired_cs_sam_stream(m, reads, batch_size=96,
                                               lanes=1))
    assert want.count(b"\n") >= 90
    for nd in (2, 4, 8):
        mm = MeshMapper(idx, cfg, mesh=make_mesh(jax.devices()[:nd]))
        got = mm.map_unpaired_sam(reads, batch_size=96)
        assert got == want, nd


def mk_cs_pairs(rng, gs, n_pairs, L=36):
    """Interleaved opp-in colour-space pairs over multiple contigs,
    with occasional discordant mates (half-paired fallback)."""
    l2n = {c: i for i, c in enumerate("ACGT")}

    def tocs(s):
        return "T" + str(l2n["T"] ^ l2n[s[0]]) + "".join(
            str(l2n[s[i]] ^ l2n[s[i + 1]]) for i in range(len(s) - 1))

    recs = []
    for k in range(n_pairs):
        src = gs[k % len(gs)]
        isz = int(rng.integers(100, 220))
        p = int(rng.integers(0, len(src) - isz - 1))
        a = list(src[p:p + L])
        b = list(src[p + isz - L:p + isz])
        for s in (a, b):
            for _ in range(int(rng.integers(0, 3))):
                s[int(rng.integers(0, L))] = "ACGT"[int(rng.integers(4))]
        r1 = tocs("".join(a))
        r2 = tocs("".join(COMP[c] for c in reversed(b)))
        if k % 9 == 0:   # discordant mate
            q = int(rng.integers(0, len(src) - L))
            r2 = tocs(src[q:q + L])
        recs.append(SeqRecord(f"cp{k}/1", r1))
        recs.append(SeqRecord(f"cp{k}/2", r2))
    return recs


def test_meshmap_colour_space_paired():
    """CS paired over the mesh: the fused CS
    launch runs as the shard_map program, pair-up + paired MQV in the
    native renderer — byte-identical to the single-device CS paired
    fast path (matching gmapper-cs paired, sw-full-cs.c:1146-1236)."""
    import shrimp_tpu.constants as C
    from shrimp_tpu.fastpath_cs import map_paired_cs_sam_stream
    from shrimp_tpu.paired import PairedMapper
    rng = np.random.default_rng(556)
    contigs, gs = _mk_genome(rng, n_contigs=2, clen=20_000)
    idx = build_index(contigs, default_seeds(mode="cs"), mode="cs")
    recs = mk_cs_pairs(rng, gs, 60)
    cfg = MapperConfig(mode=C.MODE_COLOUR_SPACE, pair_mode="opp-in")
    gen = map_paired_cs_sam_stream(PairedMapper(idx, cfg), recs,
                                   batch_size=60, lanes=1)
    assert gen is not None
    want = b"".join(gen)
    assert want.count(b"\n") >= 60
    for nd in (2, 4):
        mm = MeshMapper(idx, cfg, mesh=make_mesh(jax.devices()[:nd]))
        got = mm.map_paired_sam(recs, batch_size=60)
        assert got == want, nd
